"""Network fabric as contention domains (port of ``repro/core/topology.py``):
the event engine reads each task's loaded domains, the fluid path the
incidence matrix.  :class:`RingEdgeTopology` is the ``contention_domain=
"link"`` reading, with domains that depend on each task's member set.

A domain is a cut of the fabric: a server set whose boundary is a shared
resource.  A communication task loads a domain iff its ring crosses the cut
(member servers inside and outside).  Each domain carries an ``oversub``
factor: k tasks crossing it drain at the Eq. (5) rate of ``k * oversub``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Domain:
    """One contention domain: the cut around ``servers``."""

    name: str
    servers: Tuple[int, ...]
    oversub: float = 1.0

    def __post_init__(self) -> None:
        if not self.servers:
            raise ValueError(f"domain {self.name!r} covers no servers")
        if self.oversub <= 0:
            raise ValueError(
                f"domain {self.name!r}: oversub must be positive, got {self.oversub}"
            )
        object.__setattr__(self, "servers", tuple(sorted(set(self.servers))))


@dataclasses.dataclass(frozen=True)
class Topology:
    """A network fabric as a tuple of contention domains; ``racks`` groups
    servers for rack-aware placement (empty = one rack of every server)."""

    name: str
    n_servers: int
    domains: Tuple[Domain, ...]
    racks: Tuple[Tuple[int, ...], ...] = ()

    def __post_init__(self) -> None:
        if self.n_servers < 1:
            raise ValueError(f"n_servers must be >= 1, got {self.n_servers}")
        for d in self.domains:
            if d.servers[0] < 0 or d.servers[-1] >= self.n_servers:
                raise ValueError(
                    f"domain {d.name!r} references servers outside "
                    f"[0, {self.n_servers}): {d.servers}"
                )
        seen: set = set()
        for rack in self.racks:
            for s in rack:
                if s in seen:
                    raise ValueError(f"server {s} appears in two racks")
                if not 0 <= s < self.n_servers:
                    raise ValueError(f"rack server {s} out of range")
                seen.add(s)

    @property
    def n_domains(self) -> int:
        return len(self.domains)

    def loaded_domains(self, servers: Iterable[int]) -> frozenset:
        """Indices of the domains a comm task over ``servers`` loads: the
        cuts its ring crosses (members inside and outside).  A one-server
        task loads nothing."""
        s = set(servers)
        return frozenset(
            i
            for i, d in enumerate(self.domains)
            if not s.isdisjoint(d.servers) and not s.issubset(d.servers)
        )

    def oversub_of(self, domain_index: int) -> float:
        return self.domains[domain_index].oversub

    def incidence(self) -> np.ndarray:
        """``(n_domains, n_servers)`` float {0,1}: server s is inside
        domain d's cut."""
        inc = np.zeros((self.n_domains, self.n_servers), dtype=np.float32)
        for i, d in enumerate(self.domains):
            inc[i, list(d.servers)] = 1.0
        return inc

    def oversub_array(self) -> np.ndarray:
        return np.asarray([d.oversub for d in self.domains], dtype=np.float32)

    def rack_groups(self) -> Tuple[Tuple[int, ...], ...]:
        """Rack server groups; servers not in any rack form one trailing
        catch-all rack."""
        if not self.racks:
            return (tuple(range(self.n_servers)),)
        assigned = {s for rack in self.racks for s in rack}
        rest = tuple(s for s in range(self.n_servers) if s not in assigned)
        return self.racks + ((rest,) if rest else ())

    def server_rack(self) -> np.ndarray:
        """``(n_servers,)`` int32 rack index of each server."""
        out = np.zeros((self.n_servers,), dtype=np.int32)
        for r, rack in enumerate(self.rack_groups()):
            out[list(rack)] = r
        return out


@dataclasses.dataclass(frozen=True)
class RingEdgeTopology(Topology):
    """The ``contention_domain="link"`` reading (the paper's "each link
    between two nodes") as dynamic domains: a task over member servers
    ``S`` loads the directed edges of the ring over ``sorted(S)``, so two
    tasks contend iff they share a ring edge.  The domains depend on the
    member set, so there is no static incidence matrix: :meth:`incidence`
    raises, and the fluid path refuses this reading.  Domains are
    ``("edge", u, v)`` tuples at unit oversubscription.
    """

    def __init__(self, n_servers: int) -> None:
        # the domains are dynamic: bypass the tuple-of-domains fields
        object.__setattr__(self, "name", "ring_edges")
        object.__setattr__(self, "n_servers", n_servers)
        object.__setattr__(self, "domains", ())
        object.__setattr__(self, "racks", ())
        Topology.__post_init__(self)

    @staticmethod
    def ring_edges(servers: Iterable[int]) -> frozenset:
        """The directed ring edges of a member-server set: consecutive
        pairs of the sorted ring, wrap-around included (a 2-server ring
        loads both directions)."""
        ring = sorted(set(servers))
        return frozenset(
            ("edge", ring[i], ring[(i + 1) % len(ring)])
            for i in range(len(ring))
        )

    def loaded_domains(self, servers: Iterable[int]) -> frozenset:
        s = {x for x in servers if not 0 <= x < self.n_servers}
        if s:
            raise ValueError(f"servers {sorted(s)} outside [0, {self.n_servers})")
        members = set(servers)
        if len(members) < 2:
            return frozenset()  # single-server task: no shared link loaded
        return self.ring_edges(members)

    def oversub_of(self, domain) -> float:
        return 1.0  # every ring edge is a full-bandwidth link

    def incidence(self) -> np.ndarray:
        raise NotImplementedError(
            "ring-edge domains depend on each task's member set; there is no "
            "static [domains, servers] incidence matrix — the fluid backend "
            "does not support the legacy 'link' reading (use uplink_only/"
            "two_tier fabrics instead)"
        )


def nic_topology(n_servers: int) -> Topology:
    """The paper's model: one full-bandwidth NIC domain per server."""
    return Topology(
        name="nic",
        n_servers=n_servers,
        domains=tuple(
            Domain(name=f"nic{s}", servers=(s,)) for s in range(n_servers)
        ),
    )


def _rack_partition(n_servers: int, servers_per_rack: int) -> List[Tuple[int, ...]]:
    if servers_per_rack < 1:
        raise ValueError(f"servers_per_rack must be >= 1, got {servers_per_rack}")
    return [
        tuple(range(lo, min(lo + servers_per_rack, n_servers)))
        for lo in range(0, n_servers, servers_per_rack)
    ]


def two_tier(
    n_servers: int,
    servers_per_rack: int,
    oversub: float = 3.0,
    name: str = "",
) -> Topology:
    """Blocking two-tier fabric: per-server NIC domains plus one uplink
    domain per rack with oversubscription ``oversub``."""
    racks = _rack_partition(n_servers, servers_per_rack)
    domains = list(nic_topology(n_servers).domains)
    domains += [
        Domain(name=f"uplink{r}", servers=rack, oversub=oversub)
        for r, rack in enumerate(racks)
    ]
    return Topology(
        name=name or f"two_tier:{servers_per_rack}x{oversub:g}",
        n_servers=n_servers,
        domains=tuple(domains),
        racks=tuple(racks),
    )


def uplink_only(
    n_servers: int, servers_per_rack: int, oversub: float = 3.0
) -> Topology:
    """Rack uplinks without NIC domains: only cross-rack traffic contends."""
    racks = _rack_partition(n_servers, servers_per_rack)
    return Topology(
        name=f"uplink_only:{servers_per_rack}x{oversub:g}",
        n_servers=n_servers,
        domains=tuple(
            Domain(name=f"uplink{r}", servers=rack, oversub=oversub)
            for r, rack in enumerate(racks)
        ),
        racks=tuple(racks),
    )
