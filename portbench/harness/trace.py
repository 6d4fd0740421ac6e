"""The traced run's profile: whole chunks at set points of the window's
first batch, and the reduction of their records.

A traffic file lists ``profile_chunks``, chunk indices of a batch.  Once
the window has closed, :class:`ChunkProfiler` runs the window's first
batch again under ``torch.profiler`` and stops after the last sampled
chunk.  For each set point it records the first chunk at or after it
that replays a captured graph (a chunk that captures one is not
sampled), one profiler session per chunk, with the chunk before it as
the profiler's warm-up: from the moment the driver starts the chunk
until it starts the next one, the chunk's replays, the host sync that
ends it and the driver's work between chunks.  The sample is the same
on any two versions of the program that run the same chunks.  The
profiler slows each graph launch (its idle gaps show the host in
``cudaGraphLaunch``) and parses its records at the end of each session,
which is why it runs outside the measured window.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

WINDOW_NAME = "portbench.window"
CHUNK_TICKS = 256  # the simulator's default chunk, which the entry runs

NAME_CHARS = 160

Interval = Tuple[str, float, float]


def _runner_cls():
    from repro_torch.core import fluidsim

    return fluidsim._ChunkRunner


class _Done(Exception):
    """Raised at the chunk after the last sampled one: the profiling pass
    needs no more of the batch."""


class ChunkProfiler:
    """Profiles the traffic's ``profile_chunks`` of one call of the entry
    (:meth:`run`) and keeps each sampled chunk's records."""

    def __init__(self, traffic: dict, config: dict):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.torch, self.profile = torch, profile
        self.activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            self.activities.append(ProfilerActivity.CUDA)
        self.left = sorted(traffic["profile_chunks"])
        self.overlap = config["fusion"] != "all"
        self.n_servers = config["n_servers"]
        self.n_domains = config["n_servers"]  # one contention domain per NIC
        self.profiles: List[dict] = []
        self.k = 0
        self.prof = self.range = None
        self.recorded: Optional[int] = None

    def _boundary(self, runner) -> None:
        k, self.k = self.k, self.k + 1
        if self.range is not None:  # the sampled chunk k - 1 has ended
            self._finish()
        if not self.left:
            raise _Done
        if self.prof is None and k + 1 >= self.left[0]:
            self.prof = self.profile(activities=self.activities)
            self.prof.start()  # chunk k warms the profiler up
        elif self.prof is not None and k >= self.left[0] and runner.graph is not None:
            arr = runner.trace["arrival"]
            self.shape = (int(arr.shape[0]), int(arr.shape[1]), self.n_servers,
                          self.n_domains, self.overlap)
            self.recorded = k
            self.range = self.torch.profiler.record_function(WINDOW_NAME)
            self.range.__enter__()

    def _finish(self) -> None:
        self.range.__exit__(None, None, None)
        self.range = None
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.prof.stop()
        self.profiles.append(self._reduce(self.prof))
        self.prof = None
        self.left = [t for t in self.left if t > self.recorded]

    def _reduce(self, prof) -> dict:
        """The sampled chunk's records: device and host events cut to the
        window the harness marked (the warm-up chunk's fall outside it)."""
        dev_type = self.torch.autograd.DeviceType.CUDA
        window, device, host = None, [], []
        for e in prof.events():
            name, start, end = e.name, e.time_range.start, e.time_range.end
            if e.device_type == dev_type:
                if not (name.startswith("ProfilerStep") or name.startswith("portbench.")):
                    device.append((name, start, end))
            elif name == WINDOW_NAME:
                window = (start, end)
            else:
                host.append((name, start, end))
        if window is not None:
            device, host = clipped(device, *window), clipped(host, *window)
        return {"chunk": self.recorded, "window": window, "device": device, "host": host,
                "ticks": CHUNK_TICKS, "shape": self.shape}

    def run(self, entry, *args, **kw) -> List[dict]:
        """Call the entry under the profiler until the last sampled chunk."""
        cls = _runner_cls()
        orig = cls.run_chunk
        prof_self = self

        def run_chunk(runner):
            prof_self._boundary(runner)
            return orig(runner)

        cls.run_chunk = run_chunk
        try:
            entry(*args, **kw)
        except _Done:
            pass
        finally:
            cls.run_chunk = orig
            if self.range is not None:
                self._finish()
            elif self.prof is not None:
                self.prof.stop()
        return self.profiles


# ---- reductions shared by the metric readers ------------------------------

def describe(p: dict) -> str:
    """One line on a sampled chunk, times in ms."""
    lo, hi = p["window"]
    spent = sum(e - s for _, s, e in p["device"])
    fluid = sum(e - s for n, s, e in p["device"] if "fluid_step" in n)
    return (f"sampled chunk {p['chunk']} of {p['shape'][0]} x {p['shape'][1]}: profiled "
            f"{(hi - lo) * 1e-3:.3f} ms, {len(p['device'])} device ops, {spent * 1e-3:.3f} ms, "
            f"busy {union_length(p['device']) * 1e-3:.3f} ms, fluid step {fluid * 1e-3:.3f} ms")


def clipped(intervals: List[Interval], lo: float, hi: float) -> List[Interval]:
    return [(n, max(s, lo), min(e, hi)) for n, s, e in intervals if e > lo and s < hi]


def union_length(intervals: List[Interval]) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_and_window(profiles: List[dict]) -> Tuple[float, float]:
    """(seconds with a kernel or copy on the card, seconds profiled), over
    the sampled chunks."""
    busy = sum(union_length(p["device"]) for p in profiles) * 1e-6
    return busy, sum(p["window"][1] - p["window"][0] for p in profiles) * 1e-6


def gaps(profile: dict) -> List[Tuple[float, float]]:
    """Idle stretches of the card inside one profiled window."""
    lo, hi = profile["window"]
    out, cur = [], lo
    for _, s, e in sorted(profile["device"], key=lambda x: x[1]):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its namespaces, return type and argument
    list: the template, which names the functor, is kept."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "at::", "std::"):
        name = name.replace(noise, "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            return name[:i].strip()
    return name


def breakdown(profiles: List[dict], top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the card's idle time
    by the innermost host operation running at each gap's midpoint (both
    as the profiled chunks show them; names cut to :data:`NAME_CHARS`)."""
    by_op: Dict[str, float] = {}
    by_host: Dict[str, float] = {}
    for p in profiles:
        for name, s, e in p["device"]:
            name = short_name(name)
            by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-6
        host = sorted((h for h in p["host"] if h[0] != WINDOW_NAME), key=lambda h: h[1])
        starts = [h[1] for h in host]
        for g0, g1 in gaps(p):
            mid = 0.5 * (g0 + g1)
            k = bisect.bisect_right(starts, mid)
            inner = [h for h in host[max(0, k - 256):k] if h[2] >= mid]
            label = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "host: between ops"
            by_host[label] = by_host.get(label, 0.0) + (g1 - g0) * 1e-6
    def rank(d):
        return [[k[:NAME_CHARS], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}
