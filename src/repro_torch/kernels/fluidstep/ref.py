"""Plain PyTorch version of the fluid step core (port of
``repro/kernels/fluidstep/ref.py::fluid_step_core_ref``) with a leading
lane axis in place of ``vmap``.

Per lane it evaluates the per-tick contention/rate state of the fluid
simulator: per-domain in-flight counts, the oversub-weighted effective k,
the Eq. (5) drain ratio scaled by the slowest member server, the gating-side
``k_would`` and ``min_old_rem`` (Theorem 2's M_old, a min of per-domain
minima), and on request the job overlap matrix.  This is what a CPU tensor
runs, and what the CUDA kernel (``kernel.py``) is held against on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core import netmodel


def fluid_step_core_ref(loads, member, active, rem, bw, oversub, *,
                        b: float, eta: float, need_overlap: bool = False):
    """One evaluation of the contention/rate core for every lane.

    Args:
      loads: ``(L, J, D)`` bool — domains each job's ring crosses.
      member: ``(L, J, S)`` float {0,1} — servers each job holds GPUs on.
      active: ``(L, J)`` bool — transfers currently draining.
      rem: ``(L, J)`` float32 — remaining cost of each job's phase.
      bw: ``(S,)`` float32 — per-server relative NIC bandwidth.
      oversub: ``(D,)`` float32 — per-domain oversubscription.
      b / eta: Eq. (5) per-byte cost and contention penalty.
      need_overlap: also return the ``(L, J, J)`` overlap matrix.

    Returns ``counts`` (L, D) int32, ``k_eff`` (L, J) float32, ``ratio``
    (L, J) float32, ``k_would`` (L, J) int32, ``min_old_rem`` (L, J)
    float32 (``inf`` where no overlapping transfer is in flight) and
    ``overlap`` ((L, J, J) bool, or None unless ``need_overlap``).
    """
    counts = netmodel.domain_counts(loads, active)  # (L, D)
    k_eff = netmodel.domain_k(loads, counts.to(torch.float32) * oversub)
    scale = netmodel.slowest_member_scale(bw, member > 0)
    ratio = scale * netmodel.rate_ratio(k_eff, b, eta)
    k_would = netmodel.domain_k(loads, counts, extra=1)
    inf = torch.full_like(rem, float("inf"))
    # per-domain minimum in-flight remainder, then min over loaded domains
    dmin = torch.where(loads & active[..., None], rem[..., None], inf[..., None]).amin(-2)
    min_old_rem = torch.where(loads, dmin[..., None, :], inf[..., None]).amin(-1)
    overlap = None
    if need_overlap:
        loads_f = loads.to(torch.float32)
        overlap = (loads_f @ loads_f.transpose(-1, -2)) > 0
    return {
        "counts": counts,
        "k_eff": k_eff,
        "ratio": ratio,
        "k_would": k_would,
        "min_old_rem": min_old_rem,
        "overlap": overlap,
    }
