"""Job descriptions (port of ``repro/core/cluster.py``, trimmed to the
model profiles and job specs the fluid path reads; the event engine's
cluster state is not ported)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Measured per-model constants (paper Table III, Tesla V100, PyTorch):
    ``t_f``/``t_b`` seconds per iteration at ``batch_size``, ``size_bytes``
    the gradient message, ``mem_mb`` the GPU memory footprint.

    ``layer_grad_bytes``/``layer_t_b`` optionally resolve the gradient
    message and the backward pass to layers, in backward-ready order
    (output layer first), for the WFBP bucket stream
    (:mod:`repro_torch.workloads` derives them from model configs).  Empty
    tuples (Table III) mean the monolithic iteration-level model."""

    name: str
    size_bytes: float
    mem_mb: float
    batch_size: int
    t_f: float
    t_b: float
    layer_grad_bytes: Tuple[float, ...] = ()
    layer_t_b: Tuple[float, ...] = ()

    def __post_init__(self) -> None:
        if len(self.layer_grad_bytes) != len(self.layer_t_b):
            raise ValueError(
                f"{self.name}: layer_grad_bytes ({len(self.layer_grad_bytes)}) "
                f"and layer_t_b ({len(self.layer_t_b)}) must align"
            )

    @property
    def t_iter_compute(self) -> float:
        return self.t_f + self.t_b

    @property
    def has_layers(self) -> bool:
        return bool(self.layer_grad_bytes)


# Paper Table III.
TABLE_III = {
    "vgg16": ModelProfile("vgg16", 526.4e6, 4527.0, 16, 35.8e-3, 53.7e-3),
    "resnet50": ModelProfile("resnet50", 99.2e6, 3213.0, 16, 25.0e-3, 37.4e-3),
    "inception_v3": ModelProfile("inception_v3", 103.0e6, 3291.0, 16, 34.9e-3, 52.4e-3),
    "lstm_ptb": ModelProfile("lstm_ptb", 251.8e6, 2751.0, 64, 31.5e-3, 47.3e-3),
}


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One DDL training job (Table II: arrival A_k, |G(J_k)| GPUs, I_k
    iterations and the model).  ``min_gpus``/``max_gpus`` declare an
    elastic job for the event engine's elastic policy; the fluid path runs
    every job as a rigid gang of ``n_gpus``."""

    job_id: int
    arrival: float
    n_gpus: int
    iterations: int
    model: ModelProfile
    min_gpus: Optional[int] = None
    max_gpus: Optional[int] = None

    def __post_init__(self) -> None:
        # unset bounds default to the rigid n_gpus
        lo = self.min_gpus if self.min_gpus is not None else self.n_gpus
        hi = self.max_gpus if self.max_gpus is not None else self.n_gpus
        if not (1 <= lo <= self.n_gpus <= hi):
            raise ValueError(
                f"job {self.job_id}: elastic bounds must satisfy "
                f"1 <= min_gpus <= n_gpus <= max_gpus, got "
                f"({self.min_gpus}, {self.n_gpus}, {self.max_gpus})"
            )
