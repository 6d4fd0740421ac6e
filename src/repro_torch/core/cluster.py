"""Job descriptions (port of ``repro/core/cluster.py``, trimmed to the
model profiles and job specs the fluid path reads; the event engine's
cluster state is not ported)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Measured per-model constants (paper Table III, Tesla V100, PyTorch):
    ``t_f``/``t_b`` seconds per iteration at ``batch_size``, ``size_bytes``
    the gradient message, ``mem_mb`` the GPU memory footprint."""

    name: str
    size_bytes: float
    mem_mb: float
    batch_size: int
    t_f: float
    t_b: float

    @property
    def t_iter_compute(self) -> float:
        return self.t_f + self.t_b


# Paper Table III.
TABLE_III = {
    "vgg16": ModelProfile("vgg16", 526.4e6, 4527.0, 16, 35.8e-3, 53.7e-3),
    "resnet50": ModelProfile("resnet50", 99.2e6, 3213.0, 16, 25.0e-3, 37.4e-3),
    "inception_v3": ModelProfile("inception_v3", 103.0e6, 3291.0, 16, 34.9e-3, 52.4e-3),
    "lstm_ptb": ModelProfile("lstm_ptb", 251.8e6, 2751.0, 64, 31.5e-3, 47.3e-3),
}


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One rigid DDL training job (Table II: arrival A_k, |G(J_k)| GPUs,
    I_k iterations and the model)."""

    job_id: int
    arrival: float
    n_gpus: int
    iterations: int
    model: ModelProfile

    def __post_init__(self) -> None:
        if self.n_gpus < 1:
            raise ValueError(f"job {self.job_id}: n_gpus must be >= 1, got {self.n_gpus}")
