"""Model configuration (port of ``repro/models/config.py``).

A trimmed copy of ``ModelConfig``: the fields, derived sizes and analytic
parameter count of the ``ssm`` family, the one family the port serves so
far.  The other families' fields come with their slices (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import math

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")

#: Pad vocab so the 16-way model axis of the reference's mesh divides it;
#: the port keeps the padded embedding so weights carry across unchanged.
VOCAB_PAD_MULTIPLE = 2048


def pad_to(x: int, multiple: int) -> int:
    return int(math.ceil(x / multiple) * multiple)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    vocab_size: int
    # -- SSM (Mamba-2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    # -- bookkeeping ----------------------------------------------------------
    source: str = ""
    dtype: str = "bfloat16"

    def __post_init__(self) -> None:
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, VOCAB_PAD_MULTIPLE)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def param_count(self, padded: bool = False) -> int:
        """Total parameter count (analytic; excludes padding unless asked)."""
        if self.family != "ssm":
            raise NotImplementedError(
                f"the port's ModelConfig covers the ssm family only, not {self.family!r} "
                "(ROADMAP queue 1, item 8)"
            )
        d = self.d_model
        vocab = self.padded_vocab if padded else self.vocab_size
        total = vocab * d  # tied embedding/lm-head
        total += self.n_layers * self._ssm_params()
        total += self.n_layers * 2 * d  # norms (approx: 2 per layer)
        return total

    def _ssm_params(self) -> int:
        d, di, n = self.d_model, self.ssm_d_inner, self.ssm_state
        h = self.ssm_n_heads
        conv_dim = di + 2 * n
        in_proj = d * (2 * di + 2 * n + h)  # z, x, B, C, dt
        return in_proj + conv_dim * self.ssm_conv_width + di * d + 2 * h
