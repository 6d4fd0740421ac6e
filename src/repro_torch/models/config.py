"""Model configuration (port of ``repro/models/config.py``).

A trimmed copy of ``ModelConfig``: the fields, derived sizes and analytic
parameter count of the ``ssm``, ``dense`` and ``moe`` families.  The port
serves ``ssm`` (mamba2-130m) and ``dense`` (llama3.2-1b) models; the MoE
fields are here for the analytic per-layer counts the model zoo
(:mod:`repro_torch.workloads`) reads, not for a model.  The hybrid, enc-dec
and vlm fields come with their slices (ROADMAP).
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
    # -- attention ----------------------------------------------------------
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0            # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    sliding_window: int = 0      # 0 = full attention
    # -- mlp ----------------------------------------------------------------
    d_ff: int = 0
    act: str = "swiglu"          # swiglu | geglu | gelu (plain 2-matrix MLP)
    # -- MoE ----------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0            # 0 -> d_ff
    moe_every: int = 1           # layer i is MoE iff i % moe_every == moe_offset
    moe_offset: int = 0
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    # -- SSM (Mamba-2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    # -- enc-dec (audio backbone) ---------------------------------------------
    enc_layers: int = 0
    # -- sharding / padding ----------------------------------------------------
    padded_heads: int = 0        # pad q heads for TP divisibility (arctic)
    # -- bookkeeping ----------------------------------------------------------
    source: str = ""
    dtype: str = "bfloat16"

    def __post_init__(self) -> None:
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.family != "ssm" and self.n_heads <= 0:
            raise ValueError(f"{self.name}: attention families need n_heads")

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def q_heads_padded(self) -> int:
        return self.padded_heads or self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, VOCAB_PAD_MULTIPLE)

    @property
    def moe_d_ff_(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.n_experts == 0:
            return False
        return layer_idx % self.moe_every == self.moe_offset

    def param_count(self, padded: bool = False) -> int:
        """Total parameter count (analytic; excludes padding unless asked)."""
        d = self.d_model
        vocab = self.padded_vocab if padded else self.vocab_size
        total = vocab * d  # tied embedding/lm-head
        total += sum(self._layer_params(i, padded) for i in range(self.n_layers))
        if self.enc_layers:
            total += self.enc_layers * self._enc_layer_params(padded)
        total += self.n_layers * 2 * d  # norms (approx: 2 per layer)
        return total

    def _attn_params(self, padded: bool) -> int:
        h = self.q_heads_padded if padded else self.n_heads
        hd = self.head_dim_
        d = self.d_model
        return d * h * hd + 2 * d * self.n_kv_heads * hd + h * hd * d

    def _mlp_params(self, d_ff: int) -> int:
        n_mat = 3 if self.act in ("swiglu", "geglu") else 2
        return n_mat * self.d_model * d_ff

    def _ssm_params(self) -> int:
        d, di, n = self.d_model, self.ssm_d_inner, self.ssm_state
        h = self.ssm_n_heads
        conv_dim = di + 2 * n
        in_proj = d * (2 * di + 2 * n + h)  # z, x, B, C, dt
        return in_proj + conv_dim * self.ssm_conv_width + di * d + 2 * h

    def _layer_params(self, i: int, padded: bool, active_only: bool = False) -> int:
        """Parameters of decoder layer ``i`` (``active_only``: a MoE layer's
        routed experts only)."""
        if self.family not in ("ssm", "dense", "moe"):
            raise NotImplementedError(
                f"the port's ModelConfig counts the ssm, dense and moe families, not "
                f"{self.family!r} (ROADMAP queue 1, item 7)"
            )
        if self.family == "ssm":
            return self._ssm_params()
        mixer = self._attn_params(padded)
        if self.is_moe_layer(i):
            n_exp = self.experts_per_token if active_only else self.n_experts
            mlp = n_exp * self._mlp_params(self.moe_d_ff_) + self.d_model * self.n_experts
            if self.dense_residual:
                mlp += self._mlp_params(self.d_ff)
        else:
            mlp = self._mlp_params(self.d_ff)
        return mixer + mlp

    def _enc_layer_params(self, padded: bool) -> int:
        return self._attn_params(padded) + self._mlp_params(self.d_ff)
