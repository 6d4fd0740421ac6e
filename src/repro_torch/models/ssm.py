"""Mamba-2 (SSD — state-space duality) mixer layer [arXiv:2405.21060]
(port of ``repro/models/ssm.py``).

Prefill uses the chunked SSD algorithm: within a chunk the recurrence is a
masked quadratic form, and chunk states are carried by a Python loop over
chunks (the reference's ``lax.scan``).  Decode is the O(1) recurrent state
update, which :func:`ssm_decode_step` hands to the SSD decode-step kernel
(``repro_torch.kernels.ssd``): the CUDA kernel for CUDA tensors, its plain
version for CPU tensors; it updates the layer's cache in place.

The recurrence (per head h, state size N, head dim P):

    h_i = exp(dt_i * A) * h_{i-1} + dt_i * B_i x_i^T
    y_i = C_i . h_i + D * x_i

Rounding follows the reference op by op: ``softplus`` is
``logaddexp(x, 0)`` (``F.softplus`` switches to the identity above 20),
``silu`` is ``x * sigmoid(x)`` with both products in the input dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.ssd import ssd_decode_step
from repro_torch.kernels.ssd.ref import ssd_step  # noqa: F401  (the model's recurrence)
from repro_torch.models.common import ParamSpec, rms_norm
from repro_torch.models.config import ModelConfig

NEG_INF = -2.0**30


def ssm_schema(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, di, n = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    h, w = cfg.ssm_n_heads, cfg.ssm_conv_width
    return {
        "w_z": ParamSpec((d, di), ("embed", "ssm_inner")),
        "w_x": ParamSpec((d, di), ("embed", "ssm_inner")),
        "w_B": ParamSpec((d, n), ("embed", None)),
        "w_C": ParamSpec((d, n), ("embed", None)),
        "w_dt": ParamSpec((d, h), ("embed", "ssm_heads")),
        "conv_x": ParamSpec((di, w), ("ssm_inner", None), init="normal", scale=1.0),
        "conv_B": ParamSpec((n, w), (None, None)),
        "conv_C": ParamSpec((n, w), (None, None)),
        "conv_bias_x": ParamSpec((di,), ("ssm_inner",), init="zeros"),
        "conv_bias_B": ParamSpec((n,), (None,), init="zeros"),
        "conv_bias_C": ParamSpec((n,), (None,), init="zeros"),
        "A_log": ParamSpec((h,), ("ssm_heads",), init="zeros"),
        "D": ParamSpec((h,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), init="zeros"),
        "norm": ParamSpec((di,), ("ssm_inner",), init="ones"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed"), scale=0.5),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``, each rounded in x's dtype."""
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# Depthwise causal conv (width w), prefill and single-step forms
# ---------------------------------------------------------------------------


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (C, W) depthwise causal conv; returns (B, S, C)."""
    width = w.shape[-1]
    s = x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
    # unrolled taps, summed in the reference's order
    out = pad[:, 0:s, :] * w[:, 0][None, None, :]
    for i in range(1, width):
        out = out + pad[:, i : i + s, :] * w[:, i][None, None, :]
    return out + b[None, None, :]


def conv_step(x1: torch.Tensor, state: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x1: (B, C) new input; state: (B, C, W-1) previous inputs.
    Returns (conv output (B, C), new state)."""
    full = torch.cat([state, x1[:, :, None]], dim=-1)  # (B, C, W)
    y = torch.sum(full * w[None, :, :], dim=-1) + b[None, :]
    return y, full[:, :, 1:]


# ---------------------------------------------------------------------------
# SSD chunked scan (prefill)
# ---------------------------------------------------------------------------


def ssd_scan(
    x: torch.Tensor,     # (B, S, H, P)
    dt: torch.Tensor,    # (B, S, H)  (already softplus'd, >= 0)
    a: torch.Tensor,     # (H,)       (negative: -exp(A_log))
    b_in: torch.Tensor,  # (B, S, N)
    c_in: torch.Tensor,  # (B, S, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N) initial state or None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P) in x's dtype, final state (B,H,P,N) float32)."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    f32 = torch.float32

    dA = (dt * a[None, None, :]).to(f32)  # (B,S,H), <= 0
    if h0 is None:
        state = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    else:
        state = h0.to(f32)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))

    ys = []
    for lo in range(0, s, chunk):
        sl = slice(lo, lo + chunk)
        xc, dtc, dac = x[:, sl].to(f32), dt[:, sl], dA[:, sl]
        bc, cc = b_in[:, sl].to(f32), c_in[:, sl].to(f32)
        cum = torch.cumsum(dac, dim=1)  # (B,q,h)
        total = cum[:, -1, :]  # (B,h)
        # inter-chunk: y_i += exp(cum_i) * C_i . h_state
        y_inter = torch.einsum("bqn,bhpn->bqhp", cc, state) * torch.exp(cum)[..., None]
        # intra-chunk masked quadratic; scores * el is folded to (B,i,j,h)
        # before contracting j, so no (B,i,j,h,p) tensor is formed
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B,i,j,h)
        diff = torch.where(tri[None, :, :, None], diff, NEG_INF)
        el = torch.exp(diff) * dtc[:, None, :, :]  # (B,i,j,h)
        scores = torch.einsum("bin,bjn->bij", cc, bc)
        y_intra = torch.einsum("bijh,bjhp->bihp", scores[..., None] * el, xc)
        # state update
        decay = torch.exp(total[:, None, :] - cum) * dtc  # (B,j,h)
        state = state * torch.exp(total)[:, :, None, None] + torch.einsum(
            "bjhp,bjn->bhpn", xc * decay[..., None], bc
        )
        ys.append((y_inter + y_intra).to(x.dtype))
    return torch.cat(ys, dim=1), state


# ---------------------------------------------------------------------------
# Full mixer layer
# ---------------------------------------------------------------------------


def pick_chunk(s: int, target: int) -> int:
    """Largest divisor of s that is <= target (SSD chunk size)."""
    c = min(s, target)
    while s % c:
        c -= 1
    return c


def _in_proj(x: torch.Tensor, params: Dict[str, torch.Tensor]):
    """z, x, B, C projections and the softplus'd dt (float32)."""
    z = x @ params["w_z"]
    xs = x @ params["w_x"]
    bp = x @ params["w_B"]
    cp = x @ params["w_C"]
    dt = softplus((x @ params["w_dt"]).to(torch.float32)
                  + params["dt_bias"].to(torch.float32))
    return z, xs, bp, cp, dt


def _ssd_mix(x: torch.Tensor, xs_pre, bp_pre, cp_pre, z, dt, params, cfg: ModelConfig):
    """Conv + SSD scan + gated norm + out projection of a prompt.
    Returns (out (B, S, D), final SSD state)."""
    bsz, s, _ = x.shape
    h, p = cfg.ssm_n_heads, cfg.ssm_head_dim
    xs = silu(causal_conv(xs_pre, params["conv_x"], params["conv_bias_x"]))
    bp = silu(causal_conv(bp_pre, params["conv_B"], params["conv_bias_B"]))
    cp = silu(causal_conv(cp_pre, params["conv_C"], params["conv_bias_C"]))

    a = -torch.exp(params["A_log"].to(torch.float32))
    xh = xs.reshape(bsz, s, h, p)
    y, h_final = ssd_scan(xh, dt.to(xs.dtype), a, bp, cp, chunk=pick_chunk(s, cfg.ssm_chunk))
    y = y + xh * params["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, h * p)
    y = rms_norm(y * silu(z), params["norm"])
    return y @ params["out_proj"], h_final


def ssm_forward(x: torch.Tensor, params: Dict[str, torch.Tensor],
                cfg: ModelConfig) -> torch.Tensor:
    """(B, S, D) -> (B, S, D) Mamba-2 mixer (prefill)."""
    z, xs, bp, cp, dt = _in_proj(x, params)
    out, _ = _ssd_mix(x, xs, bp, cp, z, dt, params, cfg)
    return out


def ssm_prefill(x: torch.Tensor, params: Dict[str, torch.Tensor], cfg: ModelConfig):
    """SSM forward that also returns the decode cache (conv + state)
    (port of ``repro/models/lm.py::ssm_mod_prefill``)."""
    s = x.shape[1]
    wd = cfg.ssm_conv_width
    z, xs_pre, bp_pre, cp_pre, dt = _in_proj(x, params)
    out, h_final = _ssd_mix(x, xs_pre, bp_pre, cp_pre, z, dt, params, cfg)

    def last_w(pre):  # (B, S, C) -> (B, C, wd-1) last pre-conv inputs
        if s >= wd - 1:
            tail = pre[:, s - (wd - 1):, :]
        else:
            tail = torch.nn.functional.pad(pre, (0, 0, wd - 1 - s, 0))
        return tail.transpose(1, 2).contiguous()

    cache = {
        "conv_x": last_w(xs_pre),
        "conv_B": last_w(bp_pre),
        "conv_C": last_w(cp_pre),
        "state": h_final,
    }
    return out, cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.bfloat16,
                   device="cpu"):
    di, n, w = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_conv_width
    h, p = cfg.ssm_n_heads, cfg.ssm_head_dim
    return {
        "conv_x": torch.zeros((batch, di, w - 1), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, n, w - 1), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, n, w - 1), dtype=dtype, device=device),
        "state": torch.zeros((batch, h, p, n), dtype=torch.float32, device=device),
    }


def ssm_decode_step(x1: torch.Tensor, params: Dict[str, torch.Tensor], cache,
                    cfg: ModelConfig, ssd_impl: str = "") -> Tuple[torch.Tensor, dict]:
    """One-token decode.  x1: (B, 1, D) -> (y (B,1,D), cache).

    The new conv caches and the new state are written into ``cache``'s own
    tensors, which are returned (the reference's server donates the cache,
    so its step updates it in place too).  The SSD step with its ``D·x``
    skip term is one call of :func:`repro_torch.kernels.ssd.ssd_decode_step`
    with ``out`` the cached state (``ssd_impl`` as there: "" lets the
    device decide)."""
    bsz = x1.shape[0]
    h, p = cfg.ssm_n_heads, cfg.ssm_head_dim
    z, xs, bp, cp, dt = _in_proj(x1[:, 0, :], params)

    xs, conv_x = conv_step(xs, cache["conv_x"], params["conv_x"], params["conv_bias_x"])
    bp, conv_b = conv_step(bp, cache["conv_B"], params["conv_B"], params["conv_bias_B"])
    cp, conv_c = conv_step(cp, cache["conv_C"], params["conv_C"], params["conv_bias_C"])
    for name, new in (("conv_x", conv_x), ("conv_B", conv_b), ("conv_C", conv_c)):
        cache[name].copy_(new)
    xs, bp, cp = silu(xs), silu(bp), silu(cp)

    a = -torch.exp(params["A_log"].to(torch.float32))
    y, _ = ssd_decode_step(
        xs.reshape(bsz, h, p), dt.to(xs.dtype), a, bp, cp,
        params["D"].to(x1.dtype), cache["state"], impl=ssd_impl, out=cache["state"],
    )
    y = y.reshape(bsz, h * p)
    y = rms_norm(y * silu(z), params["norm"])
    out = (y @ params["out_proj"])[:, None, :]
    return out, cache
