"""Threefry-2x32 counter-based random numbers that reproduce ``jax.random``
(port of the default PRNG of jax 0.9.0: ``jax/_src/prng.py``'s
``threefry_2x32``, ``threefry_split``, ``threefry_fold_in`` and the
*partitionable* branch of ``threefry_random_bits``, and ``jax/_src/
random.py``'s ``_uniform``, ``_randint``, ``_normal_real``, ``choice``,
``_gumbel`` and ``categorical``).

A key is a tensor of two uint32 values, held as ``int64`` in ``[0, 2**32)``
(PyTorch has no shifts for ``uint32``), with any leading batch axes: a key
of shape ``batch + (2,)`` draws like ``jax.vmap`` over those axes, so every
sampler returns ``batch + shape``.  A key from the reference
(``np.asarray(jax.random.PRNGKey(s))``, uint32) is taken as it is.

Every function is tensor operations on the key's device, with no host
sync, so a draw can sit inside a CUDA graph.  The rounds run on ``int64``
masked to 32 bits; a draw of more than :data:`SLICE` values runs in slices
of the counter space, so that the temporaries stay bounded on the card.

Bits are the reference's bit for bit, on the CPU and on the card.
``normal`` is ``sqrt(2) * erf_inv(u)`` with XLA's single-precision
``erf_inv`` (Giles' polynomial in ``w = -log1p(-x**2)``, evaluated with
fused multiply-adds as XLA's CPU backend contracts them): it differs from
the reference by at most 2 ulp, from ``log1p``, whose last bit is the
library's own.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_I64 = torch.int64
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: Counters per slice of a large draw: 2**24 values keep each int64
#: temporary at 128 MiB.
SLICE = 1 << 24

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def as_key(key) -> torch.Tensor:
    """A key (or batch of keys, last axis 2) as int64 values in [0, 2**32)."""
    if not isinstance(key, torch.Tensor):
        key = torch.as_tensor(np.asarray(key).astype(np.int64))
    elif key.dtype == torch.uint32:
        key = torch.as_tensor(key.cpu().numpy().astype(np.int64)).to(key.device)
    key = key.to(_I64)
    if key.dim() < 1 or key.shape[-1] != 2:
        raise ValueError(f"a key has a last axis of 2, got shape {tuple(key.shape)}")
    return key


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counters ``(x1, x2)`` under the
    key ``(k1, k2)``; int64 tensors of uint32 values that broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 (the reference's name)
    """``jax.random.PRNGKey(seed)`` as the reference makes it without 64-bit
    mode: the seed is a 32-bit integer, so the high word is 0 and the low
    word the seed modulo 2**32."""
    return torch.tensor([0, int(seed) & _M32], dtype=_I64, device=device)


def _counter_hash(key: torch.Tensor, n: int, start: int = 0):
    """Both hash words of counters ``start .. start+n`` (the 64-bit iota as
    (high, low) words) under every key of the batch: ``batch + (n,)``."""
    idx = torch.arange(start, start + n, dtype=_I64, device=key.device)
    k1, k2 = key[..., 0:1], key[..., 1:2]
    return threefry2x32(k1, k2, idx >> 32, idx & _M32)


def _words(key: torch.Tensor, n: int, combine) -> torch.Tensor:
    """``combine(bits1, bits2)`` over counters 0..n, in slices of
    :data:`SLICE`; ``batch + (n,)``."""
    if n <= SLICE:
        return combine(*_counter_hash(key, n))
    parts = [combine(*_counter_hash(key, min(SLICE, n - s), s)) for s in range(0, n, SLICE)]
    return torch.cat(parts, dim=-1)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``batch + (num, 2)`` keys (the fold-like
    partitionable split)."""
    key = as_key(key)
    b1, b2 = _counter_hash(key, int(num))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter pair ``(0, data)``;
    ``data`` (int or integer tensor, taken mod 2**32) broadcasts against the
    key's batch."""
    key = as_key(key)
    data = torch.as_tensor(data, device=key.device).to(_I64) & _M32
    k1, k2 = key[..., 0], key[..., 1]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def random_bits(key, shape: Shape = (), bit_width: int = 32) -> torch.Tensor:
    """``jax.random.bits`` with ``uint32`` (or ``uint8``) words: the XOR of
    the two hash words of each counter, as int64 values; ``batch + shape``."""
    if bit_width not in (8, 32):
        raise ValueError(f"bit_width {bit_width}: the port draws 8 or 32-bit words")
    key = as_key(key)
    shape = _shape(shape)
    n = math.prod(shape)
    bits = _words(key, n, lambda b1, b2: b1 ^ b2)
    if bit_width < 32:
        bits = bits & ((1 << bit_width) - 1)
    return bits.reshape(tuple(key.shape[:-1]) + shape)


#: (total bits, mantissa bits, the bits of 1.0, an integer dtype of that width)
_FLOATS = {
    torch.float32: (32, 23, 0x3F800000, torch.int32),
    torch.bfloat16: (16, 7, 0x3F80, torch.int16),
}


def uniform(key, shape: Shape = (), dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``: ``[minval, maxval)`` from the top mantissa
    bits of each word.  ``floats * (maxval - minval) + minval`` is one fused
    multiply-add, as the reference's jitted ``_uniform`` computes it on the
    CPU (bfloat16: in float32, rounded once).  The bounds are Python
    numbers, so no tensor is made from the host (a CUDA graph can capture
    the draw)."""
    if dtype not in _FLOATS:
        raise ValueError(f"uniform draws {tuple(_FLOATS)}, not {dtype}")
    nbits, nmant, one_bits, int_dtype = _FLOATS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, shape, rng_bits)
    fbits = (bits >> (rng_bits - nmant)) | one_bits
    floats = fbits.to(int_dtype).view(dtype) - 1.0
    lo, hi = (torch.tensor(v, dtype=dtype) for v in (minval, maxval))  # host scalars
    out = _fma(floats.to(torch.float32), float(hi - lo), float(lo)).to(dtype)
    return torch.clamp(out, min=float(lo))


_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def randint(key, shape: Shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` into int32: two words per value (one from each
    half of ``split(key)``), reduced modulo the span as the reference does
    in uint32 arithmetic."""
    key = as_key(key)
    shape = _shape(shape)
    out_of_range = maxval > _I32_MAX
    lo = min(max(int(minval), _I32_MIN), _I32_MAX)
    hi = min(max(int(maxval), _I32_MIN), _I32_MAX)
    span = (hi - lo) & _M32
    if hi <= lo:
        span = 1
    elif out_of_range:
        span = (span + 1) & _M32
    keys = split(key)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    if span == 0:  # the span wrapped to 2**32: XLA's x % 0 is x
        offset = lower
    else:
        mult = (1 << 16) % span
        mult = ((mult * mult) & _M32) % span  # the square wraps in uint32
        offset = ((((higher % span) * mult) & _M32) + (lower % span)) & _M32
        offset = offset % span
    out = (lo + offset + (1 << 31)) & _M32
    return (out - (1 << 31)).to(torch.int32)


def _f32(v: float) -> float:
    return float(np.float32(v))


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (float32 operands; the product
    is exact in float64)."""
    d = lambda v: v.to(torch.float64) if isinstance(v, torch.Tensor) else v  # noqa: E731
    return (d(a) * d(b) + d(c)).to(torch.float32)


_LOG_P = tuple(_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log`` (Cephes' ``logf``: mantissa in [sqrt(1/2),
    sqrt(2)), a degree-8 polynomial in three Horner chains, the exponent
    times ln 2 in two parts), with the multiply-adds XLA's compiler fuses.
    Positive finite inputs only, as the samplers give it."""
    x = torch.clamp(x, min=float(torch.finfo(torch.float32).tiny))
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    low = m < _f32(0.707106781186547524)
    e = e - low.to(torch.float32)
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    m2 = m * m
    m3 = m2 * m
    p = _LOG_P
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, m3, y1), m3, y2)
    y = _fma(y, m3, _f32(-2.12194440e-4) * e)
    out = _fma(-0.5, m2, m) + y
    return _fma(_f32(0.693359375), e, out)


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p``: Cephes' rational approximation for
    ``|x| < sqrt(2) - 1``, else :func:`xla_log` of ``1 + x``."""

    def horner(coeffs):
        p = torch.zeros_like(x)
        for c in coeffs:
            p = _fma(p, x, _f32(c))
        return p

    x2 = x * x
    small = (x * x2) * (horner(_LOG1P_NUM) / horner(_LOG1P_DEN))
    small = x + _fma(-0.5, x2, small)
    return torch.where(x.abs() < 0.41421356237309504880, small, xla_log(x + 1.0))


_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles, "Approximating the erfinv
    function"): a degree-8 polynomial in ``w - 2.5`` or ``sqrt(w) - 3`` for
    ``w = -log1p(-x**2)`` below and above 5, each step one fused
    multiply-add; ``+-inf`` at ``+-1``."""
    x = x.to(torch.float32)
    w = -xla_log1p(x * -x)
    lt = w < 5.0
    # sqrt in float64, rounded once: float32 torch.sqrt on the CPU is not
    # always correctly rounded
    w = torch.where(lt, w - 2.5, torch.sqrt(w.to(torch.float64)).to(torch.float32) - 3.0)

    def coef(i):
        return torch.where(lt, _f32(_ERFINV_SMALL[i]), _f32(_ERFINV_LARGE[i]))

    p = coef(0)
    for i in range(1, 9):
        p = _fma(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def normal(key, shape: Shape = (), dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)`` for ``u``
    uniform on ``[nextafter(-1, 0), 1)``.  Large draws run in slices of
    :data:`SLICE` counters."""
    if dtype != torch.float32:
        raise ValueError(f"normal draws float32 (cast afterwards), not {dtype}")
    key = as_key(key)
    shape = _shape(shape)
    n = math.prod(shape)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    parts = []
    for s in range(0, max(n, 1), SLICE):
        m = min(SLICE, n - s)
        bits = _counter_hash(key, m, s)
        parts.append(_normal_from_bits(bits[0] ^ bits[1], lo))
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    return out.reshape(tuple(key.shape[:-1]) + shape)


def _normal_from_bits(bits: torch.Tensor, lo: float) -> torch.Tensor:
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(_fma(floats, 2.0, lo), min=lo)  # (1 - lo) rounds to 2 in float32
    return _SQRT2_F32 * erf_inv(u)


def gumbel(key, shape: Shape = (), dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"): ``-log(-log(u))`` for ``u``
    uniform on ``[tiny, 1)``."""
    tiny = float(torch.finfo(dtype).tiny)
    u = uniform(key, shape, dtype, minval=tiny, maxval=1.0)
    if dtype == torch.float32:
        return -xla_log(-xla_log(u))
    # bfloat16: each log in float32, rounded to bfloat16, as XLA upcasts
    # each operation
    inner = xla_log(u.float()).to(dtype)
    return (-xla_log(-inner.float())).to(dtype)


def categorical(key, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical`` (with replacement): the Gumbel-max trick,
    ``argmax(gumbel + logits)`` over ``axis`` with the first index on ties.
    A batched key draws one sample set per key over the matching leading
    axes of ``logits``."""
    key = as_key(key)
    batch = tuple(key.shape[:-1])
    if tuple(logits.shape[: len(batch)]) != batch:
        raise ValueError(f"keys of batch {batch} do not lead logits of shape "
                         f"{tuple(logits.shape)}")
    per_key = tuple(logits.shape[len(batch):])
    if axis >= 0:
        axis -= len(per_key)
    g = gumbel(key, per_key, logits.dtype)
    return torch.argmax(g + logits, dim=axis).to(torch.int32)


def choice(key, a: torch.Tensor, shape: Shape, p: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, a, shape, p=p)`` with replacement over a 1-D
    ``a``: the index where ``p``'s float32 cumulative sum first reaches
    ``total * (1 - uniform)``."""
    key = as_key(key)
    shape = _shape(shape)
    a = torch.as_tensor(a, device=key.device)
    p = torch.as_tensor(p, dtype=torch.float32, device=key.device)
    if tuple(p.shape) != tuple(a.shape[:1]) or a.dim() != 1:
        raise ValueError(f"p of shape {tuple(p.shape)} for a of shape {tuple(a.shape)}")
    cum = torch.cumsum(p, 0)
    r = cum[-1] * (1.0 - uniform(key, shape, torch.float32))
    return a[(cum < r[..., None]).sum(-1)]


__all__ = [
    "PRNGKey", "SLICE", "as_key", "categorical", "choice", "erf_inv", "fold_in", "gumbel",
    "normal", "randint", "random_bits", "split", "threefry2x32", "uniform",
]
