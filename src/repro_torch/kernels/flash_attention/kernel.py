"""Build, binding and launch of the CUDA flash-attention forward kernel
(``csrc/flash_attention.cu``; replaces the Pallas kernel
``repro/kernels/flash_attention/kernel.py::_flash_kernel``).

The source is compiled with ``nvcc`` for ``sm_90a`` at first use and
loaded with ``ctypes`` (:mod:`repro_torch.kernels.nvcc`), into the
``build/`` directory beside this module.

:func:`flash_attention_cuda` launches the kernel on PyTorch's current
stream, one CTA per (bh, query tile), and counts its launches in
``flash_attention_cuda.launches``.  The source picks the path: bf16 runs
on the bf16 tensor cores (``mma.sync``, P rounded to bf16 before the
product with V; D padded to 64, 128 or 256), float32 on the float32 cores.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.nvcc import NvccLibrary, check_tensor

#: dtype codes of the C interface (q, k, v and the output share one dtype)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Largest head dim: the tensor-core kernel's widest instantiation (bf16)
#: and the float32-core kernel's 8 output columns a lane (float32).
MAX_D = 256


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int


_LIB = NvccLibrary(Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
                   "flashattn", _bind)


def build() -> ctypes.CDLL:
    """Compile ``csrc/flash_attention.cu`` (once per source version) and load it."""
    return _LIB.load()


def build_info() -> dict:
    """Seconds the last :func:`build` took and the compiler's output."""
    return _LIB.info()


def flash_attention_cuda(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Launch the CUDA kernel on CUDA tensors q (BH,S,D), k and v (BH,T,D)
    of one dtype (float32 or bfloat16), D <= 256.  Returns a new (BH,S,D)
    tensor in q's dtype; raises on anything it does not take."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k and v must be (BH, S, D) and (BH, T, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)} and {tuple(v.shape)}")
    bh, s, d = q.shape
    t = k.shape[1]
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"q has dtype {q.dtype}, expected one of {tuple(DTYPES)}")
    if min(bh, s, t, d) < 1:
        raise ValueError(f"empty shape: BH={bh} S={s} T={t} D={d}")
    if d > MAX_D:
        raise ValueError(f"the CUDA kernel takes D <= {MAX_D}, got {d}")
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"tensors are on {device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    check_tensor("q", q, q.dtype, (bh, s, d), device)
    check_tensor("k", k, q.dtype, (bh, t, d), device)
    check_tensor("v", v, q.dtype, (bh, t, d), device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)

    lib = build()
    out = torch.empty((bh, s, d), dtype=q.dtype, device=device)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bh, s, t, d, DTYPES[q.dtype], int(bool(causal)), float(scale),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    flash_attention_cuda.launches += 1
    return out


#: Launches of the kernel in this process (reset by setting it to 0).
flash_attention_cuda.launches = 0
