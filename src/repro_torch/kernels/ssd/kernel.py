"""Build, binding and launch of the CUDA SSD decode step
(``csrc/ssd_step.cu``; replaces the Pallas kernel
``repro/kernels/ssd/kernel.py::_ssd_step_kernel``).

The source is compiled with ``nvcc`` for ``sm_90a`` at first use and
loaded with ``ctypes`` (:mod:`repro_torch.kernels.nvcc`), into the
``build/`` directory beside this module.

:func:`ssd_decode_step_cuda` launches the kernel on PyTorch's current
stream, out of place or in place (``out=state``), and counts its launches
in ``ssd_decode_step_cuda.launches``.  On the main path (N a multiple of 4,
16-byte aligned states) each CTA takes :func:`rows_per_cta` rows of one
(batch, head) block with one bulk copy; otherwise one CTA per (batch,
head) with scalar accesses.  :func:`empty_launch` launches an empty kernel
on the main path's grid: its time in a CUDA graph is the card's launch
floor for the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.nvcc import NvccLibrary, check_tensor

#: dtype codes of the C interface (x, dt, B, C and y share one dtype)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Largest state size N: B and C rows are staged (float32) in the default
#: 48 KB of dynamic shared memory on the scalar path (the main path also
#: stages its state slice and x, and asks for more than 48 KB above N 4,096).
MAX_N = 48 * 1024 // (2 * 4)
#: Bytes of state each CTA of the main path stages with its bulk copy:
#: 16 rows at N 128, so 768 CTAs at the serve batch of 8 (24 heads x P 64).
SLICE_BYTES = 8192


def rows_per_cta(n: int, p: int) -> int:
    """Rows of a (batch, head) block each CTA of the main path takes."""
    return max(1, min(p, SLICE_BYTES // (4 * n)))


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ssd_step_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ssd_step_empty_launch.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.ssd_step_empty_launch.restype = ctypes.c_int


_LIB = NvccLibrary(Path(__file__).resolve().parent / "csrc" / "ssd_step.cu", "ssdstep", _bind)


def build() -> ctypes.CDLL:
    """Compile ``csrc/ssd_step.cu`` (once per source version) and load it."""
    return _LIB.load()


def build_info() -> dict:
    """Seconds the last :func:`build` took and the compiler's output."""
    return _LIB.info()


def ssd_decode_step_cuda(x, dt, a, b, c, d, state, out=None):
    """Launch the CUDA SSD decode step on CUDA tensors: x (B,H,P), dt (B,H),
    b and c (B,N) in one dtype (float32 or bfloat16), a and d (H,) (cast to
    float32 here), state (B,H,P,N) float32.  Returns (y in x's dtype, new
    state float32).  y is a new tensor; the new state is written into
    ``out`` when it is given (a (B,H,P,N) float32 tensor that is ``state``
    itself, for an update in place, or does not overlap it), else into a new
    tensor.  Raises on anything it does not take."""
    if x.dim() != 3 or state.dim() != 4:
        raise ValueError(f"x must be (B, H, P) and state (B, H, P, N), got "
                         f"{tuple(x.shape)} and {tuple(state.shape)}")
    bsz, h, p = x.shape
    n = state.shape[-1]
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"ssd_decode_step_cuda needs CUDA tensors, got {device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x has dtype {x.dtype}, expected one of {tuple(DTYPES)}")
    if min(bsz, h, p, n) < 1:
        raise ValueError(f"empty shape: B={bsz} H={h} P={p} N={n}")
    if n > MAX_N:
        raise ValueError(f"the CUDA kernel takes N <= {MAX_N}, got {n}")
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"tensors are on {device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    a = a.to(torch.float32).contiguous()
    d = d.to(torch.float32).contiguous()
    check_tensor("x", x, x.dtype, (bsz, h, p), device)
    check_tensor("dt", dt, x.dtype, (bsz, h), device)
    check_tensor("a", a, torch.float32, (h,), device)
    check_tensor("b", b, x.dtype, (bsz, n), device)
    check_tensor("c", c, x.dtype, (bsz, n), device)
    check_tensor("d", d, torch.float32, (h,), device)
    check_tensor("state", state, torch.float32, (bsz, h, p, n), device)

    if out is not None:
        check_tensor("out", out, torch.float32, (bsz, h, p, n), device)
        nbytes = state.numel() * 4
        if out.data_ptr() != state.data_ptr() and abs(out.data_ptr() - state.data_ptr()) < nbytes:
            raise ValueError("out must be the state itself or not overlap it")

    lib = build()
    y = torch.empty((bsz, h, p), dtype=x.dtype, device=device)
    new_state = out if out is not None else torch.empty(
        (bsz, h, p, n), dtype=torch.float32, device=device)
    vec4 = n % 4 == 0 and state.data_ptr() % 16 == 0 and new_state.data_ptr() % 16 == 0
    err = lib.ssd_step_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        d.data_ptr(), state.data_ptr(), y.data_ptr(), new_state.data_ptr(),
        bsz, h, p, n, DTYPES[x.dtype], int(vec4), rows_per_cta(n, p),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_step launch failed: cudaError {err}")
    ssd_decode_step_cuda.launches += 1
    return y, new_state


#: Launches of the kernel in this process (reset by setting it to 0).
ssd_decode_step_cuda.launches = 0


def empty_launch(bsz: int, h: int, p: int, n: int, device) -> None:
    """Launch an empty kernel on the main path's grid for this shape (the
    same CTAs, threads and shared memory) on the current stream; raises if
    the launch fails.  Not counted in ``ssd_decode_step_cuda.launches``."""
    err = build().ssd_step_empty_launch(
        bsz, h, p, n, rows_per_cta(n, p), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {err}")
