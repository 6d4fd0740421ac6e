"""Build, binding and launch of the CUDA fluid step core
(``csrc/fluid_step.cu``; replaces the Pallas kernel
``repro/kernels/fluidstep/kernel.py::_fluid_step_kernel``).

The source is compiled with ``nvcc`` for ``sm_90a`` at first use and
loaded with ``ctypes`` (:mod:`repro_torch.kernels.nvcc`), into the
``build/`` directory beside this module.

:func:`fluid_step_core_cuda` launches the kernel on PyTorch's current
stream, one CTA of 512 threads per lane, and counts its launches in
``fluid_step_core_cuda.launches``.  :func:`empty_launch` launches an empty
kernel on the same grid: its time in a CUDA graph is the card's launch
floor, what no kernel of a tick can go below.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.nvcc import NvccLibrary, check_tensor

#: The kernel stages each job's domain-load row as one 64-bit mask.
MAX_DOMAINS = 64


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.fluid_step_core_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.fluid_step_empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.fluid_step_empty_launch.restype = ctypes.c_int
    lib.fluid_step_core_max_jobs.argtypes = []
    lib.fluid_step_core_max_jobs.restype = ctypes.c_int


#: ``--fmad=false``: the kernel keeps the plain version's rounding of every
#: multiply and add (a one-ulp change of a remainder moves a finish tick).
_LIB = NvccLibrary(Path(__file__).resolve().parent / "csrc" / "fluid_step.cu",
                   "fluidstep", _bind, extra_flags=("--fmad=false",))


def build() -> ctypes.CDLL:
    """Compile ``csrc/fluid_step.cu`` (once per source version) and load it."""
    return _LIB.load()


def build_info() -> dict:
    """Seconds the last :func:`build` took and the compiler's output
    (``-Xptxas -v`` register and shared-memory use; empty when the library
    was already built)."""
    return _LIB.info()


def fluid_step_core_cuda(loads, member, active, rem, bw, oversub, *,
                         b: float, eta: float, need_overlap: bool = False):
    """Launch the CUDA fluid step core on CUDA tensors (shapes and outputs
    as :func:`ref.fluid_step_core_ref`); raises on anything it does not
    take.  ``b``/``eta`` are passed as float32, rounded from the Python
    floats as the plain version rounds them."""
    if loads.dim() != 3:
        raise ValueError(f"loads must be (L, J, D), got shape {tuple(loads.shape)}")
    n_lanes, n_jobs, n_domains = loads.shape
    n_servers = bw.shape[0] if bw.dim() == 1 else -1
    device = loads.device
    if device.type != "cuda":
        raise ValueError(f"fluid_step_core_cuda needs CUDA tensors, got {device}")
    if not (1 <= n_domains <= MAX_DOMAINS):
        raise ValueError(f"the CUDA kernel takes 1..{MAX_DOMAINS} domains, got {n_domains}")
    if n_lanes < 1 or n_jobs < 1 or n_servers < 1:
        raise ValueError(f"empty batch: lanes={n_lanes} jobs={n_jobs} servers={n_servers}")
    check_tensor("loads", loads, torch.bool, (n_lanes, n_jobs, n_domains), device)
    check_tensor("member", member, torch.float32, (n_lanes, n_jobs, n_servers), device)
    check_tensor("active", active, torch.bool, (n_lanes, n_jobs), device)
    check_tensor("rem", rem, torch.float32, (n_lanes, n_jobs), device)
    check_tensor("bw", bw, torch.float32, (n_servers,), device)
    check_tensor("oversub", oversub, torch.float32, (n_domains,), device)

    lib = build()
    max_jobs = lib.fluid_step_core_max_jobs()
    if n_jobs > max_jobs:
        raise ValueError(f"the CUDA kernel keeps a lane's jobs in shared memory: at most "
                         f"{max_jobs} jobs, got {n_jobs}")
    # two output buffers, split into contiguous views
    floats = torch.empty((3, n_lanes, n_jobs), dtype=torch.float32, device=device)
    ints = torch.empty(n_lanes * (n_domains + n_jobs), dtype=torch.int32, device=device)
    k_eff, ratio, min_old_rem = floats.unbind(0)
    counts = ints[: n_lanes * n_domains].view(n_lanes, n_domains)
    k_would = ints[n_lanes * n_domains:].view(n_lanes, n_jobs)
    overlap = (
        torch.empty((n_lanes, n_jobs, n_jobs), dtype=torch.bool, device=device)
        if need_overlap else None
    )
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(f"tensors are on {device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    err = lib.fluid_step_core_launch(
        loads.data_ptr(), member.data_ptr(), active.data_ptr(), rem.data_ptr(),
        bw.data_ptr(), oversub.data_ptr(), counts.data_ptr(), k_eff.data_ptr(),
        ratio.data_ptr(), k_would.data_ptr(), min_old_rem.data_ptr(),
        overlap.data_ptr() if overlap is not None else None,
        n_lanes, n_jobs, n_servers, n_domains, b, eta,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fluid_step_core launch failed: cudaError {err}")
    fluid_step_core_cuda.launches += 1
    return {
        "counts": counts,
        "k_eff": k_eff,
        "ratio": ratio,
        "k_would": k_would,
        "min_old_rem": min_old_rem,
        "overlap": overlap,
    }


#: Launches of the kernel in this process (reset by setting it to 0).
fluid_step_core_cuda.launches = 0


def empty_launch(n_lanes: int, device) -> None:
    """Launch the empty kernel on the fluid step's grid (``n_lanes`` CTAs
    of 512 threads) on the current stream; raises if the launch fails.
    Not counted in ``fluid_step_core_cuda.launches``."""
    err = build().fluid_step_empty_launch(
        n_lanes, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {err}")
