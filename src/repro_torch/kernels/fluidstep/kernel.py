"""Build, binding and launch of the CUDA fluid step core
(``csrc/fluid_step.cu``; replaces the Pallas kernel
``repro/kernels/fluidstep/kernel.py::_fluid_step_kernel``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use, from the package's own sources, into
the ``build/`` directory beside this module, and loaded with ``ctypes``.
Nothing is compiled or imported at module import time, so the CPU-only
tests can import this module.

:func:`fluid_step_core_cuda` launches the kernel on PyTorch's current
stream, one CTA per lane, and counts its launches in
``fluid_step_core_cuda.launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

_SRC = Path(__file__).resolve().parent / "csrc" / "fluid_step.cu"
_BUILD_DIR = Path(__file__).resolve().parent / "build"
#: The kernel stages each job's domain-load row as one 64-bit mask.
MAX_DOMAINS = 64
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


class _Build:
    """The loaded library and how it was built (one per process)."""

    lib: Optional[ctypes.CDLL] = None
    log: str = ""
    seconds: float = 0.0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
            "fluid step kernel is built from csrc/ at first use"
        )
    return found


def build() -> ctypes.CDLL:
    """Compile ``csrc/fluid_step.cu`` (once per source version) and load
    it.  The library's name carries the source hash, so an edited source
    is rebuilt; the output is written to a temporary name and renamed, so
    concurrent builders never load a half-written file."""
    if _Build.lib is not None:
        return _Build.lib
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libfluidstep-{tag}.so"
    t0 = time.perf_counter()
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
            capture_output=True, text=True,
        )
        _Build.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{_Build.log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    fn = lib.fluid_step_core_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    _Build.seconds = time.perf_counter() - t0
    _Build.lib = lib
    return lib


def build_info() -> dict:
    """Seconds the last :func:`build` took and the compiler's output
    (``-Xptxas -v`` register and shared-memory use; empty when the library
    was already built)."""
    return {"seconds": _Build.seconds, "log": _Build.log}


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
    _check("loads", loads, torch.bool, (n_lanes, n_jobs, n_domains), device)
    _check("member", member, torch.float32, (n_lanes, n_jobs, n_servers), device)
    _check("active", active, torch.bool, (n_lanes, n_jobs), device)
    _check("rem", rem, torch.float32, (n_lanes, n_jobs), device)
    _check("bw", bw, torch.float32, (n_servers,), device)
    _check("oversub", oversub, torch.float32, (n_domains,), device)

    lib = build()
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
