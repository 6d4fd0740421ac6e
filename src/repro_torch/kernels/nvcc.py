"""Build and load of the port's CUDA C++ kernels with ``nvcc``.

Every kernel of the port is one ``.cu`` source with a plain C interface,
compiled for ``sm_90a`` into a shared library at first use, from the
package's own source, into the ``build/`` directory beside its module, and
loaded with ``ctypes``.  Nothing is compiled at import time, so the
CPU-only tests can import every module.

The library's name carries a hash of the source and the flags, so an
edited source is rebuilt; the output is written to a temporary name and
renamed, so concurrent builds never load a half-written file.  The
compiler's output is kept beside the library (``.log``), so a process that
finds the library already built still reads its registers and spills.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

#: Target and options shared by every kernel; ``-Xptxas -v`` puts each
#: kernel's registers, shared memory and spills in the build log.
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the port's "
            "CUDA kernels are built from their csrc/ sources at first use"
        )
    return found


class NvccLibrary:
    """One kernel source, built once per process and source version.

    ``bind`` declares the ``argtypes``/``restype`` of the library's C
    functions.  After :meth:`load`, ``seconds`` is how long the build (or,
    when the library was already built, the load) took and ``log`` is the
    compiler's output for this library, read back from the build
    directory when it was built before."""

    def __init__(self, src: Path, name: str, bind: Callable[[ctypes.CDLL], None],
                 extra_flags: Sequence[str] = ()):
        self.src = Path(src)
        self.name = name
        self.bind = bind
        self.flags = BASE_FLAGS + tuple(extra_flags)
        self.lib: Optional[ctypes.CDLL] = None
        self.log = ""
        self.seconds = 0.0

    def load(self) -> ctypes.CDLL:
        if self.lib is not None:
            return self.lib
        src = self.src.read_bytes()
        tag = hashlib.sha256(src + " ".join(self.flags).encode()).hexdigest()[:16]
        build_dir = self.src.parent.parent / "build"
        out = build_dir / f"lib{self.name}-{tag}.so"
        log = out.with_suffix(".log")
        t0 = time.perf_counter()
        if not out.exists():
            build_dir.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc_path(), *self.flags, "-o", str(tmp), str(self.src)],
                capture_output=True, text=True,
            )
            self.log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {self.src.name} ({proc.returncode}):\n{self.log}"
                )
            tmp_log = log.with_suffix(f".{os.getpid()}.logtmp")
            tmp_log.write_text(self.log)
            os.replace(tmp_log, log)
            os.replace(tmp, out)
        else:
            self.log = log.read_text() if log.exists() else ""
        lib = ctypes.CDLL(str(out))
        self.bind(lib)
        self.seconds = time.perf_counter() - t0
        self.lib = lib
        return lib

    def info(self) -> dict:
        return {"seconds": self.seconds, "log": self.log}


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous tensor of this
    device, dtype and shape (what a kernel's raw pointer assumes)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
