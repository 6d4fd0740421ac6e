"""The port's kernel builder (``repro_torch.kernels.nvcc.NvccLibrary``) on
the CPU, with a stand-in ``nvcc`` under ``$CUDA_HOME/bin``: a shell
script that copies one of torch's own shared libraries to its ``-o`` path
and prints a ptxas-like line, so the build, the cache by source hash and
the compiler log kept beside the library are exercised without a CUDA
toolkit."""

import stat
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.nvcc import NvccLibrary

#: a shared library that every torch install has, standing in for a kernel's
LIB = Path(torch.__file__).parent / "lib" / "libc10.so"


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    script = tmp_path / "cuda" / "bin" / "nvcc"
    script.parent.mkdir(parents=True)
    script.write_text(
        "#!/bin/sh\n"
        f"echo x >> {calls}\n"
        'while [ "$#" -gt 0 ]; do if [ "$1" = "-o" ]; then out="$2"; fi; shift; done\n'
        f'cp {LIB} "$out"\n'
        "echo \"ptxas info    : Used 42 registers\"\n"
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    return calls


def _n_builds(calls: Path) -> int:
    return len(calls.read_text().split()) if calls.exists() else 0


def test_log_is_kept_beside_the_library(tmp_path, fake_nvcc):
    src = tmp_path / "kern" / "csrc" / "k.cu"
    src.parent.mkdir(parents=True)
    src.write_text("// v1\n")
    first = NvccLibrary(src, "k", lambda lib: None)
    first.load()
    assert _n_builds(fake_nvcc) == 1
    assert "Used 42 registers" in first.info()["log"]
    built = sorted(p.name for p in (tmp_path / "kern" / "build").iterdir())
    assert len(built) == 2 and built[0].endswith(".log") and built[1].endswith(".so")
    assert not any(".tmp" in n or "logtmp" in n for n in built)

    again = NvccLibrary(src, "k", lambda lib: None)  # a later process: no rebuild
    again.load()
    assert _n_builds(fake_nvcc) == 1
    assert again.info()["log"] == first.info()["log"]


def test_edited_source_is_rebuilt(tmp_path, fake_nvcc):
    src = tmp_path / "kern" / "csrc" / "k.cu"
    src.parent.mkdir(parents=True)
    src.write_text("// v1\n")
    NvccLibrary(src, "k", lambda lib: None).load()
    src.write_text("// v2\n")
    NvccLibrary(src, "k", lambda lib: None).load()
    assert _n_builds(fake_nvcc) == 2
    assert len(list((tmp_path / "kern" / "build").glob("*.so"))) == 2
