"""The fluid step kernel from two sources, in turns, in one process on one
NVIDIA GPU; and, on request, where the repository's kernel spends its
cycles.

Run from the repository root::

    python3 scripts/fluid_step_ab.py --baseline OTHER/csrc/fluid_step.cu [--probe]

``--baseline`` is another version of ``fluid_step.cu`` with the same C
interface (for example the parent commit's, unpacked with ``git archive``
into a git-ignored directory).  Both sources are built with ``nvcc``
(sm_90a, ``--fmad=false``), then the port's wrapper is pointed at each in
the order baseline, current, current, baseline, and each turn measures:

- the kernel at the fluid main path's shape (8 lanes x J 160 x S 16 x
  D 16, random inputs from seed 0): bit-equality with the plain version,
  and device ms per call in a CUDA graph of 50 calls;
- one chunk of the paper ada batch (8 seeds x 160 jobs, 256 ticks) as the
  simulator runs it, replayed from its CUDA graph: wall ms per tick, the
  fastest of three chunks from the same state.

``--probe`` also builds a copy of the repository's source with a
``clock64()`` stamp by thread 0 of each CTA after each of its phase
barriers (the ``// ---- N.`` markers) and prints the median SM cycles of
each phase over the CTAs.

Prints one line per turn, the card's name and power limit, and last a
JSON object of all turns.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SHAPE = (8, 160, 16, 16)  # lanes, jobs, servers, domains
PAPER_CUT = dict(min_iters=100, max_iters=600)
PROBE_PHASES = ("0: loads issued, accumulators zeroed", "1: masks and slowest member",
                "2: per-domain counts and minima", "3: per-job outputs")


def probed_source(src: str) -> str:
    """``src`` with a ``clock64()`` stamp by thread 0 of each CTA at the
    start and after each phase (before the ``// ---- N.`` markers of
    phases 1-3, and after a barrier at the end of phase 3), and a C
    function that copies the stamps out."""
    stamp = "  if (threadIdx.x == 0) g_fluid_probe[blockIdx.x][{}] = clock64();\n"
    marks = [("  const float inf = __int_as_float(0x7f800000);\n", True),
             ("  // ---- 1. ", False), ("  // ---- 2. ", False), ("  // ---- 3. ", False),
             ("  if (overlap != nullptr) {\n    write_bytes(", False)]
    out = src.replace("namespace {\n", "__device__ long long g_fluid_probe[64][8];\nnamespace {\n", 1)
    for i, (mark, after) in enumerate(marks):
        if out.count(mark) != 1:
            raise RuntimeError(f"fluid_step.cu has no single marker {mark!r} to probe")
        add = ("  __syncthreads();\n" if i == len(marks) - 1 else "") + stamp.format(i)
        out = out.replace(mark, mark + add if after else add + mark)
    return out + ('\nextern "C" int fluid_probe_read(void* out) {\n'
                  '  return (int)cudaMemcpyFromSymbol(out, g_fluid_probe, sizeof(g_fluid_probe));\n}\n')


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="another fluid_step.cu with the same C interface")
    ap.add_argument("--probe", action="store_true",
                    help="also print the cycles of each phase of the repository's kernel")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fluid_step_ab: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    torch.set_num_threads(1)
    from chip_smoke import _cuda_ms, _rand_inputs

    from repro_torch.core import fluidsim
    from repro_torch.kernels.fluidstep import fluid_step_core
    from repro_torch.kernels.fluidstep import kernel as fk
    from repro_torch.kernels.nvcc import NvccLibrary
    from repro_torch.scenarios import fluid_config, get_scenario

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    def bind_baseline(lib):
        try:
            fk._bind(lib)  # binds the launch first
        except AttributeError:  # an older source: no job limit, no empty kernel
            lib.fluid_step_core_max_jobs = lambda: 1 << 30

    flags = ("--fmad=false",)
    libs = {"baseline": NvccLibrary(args.baseline.resolve(), "fluidstep_baseline", bind_baseline,
                                    extra_flags=flags),
            "current": fk._LIB}
    if args.probe:
        def bind_probe(lib):
            fk._bind(lib)
            lib.fluid_probe_read.argtypes = [ctypes.c_void_p]
            lib.fluid_probe_read.restype = ctypes.c_int

        probe_src = fk._LIB.src.parent.parent / "build" / "probe" / "csrc" / "fluid_step.cu"
        probe_src.parent.mkdir(parents=True, exist_ok=True)
        probe_src.write_text(probed_source(fk._LIB.src.read_text()))
        libs["probe"] = NvccLibrary(probe_src, "fluidstep_probe", bind_probe, extra_flags=flags)
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib.load) for lib in libs.values()]:
            f.result()

    dev = torch.device("cuda")
    lanes, jobs, servers, domains = SHAPE
    x = _rand_inputs(np.random.default_rng(0), lanes, jobs, servers, domains)
    inputs = [torch.as_tensor(x[k], device=dev)
              for k in ("loads", "member", "active", "rem", "bw", "oversub")]
    kw = dict(b=8.53e-10, eta=1.706e-10)
    want = fluid_step_core(*inputs, impl="ref", **kw)

    paper = [get_scenario("paper", seed=s, **PAPER_CUT) for s in range(8)]
    cfg = fluid_config(paper[0], comm="ada", placement="lwf")
    batch = fluidsim.stack_traces([fluidsim.trace_from_jobs(s.job_list(), device=dev)
                                   for s in paper])
    statics = fluidsim._Statics(cfg, dev)
    state0 = fluidsim._lane_chunk(batch, fluidsim._init_lane_state(batch, cfg, statics.n_domains),
                                  cfg, statics)

    turns = []
    for name in ("baseline", "current", "current", "baseline"):
        fk._LIB = libs[name]
        got = fluid_step_core(*inputs, impl="cuda", **kw)
        equal = all(torch.equal(got[k], v) for k, v in want.items() if v is not None)
        kernel_ms = _cuda_ms(torch, lambda: [fluid_step_core(*inputs, impl="cuda", **kw)
                                             for _ in range(50)], True, 40) / 50
        runner = fluidsim._ChunkRunner(batch, {n: v.clone() for n, v in state0.items()},
                                       cfg, statics, graph=True)
        walls = []
        for _ in range(4):  # the first captures the graph
            for n, v in runner.state.items():
                v.copy_(state0[n])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.run_chunk()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / cfg.chunk_steps * 1e3)
        runner.release()
        turn = {"build": name, "bit_equal": equal, "kernel_ms": kernel_ms,
                "tick_wall_ms": walls[1:]}
        turns.append(turn)
        print(f"{name}: bit-equal to the plain version {equal}; kernel {kernel_ms:.6f} ms "
              f"(CUDA graph of 50 calls); paper ada chunk in its CUDA graph, wall per tick "
              f"{[round(w, 6) for w in walls[1:]]} ms", flush=True)
        if not equal:
            raise RuntimeError(f"the {name} kernel is not bit-equal to the plain version")

    if args.probe:
        fk._LIB = libs["probe"]
        for _ in range(3):
            fluid_step_core(*inputs, impl="cuda", **kw)
            torch.cuda.synchronize()
        stamps = np.zeros((64, 8), np.int64)
        if libs["probe"].lib.fluid_probe_read(stamps.ctypes.data) != 0:
            raise RuntimeError("reading the probe's stamps failed")
        cycles = np.diff(stamps[:lanes, :len(PROBE_PHASES) + 1], axis=1)
        med = [int(np.median(c)) for c in cycles.T]
        print("probe, SM cycles per phase (median over the CTAs; thread 0's clock, each "
              "phase ending at a barrier): "
              + "; ".join(f"{p} {c}" for p, c in zip(PROBE_PHASES, med))
              + f"; total {sum(med)}", flush=True)
        turns.append({"build": "probe", "phase_cycles": dict(zip(PROBE_PHASES, med))})
    print(smi)
    print(json.dumps({"card": smi, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
