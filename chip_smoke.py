"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases (any failed check raises, so the exit code is non-zero):

1. the card (``nvidia-smi`` name and power limit, torch and CUDA versions);
2. the build of the CUDA fluid step kernel from ``src/repro_torch/kernels/
   fluidstep/csrc`` (``nvcc``, sm_90a), with its build time;
3. the kernel against its plain PyTorch version on the card at J in
   {8, 40, 160, 256}, S = 16, D in {16, 20}, lanes in {1, 8}, with and
   without the overlap matrix: int and bool planes exact, float32 planes
   bit-equal (max ulp difference printed); then both timed with CUDA events
   at the main path's shapes;
4. the main path, with the kernel's launch count reset just before it:
   the paper's 64-GPU cluster (16 x 4) and 160 jobs, 8 seeds per batch,
   iterations cut from 1000-6000 to 100-600, under ada (through
   ``simulate_traces_batched``), srsf1 and srsf2 (through
   ``monte_carlo_fluid``); and ``oversub_fabric`` (QUICK size, two-tier
   fabric, rack_pack placement, 8 seeds).  Every job must finish, and the
   kernel must have launched exactly once per executed tick;
5. the ada batch once more with the plain step core on the card: finished
   mask and every finish tick identical to the kernel run (the four paper
   batches run side by side in worker processes, since the simulator is
   bound by the host's per-operation cost);
6. small inputs on the card against the same runs on the CPU (identical
   finish ticks); the CPU path is the one the tests hold to the JAX
   reference;
7. the host cost: one chunk of the ada batch alone on the card, timed with
   the kernel and with the plain step core, and its device time from the
   profiler.

Then the kernels line (JSON) and, last, ``{"ok": true, "device": ...}``.
Exits non-zero without printing a result when CUDA is unavailable.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

#: H100 SXM published rates (NVIDIA data sheet): HBM bytes/s and float32
#: operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

PAPER_CUT = dict(min_iters=100, max_iters=600)  # published: 1000-6000
SEEDS = range(8)
REFERENCE_CPU_CHUNKS_ADA = 150  # the JAX reference on the CPU, same batch
SRC = Path(__file__).resolve().parent / "src"


def _log(*args) -> None:
    print(*args, flush=True)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _rand_inputs(rng, lanes, n_jobs, n_servers, n_domains):
    return {
        "loads": rng.random((lanes, n_jobs, n_domains)) < 0.35,
        "member": (rng.random((lanes, n_jobs, n_servers)) < 0.4).astype(np.float32),
        "active": rng.random((lanes, n_jobs)) < 0.5,
        "rem": rng.uniform(0.05, 80.0, (lanes, n_jobs)).astype(np.float32),
        "bw": rng.uniform(0.4, 2.5, n_servers).astype(np.float32),
        "oversub": rng.uniform(1.0, 4.0, n_domains).astype(np.float32),
    }


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    fin = np.isfinite(a) & np.isfinite(b)
    ia = a[fin].view(np.int32).astype(np.int64)
    ib = b[fin].view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max(initial=0))


def _summary(tag, res, chunk_steps):
    """Print one batch's line; every job must finish with a positive JCT."""
    recs = res["recs"]
    avg = np.array([r["avg_jct"] for r in recs])
    fin = sum(r["n_finished"] for r in recs) / sum(r["n_jobs"] for r in recs)
    ticks = res["chunks"] * chunk_steps
    _log(f"{tag}: avg JCT {avg.mean():.4f} +- {avg.std():.4f} s over {len(recs)} seeds, "
         f"finished {fin:.4f}, chunks {res['chunks']}, executed ticks {ticks}, "
         f"kernel launches {res['launches']}, wall {res['wall']:.3f} s, "
         f"{res['wall'] / ticks * 1e3:.4f} ms per tick")
    _require(all(r["n_finished"] == r["n_jobs"] for r in recs), f"{tag}: unfinished jobs")
    _require(all(np.isfinite(r["avg_jct"]) and r["avg_jct"] > 0 for r in recs), tag)
    return ticks


def _paper_batch(comm: str, impl: str, entry: str) -> dict:
    """One 8-seed paper batch in a worker process (spawned, so it imports
    the port afresh and starts with a launch count of 0)."""
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(SRC))
    from repro_torch.core import fluidsim
    from repro_torch.kernels.fluidstep import kernel as fs_kernel
    from repro_torch.scenarios import fluid_config, get_scenario, monte_carlo_fluid
    from repro_torch.scenarios.metrics import from_jcts

    out = {}
    fs_kernel.fluid_step_core_cuda.launches = 0
    t0 = time.perf_counter()
    if entry == "simulate_traces_batched":
        paper = [get_scenario("paper", seed=s, **PAPER_CUT) for s in SEEDS]
        _require(paper[0].total_gpus == 64 and paper[0].n_jobs == 160,
                 "paper cluster and job count")
        cfg = fluid_config(paper[0], comm=comm, placement="lwf", kernel=impl)
        batch = fluidsim.stack_traces(
            [fluidsim.trace_from_jobs(s.job_list(), device=cfg.device) for s in paper]
        )
        res = fluidsim.simulate_traces_batched(batch, cfg)
        recs = [
            from_jcts(res["jct"][i][res["finished"][i]].tolist(), scenario="paper",
                      backend="fluid", placement="gang-consolidate", comm=comm, seed=s,
                      n_jobs=scn.n_jobs, makespan=float(res["makespan"][i]))
            for i, (s, scn) in enumerate(zip(SEEDS, paper))
        ]
        out.update(jct=res["jct"], finished=res["finished"], chunks=res["chunks"])
    else:
        recs = monte_carlo_fluid("paper", SEEDS, comm=comm, placement="lwf",
                                 overrides=PAPER_CUT, kernel=impl)
        out["chunks"] = recs[0].chunks
    torch.cuda.synchronize()
    out.update(recs=[dataclasses.asdict(r) for r in recs], wall=time.perf_counter() - t0,
               launches=fs_kernel.fluid_step_core_cuda.launches)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    from repro_torch.core import fluidsim
    from repro_torch.kernels.fluidstep import fluid_step_core
    from repro_torch.kernels.fluidstep import kernel as fs_kernel
    from repro_torch.scenarios import (
        QUICK_OVERRIDES, fluid_config, get_scenario, monte_carlo_fluid,
        run_scenario_fluid,
    )

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    launches = fs_kernel.fluid_step_core_cuda

    # ---- 1. the card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _log(smi)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
         f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---- 2. build -----------------------------------------------------------
    fs_kernel.build()
    info = fs_kernel.build_info()
    _log(f"build: fluid_step.cu in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            _log("  ptxas:", line.strip())

    # ---- 3. kernel vs plain version -----------------------------------------
    names = ("loads", "member", "active", "rem", "bw", "oversub")
    rng = np.random.default_rng(0)
    max_ulp, max_abs = 0, 0.0
    n_cases = 0
    for n_jobs in (8, 40, 160, 256):
        for n_domains in (16, 20):
            for lanes in (1, 8):
                for need_overlap in (False, True):
                    x = _rand_inputs(rng, lanes, n_jobs, 16, n_domains)
                    args = [torch.as_tensor(x[k], device=dev) for k in names]
                    kw = dict(b=8.53e-10, eta=1.706e-10, need_overlap=need_overlap)
                    got = fluid_step_core(*args, impl="cuda", **kw)
                    want = fluid_step_core(*args, impl="ref", **kw)
                    torch.cuda.synchronize()
                    for k, v in want.items():
                        g = got[k]
                        if v is None:
                            _require(g is None, k)
                            continue
                        g, v = g.cpu().numpy(), v.cpu().numpy()
                        _require(g.dtype == v.dtype and g.shape == v.shape, k)
                        if v.dtype == np.float32:
                            _require((np.isinf(g) == np.isinf(v)).all(), f"inf pattern of {k}")
                            max_ulp = max(max_ulp, _ulps(g, v))
                            fin = np.isfinite(v)
                            max_abs = max(max_abs, float(np.abs(g[fin] - v[fin]).max(initial=0)))
                        else:
                            _require((g == v).all(), f"{k} differs at J={n_jobs} D={n_domains}")
                    n_cases += 1
    _log(f"parity: {n_cases} cases, int/bool planes exact, inf pattern exact, "
         f"float32 max ulp {max_ulp}, max abs err {max_abs}")
    _require(max_ulp == 0, "float32 planes must be bit-equal to the plain version")

    # timing at the main path's shapes: 8 lanes, J=160, S=16, D=16
    L, J, S, D = 8, 160, 16, 16
    x = _rand_inputs(rng, L, J, S, D)
    args = [torch.as_tensor(x[k], device=dev) for k in names]
    kw = dict(b=8.53e-10, eta=1.706e-10, need_overlap=False)

    def _time(impl, graph: bool, reps=40, calls=50):
        """ms per call: in a CUDA graph (device time, no host launch
        overhead) or eagerly (what a tick of the simulator pays)."""
        def run():
            for _ in range(calls):
                fluid_step_core(*args, impl=impl, **kw)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        if graph:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                run()
            g.replay()
            run = g.replay
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            run()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / (reps * calls)

    timings = {}
    for rnd in (1, 2):  # plain, kernel, kernel, plain
        for impl in (("ref", "cuda") if rnd == 1 else ("cuda", "ref")):
            for graph in (True, False):
                timings.setdefault((impl, graph), []).append(_time(impl, graph))
    kernel_ms = min(timings[("cuda", True)])
    plain_ms = min(timings[("ref", True)])
    bytes_moved = (L * J * D + L * J * S * 4 + L * J + L * J * 4 + S * 4 + D * 4
                   + L * D * 4 + 4 * L * J * 4)
    ops = L * (5 * J * D + J * S + 5 * J + D)
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    _log(f"timing (L={L} J={J} S={S} D={D}, ms per call, plain/kernel/kernel/plain): "
         f"device time in a CUDA graph: kernel {timings[('cuda', True)]}, "
         f"plain {timings[('ref', True)]}; eager (host launch included): "
         f"kernel {timings[('cuda', False)]}, plain {timings[('ref', False)]}; "
         f"bound {bound_ms:.8f} ms ({bound_by}: {bytes_moved} B, {ops} ops); "
         f"no single PyTorch call computes this function")

    # ---- 4./5. the main path, and the ada batch with the plain step core ---
    # The simulator is bound by the host's per-operation launch cost, so the
    # four paper batches run side by side in worker processes on the one
    # card; each worker starts with a launch count of 0 and reports its
    # count just after its run.  The parent meanwhile runs the second
    # fabric (its count reset just before) and the small card-vs-CPU runs.
    jobs = [("ada", "", "simulate_traces_batched"), ("srsf1", "", "monte_carlo_fluid"),
            ("srsf2", "", "monte_carlo_fluid"), ("ada", "ref", "simulate_traces_batched")]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=len(jobs),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(_paper_batch, *job) for job in jobs]

        launches.launches = 0
        t1 = time.perf_counter()
        recs = monte_carlo_fluid("oversub_fabric", SEEDS, comm="ada", placement="rack_pack",
                                 overrides=QUICK_OVERRIDES["oversub_fabric"])
        torch.cuda.synchronize()
        over = {"recs": [dataclasses.asdict(r) for r in recs], "chunks": recs[0].chunks,
                "wall": time.perf_counter() - t1, "launches": launches.launches}

        # ---- 6. small inputs: card vs CPU -----------------------------------
        for name, comm, placement in (("smoke", "ada", "lwf"),
                                      ("contended_residue", "srsf2", "ls"),
                                      ("oversub_fabric", "srsf1", "rack_pack")):
            scn = get_scenario(name, seed=1, **QUICK_OVERRIDES[name])
            on_card = run_scenario_fluid(scn, comm=comm, placement=placement)
            on_cpu = run_scenario_fluid(scn, comm=comm, placement=placement, device="cpu")
            _require((on_card["finished"] == on_cpu["finished"]).all(), name)
            _require((on_card["jct"] == on_cpu["jct"]).all(), name)
            _log(f"{name} {comm} {placement}: card == CPU on every finish tick "
                 f"({int(on_card['finished'].sum())} jobs)")
        results = [f.result() for f in futures]
    _log(f"main path: 4 paper batches side by side + oversub_fabric, wall "
         f"{time.perf_counter() - t0:.3f} s")

    chunk_steps = fluidsim.FluidSimConfig().chunk_steps
    main_launches, executed = 0, 0
    for (comm, impl, entry), res in zip(jobs, results):
        tag = f"paper {comm} ({entry}{', plain step core' if impl else ''})"
        ticks = _summary(tag, res, chunk_steps)
        if impl:
            _require(res["launches"] == 0, f"{tag}: the plain run launched the kernel")
        else:
            main_launches += res["launches"]
            executed += ticks
    executed += _summary("oversub_fabric ada rack_pack (monte_carlo_fluid, D=20)", over,
                         chunk_steps)
    main_launches += over["launches"]
    ada, ada_ref = results[0], results[3]
    _log(f"paper ada: port chunks {ada['chunks']}, JAX reference on the CPU "
         f"{REFERENCE_CPU_CHUNKS_ADA}")
    _log(f"main path: fluid_step_core launches {main_launches}, executed ticks {executed}")
    _require(main_launches > 0 and main_launches == executed, "one launch per executed tick")
    _require((ada_ref["finished"] == ada["finished"]).all(), "finished mask differs")
    _require((ada_ref["jct"] == ada["jct"]).all(), "finish ticks differ")
    _require(ada_ref["chunks"] == ada["chunks"], "chunk counts differ")
    _log("paper ada, kernel vs plain step core on the card: identical finished mask "
         "and finish ticks")

    # ---- host cost: one chunk of the ada batch, alone on the card ----------
    paper = [get_scenario("paper", seed=s, **PAPER_CUT) for s in SEEDS]
    cfg = fluid_config(paper[0], comm="ada", placement="lwf")
    batch = fluidsim.stack_traces(
        [fluidsim.trace_from_jobs(s.job_list(), device=dev) for s in paper]
    )
    statics = fluidsim._Statics(cfg, dev)
    state = fluidsim._init_lane_state(batch, cfg, statics.n_domains)
    state = fluidsim._lane_chunk(batch, state, cfg, statics)  # warm, past the start
    per_tick = {}
    for impl in ("ref", "", "", "ref"):
        c = dataclasses.replace(cfg, kernel=impl)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fluidsim._lane_chunk(batch, state, c, statics)
        torch.cuda.synchronize()
        per_tick.setdefault(impl or "cuda", []).append(
            (time.perf_counter() - t1) / cfg.chunk_steps * 1e3)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fluidsim._lane_chunk(batch, state, cfg, statics)
        torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms_tick = sum(e.self_device_time_total for e in on_device) / 1e3 / cfg.chunk_steps
    device_ops_tick = sum(e.count for e in on_device) / cfg.chunk_steps
    wall_ms_tick = min(per_tick["cuda"])
    _log(f"host cost (paper ada batch, 8 lanes x 160 jobs, one chunk of "
         f"{cfg.chunk_steps} ticks, alone on the card): wall per tick with the kernel "
         f"{per_tick['cuda']} ms, with the plain step core {per_tick['ref']} ms; "
         f"device time per tick (profiler) {device_ms_tick:.4f} ms in "
         f"{device_ops_tick:.2f} kernels and copies; device idle share "
         f"{1 - device_ms_tick / wall_ms_tick:.4f}")

    line = {"kernels": [{
        "name": "fluid_step_core",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fluidstep/csrc/fluid_step.cu",
        "replaces": "src/repro/kernels/fluidstep/kernel.py:35",
        "launches": main_launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    _log(f"total {time.perf_counter() - t_start:.1f} s")
    _log(smi)
    _log(json.dumps(line))
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
