"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases (any failed check raises, so the exit code is non-zero):

1. the card (``nvidia-smi`` name and power limit, torch and CUDA versions);
2. the build of the three CUDA kernels from their sources, ``src/repro_torch/
   kernels/{fluidstep,ssd,flash_attention}/csrc`` (one ``nvcc`` each,
   sm_90a, started together), with their build times, and the registers
   and spills of the flash kernel's bf16 D-64 tensor-core instantiation
   (the serve shape's), which must not spill;
3. the fluid step kernel against its plain PyTorch version on the card at
   J in {8, 40, 160, 256}, S = 16, D in {16, 20}, lanes in {1, 8}; at the
   shapes a warp-parallel design gets wrong, J in {1, 31, 33, 1000} x D in
   {1, 63, 64} x S in {1, 16, 40}; and on inputs with a lane without active
   jobs, jobs without members, tied remainders, remainders from 1e-30 to
   1e4 and every domain loaded; each with and without the overlap matrix:
   int and bool planes exact, float32 planes bit-equal (max ulp difference
   printed); then the kernel, its plain version and an empty kernel on the
   same grid (the card's launch floor) timed with CUDA events at the main
   path's shapes, in a CUDA graph and eagerly, beside the bound and the
   kernel's time before its redesign;
4. the main path, with the kernel's launch count reset just before it:
   the paper's 64-GPU cluster (16 x 4) and 160 jobs, 8 seeds per batch,
   iterations cut from 1000-6000 to 100-600, under ada (through
   ``simulate_traces_batched``), srsf1 and srsf2 (through
   ``monte_carlo_fluid``); and ``oversub_fabric`` (QUICK size, two-tier
   fabric, rack_pack placement, 8 seeds).  Each chunk is replayed from a
   CUDA graph, captured once per batch shape (capture and instantiation
   seconds printed).  Every job must finish, and the kernel must have
   launched exactly once per executed tick, counted over graph replays;
5. the ada batch again with the plain step core in the graph (alone on
   the card), and with the kernel run eagerly on the card (in a worker
   process during phase 10): finished mask, every finish tick and chunk
   count identical to the main path's run;
6. small inputs on the card against the same runs on the CPU (identical
   finish ticks); the CPU path is the one the tests hold to the JAX
   reference;
7. the host cost: one chunk of the ada batch alone on the card, through
   the graph and eagerly (and through the graph with the plain step core):
   wall and CUDA-event time per tick, device time per tick from the
   profiler, device idle share; before that, blocks of 8, 16, 32 and 256
   ticks: capture and instantiation seconds against wall per tick;
8. the fluid step kernel with its (L, J, J) overlap plane (the WFBP and
   exact k-way step's call) against its plain version at the new main path's
   shapes, 8 lanes x 48 jobs x 8 servers (model_zoo) and 8 x 160 x 16
   (paper): every plane exact; then timed in a CUDA graph with and without
   the plane, beside its plain version and the launch floor, and its bound
   with the plane counted;
9. the WFBP and exact k-way main path through ``monte_carlo_fluid``, each
   batch alone on the card through the CUDA graph, the launch count set to
   0 just before it: ``model_zoo`` at its registered width (48 jobs on 8 x
   4 GPUs, 64 MB buckets) with iterations cut 10x (6-40) under ada and srsf2,
   ``fusion_sweep`` at its registered size under ada at fusion "all",
   "none" and 32 MB, and kway2 on the paper batch of phase 4 (8 seeds
   each): every job finishes, one launch per executed tick; wall, chunks,
   captures and the bucket-axis width before and after compaction;
10. the model_zoo ada and paper kway2 batches again with the plain step
    core in the graph and with the kernel eagerly (the eager runs, and
    phase 5's, in worker processes): finished mask, every finish tick and
    chunk count identical to phase 9;
11. fusion_sweep (2 seeds, 32 MB) and model_zoo (2 seeds, 12 jobs) under
    ada, srsf2, kway2 and ada with ``gating="rounds"``, on the card and on
    the CPU (worker processes): identical finish ticks; on a difference,
    the first tick and job where the two devices part are printed and the
    phase fails;
12. one model_zoo chunk (8 lanes, 64 MB buckets) alone on the card,
    through the graph and eagerly: wall, CUDA-event and device ms per tick,
    kernels and copies per tick, idle share, beside phase 7's paper tick;
13. the SSD decode-step kernel against its plain PyTorch version on the
    card over ``tests/test_kernels.py``'s (B, H, P, N) sweep, P 24 and 40
    (not multiples of the kernel's 16 rows per CTA) and the serve shapes
    (8 and 64, 24, 64, 128), float32 and bfloat16, at the JAX suite's bars
    (y within 3 x tol_for, state 1e-4), max abs error printed, and in place
    (``out=state``, as the decode step calls it) bit-equal to out of place;
    then the kernel in place and out of place, its plain version and an
    empty kernel on the kernel's grid (the launch floor) timed with CUDA
    events at B 8 and B 64, states rotated so that each call finds its
    state cold in L2, beside the bound and the kernel's time before its
    redesign;
14. the serving main path, with the SSD launch count reset just before it:
    ``repro_torch.launch.serve.serve_batch`` at full-width mamba2-130m,
    batch 8, prompt 512, 64 new tokens, greedy, bf16, each decode step
    replayed from a CUDA graph (prefill and decode tok/s, ms per decode
    step, capture seconds); exactly 24 x 63 = 1,512 launches counted over
    the replays, every token in the vocab, finite logits; then the same
    batch decoded eagerly (``_graph=False``): identical tokens;
15. from copies of one prefill cache (a decode step updates its cache in
    place), decode teacher-forced over those tokens with the kernel and
    with the plain step on the card: every step's logits within the bf16
    bar (0.15), top-1 agreement printed;
16. the reduced config in float32 with the plain path, on the card and on
    the CPU: identical generated tokens;
17. decode steps through the CUDA graph and eagerly, in turns: wall per
    step, then one step under the profiler: device time, the SSD kernel's
    share, device kernels, device idle share, and the graph's capture
    seconds;
18. the flash-attention kernel against its plain PyTorch version on the
    card over ``tests/test_kernels.py::TestFlashAttention``'s shapes (slow
    ones included), causal attention with S != T both ways (also not
    multiples of the 64-row tiles), D 128 and D 30 causal, and the serve
    shape (BH 256 = batch 8 x 32 heads, S = T 512, D 64), float32 at 2e-5
    and bfloat16 at 3e-2 (``tol_for``), the scale override (0.05) and the
    peaked regime (bf16 q x 8, k x 16); max abs error printed;
19. the kernel, its plain version and ``F.scaled_dot_product_attention``
    (the yardstick, never on the path) timed with CUDA events at the serve
    shape in bfloat16, beside the bound: device time from a CUDA graph of
    10 calls (the number kept), and eager calls (host launch included);
20. the dense serving main path, with the flash launch count reset just
    before it: ``serve_batch`` at full-width llama3.2-1b (random weights
    from seed 0, their making timed), batch 8, prompt 512, 64 new tokens,
    greedy, bf16, each decode step replayed from a CUDA graph; exactly 16
    flash launches (one per layer in prefill; decode runs none), every
    token in the vocab, finite logits; then decoded eagerly: identical
    tokens;
21. the kernel against the plain attention inside the model on the card:
    at full width, each layer's attention from the same input (along the
    plain path's residual stream), and end to end on the reduced config in
    bf16 (last-token logits and teacher-forced decode from each path's
    cache), within the bf16 bar (0.15); end to end at full width (bf16 and
    float32 weights) printed but not held, since the random full-width
    model is chaotic, with the kernel path's teacher-forced logits against
    the served ones;
22. llama's reduced config in float32 with the plain path, on the card and
    on the CPU: identical generated tokens;
23. one full-width prefill under the profiler (wall, device time, the
    flash kernel's share, device kernels, device idle share), then decode
    steps through the CUDA graph and eagerly as in phase 17;
24. the threefry (``repro_torch.prng``) on the card against the CPU at odd
    and large shapes: the bits of ``split``, ``fold_in`` (a key and a
    vector of lane ticks), ``random_bits``, ``uniform`` (float32, bf16,
    [1, 1200)), ``randint`` (a range wider than 2**24), ``choice(p=...)``,
    ``categorical`` over (8, 128256) logits in float32 and bf16, and
    ``gumbel`` identical; ``normal``'s max ulp printed (held to 2); then
    the normal draw of llama's embedding table timed on the card;
25. the training main path, with the flash launch count reset just before
    it: ``repro_torch.launch.train.train`` at full-width llama3.2-1b (16
    layers, 1,237,387,264 parameters, bf16 weights from ``PRNGKey(0)``,
    float32 moments, lr 3e-4, batch 8 x seq 512, ``remat="none"``, 8
    steps): exactly 16 x 8 flash launches (the forward's; the backward
    recomputes the plain attention), every loss finite, the mean of the
    last 3 below the first; step ms, tok/s and peak memory printed; then
    mamba2-130m at full width (24 layers) with the same settings;
26. the kernel against the plain attention in training on the card: the
    reduced config in bf16, the loss of one step with the kernel and with
    the plain attention within the bf16 bar (0.15), and every grad leaf
    within 0.15 of its scale or, where larger, within the plain path's own
    distance from the float32 gradient (this random model's bf16 gradient
    is chaotic, ROADMAP R8: each path lies 0.4-1.2 of scale from the
    float32 one), every leaf's numbers printed; at full width, layer by
    layer along the plain path's residual stream, each layer's attention
    output and its input grads from the same input and cotangent;
27. the reduced config in float32 on the plain path, 4 training steps on
    the card and on the CPU: losses to round-off (1e-5); a checkpoint at
    step 2 on the card, the run resumed from it repeats the uninterrupted
    run's losses (deterministic algorithms on for both runs: the
    embedding's backward adds with atomics otherwise);
28. one full-width llama training step under the profiler: device time,
    the flash kernel's share, the backward recompute's share (a named
    range), the AdamW update's share and its kernel count per leaf, device
    idle share;
29. the random placement on the card: the paper batch of phase 4 under
    ``placement="random"`` (8 seeds, ada, through the CUDA graph; every job
    finishes, one step-kernel launch per executed tick, counted from 0
    just before), a small paper batch under ada and srsf2 on the card and
    the CPU (identical finish ticks), and ``monte_carlo_jct(n_seeds=8,
    n_jobs=64)`` on the card and on the CPU (a worker process started
    before phase 13): identical sampled traces and ``per_seed``;
30. sampled serving (``greedy=False``, temperature 0.8) at full width for
    both families (every token in the vocab), and on the reduced float32
    configs on the card (plain path) and the CPU: identical tokens, or the
    step and the logit margin where they part, and the phase fails.

Then the kernels line (JSON; the flash kernel's launches are the serving
and the training main paths', the fluid step's include phase 29's) and,
last, ``{"ok": true, "device": ...}``.
Exits non-zero without printing a result when CUDA is unavailable.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

#: H100 SXM published rates (NVIDIA data sheet): HBM bytes/s, float32
#: operations/s outside the tensor cores, dense bf16 tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

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


#: inputs at the edges of the fluid step's semantics (phase 3)
FLUID_SPECIAL = ("no_active_lane", "zero_member_rows", "tied_rem", "rem_range", "all_loaded")
#: the fluid step kernel before its redesign (a thread per domain walking
#: all jobs), in a CUDA graph on an H100 80GB HBM3 at 700 W (PERF.md)
FLUID_BEFORE_MS = 0.017127


def _special(x, case, rng) -> None:
    """Turn random inputs into one of :data:`FLUID_SPECIAL`, in place."""
    lanes, n_jobs = x["rem"].shape
    if case == "no_active_lane":
        x["active"][1] = False
    elif case == "zero_member_rows":
        x["member"][:, ::2] = 0.0
    elif case == "tied_rem":
        x["rem"] = rng.choice(np.float32([0.5, 2.5, 7.0]), (lanes, n_jobs))
    elif case == "rem_range":
        x["rem"] = (10.0 ** rng.uniform(-30, 4, (lanes, n_jobs))).astype(np.float32)
    elif case == "all_loaded":
        x["loads"][:] = True
        x["active"][:] = True


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    fin = np.isfinite(a) & np.isfinite(b)
    ia = a[fin].view(np.int32).astype(np.int64)
    ib = b[fin].view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max(initial=0))


def _cuda_ms(torch, run, graph: bool, reps: int) -> float:
    """ms per ``run()``, with CUDA events: replayed from a CUDA graph of
    one ``run()`` (device time; the host's launch work is not replayed) or
    called eagerly (host launch included).  Warmed up on a side stream
    first, as graph capture requires."""
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
    return start.elapsed_time(stop) / reps


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


def _paper_batch(comm: str, impl: str, entry: str, placement: str = "lwf") -> dict:
    """One 8-seed paper batch, from a launch count of 0, each chunk
    replayed from a CUDA graph (the main path)."""
    import torch

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
        cfg = fluid_config(paper[0], comm=comm, placement=placement, kernel=impl)
        batch = fluidsim.stack_traces(
            [fluidsim.trace_from_jobs(s.job_list(), device=cfg.device) for s in paper]
        )
        res = fluidsim.simulate_traces_batched(batch, cfg)
        recs = [
            from_jcts(res["jct"][i][res["finished"][i]].tolist(), scenario="paper",
                      backend="fluid", placement=f"gang-{cfg.placement}", comm=comm, seed=s,
                      n_jobs=scn.n_jobs, makespan=float(res["makespan"][i]))
            for i, (s, scn) in enumerate(zip(SEEDS, paper))
        ]
        out.update(jct=res["jct"], finished=res["finished"], chunks=res["chunks"],
                   captures=res["captures"])
    else:
        recs = monte_carlo_fluid("paper", SEEDS, comm=comm, placement=placement,
                                 overrides=PAPER_CUT, kernel=impl)
        out["chunks"] = recs[0].chunks
    torch.cuda.synchronize()
    out.update(recs=[dataclasses.asdict(r) for r in recs], wall=time.perf_counter() - t0,
               launches=fs_kernel.fluid_step_core_cuda.launches)
    return out


# ---------------------------------------------------------------------------
# The SSD decode-step kernel and the serving path (mamba2-130m)
# ---------------------------------------------------------------------------

#: tests/test_kernels.py's (b, h, p, n) sweep, P that is not a multiple of
#: the kernel's 16 rows per CTA at N 128, and the serve shapes (B 8 and 64 at
#: mamba2-130m's H 24, P 64, N 128)
SSD_SWEEP = [(2, 8, 64, 128), (2, 6, 16, 32), (3, 12, 32, 64), (1, 24, 64, 128),
             (2, 4, 24, 128), (3, 5, 40, 128), (8, 24, 64, 128), (64, 24, 64, 128)]
#: the SSD kernel before its redesign (one CTA per (b, h)), in a CUDA graph on
#: an H100 80GB HBM3 at 700 W (PERF.md): ms per call at B 8 and 64
SSD_BEFORE_MS = {8: 0.009024, 64: 0.043024}
SSD_ORDER = ("x", "dt", "a", "b", "c", "d", "state")
#: the main path: full-width mamba2-130m, batch 8, prompt 512, 64 new tokens
SERVE = dict(batch=8, prompt_len=512, gen=64, seed=0)
BF16_BAR = 0.15  # tests/test_models.py::TestDecodeMatchesPrefill, between two paths
#: timing rotates over this many bytes of distinct states, so each call
#: finds its state in device memory and not in the 50 MB L2 (as decode
#: does: 24 layers' states lie between two reads of one)
COLD_BYTES = 200e6


def _ssd_inputs(torch, seed, b, h, p, n, dtype, dev):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    raw = {
        "x": rng.standard_normal((b, h, p)).astype(f32),
        "dt": np.logaddexp(rng.standard_normal((b, h)), 0.0).astype(f32),
        "a": (-np.exp(rng.standard_normal(h) * 0.1)).astype(f32),
        "b": rng.standard_normal((b, n)).astype(f32),
        "c": rng.standard_normal((b, n)).astype(f32),
        "d": rng.uniform(0.5, 1.5, h).astype(f32),
        "state": rng.standard_normal((b, h, p, n)).astype(f32),
    }
    low = ("x", "dt", "b", "c")
    return {k: torch.from_numpy(v).to(device=dev, dtype=dtype if k in low else torch.float32)
            for k, v in raw.items()}


def _ssd_bound(b, h, p, n, elt):
    """(bound ms, "bytes" or "operations", bytes, ops): each input read and
    each output written once; ~5 float32 operations per state element
    (decay multiply, outer-product multiply-add, C multiply-add) plus the
    per-row skip term and one exp per (b, h)."""
    nbytes = 2 * b * h * p * n * 4 + (2 * b * h * p + b * h + 2 * b * n) * elt + 2 * h * 4
    ops = 5 * b * h * p * n + 3 * b * h * p + 2 * b * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def _ssd_kernel_phase(torch, dev) -> dict:
    """Phase 13: the kernel against its plain version over the sweep
    (f32 and bf16), out of place and in place, then both timed at B 8 and
    B 64 beside the launch floor.  Returns the kernels line's entry
    (launches are filled in by the serving phase)."""
    from repro_torch.kernels.ssd import ssd_decode_step
    from repro_torch.kernels.ssd.kernel import empty_launch

    # ---- 13. kernel vs plain version -----------------------------------------
    max_abs = 0.0
    for b, h, p, n in SSD_SWEEP:
        for name, dtype, tol in (("float32", torch.float32, 3 * 2e-5),
                                 ("bfloat16", torch.bfloat16, 3 * 3e-2)):
            t = _ssd_inputs(torch, b * 1000 + n, b, h, p, n, dtype, dev)
            state_in = t["state"].clone()
            y, s = ssd_decode_step(*(t[k] for k in SSD_ORDER))
            y_ref, s_ref = ssd_decode_step(*(t[k] for k in SSD_ORDER), impl="ref")
            torch.cuda.synchronize()
            _require(torch.equal(t["state"], state_in), "the SSD state is updated out of place")
            _require(y.dtype == dtype and s.dtype == torch.float32, "SSD output dtypes")
            # in place, as the decode step calls it: bit-equal to out of place
            st = t["state"].clone()
            y_in, s_in = ssd_decode_step(*(t[k] for k in SSD_ORDER[:-1]), st, out=st)
            torch.cuda.synchronize()
            _require(s_in is st and torch.equal(y_in, y) and torch.equal(s_in, s),
                     f"SSD in place == out of place at {(b, h, p, n)} {name}")
            err_y = float((y.float() - y_ref.float()).abs().max())
            err_s = float((s - s_ref).abs().max())
            # y's error in ulps of the working dtype at |y| + |x*d| (the
            # skip term is added after rounding on one side, before on the other)
            mag = y_ref.float().abs() + (t["x"].float() * t["d"][None, :, None]).abs()
            mant = 7 if dtype == torch.bfloat16 else 23
            ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - mant)
            ulps_y = float(((y.float() - y_ref.float()).abs() / ulp).max())
            ok_y = bool(((y.float() - y_ref.float()).abs() <= tol + tol * y_ref.float().abs()).all())
            ok_s = bool(((s - s_ref).abs() <= 1e-4 + 1e-4 * s_ref.abs()).all())
            _log(f"ssd parity B={b} H={h} P={p} N={n} {name}: max abs err y {err_y} "
                 f"({ulps_y:.3f} {name} ulps), state {err_s}; in place bit-equal")
            _require(ok_y and ok_s, f"SSD kernel vs plain at {(b, h, p, n)} {name}")
            max_abs = max(max_abs, err_y, err_s)

    # ---- 13. timing, states cold in L2 ------------------------------------
    def _time(impl, graph, t, states, reps):
        """ms per call over rotating states: in a CUDA graph (device time)
        or eagerly (what a decode step pays, host launch included).  impl
        "cuda" is the kernel in place (the decode step's call), "cuda
        out of place" the call the kernel's earlier design was timed with
        (its output buffer reused, so the writes stay in L2), "ref" the
        plain version out of place, "empty" the empty kernel on the
        kernel's grid (the launch floor)."""
        others = [t[k] for k in SSD_ORDER[:-1]]
        b, h, p, n = t["state"].shape

        def run():
            for st in states:
                if impl == "empty":
                    empty_launch(b, h, p, n, dev)
                elif impl == "cuda":
                    ssd_decode_step(*others, st, out=st)
                else:
                    ssd_decode_step(*others, st, impl="cuda" if impl != "ref" else "ref")
        return _cuda_ms(torch, run, graph, reps) / len(states)

    entry = {}
    order = ("ref", "cuda", "cuda out of place", "empty", "empty", "cuda out of place", "cuda",
             "ref")
    for b in (8, 64):
        h, p, n = 24, 64, 128
        t = _ssd_inputs(torch, b, b, h, p, n, torch.bfloat16, dev)
        k = max(2, int(np.ceil(COLD_BYTES / (b * h * p * n * 4))))
        states = [t["state"].clone() for _ in range(k)]
        reps = max(4, 640 // k)
        timings = {}
        for impl in order:
            for graph in (True, False):
                timings.setdefault((impl, graph), []).append(_time(impl, graph, t, states, reps))
        del states
        bound_ms, bound_by, nbytes, ops = _ssd_bound(b, h, p, n, 2)
        best = {impl: min(timings[(impl, True)]) for impl in set(order)}
        kernel_ms, plain_ms, floor_ms = best["cuda"], best["ref"], best["empty"]
        _log(f"ssd timing B={b} H={h} P={p} N={n} bf16 ({k} states rotated, ms per call, "
             f"in the order {'/'.join(order)}): device time in a CUDA graph: kernel in place "
             f"{timings[('cuda', True)]}, kernel out of place "
             f"{timings[('cuda out of place', True)]}, plain {timings[('ref', True)]}, empty "
             f"kernel on the kernel's grid (launch floor) {timings[('empty', True)]}; eager "
             f"(host launch included): kernel in place {timings[('cuda', False)]}, out of place "
             f"{timings[('cuda out of place', False)]}, plain {timings[('ref', False)]}, empty "
             f"{timings[('empty', False)]}; bound {bound_ms:.8f} ms ({bound_by}: {nbytes} B, "
             f"{ops} ops), share of bound reached {bound_ms / kernel_ms:.4f} in place, "
             f"{bound_ms / best['cuda out of place']:.4f} out of place; kernel / launch floor "
             f"{kernel_ms / floor_ms:.4f}; the kernel before its redesign "
             f"{SSD_BEFORE_MS[b]} ms ({bound_ms / SSD_BEFORE_MS[b]:.4f} of the bound); no "
             f"single PyTorch call computes this function")
        if b == SERVE["batch"]:
            entry = {
                "name": "ssd_decode_step",
                "route": "cuda",
                "source": "src/repro_torch/kernels/ssd/csrc/ssd_step.cu",
                "replaces": "src/repro/kernels/ssd/kernel.py:24",
                "launches": 0,
                "max_abs_err": max_abs,
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
            }
    return entry


def _clone(tree):
    """A copy of a cache: a decode step updates its cache in place."""
    from repro_torch.models.common import tree_map

    return tree_map(lambda t: t.clone(), tree)


def _serve_both(torch, tag, cfg, params, counter) -> dict:
    """The serving main path through ``serve_batch`` (batch 8, prompt 512,
    64 new tokens): with the decode step replayed from its CUDA graph (the
    main path; ``counter.launches`` reset just before it and read just
    after), then eagerly (``_graph=False``), whose tokens must be
    identical.  Returns the graph run's dict with ``launches`` added."""
    from repro_torch.launch.serve import serve_batch

    bsz, plen, gen, seed = (SERVE[k] for k in ("batch", "prompt_len", "gen", "seed"))
    counter.launches = 0
    res = serve_batch(cfg, bsz, plen, gen, seed, params=params)
    res["launches"] = counter.launches
    torch.cuda.synchronize()
    eager = serve_batch(cfg, bsz, plen, gen, seed, params=params, _graph=False)
    for mode, r in (("CUDA graph", res), ("eager", eager)):
        _log(f"serve {tag} main path, decode {mode} (batch {bsz}, prompt {plen}, gen {gen}, "
             f"greedy, bf16): prefill {r['prefill_s']:.4f} s = {r['prefill_tok_per_s']:.1f} "
             f"tok/s; decode {r['decode_s']:.4f} s = {r['decode_tok_per_s']:.1f} tok/s, "
             f"{r['decode_s'] / (gen - 1) * 1e3:.4f} ms per decode step (graph recording and "
             f"instantiation {r['capture_s']:.4f} s of it)")
    _require(bool((res["generated"] == eager["generated"]).all()),
             f"{tag}: tokens through the decode graph == eager tokens")
    diff = float((res["logits"].float() - eager["logits"].float()).abs().max())
    _log(f"serve {tag}: tokens through the decode graph identical to the eager run; max abs "
         f"logit difference {diff}; decode speed-up {eager['decode_s'] / res['decode_s']:.3f}x")
    _log(f"serve sample tokens: {res['generated'][0][:16].tolist()}")
    return res


def _decode_modes(torch, tag, lm, params, cache0, tok, flags, key, expect_key) -> None:
    """Phases 17 and 23: decode steps through the runner's CUDA graph and
    eagerly, from copies of one prefill cache, each mode's steps greedy
    from ``tok``: wall per step (3 rounds of 10, modes in turns), then one
    step under the profiler: device time, kernels and copies per step, the
    share of the kernels whose name holds ``key`` (there must be some iff
    ``expect_key``), device idle share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import _DecodeRunner
    from repro_torch.launch.steps import make_serve_step

    decode = make_serve_step(lm, flags)
    runners, walls = {}, {}
    with torch.no_grad():
        for mode in ("graph", "eager"):
            runners[mode] = _DecodeRunner(decode, params, _clone(cache0), tok,
                                          graph=mode == "graph")
            runners[mode].step()  # the first step (and, for the graph, its capture)
        for rnd in range(3):
            for mode in (("graph", "eager") if rnd % 2 == 0 else ("eager", "graph")):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for _ in range(10):
                    runners[mode].step()
                torch.cuda.synchronize()
                walls.setdefault(mode, []).append((time.perf_counter() - t1) / 10 * 1e3)
        for mode, r in runners.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                r.step()
                torch.cuda.synchronize()
            on_device = [e for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA]
            device_ms = sum(e.self_device_time_total for e in on_device) / 1e3
            key_ms = sum(e.self_device_time_total for e in on_device if key in e.key) / 1e3
            n_kernels = sum(e.count for e in on_device)
            _require(device_ms > 0, f"the profiler saw the {tag} decode step's device time "
                     f"({mode})")
            _require((key_ms > 0) == expect_key, f"{key} kernel time in the {tag} decode step")
            cap = (f"; capture: eager first step {r.timing['warmup_s']:.4f} s, recording "
                   f"{r.timing['capture_s']:.4f} s, instantiation "
                   f"{r.timing['instantiate_s']:.4f} s" if mode == "graph" else "")
            _log(f"{tag} decode step, {mode} (batch {SERVE['batch']}, full width): wall "
                 f"{walls[mode]} ms; device time {device_ms:.4f} ms in {n_kernels} kernels and "
                 f"copies, of which {key} {key_ms:.4f} ms ({key_ms / device_ms:.4f}); device "
                 f"idle share {1 - device_ms / min(walls[mode]):.4f}{cap}")
            top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:6]
            for e in top:
                _log(f"  {e.key[:80]}: {e.count} x, {e.self_device_time_total / 1e3:.4f} ms")
            r.release()


def _serve_phases(torch, dev) -> int:
    """Phases 14-17: the main path (full-width mamba2-130m served through
    ``serve_batch``), the kernel path against the plain path teacher-forced
    over its tokens, the card against the CPU on the reduced config, and
    one decode step under the profiler.  Returns the SSD kernel's launches
    on the main path."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd.kernel import ssd_decode_step_cuda
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.common import param_count, tree_leaves
    from repro_torch.models.lm import LM, RunFlags

    cfg = get_config("mamba2-130m")
    bsz, plen, gen, seed = (SERVE[k] for k in ("batch", "prompt_len", "gen", "seed"))
    lm = LM(cfg)
    t0 = time.perf_counter()
    params = lm.init(prng.PRNGKey(seed, dev), torch.bfloat16, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    _log(f"serve: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
         f"{cfg.ssm_n_heads} heads x P {cfg.ssm_head_dim}, N {cfg.ssm_state}, vocab "
         f"{cfg.vocab_size} padded to {cfg.padded_vocab}), {n_params} parameters in bf16 "
         f"from PRNGKey({seed}), drawn by the threefry on the card in "
         f"{time.perf_counter() - t0:.2f} s")
    _require(n_params == param_count(lm.schema()), "parameters of the schema")
    warm = serve_batch(cfg, bsz, plen, 2, seed, params=params)  # cuBLAS, allocator
    _log(f"serve warm-up (gen 2): prefill {warm['prefill_s']:.4f} s")

    # ---- 14. the main path, through the decode graph; then eagerly ----------
    res = _serve_both(torch, cfg.name, cfg, params, ssd_decode_step_cuda)
    launches = res["launches"]
    generated, logits = res["generated"], res["logits"]
    _log(f"serve {cfg.name}: ssd kernel launches {launches} over the graph's replays (expected "
         f"{cfg.n_layers} x {gen - 1} = {cfg.n_layers * (gen - 1)})")
    _require(launches == cfg.n_layers * (gen - 1), "one SSD launch per layer per decode token")
    _require(generated.shape == (bsz, gen), "generated shape")
    _require(((generated >= 0) & (generated < cfg.vocab_size)).all(), "tokens in the vocab")
    _require(tuple(logits.shape) == (bsz, gen, cfg.vocab_size), "logits shape")
    _require(bool(torch.isfinite(logits).all()), "finite logits")

    # ---- 15. kernel path vs plain path, teacher-forced on the card ---------
    flags = {impl: RunFlags(remat="none", q_chunk=min(512, plen), ssd_impl=impl)
             for impl in ("cuda", "ref")}
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (bsz, plen))
    tokens = torch.as_tensor(prompts, dtype=torch.int32).to(dev)
    gen_t = torch.as_tensor(generated).to(dev)
    worst, agree, replay = 0.0, 0, 0.0
    with torch.no_grad():
        first, cache0 = make_prefill_step(lm, plen + gen, flags["cuda"])(params, {"tokens": tokens})
        steps = {impl: make_serve_step(lm, f) for impl, f in flags.items()}
        caches = {impl: _clone(cache0) for impl in flags}  # each step updates its own
        replay = float((first.float() - logits[:, 0].float()).abs().max())
        for i in range(gen - 1):
            tok = gen_t[:, i:i + 1]
            lk, caches["cuda"] = steps["cuda"](params, caches["cuda"], tok)
            lr, caches["ref"] = steps["ref"](params, caches["ref"], tok)
            lk, lr = lk.float(), lr.float()
            diff = (lk - lr).abs()
            _require(bool((diff <= BF16_BAR + BF16_BAR * lr.abs()).all()),
                     f"kernel vs plain decode logits at step {i + 1}")
            worst = max(worst, float(diff.max()))
            agree += int((lk.argmax(-1) == lr.argmax(-1)).sum())
            replay = max(replay, float((lk - logits[:, i + 1].float()).abs().max()))
        torch.cuda.synchronize()
    _log(f"teacher-forced over the {gen - 1} decode tokens, kernel vs plain SSD step on the "
         f"card: max abs logit difference {worst} (bar {BF16_BAR}), top-1 agreement "
         f"{agree / (bsz * (gen - 1)):.6f}; kernel replay vs the served logits max abs "
         f"difference {replay}")

    # ---- 16. the reduced config in f32, plain path: card vs CPU -----------
    red = get_config("mamba2-130m", reduced=True)
    on_card = serve_batch(red, 2, 32, 8, 0, device=dev, dtype=torch.float32, ssd_impl="ref")
    on_cpu = serve_batch(red, 2, 32, 8, 0, device="cpu", dtype=torch.float32)
    _require((on_card["generated"] == on_cpu["generated"]).all(), "reduced f32: card vs CPU")
    diff = float((on_card["logits"].cpu() - on_cpu["logits"]).abs().max())
    _log(f"{red.name} f32, plain path, card vs CPU: identical generated tokens "
         f"{on_card['generated'].tolist()}, max abs logit difference {diff}")

    # ---- 17. decode steps: the graph against eager ---------------------------
    _decode_modes(torch, cfg.name, lm, params, cache0, gen_t[:, :1], flags["cuda"], "ssd_step",
                  True)
    return launches


# ---------------------------------------------------------------------------
# The flash-attention kernel and the dense serving path (llama3.2-1b)
# ---------------------------------------------------------------------------

#: (bh, s, t, d, causal): tests/test_kernels.py::TestFlashAttention's sweep
#: (slow cases included), causal with S != T both ways, and the serve shape
#: of llama3.2-1b (batch 8 x 32 heads, prompt 512, head dim 64); then S and
#: T that are not multiples of the tensor-core path's 64-row tiles, D 128
#: causal and D 30 (staged without 16-byte copies)
FLASH_SWEEP = [(4, 256, 256, 64, True), (3, 200, 200, 64, True), (2, 128, 384, 128, False),
               (1, 64, 512, 256, False), (2, 512, 512, 64, True), (2, 128, 384, 64, True),
               (2, 384, 128, 64, True), (256, 512, 512, 64, True), (2, 130, 70, 64, True),
               (2, 70, 130, 64, True), (2, 200, 200, 128, True), (3, 77, 91, 30, True)]
#: the peaked regime (ROADMAP R8): q x 8 and k x 16, scores of std 128
FLASH_PEAKED = ((2, 256, 256, 64, True), (8.0, 16.0, 1.0))
FLASH_SERVE = (256, 512, 512, 64)


def _qkv(torch, seed, bh, s, t, d, dtype, dev, mul=(1.0, 1.0, 1.0)):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * f).to(dev, dtype)
            for shape, f in zip(((bh, s, d), (bh, t, d), (bh, t, d)), mul)]


def _ptxas_entries(log: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from an ``nvcc -Xptxas -v`` log."""
    out, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name, spills = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            out[name] = (int(m.group(1)), *spills)
            name = None
    return out


def _flash_bound(bh, s, t, d, elt):
    """(bound ms, "bytes" or "operations", bytes, ops) of causal attention:
    q, k, v read once and the output written once; two products of
    2 * D operations for each (query, visible key) pair, top-left causal."""
    nbytes = (2 * bh * s * d + 2 * bh * t * d) * elt
    pairs = sum(min(i + 1, t) for i in range(s))
    ops = 4 * bh * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def _flash_kernel_phase(torch, dev) -> dict:
    """Phases 18-19: the kernel against its plain version over the sweep,
    then the kernel, the plain version and SDPA timed at the serve shape.
    Returns the kernels line's entry (launches are filled in by phase 20)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention

    # ---- 18. kernel vs plain version ----------------------------------------
    max_abs = 0.0
    ones = (1.0, 1.0, 1.0)
    cases = ([(shape, None, ones) for shape in FLASH_SWEEP]
             + [((1, 128, 128, 64, c), 0.05, ones) for c in (False, True)]
             + [(FLASH_PEAKED[0], None, FLASH_PEAKED[1])])
    for (bh, s, t, d, causal), scale, mul in cases:
        for name, dtype, tol in (("float32", torch.float32, 2e-5),
                                 ("bfloat16", torch.bfloat16, 3e-2)):
            if (scale is not None and dtype != torch.float32) or (
                    mul != ones and dtype != torch.bfloat16):
                continue
            q, k, v = _qkv(torch, bh * 1000 + s + d, bh, s, t, d, dtype, dev, mul)
            out = flash_attention(q, k, v, causal=causal, scale=scale)
            ref = flash_attention(q, k, v, causal=causal, scale=scale, impl="ref")
            torch.cuda.synchronize()
            _require(out.dtype == dtype and tuple(out.shape) == (bh, s, d), "flash output")
            diff = (out.float() - ref.float()).abs()
            err = float(diff.max())
            ok = bool((diff <= tol + tol * ref.float().abs()).all())
            _log(f"flash parity BH={bh} S={s} T={t} D={d} causal={causal} scale={scale} "
                 f"q, k, v x {mul} {name}: max abs err {err} (bar {tol})")
            _require(ok, f"flash kernel vs plain at {(bh, s, t, d, causal, scale)} {name}")
            max_abs = max(max_abs, err)

    # ---- 19. timing at the serve shape, bf16 ---------------------------------
    bh, s, t, d = FLASH_SERVE
    q, k, v = _qkv(torch, 14, bh, s, t, d, torch.bfloat16, dev)
    fns = {
        "ref": lambda: flash_attention(q, k, v, causal=True, impl="ref"),
        "cuda": lambda: flash_attention(q, k, v, causal=True),
        # (BH, S, D) seen as one batch of BH heads: the 4-d layout SDPA's
        # fused backends take
        "sdpa": lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True)[0],
    }
    sdpa_err = float((fns["sdpa"]().float() - fns["cuda"]().float()).abs().max())

    def _time(fn, graph: bool, calls=10, reps=20):
        """ms per call, over a graph of (or ``calls`` eager) calls; in the
        graph the wrapper's checks, allocation and ctypes call are not
        replayed."""
        def run():
            for _ in range(calls):
                fn()
        return _cuda_ms(torch, run, graph, reps) / calls

    timings = {}
    for impl in ("ref", "cuda", "sdpa", "sdpa", "cuda", "ref"):
        for graph in (True, False):
            timings.setdefault((impl, graph), []).append(_time(fns[impl], graph))
    bound_ms, bound_by, nbytes, ops = _flash_bound(bh, s, t, d, 2)
    kernel_ms, plain_ms, sdpa_ms = (min(timings[(i, True)]) for i in ("cuda", "ref", "sdpa"))
    _log(f"flash timing BH={bh} S={s} T={t} D={d} causal bf16 (ms per call, CUDA events, "
         f"plain/kernel/sdpa/sdpa/kernel/plain): device time in a CUDA graph of 10 calls: "
         f"kernel {timings[('cuda', True)]}, plain {timings[('ref', True)]}, "
         f"F.scaled_dot_product_attention {timings[('sdpa', True)]}; eager (host launch "
         f"included): kernel {timings[('cuda', False)]}, plain {timings[('ref', False)]}, "
         f"sdpa {timings[('sdpa', False)]}; max abs difference of SDPA to the kernel "
         f"{sdpa_err}; bound {bound_ms:.8f} ms ({bound_by}: {nbytes} B, {ops} ops), share "
         f"of bound reached {bound_ms / kernel_ms:.4f}; achieved "
         f"{ops / kernel_ms / 1e9:.2f} TFLOP/s; kernel / SDPA {kernel_ms / sdpa_ms:.4f}")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
        "launches": 0,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": sdpa_ms,
    }


def _dense_serve_phases(torch, dev) -> int:
    """Phases 20-23: full-width llama3.2-1b served through ``serve_batch``,
    kernel against plain prefill attention (and teacher-forced decode from
    each path's cache), the reduced config's card against the CPU, and one
    profiled prefill.  Returns the flash kernel's launches on the main
    path."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.common import param_count, tree_leaves
    from repro_torch.models.lm import LM, RunFlags

    cfg = get_config("llama3.2-1b")
    bsz, plen, gen, seed = (SERVE[k] for k in ("batch", "prompt_len", "gen", "seed"))
    lm = LM(cfg)
    t0 = time.perf_counter()
    params = lm.init(prng.PRNGKey(seed, dev), torch.bfloat16, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    _log(f"serve: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
         f"query heads over {cfg.n_kv_heads} kv heads of dim {cfg.head_dim_}, d_ff {cfg.d_ff}, "
         f"vocab {cfg.vocab_size} padded to {cfg.padded_vocab}, rope theta {cfg.rope_theta}), "
         f"{n_params} parameters in bf16 from PRNGKey({seed}), drawn by the threefry on the "
         f"card in {time.perf_counter() - t0:.2f} s")
    _require(n_params == param_count(lm.schema()), "parameters of the schema")
    warm = serve_batch(cfg, bsz, plen, 2, seed, params=params)  # cuBLAS, allocator
    _log(f"serve warm-up (gen 2): prefill {warm['prefill_s']:.4f} s")
    del warm

    # ---- 20. the main path, through the decode graph; then eagerly ---------
    res = _serve_both(torch, cfg.name, cfg, params, flash_attention_cuda)
    launches = res["launches"]
    generated, logits = res["generated"], res["logits"]
    _log(f"serve {cfg.name}: flash kernel launches {launches} (expected one per layer in "
         f"prefill: {cfg.n_layers})")
    _require(launches == cfg.n_layers, "one flash launch per layer in prefill, none in decode")
    _require(generated.shape == (bsz, gen), "generated shape")
    _require(((generated >= 0) & (generated < cfg.vocab_size)).all(), "tokens in the vocab")
    _require(tuple(logits.shape) == (bsz, gen, cfg.vocab_size), "logits shape")
    _require(bool(torch.isfinite(logits).all()), "finite logits")

    # ---- 21. kernel vs plain prefill attention --------------------------
    # (a) full width, layer by layer along the plain path's residual stream:
    #     each layer's attention from the same input, kernel vs plain;
    # (b) end to end on the reduced config in bf16: last-token logits and
    #     teacher-forced decode from each path's cache;
    # (c) end to end at full width, in bf16 and float32: printed, not held.
    #     The random weights make the full-width model chaotic (its softmax is
    #     nearly a hard maximum, printed in (a)): float32 round-off in layer 0
    #     grows layer by layer to full divergence (printed; PERF.md, PR 13).
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.common import rms_norm, tree_map
    from repro_torch.models.lm import _layer

    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (bsz, plen))
    tokens = torch.as_tensor(prompts, dtype=torch.int32).to(dev)
    flags = {impl: RunFlags(remat="none", q_chunk=min(512, plen), attn_impl=impl)
             for impl in ("cuda", "ref")}
    per_layer = []
    with torch.no_grad():
        x = params["embed"][tokens.long()]
        for i in range(lm.n_blocks):
            bp = _layer(params["blocks"], i)
            h = rms_norm(x, bp["attn_norm"])
            yk, yr = (attn_mod.attention_forward(h, bp["attn"], cfg, impl=impl).float()
                      for impl in ("cuda", "ref"))
            diff = (yk - yr).abs()
            _require(bool((diff <= BF16_BAR + BF16_BAR * yr.abs()).all()),
                     f"kernel vs plain attention at layer {i}, same input")
            per_layer.append((float(diff.max()), float(yr.abs().max())))
            if i == 0:  # how peaked the softmax is: the first kv group's heads
                rep = cfg.n_heads // cfg.n_kv_heads
                q = torch.einsum("bsd,dhk->bhsk", h, bp["attn"]["wq"][:, :rep]).float()
                k = torch.einsum("bsd,dk->bsk", h, bp["attn"]["wk"][:, 0]).float()
                scores = torch.einsum("bhsk,btk->bhst", q, k) / cfg.head_dim_ ** 0.5
                seen = torch.ones(plen, plen, dtype=torch.bool, device=dev).tril()
                score_std = float(scores[..., seen].std())
                top_prob = float(torch.softmax(scores.masked_fill(~seen, -2.0**30), -1)
                                 .amax(-1).mean())
                del q, k, scores
            x, _ = lm._apply_block(x, bp, flags=flags["ref"], collect_kv=False)
    _log(f"kernel vs plain attention at full width, layer by layer from the same input (bf16, "
         f"bar {BF16_BAR} + {BF16_BAR}|plain|): max abs difference / max |plain| per layer "
         f"{[f'{d:.4g}/{m:.4g}' for d, m in per_layer]}; layer 0, first kv group: score std "
         f"{score_std:.4f} over the visible pairs, mean largest probability {top_prob:.4f}")

    def _end_to_end(model, p, toks, forced, hold: bool):
        """Prefill with each attention path, then decode teacher-forced
        over ``forced`` from each path's own cache.  Returns (max abs logit
        difference, top-1 agreement, the kernel path's logits per step)."""
        worst, agree, n, steps = 0.0, 0, 0, []
        decode = make_serve_step(model, flags["cuda"])
        with torch.no_grad():
            out, caches = {}, {}
            for impl, f in flags.items():  # each prefill makes its own cache
                out[impl], caches[impl] = make_prefill_step(
                    model, toks.shape[1] + forced.shape[1] + 1, f)(p, {"tokens": toks})
            for i in range(forced.shape[1] + 1):
                if i:
                    for impl in flags:
                        out[impl], caches[impl] = decode(p, caches[impl], forced[:, i - 1:i])
                lk, lr = out["cuda"].float(), out["ref"].float()
                diff = (lk - lr).abs()
                if hold:
                    _require(bool((diff <= BF16_BAR + BF16_BAR * lr.abs()).all()),
                             f"kernel vs plain prefill, {model.cfg.name}: logits at step {i}")
                worst = max(worst, float(diff.max()))
                agree += int((lk.argmax(-1) == lr.argmax(-1)).sum())
                n += lk.shape[0]
                steps.append(lk)
        return worst, agree / n, steps

    red = get_config("llama3.2-1b", reduced=True)
    red_lm = LM(red)
    red_params = red_lm.init(prng.PRNGKey(seed, dev), torch.bfloat16, dev)
    red_toks = torch.as_tensor(np.random.default_rng(seed).integers(0, red.vocab_size, (2, 32)),
                               dtype=torch.int32).to(dev)
    red_forced = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, red.vocab_size, (2, 15)), dtype=torch.int32).to(dev)
    worst, agree, _ = _end_to_end(red_lm, red_params, red_toks, red_forced, hold=True)
    _log(f"kernel vs plain prefill attention end to end, {red.name} bf16 on the card (batch 2, "
         f"prompt 32, last-token logits and 15 teacher-forced decode steps from each path's "
         f"cache): max abs logit difference {worst} (bar {BF16_BAR}), top-1 agreement "
         f"{agree:.6f}")

    gen_t = torch.as_tensor(generated).to(dev)
    worst, agree, steps = _end_to_end(lm, params, tokens, gen_t[:, :gen - 1], hold=False)
    replay = max(float((lk - logits[:, i].float()).abs().max()) for i, lk in enumerate(steps))
    del steps
    _log(f"kernel vs plain prefill attention end to end at full width (not held: the random "
         f"full-width model is chaotic): bf16 last-token logits and {gen - 1} teacher-forced "
         f"decode steps max abs logit difference {worst}, top-1 agreement {agree:.6f}; kernel "
         f"path replay vs the served logits max abs difference {replay}")
    # each path on its own residual stream from the embeddings, bf16 and float32
    for name, p in (("bf16", params), ("float32", None)):
        p = p if p is not None else tree_map(lambda t: t.float(), params)
        with torch.no_grad():
            xs = {impl: p["embed"][tokens.long()] for impl in flags}
            growth = []
            for i in range(lm.n_blocks):
                bp = _layer(p["blocks"], i)
                for impl, f in flags.items():
                    xs[impl], _ = lm._apply_block(xs[impl], bp, flags=f, collect_kv=False)
                growth.append(float((xs["cuda"].float() - xs["ref"].float()).abs().max()))
            last = {impl: torch.einsum("bd,vd->bv", rms_norm(x[:, -1], p["final_norm"]),
                                       p["embed"])[:, :cfg.vocab_size].float()
                    for impl, x in xs.items()}
        rms = float(xs["ref"].float().pow(2).mean().sqrt())
        _log(f"  {name} weights, each path on its own residual stream: max abs residual "
             f"difference after each layer {[f'{g:.3g}' for g in growth]} (final residual rms "
             f"{rms:.4g}); last-token logits max abs difference "
             f"{float((last['cuda'] - last['ref']).abs().max())}, logits std "
             f"{float(last['ref'].std()):.4f}, top-1 agreement "
             f"{float((last['cuda'].argmax(-1) == last['ref'].argmax(-1)).float().mean()):.6f}")
        del p, xs, last
    torch.cuda.empty_cache()

    # ---- 22. the reduced config in f32, plain path: card vs CPU -----------
    on_card = serve_batch(red, 2, 32, 8, 0, device=dev, dtype=torch.float32, attn_impl="ref")
    on_cpu = serve_batch(red, 2, 32, 8, 0, device="cpu", dtype=torch.float32)
    _require((on_card["generated"] == on_cpu["generated"]).all(), "reduced f32: card vs CPU")
    diff = float((on_card["logits"].cpu() - on_cpu["logits"]).abs().max())
    _log(f"{red.name} f32, plain path, card vs CPU: identical generated tokens "
         f"{on_card['generated'].tolist()}, max abs logit difference {diff}")

    # ---- 23. one prefill, then decode steps: the graph against eager --------
    from torch.profiler import ProfilerActivity, profile

    prefill = make_prefill_step(lm, plen + gen, flags["cuda"])
    with torch.no_grad():
        _, cache0 = prefill(params, {"tokens": tokens})
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    flash_ms = sum(e.self_device_time_total for e in on_device if "flash_fwd" in e.key) / 1e3
    n_kernels = sum(e.count for e in on_device)
    _require(device_ms > 0 and flash_ms > 0, "the profiler saw the prefill's flash kernel")
    _log(f"prefill profile (batch {bsz}, prompt {plen}, full width): wall {walls} ms; device "
         f"time {device_ms:.4f} ms in {n_kernels} kernels and copies, of which the flash "
         f"kernel {flash_ms:.4f} ms ({flash_ms / device_ms:.4f}); device idle share "
         f"{1 - device_ms / min(walls):.4f}")
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        _log(f"  {e.key[:80]}: {e.count} x, {e.self_device_time_total / 1e3:.4f} ms")
    _decode_modes(torch, cfg.name, lm, params, cache0, gen_t[:, :1], flags["cuda"], "flash_fwd",
                  False)
    return launches


# ---------------------------------------------------------------------------
# WFBP bucket streams, the gating closures and exact k-way (phases 8-12)
# ---------------------------------------------------------------------------

#: the step kernel with its (L, J, J) overlap plane, at the shapes of the
#: WFBP and k-way main path: model_zoo (8 lanes x 48 jobs on 8 servers,
#: NIC-only, so D 8) and the paper batch (160 jobs, 16 servers, D 16)
OVERLAP_SHAPES = {"model_zoo": (8, 48, 8, 8), "paper": (8, 160, 16, 16)}
#: model_zoo at its registered width (48 jobs on 8 x 4 GPUs, 64 MB
#: buckets, arrivals over 2400 s) with iterations cut 10x, as the paper
#: batch's: at 60-400 iterations a 16-GPU olmoe job of seed 0 still has 66
#: of 368 iterations left at the 400,000-tick horizon (the reference's
#: max_steps), and the batch takes ~146,000 executed ticks
ZOO_CUT = dict(min_iters=6, max_iters=40)
#: the paper batch under kway2 (phase 9): its seeds, cut from SEEDS only
#: where the batch would not fit the time limit (jobs are never cut)
KWAY_SEEDS = SEEDS
#: phase 9's batches, each through monte_carlo_fluid: (tag, scenario,
#: seeds, comm, overrides); fusion_sweep at its registered size (6 jobs of
#: 8 GPUs on 4 x 4, 32-48 iterations)
MAIN_WFBP = (
    ("model_zoo ada", "model_zoo", SEEDS, "ada", ZOO_CUT),
    ("model_zoo srsf2", "model_zoo", SEEDS, "srsf2", ZOO_CUT),
    ("fusion_sweep ada fusion all", "fusion_sweep", SEEDS, "ada", {"fusion": "all"}),
    ("fusion_sweep ada fusion none", "fusion_sweep", SEEDS, "ada", {"fusion": "none"}),
    ("fusion_sweep ada fusion 32e6", "fusion_sweep", SEEDS, "ada", {"fusion": 32e6}),
    ("paper kway2", "paper", KWAY_SEEDS, "kway2", PAPER_CUT),
)
#: phase 11's cells, each on the card and on the CPU: (scenario, seeds,
#: overrides), under ada, srsf2, kway2 and ada with gating="rounds"
CARD_CPU_CELLS = (("fusion_sweep", (0, 1), {"fusion": 32e6}),
                  ("model_zoo", (0, 1), {"n_jobs": 12, "min_iters": 15, "max_iters": 60,
                                         "horizon_s": 600.0}))
CARD_CPU_POLICIES = (("ada", {}), ("srsf2", {}), ("kway2", {}), ("ada", {"gating": "rounds"}))


def _tick_cost(torch, tag, batch, cfg, blocks=(), plain=True) -> dict:
    """Phases 7 and 12: one chunk of a batch alone on the card, from the
    state after its first chunk, through the graph and eagerly (and, with
    ``plain``, through the graph with the plain step core): wall and
    CUDA-event ms per tick, device ms per tick from the profiler, device
    kernels and copies per tick, idle share.  Before that, for each block
    size in ``blocks``, capture and instantiation seconds against wall per
    tick.  Returns {mode: (wall ms, device ms, kernels per tick)}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import fluidsim

    dev = batch["arrival"].device
    statics = fluidsim._Statics(cfg, dev)
    state0 = fluidsim._init_lane_state(batch, cfg, statics.n_domains)
    state0 = fluidsim._lane_chunk(batch, state0, cfg, statics)  # past the start
    ticks = cfg.chunk_steps

    def _runner(graph: bool, block: int = fluidsim.BLOCK_TICKS, impl: str = ""):
        """A chunk runner from ``state0``; a graph runner is captured by a
        first chunk, timed here."""
        r = fluidsim._ChunkRunner(batch, {n: v.clone() for n, v in state0.items()},
                                  dataclasses.replace(cfg, kernel=impl), statics,
                                  block=block, graph=graph)
        t1 = time.perf_counter()
        r.run_chunk()
        torch.cuda.synchronize()
        r.first_chunk_s = time.perf_counter() - t1
        return r

    def _chunk(r):
        """(host wall ms, CUDA-event ms) per tick of one chunk from state0."""
        for n, v in r.state.items():
            v.copy_(state0[n])
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        start.record()
        r.run_chunk()
        stop.record()
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) / ticks * 1e3, start.elapsed_time(stop) / ticks

    def _device_ms(r):
        """Device time per tick by the profiler (kernels and copies), and
        their number per tick."""
        for n, v in r.state.items():
            v.copy_(state0[n])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            r.run_chunk()
            torch.cuda.synchronize()
        on_device = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
        return (sum(e.self_device_time_total for e in on_device) / 1e3 / ticks,
                sum(e.count for e in on_device) / ticks)

    # ticks per captured block: capture and instantiation cost against replay
    for block in blocks:
        r = _runner(True, block=block)
        walls = [_chunk(r) for _ in range(2)]
        _log(f"block of {block} ticks: first chunk (eager block, capture, instantiation, "
             f"replays) {r.first_chunk_s:.4f} s: eager block {r.timing['warmup_s']:.4f} s, "
             f"recording {r.timing['capture_s']:.4f} s, instantiation "
             f"{r.timing['instantiate_s']:.4f} s; then wall per tick "
             f"{[round(w, 6) for w, _ in walls]} ms")
        r.release()

    runners = {"graph": _runner(True), "eager": _runner(False)}
    order = ["graph", "eager", "eager", "graph"]
    if plain:
        runners["graph, plain step core"] = _runner(True, impl="ref")
        order.append("graph, plain step core")
    per_tick, out = {}, {}
    for mode in order:
        per_tick.setdefault(mode, []).append(_chunk(runners[mode]))
    for mode, r in runners.items():
        wall = min(w for w, _ in per_tick[mode])
        events = min(e for _, e in per_tick[mode])
        dev_ms, n_ops = _device_ms(r)
        idle = f"{1 - dev_ms / wall:.4f}" if dev_ms > 0 else "not measured"
        _log(f"host cost, {mode} ({tag}, one chunk of {ticks} ticks in blocks of {r.block}, "
             f"alone on the card): wall per tick {[round(w, 6) for w, _ in per_tick[mode]]} ms, "
             f"CUDA events per tick {[round(e, 6) for _, e in per_tick[mode]]} ms; device time "
             f"per tick (profiler) {dev_ms:.6f} ms in {n_ops:.2f} kernels and copies; device "
             f"idle share {idle} (events: {1 - dev_ms / events:.4f})")
        if mode == "eager":
            _require(dev_ms > 0, "the profiler saw the eager chunk's device time")
        out[mode] = (wall, dev_ms, n_ops)
        r.release()
    return out


def _fluid_bound(L, J, S, D, need_overlap: bool):
    """(bound ms, "bytes" or "operations", bytes, ops) of one call of the
    fluid step core: each input read once and each output written once
    (the (L, J, J) bool overlap plane too, where asked); the float32
    operations of the counts, k, rates and minima, plus a J x J x D
    product per lane for the overlap plane."""
    nbytes = (L * J * D + L * J * S * 4 + L * J + L * J * 4 + S * 4 + D * 4
              + L * D * 4 + 4 * L * J * 4)
    ops = L * (5 * J * D + J * S + 5 * J + D)
    if need_overlap:
        nbytes += L * J * J
        ops += 2 * L * J * J * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def _overlap_kernel_phase(torch, dev) -> dict:
    """Phase 8: the kernel with the overlap plane against its plain
    version at the WFBP and k-way main path's shapes (random inputs, and
    every domain loaded and active), every plane exact; then timed in a
    CUDA graph with and without the plane, beside its plain version and
    the launch floor.  Returns {shape tag: timings}."""
    from repro_torch.kernels.fluidstep import fluid_step_core
    from repro_torch.kernels.fluidstep import kernel as fs_kernel

    names = ("loads", "member", "active", "rem", "bw", "oversub")
    kw = dict(b=8.53e-10, eta=1.706e-10)
    rng = np.random.default_rng(8)
    rows = {}
    for tag, (L, J, S, D) in OVERLAP_SHAPES.items():
        for trial in range(4):
            x = _rand_inputs(rng, L, J, S, D)
            if trial == 3:
                _special(x, "all_loaded", rng)
            args = [torch.as_tensor(x[k], device=dev) for k in names]
            got = fluid_step_core(*args, impl="cuda", need_overlap=True, **kw)
            want = fluid_step_core(*args, impl="ref", need_overlap=True, **kw)
            torch.cuda.synchronize()
            _require(got.keys() == want.keys(), "step core outputs")
            for k, v in want.items():
                _require(got[k].dtype == v.dtype and torch.equal(got[k], v),
                         f"{k} of the kernel with the overlap plane differs at {tag} "
                         f"(L={L} J={J} S={S} D={D}, trial {trial})")
            _require(bool(got["overlap"].any()), "the overlap plane is not empty")
        x = _rand_inputs(rng, L, J, S, D)
        args = [torch.as_tensor(x[k], device=dev) for k in names]

        def _time(impl, overlap, reps=40, calls=50):
            def run():
                for _ in range(calls):
                    if impl == "empty":
                        fs_kernel.empty_launch(L, dev)
                    else:
                        fluid_step_core(*args, impl=impl, need_overlap=overlap, **kw)
            return _cuda_ms(torch, run, True, reps) / calls

        cases = (("cuda", True), ("cuda", False), ("ref", True), ("empty", False))
        timings = {}
        for case in cases + cases[::-1]:
            timings.setdefault(case, []).append(_time(*case))
        best = {case: min(v) for case, v in timings.items()}
        bound_ms, bound_by, nbytes, ops = _fluid_bound(L, J, S, D, True)
        rows[tag] = {"ms": best[("cuda", True)], "ms_no_overlap": best[("cuda", False)],
                     "plain_ms": best[("ref", True)], "floor_ms": best[("empty", False)],
                     "bound_ms": bound_ms}
        _log(f"step kernel with the overlap plane, {tag} shape (L={L} J={J} S={S} D={D}): "
             f"4 cases bit-equal to the plain version (overlap exact); device time in a CUDA "
             f"graph of 50 calls, ms per call, in the order kernel with plane / without / plain "
             f"with plane / empty kernel (launch floor), then back: with the plane "
             f"{timings[('cuda', True)]}, without {timings[('cuda', False)]}, plain "
             f"{timings[('ref', True)]}, launch floor {timings[('empty', False)]}; bound "
             f"{bound_ms:.8f} ms ({bound_by}: {nbytes} B, {ops} ops); with the plane / without "
             f"{best[('cuda', True)] / best[('cuda', False)]:.4f}, / launch floor "
             f"{best[('cuda', True)] / best[('empty', False)]:.4f}")
    return rows


def _spy_batches() -> list:
    """Record each result of ``simulate_traces_batched`` that
    ``monte_carlo_fluid`` gets (finish ticks, chunks, captures, bucket-axis
    widths: more than its ``RunMetrics`` carry); returns the list."""
    from repro_torch.scenarios import sweep as sweep_mod

    seen = []
    real = sweep_mod.simulate_traces_batched

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(out)
        return out

    sweep_mod.simulate_traces_batched = spy
    return seen


def _batch_worker(job) -> dict:
    """One batch through ``simulate_traces_batched`` (phases 10 and 11; in
    a worker process or this one): ``job`` = (scenario, seeds, overrides,
    comm, fast_kw, device, graph).  Returns the finished mask, finish
    ticks, chunks, the kernel's launches and the wall seconds."""
    import torch

    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    from repro_torch.core import fluidsim
    from repro_torch.kernels.fluidstep import kernel as fs_kernel
    from repro_torch.scenarios import fluid_config, get_scenario

    name, seeds, over, comm, fast_kw, device, graph = job
    scns = [get_scenario(name, seed=s, **over) for s in seeds]
    cfg = fluid_config(scns[0], comm=comm, placement="lwf", device=device, **fast_kw)
    batch = fluidsim.stack_traces([fluidsim.trace_from_jobs(s.job_list(), fusion=s.fusion,
                                                            device=cfg.device) for s in scns])
    fs_kernel.fluid_step_core_cuda.launches = 0
    t0 = time.perf_counter()
    out = fluidsim.simulate_traces_batched(batch, cfg, _graph=graph)
    if device == "cuda":
        torch.cuda.synchronize()
    return {"jct": out["jct"], "finished": out["finished"], "chunks": out["chunks"],
            "launches": fs_kernel.fluid_step_core_cuda.launches,
            "wall": time.perf_counter() - t0}


def _main_wfbp_phase(torch, chunk_steps) -> tuple:
    """Phase 9: the WFBP and exact k-way main path through
    ``monte_carlo_fluid``, each batch alone on the card through the CUDA
    graph, the launch count set to 0 just before it and read just after.
    Returns ({tag: the driver's result}, launches, executed ticks)."""
    from repro_torch.kernels.fluidstep import kernel as fs_kernel
    from repro_torch.scenarios import monte_carlo_fluid

    seen = _spy_batches()
    results, launches, executed = {}, 0, 0
    for tag, name, seeds, comm, over in MAIN_WFBP:
        fs_kernel.fluid_step_core_cuda.launches = 0
        t0 = time.perf_counter()
        recs = monte_carlo_fluid(name, seeds, comm=comm, placement="lwf", overrides=over)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = fs_kernel.fluid_step_core_cuda.launches
        res = seen[-1]
        res.update(recs=[dataclasses.asdict(r) for r in recs], wall=wall, launches=n)
        ticks = _summary(f"{tag} (monte_carlo_fluid, {recs[0].n_jobs} jobs, CUDA graph)", res,
                         chunk_steps)
        _require(n == ticks, f"{tag}: one launch per executed tick")
        caps = res["captures"]
        widths = res["bucket_widths"]
        _log(f"  {len(caps)} captures: recording {sum(c['capture_s'] for c in caps):.4f} s, "
             f"instantiation {sum(c['instantiate_s'] for c in caps):.4f} s, eager first blocks "
             f"{sum(c['warmup_s'] for c in caps):.4f} s; bucket-axis width "
             + (f"{widths[0]} before compaction, {widths[-1]} after (per batch shape: {widths})"
                if widths else "none (monolithic trace)"))
        _require(len(caps) >= 1, f"{tag}: captured")
        _require(not widths or min(widths) >= 2, f"{tag}: the bucket axis keeps 2 columns")
        results[tag] = res
        launches += n
        executed += ticks
    if len(KWAY_SEEDS) < len(SEEDS):
        _log(f"paper kway2 batch cut to {len(KWAY_SEEDS)} seeds (of {len(SEEDS)}) to fit the "
             f"time limit; its jobs are not cut")
    return results, launches, executed


def _check_same(tag, got, want) -> None:
    _require((got["finished"] == want["finished"]).all(), f"finished mask differs: {tag}")
    _require((got["jct"] == want["jct"]).all(), f"finish ticks differ: {tag}")
    _require(got["chunks"] == want["chunks"], f"chunk counts differ: {tag}")


def _first_divergence(torch, name, seeds, over, comm, fast_kw, dev, max_ticks=400_000):
    """Where a cell's finish ticks differ between the card and the CPU:
    from the same state, one tick on each device, leaf by leaf, until
    the first difference; prints the tick, the leaf and the jobs, and the
    jobs' remainders and k-way inputs there."""
    from repro_torch.core import fluidsim
    from repro_torch.scenarios import fluid_config, get_scenario

    scns = [get_scenario(name, seed=s, **over) for s in seeds]
    cfgs, traces, statics, consts = {}, {}, {}, {}
    for d in (dev, torch.device("cpu")):
        cfgs[d.type] = fluid_config(scns[0], comm=comm, placement="lwf", device=str(d), **fast_kw)
        traces[d.type] = fluidsim.stack_traces(
            [fluidsim.trace_from_jobs(s.job_list(), fusion=s.fusion, device=d) for s in scns])
        statics[d.type] = fluidsim._Statics(cfgs[d.type], d)
        consts[d.type] = fluidsim._trace_consts(traces[d.type], cfgs[d.type],
                                                statics[d.type].inv_dt)
    n_jobs = traces["cpu"]["arrival"].shape[1]
    st = fluidsim._init_lane_state(traces["cpu"], cfgs["cpu"], statics["cpu"].n_domains)
    for _ in range(max_ticks):
        out = {}
        for d in ("cuda", "cpu"):
            prev = {k: v.to(d) for k, v in st.items()}
            out[d] = fluidsim._live_tick(traces[d], consts[d], prev, statics[d], cfgs[d], n_jobs)
        for k, v in out["cpu"].items():
            g = out["cuda"][k].cpu()
            if not torch.equal(g, v):
                diff = (g != v).nonzero().tolist()[:8]
                _log(f"card vs CPU, {name} {comm} {fast_kw}: first difference after tick "
                     f"{st['i'].tolist()} in {k!r} at (lane, job, ...) {diff}; card "
                     f"{[g[tuple(i)].item() for i in diff]}, CPU "
                     f"{[v[tuple(i)].item() for i in diff]}; remainders of those lanes' jobs "
                     f"before the tick {[st['rem'][i[0]].tolist() for i in diff[:1]]}")
                return
        st = out["cpu"]
        if bool((st["n_done"] >= n_jobs).all()):
            break
    _log(f"card vs CPU, {name} {comm} {fast_kw}: no tick differs from the same state")


def _wfbp_checks_phase(torch, dev, main, chunk_steps) -> None:
    """Phases 10 and 11, and phase 5's eager run.  The host-bound runs
    (the eager runs of the paper ada, model_zoo ada and paper kway2
    batches, and the CPU side of phase 11) go to worker processes,
    started together, while this process replays the plain step core's
    graphs and phase 11's card side, so the card is shared meanwhile
    (their walls are printed, not kept; phase 7 times an eager tick
    alone)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    reruns = (("model_zoo ada", "model_zoo", SEEDS, ZOO_CUT, "ada"),
              ("paper kway2", "paper", KWAY_SEEDS, PAPER_CUT, "kway2"))
    cpu_jobs = [(name, seeds, over, comm, fast_kw, "cpu", None)
                for name, seeds, over in CARD_CPU_CELLS for comm, fast_kw in CARD_CPU_POLICIES]
    eager_runs = (("paper kway2", "paper", KWAY_SEEDS, PAPER_CUT, "kway2"),
                  ("paper ada", "paper", SEEDS, PAPER_CUT, "ada"),
                  ("model_zoo ada", "model_zoo", SEEDS, ZOO_CUT, "ada"))
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=6,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        eager = [pool.submit(_batch_worker, (name, seeds, over, comm, {}, "cuda", False))
                 for _, name, seeds, over, comm in eager_runs]
        on_cpu = [pool.submit(_batch_worker, job) for job in cpu_jobs]
        # ---- 10. the plain step core in the graph ---------------------------
        for tag, name, seeds, over, comm in reruns:
            res = _batch_worker((name, seeds, over, comm, {"kernel": "ref"}, "cuda", None))
            _require(res["launches"] == 0, f"{tag}: the plain run launched the kernel")
            _check_same(f"{tag}, plain step core in the graph", res, main[tag])
            _log(f"{tag}, plain step core in the graph: identical finished mask, finish ticks "
                 f"and chunk count ({res['chunks']}); wall {res['wall']:.3f} s (card shared)")
        # ---- 11. card side ---------------------------------------------------
        on_card = [_batch_worker((name, seeds, over, comm, fast_kw, "cuda", None))
                   for name, seeds, over, comm, fast_kw, _, _ in cpu_jobs]
        for job, card, fut in zip(cpu_jobs, on_card, on_cpu):
            name, seeds, over, comm, fast_kw = job[:5]
            cpu = fut.result()
            tag = f"{name} {comm} {fast_kw or ''} ({len(seeds)} seeds)"
            if not ((card["finished"] == cpu["finished"]).all()
                    and (card["jct"] == cpu["jct"]).all()):
                _first_divergence(torch, name, seeds, over, comm, fast_kw, dev)
            _check_same(f"{tag}: card vs CPU", card, cpu)
            _log(f"{tag}: card == CPU on every finish tick ({int(card['finished'].sum())} "
                 f"jobs, {card['chunks']} chunks)")
        for (tag, *_), fut in zip(eager_runs, eager):
            res = fut.result()
            ticks = res["chunks"] * chunk_steps
            _require(res["launches"] == ticks, f"{tag} eager: one launch per executed tick")
            _check_same(f"{tag}, kernel eagerly", res, main[tag])
            _log(f"{tag}, kernel eagerly (worker process, card shared): identical finished "
                 f"mask, finish ticks and chunk count; wall {res['wall']:.3f} s, "
                 f"{res['wall'] / ticks * 1e3:.4f} ms per tick, {res['launches']} launches")
    _log(f"phases 10-11: {time.perf_counter() - t0:.3f} s wall")


# ---------------------------------------------------------------------------
# The threefry, training, and the threefry's users (phases 24-30)
# ---------------------------------------------------------------------------

#: the training main path: batch 8 x seq 512 (the serve shape: BH 256, S = T
#: 512, D 64 in llama's attention), the reference's default lr, 8 steps
TRAIN = dict(steps=8, batch=8, seq=512, lr=3e-4, seed=0)
#: the paper batch of phase 4 under the random placement (phase 29)
MC_JCT = dict(n_seeds=8, n_jobs=64)
SAMPLE_T = 0.8


def _prng_phase(torch, dev) -> None:
    """Phase 24: the threefry on the card against the CPU, at odd and large
    shapes: every function's bits identical, ``normal``'s max ulp printed
    (and held to 2)."""
    from repro_torch import prng

    t0 = time.perf_counter()
    cases = 0
    logits = np.random.default_rng(0).standard_normal((8, 128256)).astype(np.float32)
    p = np.array([80, 14, 26, 30, 8, 2], np.float64)
    p = (p / p.sum()).astype(np.float32)
    a = np.array([1, 2, 4, 8, 16, 32], np.int32)
    def draws(seed, on):
        key = prng.PRNGKey(seed, on)
        keys = prng.split(key, 7)
        ticks = torch.arange(1000, device=on) * 7919
        out = {
            "split": prng.split(key, 1000),
            "fold_in": prng.fold_in(keys, 2**31 + 5),
            "fold_in lanes": prng.fold_in(key, ticks),
            "bits": prng.random_bits(keys, (3, 5)),
            "bits large": prng.random_bits(key, (1_000_003,)),
            "uniform": prng.uniform(keys, (1001,)),
            "uniform 1-1200": prng.uniform(key, (2**20 + 3,), minval=1.0, maxval=1200.0),
            "uniform bf16": prng.uniform(key, (4097,), torch.bfloat16),
            "randint": prng.randint(keys, (999,), 1000, 6001),
            "randint wide": prng.randint(key, (100003,), -5, 2**25 + 3),
            "choice": prng.choice(key, torch.from_numpy(a).to(on), (100003,),
                                  p=torch.from_numpy(p).to(on)),
            "categorical": prng.categorical(key, torch.from_numpy(logits).to(on)),
            "categorical bf16": prng.categorical(
                key, torch.from_numpy(logits).to(on, torch.bfloat16)),
            "gumbel": prng.gumbel(key, (4097,)),
            "normal": prng.normal(key, (2**20 + 1,)),
        }
        torch.cuda.synchronize()
        return {k: v.cpu() for k, v in out.items()}

    for seed in (0, 2**31 + 5):
        card, cpu = draws(seed, dev), draws(seed, torch.device("cpu"))
        for k, v in card.items():
            w = cpu[k]
            _require(v.dtype == w.dtype and v.shape == w.shape, f"threefry {k}: dtype/shape")
            if k == "normal":
                ulps = int((v.view(torch.int32).long() - w.view(torch.int32).long()).abs().max())
                _log(f"threefry normal, seed {seed}, {v.numel()} values: card vs CPU max ulp "
                     f"{ulps}")
                _require(ulps <= 2, "threefry normal within 2 ulp on the card")
            else:
                same = torch.equal(v.view(torch.int16) if v.dtype == torch.bfloat16 else
                                   (v.view(torch.int32) if v.dtype == torch.float32 else v),
                                   w.view(torch.int16) if w.dtype == torch.bfloat16 else
                                   (w.view(torch.int32) if w.dtype == torch.float32 else w))
                _require(same, f"threefry {k}, seed {seed}: card bits == CPU bits")
            cases += 1
    key = prng.PRNGKey(0, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    big = prng.normal(key, (128256 * 2048,))  # llama3.2-1b's embedding table
    torch.cuda.synchronize()
    t_big = time.perf_counter() - t1
    del big
    _log(f"threefry: {cases} cases (split, fold_in, bits, uniform, randint, choice(p=...), "
         f"categorical, gumbel: bits identical on the card and the CPU; normal within 2 ulp) "
         f"in {time.perf_counter() - t0:.2f} s; normal of llama's 262,668,288-entry embedding "
         f"on the card in {t_big:.4f} s (slices of {prng.SLICE} counters)")


def _train_main(torch, cfg, counter, remat="none") -> dict:
    """One run of ``repro_torch.launch.train.train`` on the card (the user's
    entry point), its printed log kept: losses, wall, per-step ms from the
    logged tok/s (each step synchronises on its loss), peak memory and,
    with ``counter``, the kernel's launches from a count of 0 just before."""
    from repro_torch.launch.train import train

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    if counter is not None:
        counter.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        losses = train(cfg, log_every=1, remat=remat, **TRAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.launches if counter is not None else None
    log = buf.getvalue()
    tok_s = [float(v) for v in re.findall(r"tok/s=([0-9.]+)", log)]
    gnorm = [float(v) for v in re.findall(r"gnorm=([0-9.e+-]+)", log)]
    toks = TRAIN["batch"] * TRAIN["seq"]
    step_ms = [toks / v * 1e3 for v in tok_s]
    peak = torch.cuda.max_memory_allocated()
    _log(f"train {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}), batch "
         f"{TRAIN['batch']} x seq {TRAIN['seq']}, bf16 weights from PRNGKey({TRAIN['seed']}), "
         f"float32 moments, lr {TRAIN['lr']}, remat {remat!r}: losses {losses}; wall "
         f"{wall:.3f} s (init and the first step's warm-up included); step ms {step_ms}; "
         f"tok/s {tok_s}; steady state (steps 2-{TRAIN['steps']}) median "
         f"{float(np.median(step_ms[1:])):.3f} ms per step = "
         f"{float(np.median(tok_s[1:])):.1f} tok/s; torch.cuda.max_memory_allocated "
         f"{peak} B ({peak / 2**30:.3f} GiB); grad norms before clipping {gnorm}; mean of the "
         f"last 3 losses minus the first {float(np.mean(losses[-3:])) - losses[0]}")
    _require(len(losses) == TRAIN["steps"] and len(tok_s) == TRAIN["steps"], "train steps")
    _require(all(np.isfinite(losses)) and all(np.isfinite(gnorm)), f"{cfg.name}: finite losses")
    return {"losses": losses, "step_ms": step_ms, "tok_s": tok_s, "peak": peak,
            "launches": launches, "wall": wall, "gnorm": gnorm}


def _cast(params, dtype):
    from repro_torch.models.common import tree_map

    return tree_map(lambda t: t.to(dtype), params)


def _grad_run(torch, lm, params, batch, flags):
    """(loss, {flat key: grad}) of one forward and backward from copies of
    ``params``."""
    from repro_torch.models.common import tree_leaves, tree_map

    p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss, _ = lm.loss_fn(p, batch, flags)
    loss.backward()
    return loss.detach(), {k: t.grad for k, t in tree_leaves(p)}


def _close_to_scale(got, want) -> float:
    """Max |got - want| / scale, scale the largest |want| (at least 1e-30)."""
    got, want = got.float(), want.float()
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) / scale


def _train_phases(torch, dev) -> int:
    """Phases 25-28: the training main path (full-width llama3.2-1b, then
    mamba2-130m), the kernel against the plain attention in training, the
    reduced float32 config on the card and the CPU with a checkpoint
    resume, and one profiled training step.  Returns the flash kernel's
    launches on the training main path."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import BACKWARD_RANGE
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.common import param_count, rms_norm, tree_leaves
    from repro_torch.models.lm import LM, RunFlags, _layer
    from repro_torch.optim.adamw import UPDATE_RANGE, AdamWConfig, adamw_init

    # ---- 25. the training main path ----------------------------------------
    cfg = get_config("llama3.2-1b")
    _require(param_count(LM(cfg).schema()) == 1_237_387_264, "llama3.2-1b parameters")
    main = _train_main(torch, cfg, flash_attention_cuda)
    launches = main["launches"]
    _log(f"train {cfg.name}: flash kernel launches {launches} (expected {cfg.n_layers} layers "
         f"x {TRAIN['steps']} steps = {cfg.n_layers * TRAIN['steps']}: one per layer in each "
         f"forward; the backward recomputes the plain version)")
    _require(launches == cfg.n_layers * TRAIN["steps"], "one flash launch per layer per step")
    # The reference's init makes this model's gradient explode with depth
    # (ROADMAP R12): its norm is ~1e11, so the clipped step is ~1e-11 an
    # entry, below AdamW's eps, and 8 steps at lr 3e-4 leave the loss at
    # ln(vocab); it is held finite, not falling.  mamba2-130m's falls.
    _log(f"train {cfg.name}: grad norm {min(main['gnorm']):.4g}-{max(main['gnorm']):.4g} "
         f"before clipping to 1.0; losses within {max(main['losses']) - min(main['losses']):.4g} "
         f"of each other, ln(vocab) = {math.log(cfg.vocab_size):.5f}")
    ssm_cfg = get_config("mamba2-130m")
    ssm = _train_main(torch, ssm_cfg, None)
    _require(float(np.mean(ssm["losses"][-3:])) < ssm["losses"][0],
             f"{ssm_cfg.name}: the mean of the last 3 losses is below the first")

    # ---- 26. the kernel against the plain attention in training ------------
    red = get_config("llama3.2-1b", reduced=True)
    red_lm = LM(red)
    red_params = red_lm.init(prng.PRNGKey(0, dev), torch.bfloat16, dev)
    data = SyntheticLMDataset(red, 2, 128).batch_at(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    runs = {impl: _grad_run(torch, red_lm, red_params, batch,
                            RunFlags(remat="none", attn_impl=impl)) for impl in ("", "ref")}
    (lk, gk), (lr_, gr) = runs[""], runs["ref"]
    l32, g32 = _grad_run(torch, red_lm, _cast(red_params, torch.float32), batch,
                         RunFlags(remat="none", attn_impl="ref"))
    loss_err = abs(float(lk) - float(lr_)) / max(1.0, abs(float(lr_)))
    per_leaf = {k: (_close_to_scale(gk[k], gr[k]), _close_to_scale(gk[k], g32[k]),
                    _close_to_scale(gr[k], g32[k])) for k in gr}
    worst = max(v[0] for v in per_leaf.values())
    _log(f"train {red.name} bf16, one step, kernel vs plain attention on the card: loss "
         f"{float(lk)} vs {float(lr_)} (relative {loss_err}; float32 plain {float(l32)}); worst "
         f"grad leaf max abs difference / its scale {worst} (bar {BF16_BAR}, or the plain "
         f"path's own distance from the float32 gradient where that is larger)")
    for k, (kp, k32, p32_) in per_leaf.items():
        _log(f"  {k}: kernel vs plain {kp:.5f}; against the float32 plain gradient: kernel "
             f"{k32:.5f}, plain {p32_:.5f}")
    # This random model's bf16 gradient is chaotic (ROADMAP R8): each bf16
    # path lies 0.4-1.2 of a leaf's scale from the float32 gradient, so the
    # two paths are held no further apart than the plain path is from it.
    _require(loss_err <= BF16_BAR, "kernel vs plain attention: the loss")
    _require(all(kp <= max(BF16_BAR, p32_) for kp, _, p32_ in per_leaf.values()),
             "kernel vs plain attention grads")
    del runs, gk, gr, g32

    lm = LM(cfg)
    params = lm.init(prng.PRNGKey(0, dev), torch.bfloat16, dev)
    full = SyntheticLMDataset(cfg, TRAIN["batch"], TRAIN["seq"]).batch_at(0)
    tokens = torch.from_numpy(full["tokens"]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    out_worst, grad_worst, grad_exact = 0.0, 0.0, True
    with torch.no_grad():
        x = params["embed"][tokens.long()]
    for i in range(lm.n_blocks):
        bp = _layer(params["blocks"], i)
        with torch.no_grad():
            h = rms_norm(x, bp["attn_norm"])
        cot = torch.randn(h.shape, generator=gen, device=dev).to(h.dtype)
        res = {}
        for impl in ("cuda", "ref"):
            hh = h.detach().clone().requires_grad_()
            y = attn_mod.attention_forward(hh, bp["attn"], cfg, impl=impl)
            y.backward(cot)
            res[impl] = (y.detach(), hh.grad)
        out_worst = max(out_worst, _close_to_scale(res["cuda"][0], res["ref"][0]))
        grad_worst = max(grad_worst, _close_to_scale(res["cuda"][1], res["ref"][1]))
        grad_exact &= torch.equal(res["cuda"][1], res["ref"][1])
        with torch.no_grad():  # along the plain path's residual stream
            x = lm._apply_block(x, bp, flags=RunFlags(remat="none", attn_impl="ref"),
                                collect_kv=False)[0]
    _log(f"train {cfg.name}, layer by layer (batch {TRAIN['batch']} x seq {TRAIN['seq']}), "
         f"kernel vs plain attention from the same input: worst output difference / scale "
         f"{out_worst}, worst input-grad difference / scale {grad_worst} (bar {BF16_BAR}); "
         f"input grads bit-identical: {grad_exact} (both backwards recompute the plain version "
         f"from the same q, k, v)")
    _require(out_worst <= BF16_BAR and grad_worst <= BF16_BAR, "layer-by-layer attention")
    del params, x

    # ---- 27. reduced float32, plain path: card vs CPU; checkpoint resume ----
    losses = []
    for on in (dev, torch.device("cpu")):
        p32 = red_lm.init(prng.PRNGKey(0, on), torch.float32, on)
        opt = AdamWConfig()
        st = adamw_init(p32, opt)
        step = make_train_step(red_lm, opt, RunFlags(remat="none", attn_impl="ref"))
        ds = SyntheticLMDataset(red, 2, 64)
        out = []
        for i in range(4):
            b = {k: torch.from_numpy(v).to(on) for k, v in ds.batch_at(i).items()}
            p32, st, m = step(p32, st, b)
            out.append(float(m["loss"]))
        losses.append(out)
    rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    _log(f"train {red.name} float32, plain path, 4 steps: card {losses[0]}, CPU "
         f"{losses[1]}, max relative difference {rel}")
    _require(rel <= 1e-5, "reduced float32 losses: card vs CPU to round-off")
    torch.use_deterministic_algorithms(True, warn_only=True)  # the embedding's atomics
    try:
        with tempfile.TemporaryDirectory() as d:
            kw = dict(batch=2, seq=64, lr=3e-3, log_every=0, seed=0)
            with contextlib.redirect_stdout(io.StringIO()):
                whole = train(red, steps=4, ckpt_dir=d, ckpt_every=2, **kw)
                Path(d, "step_00000004.npz").unlink()
                resumed = train(red, steps=4, ckpt_dir=d, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    _log(f"train {red.name} bf16 on the card, checkpoint at step 2: uninterrupted {whole}, "
         f"resumed {resumed}")
    _require(resumed == whole[2:], "the resumed run repeats the uninterrupted run's losses")

    # ---- 28. one training step under the profiler ---------------------------
    from torch.profiler import ProfilerActivity, profile

    params = lm.init(prng.PRNGKey(0, dev), torch.bfloat16, dev)
    opt = AdamWConfig(lr=TRAIN["lr"])
    st = adamw_init(params, opt)
    step = make_train_step(lm, opt, RunFlags(remat="none"))
    ds = SyntheticLMDataset(cfg, TRAIN["batch"], TRAIN["seq"])
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in ds.batch_at(i).items()}
               for i in range(5)]
    params, st, _ = step(params, st, batches[0])  # warm-up
    walls = []
    for b in batches[1:4]:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, st, m = step(params, st, b)
        float(m["loss"])
        walls.append((time.perf_counter() - t1) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        params, st, m = step(params, st, batches[4])
        float(m["loss"])
        torch.cuda.synchronize()
    names = (BACKWARD_RANGE, UPDATE_RANGE)
    # the named ranges also show as device-side annotations: not kernels
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in names]
    device_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    flash_ms = sum(e.self_device_time_total for e in on_device if "flash_fwd" in e.key) / 1e3
    n_kernels = sum(e.count for e in on_device)

    def kernels_in(e):
        return len(e.kernels) + sum(kernels_in(c) for c in e.cpu_children)

    ranges = {name: [e for e in prof.events() if e.name == name
                     and e.device_type == torch.autograd.DeviceType.CPU] for name in names}
    rec_ms = sum(e.device_time_total for e in ranges[BACKWARD_RANGE]) / 1e3
    upd_ms = sum(e.device_time_total for e in ranges[UPDATE_RANGE]) / 1e3
    upd_kernels = sum(kernels_in(e) for e in ranges[UPDATE_RANGE])
    n_leaves = len(list(tree_leaves(params)))
    _require(device_ms > 0 and flash_ms > 0, "the profiler saw the training step's flash kernel")
    _require(len(ranges[BACKWARD_RANGE]) == cfg.n_layers and len(ranges[UPDATE_RANGE]) == 1,
             "the profiler saw the recompute and update ranges")
    _log(f"train step profile ({cfg.name}, batch {TRAIN['batch']} x seq {TRAIN['seq']}, "
         f"remat 'none'): wall {walls} ms; device time {device_ms:.4f} ms in {n_kernels} "
         f"kernels and copies; flash kernel {flash_ms:.4f} ms ({flash_ms / device_ms:.4f}); "
         f"backward recompute of the plain attention {rec_ms:.4f} ms "
         f"({rec_ms / device_ms:.4f}, {len(ranges[BACKWARD_RANGE])} ranges); AdamW update "
         f"{upd_ms:.4f} ms ({upd_ms / device_ms:.4f}) in {upd_kernels} kernels over {n_leaves} "
         f"leaves ({upd_kernels / n_leaves:.1f} per leaf); device idle share "
         f"{1 - device_ms / min(walls):.4f}")
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        _log(f"  {e.key[:80]}: {e.count} x, {e.self_device_time_total / 1e3:.4f} ms")
    del params, st, batches
    torch.cuda.empty_cache()
    return launches


def _mc_worker(device) -> dict:
    """``monte_carlo_jct`` (phase 29) on ``device``, in a worker process or
    this one."""
    import torch

    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    from repro_torch.core import fluidsim

    t0 = time.perf_counter()
    out = fluidsim.monte_carlo_jct(device=device, **MC_JCT)
    if device == "cuda":
        torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t0
    return out


def _random_phase(torch, dev, chunk_steps, cpu_mc) -> tuple:
    """Phase 29: the random placement on the card.  The paper batch of
    phase 4 under ``placement="random"`` (the main path: launch count 0
    just before, one launch per executed tick), a small batch on the card
    and the CPU, and ``monte_carlo_jct`` on both (``cpu_mc``: the CPU
    side's future, started in a worker process during the serving
    phases).  Returns (launches, executed ticks)."""
    from repro_torch.scenarios import get_scenario, run_scenario_fluid

    res = _paper_batch("ada", "", "simulate_traces_batched", placement="random")
    ticks = _summary("paper ada random placement (simulate_traces_batched, CUDA graph)", res,
                     chunk_steps)
    _require(res["launches"] == ticks > 0, "random placement: one launch per executed tick")
    small = get_scenario("paper", seed=1, n_jobs=24, min_iters=60, max_iters=300,
                         horizon_s=300.0)
    for comm in ("ada", "srsf2"):
        on_card = run_scenario_fluid(small, comm=comm, placement="random")
        on_cpu = run_scenario_fluid(small, comm=comm, placement="random", device="cpu")
        _require((on_card["finished"] == on_cpu["finished"]).all()
                 and (on_card["jct"] == on_cpu["jct"]).all(), f"random {comm}: card vs CPU")
        _log(f"paper (24 jobs, seed 1) {comm} random placement: card == CPU on every finish "
             f"tick ({int(on_card['finished'].sum())} jobs)")
    card = _mc_worker("cuda")
    cpu = cpu_mc.result()
    for k, v in card["traces"].items():
        _require((v == cpu["traces"][k]).all(), f"monte_carlo_jct traces: {k}")
    _require((card["per_seed"] == cpu["per_seed"]).all(), "monte_carlo_jct per_seed")
    _log(f"monte_carlo_jct(n_seeds={MC_JCT['n_seeds']}, n_jobs={MC_JCT['n_jobs']}): sampled "
         f"traces and per_seed identical on the card and the CPU; avg JCT "
         f"{card['avg_jct_mean']:.4f} +- {card['avg_jct_std']:.4f} s, finished "
         f"{card['finished_frac']}; wall card {card['wall']:.3f} s, CPU {cpu['wall']:.3f} s")
    return res["launches"], ticks


def _sampled_phase(torch, dev) -> None:
    """Phase 30: sampled serving (``greedy=False``, temperature 0.8) at full
    width for both families, then the reduced float32 configs on the card
    (plain path) and the CPU: identical tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch

    bsz, plen, gen, seed = (SERVE[k] for k in ("batch", "prompt_len", "gen", "seed"))
    for arch in ("mamba2-130m", "llama3.2-1b"):
        cfg = get_config(arch)
        res = serve_batch(cfg, bsz, plen, gen, seed, greedy=False, temperature=SAMPLE_T)
        g = res["generated"]
        _require(g.shape == (bsz, gen) and ((g >= 0) & (g < cfg.vocab_size)).all(),
                 f"{arch}: sampled tokens in the vocab")
        _log(f"serve {cfg.name} sampled (temperature {SAMPLE_T}, batch {bsz}, prompt {plen}, "
             f"gen {gen}, bf16): decode {res['decode_tok_per_s']:.1f} tok/s, "
             f"{res['decode_s'] / (gen - 1) * 1e3:.4f} ms per step (draw outside the graph); "
             f"sample tokens {g[0][:16].tolist()}")
        red = get_config(arch, reduced=True)
        kw = dict(greedy=False, temperature=SAMPLE_T, dtype=torch.float32)
        on_card = serve_batch(red, 2, 32, 8, seed, device=dev, ssd_impl="ref", attn_impl="ref",
                              **kw)
        on_cpu = serve_batch(red, 2, 32, 8, seed, device="cpu", **kw)
        same = (on_card["generated"] == on_cpu["generated"])
        if not same.all():
            step = int(np.nonzero(~same.all(0))[0][0])
            lg = on_cpu["logits"][:, step].float()
            top2 = torch.topk(lg, 2, dim=-1).values
            _log(f"{red.name} sampled f32: card and CPU part at step {step}: card "
                 f"{on_card['generated'][:, step].tolist()}, CPU "
                 f"{on_cpu['generated'][:, step].tolist()}; logit margin (top-1 - top-2) "
                 f"{(top2[:, 0] - top2[:, 1]).tolist()}, max abs logit difference "
                 f"{float((on_card['logits'][:, step].cpu() - lg).abs().max())}")
        _require(same.all(), f"{red.name} sampled f32: card vs CPU tokens")
        _log(f"{red.name} sampled f32, plain path: card == CPU tokens "
             f"{on_card['generated'].tolist()}")


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
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.fluidstep import kernel as fs_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.scenarios import (
        QUICK_OVERRIDES, fluid_config, get_scenario, monte_carlo_fluid,
        run_scenario_fluid,
    )

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # float32 products in full float32 (the plain versions' contractions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = fs_kernel.fluid_step_core_cuda

    # ---- 1. the card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _log(smi)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
         f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---- 2. build: one nvcc per kernel source, started together -------------
    t0 = time.perf_counter()
    kernels = (("fluid_step.cu", fs_kernel), ("ssd_step.cu", ssd_kernel),
               ("flash_attention.cu", flash_kernel))
    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:
        for f in [pool.submit(k.build) for _, k in kernels]:
            f.result()
    _log(f"build: {len(kernels)} kernels in {time.perf_counter() - t0:.2f} s wall")
    for src, k in kernels:
        info = k.build_info()
        _log(f"build: {src} in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                _log("  ptxas:", line.strip())
    tc64 = [v for name, v in _ptxas_entries(flash_kernel.build_info()["log"]).items()
            if "flash_fwd_tc_kernelILi64E" in name]
    _require(len(tc64) == 1, "the ptxas log names the bf16 D-64 tensor-core instantiation")
    regs, spill_st, spill_ld = tc64[0]
    _log(f"build: flash_attention.cu bf16 D-64 tensor-core instantiation (the serve shape's): "
         f"{regs} registers, {spill_st} bytes spill stores, {spill_ld} bytes spill loads")
    _require(spill_st == 0 and spill_ld == 0, "the bf16 D-64 flash instantiation spills")

    # ---- 3. kernel vs plain version -----------------------------------------
    names = ("loads", "member", "active", "rem", "bw", "oversub")
    rng = np.random.default_rng(0)
    max_ulp, max_abs = 0, 0.0
    n_cases = 0
    # the main path's neighbourhood, then the shapes a warp-parallel design
    # gets wrong, then inputs at the edges of the semantics
    grid = [(lanes, n_jobs, 16, n_domains, None) for n_jobs in (8, 40, 160, 256)
            for n_domains in (16, 20) for lanes in (1, 8)]
    grid += [(3, n_jobs, n_servers, n_domains, None) for n_jobs in (1, 31, 33, 1000)
             for n_domains in (1, 63, 64) for n_servers in (1, 16, 40)]
    grid += [(3, 45, 16, 20, case) for case in FLUID_SPECIAL]
    for lanes, n_jobs, n_servers, n_domains, case in grid:
        for need_overlap in (False, True):
            x = _rand_inputs(rng, lanes, n_jobs, n_servers, n_domains)
            if case:
                _special(x, case, rng)
            args = [torch.as_tensor(x[k], device=dev) for k in names]
            kw = dict(b=8.53e-10, eta=1.706e-10, need_overlap=need_overlap)
            got = fluid_step_core(*args, impl="cuda", **kw)
            want = fluid_step_core(*args, impl="ref", **kw)
            torch.cuda.synchronize()
            where = f"L={lanes} J={n_jobs} S={n_servers} D={n_domains} {case or ''}"
            for k, v in want.items():
                g = got[k]
                if v is None:
                    _require(g is None, k)
                    continue
                g, v = g.cpu().numpy(), v.cpu().numpy()
                _require(g.dtype == v.dtype and g.shape == v.shape, k)
                if v.dtype == np.float32:
                    _require((np.isinf(g) == np.isinf(v)).all(), f"inf pattern of {k} at {where}")
                    max_ulp = max(max_ulp, _ulps(g, v))
                    fin = np.isfinite(v)
                    max_abs = max(max_abs, float(np.abs(g[fin] - v[fin]).max(initial=0)))
                else:
                    _require((g == v).all(), f"{k} differs at {where}")
            n_cases += 1
    _log(f"parity: {n_cases} cases (J up to 1000, S 1-40, D 1-64, with and without "
         f"overlap, special inputs {FLUID_SPECIAL}), int/bool planes exact, inf pattern "
         f"exact, float32 max ulp {max_ulp}, max abs err {max_abs}")
    _require(max_ulp == 0, "float32 planes must be bit-equal to the plain version")

    # timing at the main path's shapes: 8 lanes, J=160, S=16, D=16
    L, J, S, D = 8, 160, 16, 16
    x = _rand_inputs(rng, L, J, S, D)
    args = [torch.as_tensor(x[k], device=dev) for k in names]
    kw = dict(b=8.53e-10, eta=1.706e-10, need_overlap=False)

    def _time(impl, graph: bool, reps=40, calls=50):
        """ms per call: in a CUDA graph (device time, no host launch
        overhead) or eagerly (what a tick of the simulator pays); impl
        "empty" is the empty kernel on the same grid (the launch floor)."""
        def run():
            for _ in range(calls):
                if impl == "empty":
                    fs_kernel.empty_launch(L, dev)
                else:
                    fluid_step_core(*args, impl=impl, **kw)
        return _cuda_ms(torch, run, graph, reps) / calls

    timings = {}
    for impl in ("ref", "cuda", "empty", "empty", "cuda", "ref"):
        for graph in (True, False):
            timings.setdefault((impl, graph), []).append(_time(impl, graph))
    kernel_ms = min(timings[("cuda", True)])
    plain_ms = min(timings[("ref", True)])
    floor_ms = min(timings[("empty", True)])
    bound_ms, bound_by, bytes_moved, ops = _fluid_bound(L, J, S, D, False)
    _log(f"timing (L={L} J={J} S={S} D={D}, ms per call, plain/kernel/empty/empty/kernel/"
         f"plain): device time in a CUDA graph of 50 calls: kernel {timings[('cuda', True)]}, "
         f"plain {timings[('ref', True)]}, empty kernel on the same grid (launch floor) "
         f"{timings[('empty', True)]}; eager (host launch included): kernel "
         f"{timings[('cuda', False)]}, plain {timings[('ref', False)]}, empty "
         f"{timings[('empty', False)]}; bound {bound_ms:.8f} ms ({bound_by}: {bytes_moved} B, "
         f"{ops} ops); kernel / launch floor {kernel_ms / floor_ms:.4f}; the kernel before its "
         f"redesign {FLUID_BEFORE_MS} ms; no single PyTorch call computes this function")

    # ---- 4./5. the main path, and the ada batch with the plain step core ---
    # One batch at a time, alone on the card: graph replays from separate
    # processes would take turns on it.  Each batch starts with a launch
    # count of 0 and reports its count just after its run.
    jobs = [("ada", "", "simulate_traces_batched"), ("srsf1", "", "monte_carlo_fluid"),
            ("srsf2", "", "monte_carlo_fluid"), ("ada", "ref", "simulate_traces_batched")]
    t0 = time.perf_counter()
    results = [_paper_batch(*job) for job in jobs]
    launches.launches = 0
    t1 = time.perf_counter()
    recs = monte_carlo_fluid("oversub_fabric", SEEDS, comm="ada", placement="rack_pack",
                             overrides=QUICK_OVERRIDES["oversub_fabric"])
    torch.cuda.synchronize()
    over = {"recs": [dataclasses.asdict(r) for r in recs], "chunks": recs[0].chunks,
            "wall": time.perf_counter() - t1, "launches": launches.launches}
    _log(f"main path: 4 paper batches + oversub_fabric, one at a time, wall "
         f"{time.perf_counter() - t0:.3f} s")

    # ---- 6. small inputs: card vs CPU ---------------------------------------
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

    chunk_steps = fluidsim.FluidSimConfig().chunk_steps
    main_launches, executed = 0, 0
    for (comm, impl, entry), res in zip(jobs, results):
        tag = f"paper {comm} ({entry}{', plain step core' if impl else ''}, CUDA graph)"
        ticks = _summary(tag, res, chunk_steps)
        for cap in res.get("captures", []):
            _log(f"  capture at {cap['lanes']} lanes x {cap['jobs']} jobs: eager first block "
                 f"{cap['warmup_s']:.4f} s, recording {cap['capture_s']:.4f} s, "
                 f"instantiation {cap['instantiate_s']:.4f} s")
        _require(bool(res.get("captures")) == (entry == "simulate_traces_batched"),
                 f"{tag}: captures")
        if impl:
            _require(res["launches"] == 0, f"{tag}: the plain run launched the kernel")
        else:
            main_launches += res["launches"]
            executed += ticks
    executed += _summary("oversub_fabric ada rack_pack (monte_carlo_fluid, D=20, CUDA graph)",
                         over, chunk_steps)
    main_launches += over["launches"]
    ada, ada_ref = results[0], results[3]
    _log(f"paper ada: port chunks {ada['chunks']}, JAX reference on the CPU "
         f"{REFERENCE_CPU_CHUNKS_ADA}")
    _log(f"main path: fluid_step_core launches {main_launches} (counted over graph replays), "
         f"executed ticks {executed}")
    _require(main_launches > 0 and main_launches == executed, "one launch per executed tick")
    _check_same("paper ada, plain step core in the graph", ada_ref, ada)
    _log("paper ada on the card, kernel in the graph vs plain step core in the graph: "
         "identical finished mask, finish ticks and chunk count (the eager run is in phase 10)")

    # ---- 7. host cost: one chunk of the ada batch, alone on the card --------
    paper = [get_scenario("paper", seed=s, **PAPER_CUT) for s in SEEDS]
    cfg = fluid_config(paper[0], comm="ada", placement="lwf")
    batch = fluidsim.stack_traces(
        [fluidsim.trace_from_jobs(s.job_list(), device=dev) for s in paper]
    )
    paper_tick = _tick_cost(torch, "paper ada batch, 8 lanes x 160 jobs", batch, cfg,
                            blocks=(8, 16, 32, cfg.chunk_steps))

    # ---- 8. the step kernel with its overlap plane --------------------------
    overlap_rows = _overlap_kernel_phase(torch, dev)

    # ---- 9. the WFBP and exact k-way main path -------------------------------
    t0 = time.perf_counter()
    wfbp_main, wfbp_launches, wfbp_ticks = _main_wfbp_phase(torch, chunk_steps)
    _log(f"main path, WFBP and k-way: {len(MAIN_WFBP)} batches, one at a time, wall "
         f"{time.perf_counter() - t0:.3f} s; fluid_step_core launches {wfbp_launches} "
         f"(counted over graph replays), executed ticks {wfbp_ticks}")
    _require(wfbp_launches == wfbp_ticks > 0, "one launch per executed tick")

    # ---- 10./11. plain core and eager; card against CPU ----------------------
    _wfbp_checks_phase(torch, dev, {**wfbp_main, "paper ada": ada}, chunk_steps)

    # ---- 12. per tick: one model_zoo chunk through the graph -----------------
    zoo = [get_scenario("model_zoo", seed=s, **ZOO_CUT) for s in SEEDS]
    zoo_cfg = fluid_config(zoo[0], comm="ada", placement="lwf")
    zoo_batch = fluidsim.stack_traces(
        [fluidsim.trace_from_jobs(s.job_list(), fusion=s.fusion, device=dev) for s in zoo])
    zoo_tick = _tick_cost(torch, "model_zoo ada batch, 8 lanes x 48 jobs, 64 MB buckets",
                          zoo_batch, zoo_cfg, plain=False)
    for mode in ("graph", "eager"):
        (w, d, n), (pw, pd, pn) = zoo_tick[mode], paper_tick[mode]
        _log(f"per tick, {mode}: WFBP model_zoo tick wall {w:.6f} ms, device {d:.6f} ms in "
             f"{n:.2f} kernels and copies; monolithic paper tick (phase 7) wall {pw:.6f} ms, "
             f"device {pd:.6f} ms in {pn:.2f}")

    # phase 29's CPU side, in a worker process while the card serves and trains
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    mc_pool = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    cpu_mc = mc_pool.submit(_mc_worker, "cpu")
    try:
        # ---- 13.-17. the SSD decode-step kernel and the serving path ------
        ssd = _ssd_kernel_phase(torch, dev)
        ssd["launches"] = _serve_phases(torch, dev)

        # ---- 18.-23. the flash-attention kernel and dense serving ----------
        flash = _flash_kernel_phase(torch, dev)
        flash["launches"] = _dense_serve_phases(torch, dev)

        # ---- 24. the threefry: card against CPU -----------------------------
        _prng_phase(torch, dev)

        # ---- 25.-28. training ---------------------------------------------
        flash["launches"] += _train_phases(torch, dev)

        # ---- 29. the random placement and monte_carlo_jct -------------------
        random_launches, random_ticks = _random_phase(torch, dev, chunk_steps, cpu_mc)
        main_launches += random_launches

        # ---- 30. sampled serving --------------------------------------------
        _sampled_phase(torch, dev)
    finally:
        mc_pool.shutdown(cancel_futures=True)

    line = {"kernels": [{
        "name": "fluid_step_core",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fluidstep/csrc/fluid_step.cu",
        "replaces": "src/repro/kernels/fluidstep/kernel.py:35",
        "launches": main_launches + wfbp_launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, ssd, flash]}
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
