"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases (any failed check raises, so the exit code is non-zero):

1. the card (``nvidia-smi`` name and power limit, torch and CUDA versions);
2. the build of the three CUDA kernels from their sources, ``src/repro_torch/
   kernels/{fluidstep,ssd,flash_attention}/csrc`` (one ``nvcc`` each,
   sm_90a, started together), with their build times, and the registers
   and spills of the flash kernel's bf16 D-64, D-128 and D-256 tensor-core
   instantiations (llama's shape; olmoe's, jamba's and arctic's; gemma's),
   which must not spill;
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
   finish ticks; run in phase 11, beside its workers); the CPU path is the
   one the tests hold to the JAX reference;
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
    chunk count identical to phase 9; the eager kway2 run at half phase
    9's depth (iterations 50-300), held to the same batch through the
    graph, so that phases 10-11 fit the time limit;
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
    the CPU (identical finish ticks; run in phase 11, beside its workers), and
    ``monte_carlo_jct(n_seeds=8, n_jobs=16)`` on the card and on the CPU
    (the CPU side in a worker process from phase 8 to the end of phase
    11, the card side beside phases 31-32's workers): identical sampled
    traces and ``per_seed``;
30. sampled serving (``greedy=False``, temperature 0.8) at full width for
    both families (every token in the vocab), and on the reduced float32
    configs on the card (plain path) and the CPU: identical tokens, or the
    step and the logit margin where they part, and the phase fails.

31. the event engine (``run_scenario_event``) on the host at registered
    size, seed 0: ``paper`` (160 jobs, 1000-6000 iterations, 16 x 4 GPUs)
    under ada, srsf1 and srsf2 with LWF-1, and ``oversub_fabric`` under ada
    with LWF_RACK: every job finishes; avg JCT, wall and events per second
    beside the host CPU's model name (these runs and phase 32's go to 4
    worker processes started when phase 29 ends, so they run beside no
    card phase);
32. phase 4's 8 paper job lists (iterations cut the same way) through the
    event engine on the host under ada, srsf1 and srsf2: both backends
    finish every job; the fluid / event avg JCT ratio per seed printed
    beside the reference's bound of 2.0 (not held: the reference bounds
    other cells), and each seed's fluid avg JCT on the card held equal to
    the JAX reference's on the CPU (``scripts/fluid_event_reference.py``);
33. ``repro_torch.launch.multi_job.run_multi_job`` on the reference's
    default jobs (llama3.2-1b on 4 GPUs for 300 iterations and mamba2-130m
    on 2 for 500 at full width, olmoe-1b-7b on 8 for 200 at its reduced
    config, the reference's default, since at full width its init and the
    profiling copies would hold ~136 GB), batch 8 x seq 512, ada over the
    virtual 10GbE fabric, 4 executed steps, the flash launch count reset
    just before: exactly (16 + 2) x (1 warm-up + 3 timed + 4 executed)
    launches, every job completes in the schedule, every loss finite,
    each job's first executed loss equal to
    its warm-up loss bit for bit (the same init on the same batch); the
    card's profiles, peak memory, and the avg JCT of ada, srsf1 and srsf2
    schedules of those profiles; then the same profiles scheduled with two
    more jobs that span servers (llama3.2-1b on 8 GPUs, mamba2-130m on 12):
    every job completes under each policy, and ada starts at least one
    all-reduce under contention (the gating decides);
34. the flash kernel at head dim 128, at olmoe-1b-7b's prefill shape (BH
    128 = batch 8 x 16 heads, S = T 512) and jamba-v0.1-52b's (BH 256 =
    batch 8 x 32 heads), and the SSD step at jamba's decode shape (B 8, H
    128, P 64, N 128), against their plain versions in float32 and bf16
    (the SSD step also in place on a view of a stacked 7-mixer cache,
    bit-equal to out of place); then timed in CUDA graphs beside their
    bounds, the flash kernel beside SDPA;
35. the MoE serving main path: ``serve_batch`` at full-width olmoe-1b-7b
    (16 layers, 64 experts top-8, 6,816,071,680 parameters by the analytic
    count; weights drawn on the card, timed), batch 8, prompt 512, 64 new
    tokens, greedy, bf16, each decode step (its dispatch included)
    replayed from a CUDA graph, then eagerly: identical tokens, exactly 16
    flash launches and no SSD launch; the decode step beside its bytes
    bound (every expert's weights and the cache read once); sampled
    serving (temperature 0.8: every token in the vocab); one prefill and
    decode steps under the profiler as in phase 23;
36. the hybrid serving main path: jamba-v0.1-52b at full width cut to one
    pattern block of 8 of its 32 layers (the 32 layers' 102 GB of bf16
    weights do not fit the card): 1 attention layer, 7 SSD mixers at H
    128, 4 MoE (16 experts top-2) and 4 gated MLPs; as phase 35, with
    exactly 1 flash launch and 7 x 63 = 441 SSD launches over the graph's
    replays, each in place on its view of the stacked cache;
37. the reduced olmoe and jamba configs in float32 with the plain path,
    served greedily and sampled (0.8) on the card and on the CPU:
    identical tokens;
38. the MoE training main path: ``train`` at full-width olmoe-1b-7b cut to
    4 of its 16 layers (at 16, bf16 weights and grads with float32 moments
    take 76 GiB), batch 8 x seq 512, float32 moments, lr 3e-4,
    ``remat="none"``, 8 steps: exactly 4 x 8 flash launches, every loss
    and router aux loss finite, the aux > 0; step ms and peak memory;
39. the flash kernel at gemma-7b's prefill shape (BH 128 = batch 8 x 16
    heads, S = T 512, D 256: the DP-256 tensor-core instantiation) and
    arctic-480b's (BH 512 = batch 8 x 64 padded query heads, D 128)
    against its plain version (float32 2e-5, bf16 3e-2) and, in bf16, its
    tensor-core emulation (1e-2, ``tests/test_torch_flash_attention_cuda.py``);
    then timed in CUDA graphs beside the bound, the plain version and SDPA;
40. the dense serving main path at full-width gemma-7b (28 layers, GeGLU,
    head dim 256, 8,537,677,824 parameters) as phase 35: identical tokens
    through the decode graph and eagerly, exactly 28 flash launches, every
    one the D-256 tensor-core kernel (by the profiler's kernel names);
41. arctic-480b at full width cut to 1 of its 35 layers (13,840,562,176
    parameters, 27.7 GB in bf16): 128 experts top-2 beside the dense
    residual FFN, 64 padded query heads; as phase 40, exactly 1 flash
    launch (the D-128 kernel at BH 512);
42. llama3.2-1b-swa8k (the reference's long-context variant, window
    8,192) at full width, batch 2, 64 new tokens: a prompt of 12,288 (the
    sliding prefill, the cache packed from the last 8,192 keys) and one of
    8,160 (the ring wraps at decode step 32, inside the decode graph); each
    through the decode graph and eagerly, identical tokens, no flash launch
    (the sliding prefill is plain PyTorch); a profiled prefill and decode
    steps at each;
43. the reduced arctic, gemma, phi4 and yi configs, and the reduced llama
    and gemma with a window of 16 (prompt 32, 8 new tokens: the sliding
    prefill and the ring's wrap), as phase 37: identical tokens on the card
    and on the CPU;
44. the flash kernel under the full mask (``causal=False``) at the three
    shapes the new models give it: the VLM's cross attention (BH 256, S
    512, T 1,601, D 128: a last key tile of one valid key), seamless's
    encoder (BH 128, S = T 3,000, D 64) and its decoder's cross attention
    (BH 128, S 512, T 3,000), against its plain version and, in bf16, its
    tensor-core emulation, as phase 39; then timed in CUDA graphs beside
    the bound (S * T pairs), the plain version and SDPA;
45. the VLM serving main path: llama-3.2-vision-11b at full width (40
    layers, every 5th a gated cross-attention layer over 1,601 vision
    tokens; 9,252,966,408 parameters, 18.5 GB in bf16), batch 8, prompt
    512, 64 new tokens, the stub image embeddings (8, 1601, 4096) drawn as
    ``serve_batch`` draws them; as phase 40: identical tokens through the
    decode graph and eagerly, exactly 40 flash launches (32 causal, 8 full
    mask over T 1,601, counted by mask), the decode step beside its bytes
    bound, a profiled prefill and decode steps, and the per-step repeat of
    the cross cache's heads timed alone beside the decode step;
46. the enc-dec serving main path: seamless-m4t-large-v2 at full width (24
    encoder layers over 3,000 stub audio frames, 24 decoder layers with
    cross attention; 1,371,662,336 parameters), as phase 45: exactly 72
    flash launches (24 full-mask encoder, 24 causal, 24 full-mask cross),
    the encoder's share of the prefill's device time, the decode step
    beside its bytes bound (the cross cache, 2.36 GB, outweighs the
    decoder's weights);
47. the reduced vision and audio configs (their wq and wk scaled by 1/4,
    the VLM's cross gates at 0.5, on both sides), as phase 37: identical
    tokens on the card and on the CPU;
48. rematerialisation on the training main path: phase 25's llama3.2-1b
    run (batch 8 x seq 512, 8 steps, bf16) again with ``remat="dots"``
    (each block selectively checkpointed: the products with no batch
    dimension saved, the rest recomputed) and with ``remat="block"``,
    beside phase 25's ``"none"``: step 1's loss identical to phase 25's,
    the later losses within phase 26's bar (0.15 of the loss, relative),
    ``torch.cuda.max_memory_allocated`` ordered block < dots < none, and
    exactly 16 layers x 8 steps x 2 flash launches per run (the forward,
    and the recompute's forward in the backward pass: the kernel's custom
    op is one the dots policy does not save, so the checkpoint runs it
    again); step ms and peak memory of the three;
49. the dynamic event engine on the host, seed 0, comm ada, at registered
    size: ``preemption_gain`` under ``sched`` static and
    preemptive_srsf, ``elastic_surge`` under static and elastic, the three
    ``chaos_*`` scenarios (fault injection) and the three
    ``trace_replay_*`` (arrivals streamed from their sources): each run's
    avg JCT and its preemption, resize, fault, cancellation and censored
    counts ``==`` the JAX reference's on the CPU
    (``scripts/event_dynamic_reference.py``), in phase 31-32's worker
    processes;
50. the rest of the event engine and the sweep runner: (a) ``sweep
    (["fusion_sweep", "model_zoo"], comms=("ada", "srsf2"), seeds=(0, 1),
    backend="fluid")`` at phase 11's overrides, 8 cells through
    ``run_cell`` on the card (the fluid path's new entry point; the
    launch count set to 0 just before, one launch per executed tick), in
    this process while phases 31-32's workers run: every record, wall
    aside, ``==`` the port's own CPU run of the same cells (worker
    processes of phases 10-11) and within 1e-6 relative of the JAX
    reference's ``run_cell`` on the CPU, finished counts exact; (b) on the
    host, registered size, seed 0, ada, in phase 31-32's workers:
    ``paper`` with ``comm_chunks=4`` and with ``contention_domain="link"``,
    ``paper`` and ``preemption_gain`` (preemptive_srsf) under
    ``gating="rescan"`` and ``workloads="rescan"`` (each also ``==`` its
    incremental run of phase 31 or 49: avg JCT, events, every finish
    time; ``paper`` under the gating rescan at half its registered
    depth, iterations 500-3000, and ``==`` an incremental run of that
    depth beside it, REST_CUTS), ``paper`` and
    ``chaos_recovery_storm`` under
    ``observe=ObsConfig.full()`` (``==`` the unobserved run, mean JCT parts
    the reference's, the Chrome trace written to a temporary file, loaded
    back, the reference's event count; observed and unobserved wall times
    printed beside the host CPU), and ``trace_replay_philly`` under
    ``profile_phases=True`` (``replay_summary``'s keys and values the
    reference's); (c) after the card phases, the event ``sweep(["paper",
    "oversub_fabric"], comms=("ada", "srsf1", "srsf2"))`` at QUICK size in
    EVENT_WORKERS spawned processes and in this process: every record,
    wall aside, ``==`` and the reference's.  The constants come from
    ``scripts/event_rest_reference.py``;
51. sharded training through a one-rank mesh, in a spawned process (this
    one keeps no process group; the machine has one card, and NCCL
    refuses two ranks on one device) whose imports run beside phases
    25-28: full-width llama3.2-1b (batch 8 x seq 512, 8 steps, bf16,
    ``remat="none"``, deterministic algorithms in all three runs) trained
    plain through ``make_train_step``, then, on an NCCL group of one rank
    (``HashStore``, no TCP port), through ``train(mesh_shape=(1, 1))``
    (``dp``: DTensor parameters, moments and batches, all replicated) and
    under ``tp`` through ``make_train_step`` (every head, ffn and vocab
    dim ``Shard`` over the size-1 "model" dim, so ``local_map`` and the
    redistributions run, the loss on the vocab-parallel path): both runs'
    losses bit-identical to the plain run's (every collective over one
    rank is the identity, and so is every reduction of the loss), exactly 16 x
    8 flash launches in each; step ms (median of steps 3-8), peak memory,
    and one profiled step's device ms, NCCL kernels and idle share of the
    three;
52. the dry-run beside the card: (a) in phase 51's worker, on the same
    one-rank NCCL mesh, full-width llama3.2-1b served greedily through
    ``make_prefill_step`` and ``make_serve_step`` (batch 8, prompt 512, 8
    tokens, bf16): plain, then on DTensor parameters under ``tp`` with the
    prefill's cache placed by ``place_cache`` and decoded with
    ``decode_constrain`` (the softmax as partial reductions over the
    sequence shards): tokens identical, 16 flash launches each (the
    prefill's); (b) after the card phases, in this process (meta shards on
    fake process groups, no card work): ``launch/dryrun.py``'s trace of
    phase 25's training step, phase 20's prefill and one decode step on a
    fake one-rank mesh, and of ``llama32_1b|train_4k|single|tuned`` and
    ``llama32_1b|prefill_32k|single|tuned`` on the fake (32, 8) H100 mesh
    and, unsharded, on a fake one-rank mesh: counted FLOPs,
    ``model_flops``, the useful ratio, ``compute_s`` and ``memory_s``
    beside phase 28's device time of a step, ``peak_bytes`` beside phase
    25's ``torch.cuda.max_memory_allocated``; every trace completes with
    positive counts and ``run_useful_ratio`` <= 1 (``model_flops`` less
    the prefill's vocab projection of the prompt tokens it does not
    project), the largest ops by FLOPs printed; no rank repeats work of
    another (the 256 ranks' FLOPs at most 1.01 times the unsharded
    step's), the useful ratios and collective bytes printed beside those
    of the port before its products were pinned (:data:`UNPINNED`) and,
    for ``train_4k``, before its loss was partitioned (:data:`GATHERED`);
    no all-gather of ``train_4k`` reaches a rank's (B, S, V) float32
    logits.

Phases run in the order of their numbers, but for 31, 32, 49 and 50 (a, b),
which run after 29, 48 and 51 (with 52 (a)), which run after phase 25's
main path, phase 6 and phase 29's small batch, which run in phase 11
while its workers finish, phase 29's ``monte_carlo_jct`` on the card,
which runs beside phases 31-32's workers (checks, not timed), and 50 (c)
and 52 (b), which run last.  Worker processes run only during phases
8-11 (started at phase 8, importing, phase 29's CPU side from phase 8,
the rest from phase 10, with phase 50 (a)'s CPU side) and 31-32 (49 and
50 (b) with them, beside phases 50 (a)'s and 29's card runs), and phase
51's (its imports beside phases 25-28, its run alone), so the phases
that time host-bound work (7, 12-30, 33) have the host to themselves.  The
served models' prefill windows (phases 35-36, 40-41, 45-46), whose flash
records are counted, run the prefill once as a
discarded warm-up step before the one they report (in a whole run a
window loses its first records while CUPTI starts).  A profiler window
that shows no device time at all (CUPTI drops one now and then), or too
few flash records for a served model's prefill, is logged and taken
again, up to 3 windows, before the check that needs it fails.

Then the kernels line (JSON; the flash kernel's launches are the serving,
training (phases 48's and 51's too, and 52 (a)'s sharded prefill) and
multi_job main paths' of every family, the
SSD step's those of mamba and jamba, the fluid step's include phase 29's
and phase 50 (a)'s;
phases 34's, 39's and 44's shapes under "shapes") and, last, ``{"ok":
true, "device": ...}``.
Exits non-zero without printing a result when CUDA is unavailable.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
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


_START = time.perf_counter()


def _mark(phases: str) -> None:
    """Log the start of a group of phases, in seconds since the script began."""
    _log(f"-- phase {phases} at {time.perf_counter() - _START:.1f} s")


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


#: profiler windows taken before a check that needs device time fails
PROFILE_WINDOWS = 3


def _profile(torch, run, what: str, required: bool = True, prepare=None, complete=None,
             warmup: bool = False, host: bool = True):
    """``run()`` under ``torch.profiler`` (host and CUDA activity; CUDA only
    without ``host``, for a caller that reads the device records alone),
    then a synchronize, inside the window (``prepare()`` and a synchronize
    before each run, outside the window).  Returns the profile and its
    averages on the device.  In a whole chip_smoke.py run a window loses its first
    kernel records while CUPTI starts (42-44 of gemma's prefill's 2,925,
    and of a VLM prefill's its first flash launch; a fresh process loses
    none): with ``warmup`` each window first runs ``run()`` once as a
    discarded warm-up step, then reports the second run.  CUPTI now and
    then also hands back a window with no device record at all: such a
    window, or one where ``complete(averages)`` is false, is logged and
    taken again, up to ``PROFILE_WINDOWS`` in all.  With ``required``,
    the check fails if no window shows device time; without it, the last
    window is returned as it is; the caller checks what ``complete``
    tests."""
    from torch.profiler import ProfilerActivity, profile, schedule

    runs = 2 if warmup else 1
    kw = {"schedule": schedule(wait=0, warmup=1, active=1, repeat=1)} if warmup else {}
    for window in range(1, PROFILE_WINDOWS + 1):
        activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
        with profile(activities=activities, **kw) as prof:
            for i in range(runs):
                if prepare is not None:
                    prepare()
                    torch.cuda.synchronize()
                if i == 1:
                    prof.step()  # the warm-up run ends, the reported one begins
                run()
                torch.cuda.synchronize()
            if warmup:
                prof.step()
        # the step's own range shows as a device-side annotation: not a kernel
        on_device = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.key.startswith("ProfilerStep")]
        has_time = sum(e.self_device_time_total for e in on_device) > 0
        if has_time and (complete is None or complete(on_device) or window == PROFILE_WINDOWS):
            return prof, on_device
        _log(f"the profiler saw {'too few records' if has_time else 'no device time'} in "
             f"{what} (window {window} of {PROFILE_WINDOWS})")
    _require(not required, f"the profiler saw the device time of {what}")
    return prof, on_device


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


def _serve_both(torch, tag, cfg, params, counters) -> dict:
    """The serving main path through ``serve_batch`` (batch 8, prompt 512,
    64 new tokens): with the decode step replayed from its CUDA graph (the
    main path; each counter's ``launches`` reset just before it and read
    just after), then eagerly (``_graph=False``), whose tokens must be
    identical.  Returns the graph run's dict with ``launches`` added, one
    count per counter."""
    from repro_torch.launch.serve import serve_batch

    bsz, plen, gen, seed = (SERVE[k] for k in ("batch", "prompt_len", "gen", "seed"))
    for counter in counters:
        counter.launches = 0
    res = serve_batch(cfg, bsz, plen, gen, seed, params=params)
    res["launches"] = tuple(counter.launches for counter in counters)
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


def _decode_modes(torch, tag, lm, params, cache0, tok, flags, key, expect_key) -> dict:
    """Phases 17 and 23: decode steps through the runner's CUDA graph and
    eagerly, from copies of one prefill cache, each mode's steps greedy
    from ``tok``: wall per step (3 rounds of 10, modes in turns), then one
    step under the profiler: device time, kernels and copies per step, the
    share of the kernels whose name holds ``key`` (there must be some iff
    ``expect_key``), device idle share.  Returns each mode's device ms."""
    from repro_torch.launch.serve import _DecodeRunner
    from repro_torch.launch.steps import make_serve_step

    decode = make_serve_step(lm, flags)
    runners, walls, device = {}, {}, {}
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
            _, on_device = _profile(torch, r.step, f"the {tag} decode step ({mode})")
            device_ms = sum(e.self_device_time_total for e in on_device) / 1e3
            device[mode] = device_ms
            key_ms = sum(e.self_device_time_total for e in on_device if key in e.key) / 1e3
            n_kernels = sum(e.count for e in on_device)
            _require((key_ms > 0) == expect_key, f"{key} kernel time in the {tag} decode step")
            cap = (f"; capture: eager first step {r.timing['warmup_s']:.4f} s, recording "
                   f"{r.timing['capture_s']:.4f} s, instantiation "
                   f"{r.timing['instantiate_s']:.4f} s" if mode == "graph" else "")
            _log(f"{tag} decode step, {mode} (batch {tok.shape[0]}, full width): wall "
                 f"{walls[mode]} ms; device time {device_ms:.4f} ms in {n_kernels} kernels and "
                 f"copies, of which {key} {key_ms:.4f} ms ({key_ms / device_ms:.4f}); device "
                 f"idle share {1 - device_ms / min(walls[mode]):.4f}{cap}")
            top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:6]
            for e in top:
                _log(f"  {e.key[:80]}: {e.count} x, {e.self_device_time_total / 1e3:.4f} ms")
            r.release()
    return device


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
    res = _serve_both(torch, cfg.name, cfg, params, (ssd_decode_step_cuda,))
    launches = res["launches"][0]
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
#: causal and D 30 (staged without 16-byte copies); then the full mask over
#: key lengths one past a 64-key tile (T 1,601) and with a last tile of 56
#: keys (T 3,000), at D 128 and 64
FLASH_SWEEP = [(4, 256, 256, 64, True), (3, 200, 200, 64, True), (2, 128, 384, 128, False),
               (1, 64, 512, 256, False), (2, 512, 512, 64, True), (2, 128, 384, 64, True),
               (2, 384, 128, 64, True), (256, 512, 512, 64, True), (2, 130, 70, 64, True),
               (2, 70, 130, 64, True), (2, 200, 200, 128, True), (3, 77, 91, 30, True),
               (2, 64, 1601, 128, False), (2, 200, 3000, 64, False)]
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


def _flash_bound(bh, s, t, d, elt, causal=True):
    """(bound ms, "bytes" or "operations", bytes, ops) of attention: q, k,
    v read once and the output written once; two products of 2 * D
    operations for each (query, visible key) pair: top-left causal, or all
    S * T pairs without the mask."""
    nbytes = (2 * bh * s * d + 2 * bh * t * d) * elt
    pairs = sum(min(i + 1, t) for i in range(s)) if causal else s * t
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
    res = _serve_both(torch, cfg.name, cfg, params, (flash_attention_cuda,))
    launches = res["launches"][0]
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
            x = lm._apply_block(x, bp, flags=flags["ref"], collect_kv=False)[0]
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
                    xs[impl] = lm._apply_block(xs[impl], bp, flags=f, collect_kv=False)[0]
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
        _, on_device = _profile(torch, lambda: prefill(params, {"tokens": tokens}),
                                "the prefill")
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
#: phase 10's eager paper kway2 run (~4.5 ms a tick): half PAPER_CUT's
#: iterations, held to the same batch through the graph
KWAY_EAGER_CUT = dict(min_iters=50, max_iters=300)
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

    def _device_ms(r, mode):
        """Device time per tick by the profiler (kernels and copies), and
        their number per tick: device records only (gathering an eager
        chunk's host records, ~250 ops a tick, took ~30 s of phase 7), the
        chunk run once as a discarded warm-up first (without host records
        a window lost ~3 ticks' kernel records while CUPTI started)."""
        def reset():
            for n, v in r.state.items():
                v.copy_(state0[n])

        _, on_device = _profile(torch, r.run_chunk, f"a chunk of the {tag} ({mode})",
                                required=mode == "eager", prepare=reset, warmup=True,
                                host=False)
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
        dev_ms, n_ops = _device_ms(r, mode)
        idle = f"{1 - dev_ms / wall:.4f}" if dev_ms > 0 else "not measured"
        _log(f"host cost, {mode} ({tag}, one chunk of {ticks} ticks in blocks of {r.block}, "
             f"alone on the card): wall per tick {[round(w, 6) for w, _ in per_tick[mode]]} ms, "
             f"CUDA events per tick {[round(e, 6) for _, e in per_tick[mode]]} ms; device time "
             f"per tick (profiler) {dev_ms:.6f} ms in {n_ops:.2f} kernels and copies; device "
             f"idle share {idle} (events: {1 - dev_ms / events:.4f})")
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
    import importlib

    # the module: the package's ``sweep`` attribute is the sweep function
    sweep_mod = importlib.import_module("repro_torch.scenarios.sweep")

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


#: phases 8-11's worker processes
WFBP_WORKERS = 7


def _pool_imports() -> None:
    """Phases 8-11's workers, started at phase 8: the imports their runs
    need (no CUDA call: the card is the main process's meanwhile)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch  # noqa: F401

    from repro_torch.core import fluidsim  # noqa: F401
    from repro_torch.scenarios import sweep  # noqa: F401


def _wfbp_checks_phase(torch, dev, main, chunk_steps, pool, mc_cpu) -> tuple:
    """Phases 10 and 11, and phase 5's eager run.  The host-bound runs
    (the eager runs of the paper ada, model_zoo ada and paper kway2
    batches, the CPU side of phase 11 and phase 50's CPU side of the
    sweep's fluid cells) go to ``pool``'s worker processes, started
    together, while this process replays the plain step core's graphs and
    phase 11's card side, so the card is shared meanwhile (their walls are
    printed, not kept; phase 7 times an eager tick alone), and then phase 6
    and phase 29's small batch (checks, card against CPU) while the
    workers finish.  ``mc_cpu``, phase 29's CPU side of
    ``monte_carlo_jct``, runs in the same pool since phase 8.  Returns phase 29's and phase 50's CPU sides, so that
    no worker runs beside the phases that time host-bound work after phase
    12."""
    reruns = (("model_zoo ada", "model_zoo", SEEDS, ZOO_CUT, "ada"),
              ("paper kway2", "paper", KWAY_SEEDS, PAPER_CUT, "kway2"))
    cpu_jobs = [(name, seeds, over, comm, fast_kw, "cpu", None)
                for name, seeds, over in CARD_CPU_CELLS for comm, fast_kw in CARD_CPU_POLICIES]
    eager_runs = (("paper kway2", "paper", KWAY_SEEDS, KWAY_EAGER_CUT, "kway2"),
                  ("paper ada", "paper", SEEDS, PAPER_CUT, "ada"),
                  ("model_zoo ada", "model_zoo", SEEDS, ZOO_CUT, "ada"))
    t0 = time.perf_counter()
    eager = [pool.submit(_batch_worker, (name, seeds, over, comm, {}, "cuda", False))
             for _, name, seeds, over, comm in eager_runs]
    # one worker per scenario: the 8 cells run one after another in each
    rest_cpu = [pool.submit(_rest_fluid_sweep, "cpu", (name,))
                for name in REST_FLUID["scenarios"]]
    on_cpu = [pool.submit(_batch_worker, job) for job in cpu_jobs]
    # ---- 10. the plain step core in the graph -------------------------------
    for tag, name, seeds, over, comm in reruns:
        res = _batch_worker((name, seeds, over, comm, {"kernel": "ref"}, "cuda", None))
        _require(res["launches"] == 0, f"{tag}: the plain run launched the kernel")
        _check_same(f"{tag}, plain step core in the graph", res, main[tag])
        _log(f"{tag}, plain step core in the graph: identical finished mask, finish ticks "
             f"and chunk count ({res['chunks']}); wall {res['wall']:.3f} s (card shared)")
    # the graph side of the shallower eager kway2 run
    eager_ref = {tag: main[tag] for tag, *_ in eager_runs}
    eager_ref["paper kway2"] = _batch_worker(
        ("paper", KWAY_SEEDS, KWAY_EAGER_CUT, "kway2", {}, "cuda", None))
    # ---- 11. card side -------------------------------------------------------
    on_card = [_batch_worker((name, seeds, over, comm, fast_kw, "cuda", None))
               for name, seeds, over, comm, fast_kw, _, _ in cpu_jobs]
    # ---- 6. and 29's small batch: card against CPU, while the workers run -
    _mark("6, beside phases 10-11's workers")
    _card_cpu_phase()
    _mark("29 (small batch), beside phases 10-11's workers")
    _random_small_phase()
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
    for (tag, _, _, over, _), fut in zip(eager_runs, eager):
        res = fut.result()
        ticks = res["chunks"] * chunk_steps
        _require(res["launches"] == ticks, f"{tag} eager: one launch per executed tick")
        _check_same(f"{tag}, kernel eagerly", res, eager_ref[tag])
        _log(f"{tag} (iterations {over.get('min_iters')}-{over.get('max_iters')}), kernel "
             f"eagerly (worker process, card shared): finished mask, finish ticks and "
             f"chunk count identical to the graph's; wall {res['wall']:.3f} s, "
             f"{res['wall'] / ticks * 1e3:.4f} ms per tick, {res['launches']} launches")
    mc = mc_cpu.result()
    rest = [r for fut in rest_cpu for r in fut.result()]
    _log(f"phases 10-11: {time.perf_counter() - t0:.3f} s wall (phase 29's CPU side, begun "
         f"at phase 8, {mc['wall']:.3f} s; phase 50's CPU side {sum(r['wall_s'] for r in rest):.3f} "
         f"s in {len(rest)} cells)")
    return mc, rest


# ---------------------------------------------------------------------------
# The threefry, training, and the threefry's users (phases 24-30)
# ---------------------------------------------------------------------------

#: the training main path: batch 8 x seq 512 (the serve shape: BH 256, S = T
#: 512, D 64 in llama's attention), the reference's default lr, 8 steps
TRAIN = dict(steps=8, batch=8, seq=512, lr=3e-4, seed=0)
#: phase 52 (a): llama3.2-1b served through the one-rank mesh, greedy
MESH_SERVE = dict(batch=8, prompt=512, gen=8)
#: what phases 25 and 28 measured, for phase 52 (b) to print beside its traces
MEASURED: dict = {}
#: phase 52 (b)'s (32, 8) combos as recorded before every product of a
#: model-sharded weight was pinned, under DTensor's own plan (torch 2.11 on
#: an H100's host, ``python -m repro_torch.launch.dryrun --no-correction``;
#: not measured by this script, printed as the "before" of its "after"):
#: useful ratio and collective bytes a rank
UNPINNED = {"train_4k": (0.1194, 1.7955e11), "prefill_32k": (0.1428, 2.8320e10)}
#: phase 52 (b)'s ``train_4k`` collective bytes a rank with the products
#: pinned but the loss's logits gathered whole over "model" for it (this
#: phase's count on an H100's host and ``python -m
#: repro_torch.launch.dryrun`` under torch 2.13 alike; printed as the
#: "before" of its "after")
GATHERED = {"train_4k": 2.853635e10}
#: the paper batch of phase 4 under the random placement (phase 29), its
#: jobs cut from 32 to 16 a lane on both sides so that phases 8-11 fit the
#: time limit
MC_JCT = dict(n_seeds=8, n_jobs=16)
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


def _train_main(torch, cfg, counter, remat="none", mesh_shape=(1, 1)) -> dict:
    """One run of ``repro_torch.launch.train.train`` on the card (the user's
    entry point), its printed log kept: losses, wall, per-step ms from the
    logged tok/s (each step synchronises on its loss), peak memory and,
    with ``counter``, the kernel's launches from a count of 0 just before.
    With a process group (phase 51) the run goes through ``mesh_shape``."""
    from repro_torch.launch.train import train

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    if counter is not None:
        counter.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        losses = train(cfg, log_every=1, remat=remat, mesh_shape=mesh_shape, **TRAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.launches if counter is not None else None
    log = buf.getvalue()
    tok_s = [float(v) for v in re.findall(r"tok/s=([0-9.]+)", log)]
    gnorm = [float(v) for v in re.findall(r"gnorm=([0-9.e+-]+)", log)]
    aux = [float(v) for v in re.findall(r"aux=([0-9.e+-]+|nan|inf)", log)]
    toks = TRAIN["batch"] * TRAIN["seq"]
    step_ms = [toks / v * 1e3 for v in tok_s]
    peak = torch.cuda.max_memory_allocated()
    where = "" if tuple(mesh_shape) == (1, 1) and not _group_up() else f", mesh {mesh_shape}"
    _log(f"train {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}), batch "
         f"{TRAIN['batch']} x seq {TRAIN['seq']}, bf16 weights from PRNGKey({TRAIN['seed']}), "
         f"float32 moments, lr {TRAIN['lr']}, remat {remat!r}{where}: losses {losses}; wall "
         f"{wall:.3f} s (init and the first step's warm-up included); step ms {step_ms}; "
         f"tok/s {tok_s}; steady state (steps 2-{TRAIN['steps']}) median "
         f"{float(np.median(step_ms[1:])):.3f} ms per step = "
         f"{float(np.median(tok_s[1:])):.1f} tok/s; torch.cuda.max_memory_allocated "
         f"{peak} B ({peak / 2**30:.3f} GiB); grad norms before clipping {gnorm}; mean of the "
         f"last 3 losses minus the first {float(np.mean(losses[-3:])) - losses[0]}"
         + (f"; router aux losses {aux}" if aux else ""))
    _require(len(losses) == TRAIN["steps"] and len(tok_s) == TRAIN["steps"], "train steps")
    _require(all(np.isfinite(losses)) and all(np.isfinite(gnorm)), f"{cfg.name}: finite losses")
    return {"losses": losses, "step_ms": step_ms, "tok_s": tok_s, "peak": peak,
            "launches": launches, "wall": wall, "gnorm": gnorm, "aux": aux}


def _remat_phase(torch, cfg, none_run, counter) -> int:
    """Phase 48: phase 25's training run again under ``remat="dots"`` and
    ``"block"``.  Returns the flash kernel's launches of the two runs."""
    runs = {"none": none_run}
    for remat in ("dots", "block"):
        runs[remat] = _train_main(torch, cfg, counter, remat=remat)
    expected = cfg.n_layers * TRAIN["steps"] * 2
    for remat in ("dots", "block"):
        r = runs[remat]
        rel = [abs(a - b) / max(1.0, abs(b)) for a, b in zip(r["losses"], none_run["losses"])]
        _log(f"train {cfg.name} remat {remat!r} vs 'none' (phase 25): step 1 loss "
             f"{r['losses'][0]} vs {none_run['losses'][0]}; relative loss differences per step "
             f"{rel} (bar {BF16_BAR} after step 1); flash launches {r['launches']} (expected "
             f"{cfg.n_layers} layers x {TRAIN['steps']} steps x 2 = {expected}: the forward, and "
             f"the checkpoint's recompute of it in the backward pass)")
        _require(r["losses"][0] == none_run["losses"][0],
                 f"remat {remat}: step 1's loss identical to phase 25's")
        _require(max(rel) <= BF16_BAR, f"remat {remat}: losses within the bar of phase 25's")
        _require(r["launches"] == expected, f"remat {remat}: two flash launches per layer "
                 "and step")
    peaks = {k: v["peak"] for k, v in runs.items()}
    median_ms = {k: float(np.median(v["step_ms"][1:])) for k, v in runs.items()}
    _log(f"train {cfg.name} (batch {TRAIN['batch']} x seq {TRAIN['seq']}, {TRAIN['steps']} "
         f"steps) by remat: steady-state step ms (median of steps 2-{TRAIN['steps']}) "
         f"{median_ms}; step ms {({k: v['step_ms'] for k, v in runs.items()})}; "
         f"torch.cuda.max_memory_allocated B {peaks} = "
         f"{({k: round(v / 2**30, 3) for k, v in peaks.items()})} GiB; dots / none step time "
         f"{median_ms['dots'] / median_ms['none']:.4f}, block / none "
         f"{median_ms['block'] / median_ms['none']:.4f}")
    _require(peaks["block"] < peaks["dots"] < peaks["none"],
             "peak memory ordered block < dots < none")
    return 2 * expected


def _group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _mesh_steps(torch, cfg, base, mesh, strategy, steps, counter) -> dict:
    """Phase 51: ``steps`` training steps of full-width ``cfg`` through
    ``make_train_step`` from ``base`` (TRAIN's seed's weights, kept in host
    memory and copied to the card for each run), on TRAIN's batches, plain
    (``mesh`` None) or with parameters, moments and batches placed on
    ``mesh`` under ``strategy``; then one more step under the profiler.
    Returns the losses, per-step wall ms (each step waits for its loss),
    peak memory, the flash kernel's launches over the timed steps, and the
    profiled step's device ms, NCCL kernels and their ms."""
    from repro_torch.data import SyntheticLMDataset, make_train_iterator
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import tree_map
    from repro_torch.models.lm import LM, RunFlags
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.sharding.rules import (
        ShardingStrategy, distribute, moment_shardings, param_shardings, token_sharding,
    )

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda", torch.cuda.current_device())
    lm = LM(cfg)
    opt_cfg = AdamWConfig(lr=TRAIN["lr"])
    params = tree_map(lambda t: t.to(dev, non_blocking=True), base)
    shardings, moments = None, None
    if mesh is not None:
        st = ShardingStrategy.from_name(strategy)
        p_sh = param_shardings(lm.logical_axes(), params, mesh, st)
        moments = moment_shardings(p_sh, params, mesh, st)
        params = tree_map(distribute, params, p_sh)
        tok = token_sharding(mesh, TRAIN["batch"])
        shardings = {"tokens": tok, "labels": tok}
    opt = adamw_init(params, opt_cfg, moments)
    step = make_train_step(lm, opt_cfg, RunFlags(remat="none", q_chunk=min(512, TRAIN["seq"])))
    it = make_train_iterator(SyntheticLMDataset(cfg, TRAIN["batch"], TRAIN["seq"],
                                                seed=TRAIN["seed"]), device=dev,
                             shardings=shardings)
    state = {"p": params, "o": opt}
    del params, opt
    losses, walls = [], []
    try:
        counter.launches = 0
        for _ in range(steps):
            b = next(it)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state["p"], state["o"], m = step(state["p"], state["o"], b)
            losses.append(float(m["loss"]))
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = counter.launches
        peak = torch.cuda.max_memory_allocated()
        last = next(it)

        def run():
            state["p"], state["o"], m = step(state["p"], state["o"], last)
            float(m["loss"])

        t0 = time.perf_counter()
        kernels = _device_only_profile(torch, run, f"the {strategy or 'plain'} training step")
        prof_s = time.perf_counter() - t0
    finally:
        it.close()
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    nccl = [e for e in kernels if "nccl" in e.key.lower()]
    del state
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": walls, "peak": peak, "launches": launches,
            "device_ms": device_ms, "n_kernels": sum(e.count for e in kernels),
            "nccl": sum(e.count for e in nccl),
            "nccl_ms": sum(e.self_device_time_total for e in nccl) / 1e3, "profile_s": prof_s}


def _mesh_serve(torch, cfg, base, mesh) -> dict:
    """Phase 52 (a), in phase 51's worker: full-width ``cfg`` (``base``'s bf16
    weights) served greedily through ``make_prefill_step`` and
    ``make_serve_step``, MESH_SERVE's batch, prompt (drawn from seed 0) and
    tokens: plain, then on ``mesh`` under ``tp`` (DTensor parameters, the
    prompt placed by ``token_sharding``, the prefill's cache placed by
    ``place_cache`` and decoded with ``decode_constrain``).  Returns each
    run's tokens, flash launches (prefill and decode), wall and cache
    placements."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.lm import LM, RunFlags
    from repro_torch.sharding.rules import (
        ShardingStrategy, distribute, full, param_shardings, place_cache, token_sharding,
    )

    dev = torch.device("cuda", torch.cuda.current_device())
    lm = LM(cfg)
    b, s, gen = MESH_SERVE["batch"], MESH_SERVE["prompt"], MESH_SERVE["gen"]
    prompt = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)),
                             dtype=torch.int32)
    out = {}
    for tag in ("plain", "sharded"):
        params = tree_map(lambda t: t.to(dev, non_blocking=True), base)
        tokens = prompt.to(dev)
        flags = RunFlags(remat="none", q_chunk=min(512, s))
        if tag == "sharded":
            params = tree_map(distribute, params, param_shardings(
                lm.logical_axes(), params, mesh, ShardingStrategy("tp")))
            tokens = distribute(tokens, token_sharding(mesh, b))
            flags = RunFlags(remat="none", q_chunk=min(512, s), decode_constrain=True)
        torch.cuda.synchronize()
        flash_attention_cuda.launches = 0
        t0 = time.perf_counter()
        logits, cache = make_prefill_step(lm, s + gen, flags)(params, {"tokens": tokens})
        prefill_flash = flash_attention_cuda.launches
        placed = {}
        if tag == "sharded":
            cache = place_cache(cache, mesh, b, cfg, mode="auto")
            placed = {k: [repr(p) for p in t.placements] for k, t in tree_leaves(cache)}
        step = make_serve_step(lm, flags)
        toks = [torch.argmax(full(logits), dim=-1)]
        for _ in range(gen - 1):
            tok = toks[-1][:, None].to(torch.int32)
            if tag == "sharded":
                tok = distribute(tok, token_sharding(mesh, b))
            logits, cache = step(params, cache, tok)
            toks.append(torch.argmax(full(logits), dim=-1))
        generated = torch.stack(toks, dim=1).cpu().numpy()
        torch.cuda.synchronize()
        out[tag] = {"tokens": generated.tolist(), "prefill_flash": prefill_flash,
                    "flash": flash_attention_cuda.launches,
                    "wall": time.perf_counter() - t0, "placed": placed,
                    "in_vocab": bool(((generated >= 0) & (generated < cfg.vocab_size)).all())}
        del params, cache, logits
        torch.cuda.empty_cache()
    return out


def _device_only_profile(torch, run, what: str) -> list:
    """``run()`` under ``torch.profiler`` with CUDA activity only (a DTensor
    step dispatches tens of thousands of host ops, whose records would
    cost seconds a window), up to PROFILE_WINDOWS windows until one shows
    device time; returns its averages, the named ranges' annotations left
    out (not kernels)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention.ops import BACKWARD_RANGE
    from repro_torch.optim.adamw import UPDATE_RANGE

    for window in range(1, PROFILE_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.key not in (BACKWARD_RANGE, UPDATE_RANGE)]
        if sum(e.self_device_time_total for e in kernels) > 0:
            return kernels
        _log(f"the profiler saw no device time in {what} (window {window} of "
             f"{PROFILE_WINDOWS})")
    _require(False, f"the profiler saw the device time of {what}")


def _mesh_imports() -> float:
    """Phase 51's worker, started while phases 25-28 run: the imports its
    run needs (no CUDA call: the card is the main process's meanwhile).
    Returns their seconds."""
    import os

    t0 = time.perf_counter()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch.distributed.tensor  # noqa: F401

    import repro_torch.launch.train  # noqa: F401
    from repro_torch.kernels.flash_attention import kernel  # noqa: F401

    return time.perf_counter() - t0


def _mesh_worker() -> dict:
    """Phase 51, in a spawned process (so that this script's own process
    keeps no process group): full-width llama3.2-1b trained plain, then
    through a one-rank NCCL mesh (``init_process_group`` on a ``HashStore``,
    no TCP port): ``train(mesh_shape=(1, 1))`` (``dp``, every leaf
    replicated), a ``dp`` step beside it for the profile, and TRAIN's steps
    under ``tp`` through ``make_train_step`` (every head, ffn and vocab dim
    ``Shard`` over the size-1 "model" dim, so ``local_map`` and the
    redistributions run).  Deterministic algorithms throughout (the
    embedding's backward accumulates with atomics otherwise), so the
    three runs can be held bit-identical."""
    import os

    t_start = time.perf_counter()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import tree_map
    from repro_torch.models.lm import LM

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.cuda.set_device(0)
    marks = {"start": time.perf_counter() - t_start}
    cfg = get_config("llama3.2-1b")
    base = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t),
                    LM(cfg).init(prng.PRNGKey(TRAIN["seed"]), device=torch.device("cuda", 0)))
    marks["init"] = time.perf_counter() - t_start
    out = {"plain": _mesh_steps(torch, cfg, base, None, None, TRAIN["steps"],
                                flash_attention_cuda)}
    marks["plain"] = time.perf_counter() - t_start
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        out["train_dp"] = _train_main(torch, cfg, flash_attention_cuda, mesh_shape=(1, 1))
        marks["train_dp"] = time.perf_counter() - t_start
        mesh = make_host_mesh(1, 1)
        # the dp step's time is train()'s; this one warms up, then is profiled
        out["dp"] = _mesh_steps(torch, cfg, base, mesh, "dp", 1, flash_attention_cuda)
        marks["dp"] = time.perf_counter() - t_start
        out["tp"] = _mesh_steps(torch, cfg, base, mesh, "tp", TRAIN["steps"],
                                flash_attention_cuda)
        marks["tp"] = time.perf_counter() - t_start
        out["serve"] = _mesh_serve(torch, cfg, base, mesh)
        marks["serve"] = time.perf_counter() - t_start
    finally:
        dist.destroy_process_group()
    out["marks"] = marks
    return out


def _mesh_pool():
    """Phase 51's spawned process, its imports begun (:func:`_mesh_imports`):
    (the pool, the imports' future).  The caller shuts the pool down."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(_mesh_imports)


def _mesh_phase(pool, imports) -> int:
    """Phase 51: :func:`_mesh_worker` in ``pool``'s spawned process; the
    losses of the ``dp`` and ``tp`` runs on the one-rank mesh bit-identical
    to the plain run's, 16 x 8 flash launches in each, and the three paths'
    step ms, peak memory, device ms and idle share printed.  Returns the
    flash launches of the dp and tp runs."""
    t0 = time.perf_counter()
    import_s = imports.result()
    res = pool.submit(_mesh_worker).result()
    plain, train_dp, dp, tp = res["plain"], res["train_dp"], res["dp"], res["tp"]
    n = 16 * TRAIN["steps"]
    for tag, r in (("plain", plain), ("train() dp", train_dp), ("tp", tp)):
        _require(r["launches"] == n, f"phase 51 {tag}: {n} flash launches")
    _require(train_dp["losses"] == plain["losses"],
             "phase 51: train() on the one-rank mesh (dp), losses bit-identical to the plain path")
    _require(tp["losses"] == plain["losses"],
             "phase 51: tp on the one-rank mesh, losses bit-identical to the plain path")
    _require(dp["losses"] == plain["losses"][:1], "phase 51: the dp step's loss")
    # steady state: the median of steps 3-8 (dp: train()'s, the same path)
    rows = {"plain": float(np.median(plain["step_ms"][2:])),
            "dp": float(np.median(train_dp["step_ms"][2:])),
            "tp": float(np.median(tp["step_ms"][2:]))}
    for tag, r in (("plain", plain), ("dp", dp), ("tp", tp)):
        med = rows[tag]
        _log(f"mesh train {tag} (llama3.2-1b, batch {TRAIN['batch']} x seq {TRAIN['seq']}, "
             f"deterministic algorithms): step ms {(train_dp if tag == 'dp' else r)['step_ms']}; "
             f"median (steps 3-{TRAIN['steps']}) {med:.3f} ms; torch.cuda.max_memory_allocated "
             f"{(train_dp if tag == 'dp' else r)['peak']} B "
             f"({(train_dp if tag == 'dp' else r)['peak'] / 2**30:.3f} GiB); one profiled step: "
             f"device {r['device_ms']:.4f} ms in {r['n_kernels']} kernels and copies, NCCL "
             f"kernels {r['nccl']} ({r['nccl_ms']:.4f} ms), idle share "
             f"{1 - r['device_ms'] / med:.4f}; flash launches "
             f"{(train_dp if tag == 'dp' else r)['launches']}")
    _log(f"mesh train: losses plain {plain['losses']}; train() dp and tp identical to them; "
         f"dp / plain step {rows['dp'] / rows['plain']:.4f}, "
         f"tp / plain {rows['tp'] / rows['plain']:.4f}; phase 51 wall "
         f"{time.perf_counter() - t0:.1f} s (a spawned process, started with its imports, "
         f"{import_s:.1f} s, while phases 25-28 ran; seconds since its run began, at the end "
         f"of each stage: {res['marks']}; profiled steps "
         f"{[round(r['profile_s'], 3) for r in (plain, dp, tp)]} s)")
    # ---- 52 (a). sharded serving through the same one-rank mesh --------------
    serve = res["serve"]
    sp, ss = serve["plain"], serve["sharded"]
    _log(f"-- phase 52 (a): llama3.2-1b served greedily (batch {MESH_SERVE['batch']}, prompt "
         f"{MESH_SERVE['prompt']}, {MESH_SERVE['gen']} tokens, bf16, make_prefill_step / "
         f"make_serve_step): plain {sp['wall']:.3f} s, on the one-rank mesh under tp with the "
         f"cache placed by place_cache and decode_constrain {ss['wall']:.3f} s; flash launches "
         f"plain {sp['flash']} (prefill {sp['prefill_flash']}), sharded {ss['flash']} (prefill "
         f"{ss['prefill_flash']}); tokens identical: {sp['tokens'] == ss['tokens']}; first "
         f"row {ss['tokens'][0]}; cache placements {ss['placed']}")
    _require(sp["in_vocab"] and ss["in_vocab"], "phase 52 (a): every token in the vocab")
    _require(ss["tokens"] == sp["tokens"],
             "phase 52 (a): the sharded serve's tokens identical to the plain path's")
    _require(ss["prefill_flash"] == ss["flash"] == 16 and sp["flash"] == 16,
             "phase 52 (a): 16 flash launches a prefill (one per layer), none in decode")
    return train_dp["launches"] + tp["launches"] + ss["flash"]


def _dryrun_phase() -> None:
    """Phase 52 (b), after the card phases, in this process (no card work:
    meta shards on fake process groups): the dry-run of phase 25's training
    step and phase 20's serve (prefill 8 x 512, one decode step of a
    576-slot cache) through a fake one-rank mesh under ``dp`` (the plain
    path's replicated layout), and of ``llama32_1b|train_4k`` and
    ``|prefill_32k`` under the tuned profile on the fake (32, 8) H100 mesh
    and, unsharded, on the fake one-rank mesh, each printed beside what
    phases 25 and 28 measured: counted FLOPs, ``model_flops``, the useful
    ratio, ``compute_s`` and ``memory_s`` against the step's measured
    device time, ``peak_bytes`` against ``torch.cuda.max_memory_allocated``,
    and the ops with the most FLOPs.  Requires every trace to complete with
    positive counts and ``run_useful_ratio`` (``model_flops`` less what
    the step does not run: a prefill's vocab projection of all but the
    last token) <= 1, and no redundant work on the (32, 8) mesh: its 256
    ranks' FLOPs at most 1.01 times the unsharded step's (every product of
    a weight split over "model" runs on each rank's shard; llama's weights
    all divide the 8-way axis); and for ``train_4k`` no all-gather as large
    as a rank's (B, S, V) float32 logits (the loss runs on each rank's
    vocab columns); the ratios and bytes are findings."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.config import INPUT_SHAPES, InputShape

    t0 = time.perf_counter()
    plain = dryrun.Profile(strategy="dp", remat="none")
    tuned = dryrun.TUNED_PROFILES["llama32_1b"]
    runs, whole = {}, {}

    def trace(shape, mesh, profile):
        t1 = time.perf_counter()
        r = dryrun.run_combo("llama32_1b", shape, mesh, profile, correct_scan=False)
        r["wall_s"] = time.perf_counter() - t1
        return r

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        one = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        for tag, shape in (("train, phase 25", InputShape("chip_train", TRAIN["seq"],
                                                           TRAIN["batch"], "train")),
                           ("prefill, phase 20", InputShape("chip_prefill", 512, 8, "prefill")),
                           ("decode, phase 20", InputShape("chip_decode", 576, 8, "decode"))):
            runs[tag] = trace(shape, one, plain)
        for name in UNPINNED:
            whole[name] = runs[f"llama32_1b|{name}|unsharded|tuned"] = trace(
                INPUT_SHAPES[name], one, tuned)
    finally:
        dist.destroy_process_group()
    mesh = make_production_mesh()
    data_ranks = mesh.size(mesh.mesh_dim_names.index("data"))
    try:
        for name in UNPINNED:
            runs[f"llama32_1b|{name}|single|tuned"] = trace(INPUT_SHAPES[name], mesh, tuned)
    finally:
        dist.destroy_process_group()
    import torch

    from repro_torch.launch.mesh import HBM_BYTES

    _log(f"dry-run: HBM_BYTES {HBM_BYTES} B (80 GiB, the roofline's); the card's "
         f"torch.cuda.get_device_properties(0).total_memory "
         f"{torch.cuda.get_device_properties(0).total_memory} B")
    dev_s = MEASURED.get("train_device_ms", float("nan")) / 1e3
    for tag, r in runs.items():
        _require(r["status"] == "ok", f"phase 52 (b): the {tag} trace completes")
        c, rf, mem = r["cost"], r["roofline"], r["memory"]
        _log(f"dry-run {tag} ({rf['chips']} chips, {r['wall_s']:.2f} s to trace): counted "
             f"{c['flops']:.6e} FLOPs a rank ({rf['hlo_flops_global']:.6e} in all), model_flops "
             f"{rf['model_flops']:.6e}, useful ratio {rf['useful_flops_ratio']:.4f}; run_flops "
             f"{rf['run_flops']:.6e}, run useful ratio {rf['run_useful_ratio']:.4f}; unfused "
             f"bytes {c['bytes_accessed']:.6e}, transcendentals {c['transcendentals']:.6e}; "
             f"compute_s {rf['compute_s']:.6f}, memory_s {rf['memory_s']:.6f}, collective_s "
             f"{rf['collective_s']:.6f} (dominant {rf['dominant']}); peak_bytes "
             f"{mem['peak_bytes']:.6e} ({rf['hbm_peak_frac']:.4f} of 80 GiB); collectives "
             f"{r['collectives']['op_counts']}, {r['collectives']['total']:.6e} B a rank")
        _require(c["flops"] > 0 and c["bytes_accessed"] > 0 and mem["peak_bytes"] > 0,
                 f"phase 52 (b): positive counts for {tag}")
        _log(f"  the largest ops a rank: " + "; ".join(
            f"{op} {n:.4e}" for op, n in list(r["flops_by_op"].items())[:4]))
        _require(rf["run_useful_ratio"] <= 1,
                 f"phase 52 (b): the useful ratio of what the step runs <= 1 for {tag}")
    for name, (useful0, coll0) in UNPINNED.items():
        r, w = runs[f"llama32_1b|{name}|single|tuned"], whole[name]
        chips = r["roofline"]["chips"]
        ratio = r["cost"]["flops"] * chips / w["cost"]["flops"]
        _log(f"dry-run llama32_1b|{name} on (32, 8) under torch {torch.__version__}: {chips} "
             f"ranks x {r['cost']['flops']:.6e} FLOPs = {ratio:.6f} of the unsharded step's "
             f"{w['cost']['flops']:.6e}; useful ratio {r['roofline']['useful_flops_ratio']:.4f} "
             f"(recorded before the products were pinned: {useful0}); collectives "
             f"{r['collectives']['total']:.6e} B a rank (recorded before: {coll0:.4e})")
        _require(ratio <= 1.01, f"phase 52 (b): no rank repeats another's work in "
                                f"llama32_1b|{name} (256 ranks' FLOPs <= 1.01 x unsharded)")
        if name in GATHERED:
            shape = INPUT_SHAPES[name]
            logits = (shape.global_batch // data_ranks * shape.seq_len
                      * get_config("llama3.2-1b").padded_vocab * 4)
            gather = r["largest_collectives"].get("all-gather", 0.0)
            _log(f"dry-run llama32_1b|{name}: collectives {r['collectives']['total']:.6e} B a "
                 f"rank with the loss on each rank's vocab columns, against "
                 f"{GATHERED[name]:.6e} with its logits gathered for it; the largest all-gather "
                 f"{gather:.6e} B, the rank's (B, S, V) float32 logits {logits:.6e} B; "
                 f"by kind {r['collectives']['op_counts']}")
            _require(gather < logits, f"phase 52 (b): no all-gather of llama32_1b|{name} "
                                      "reaches the logits' size")
    tr = runs["train, phase 25"]
    rf = tr["roofline"]
    _log(f"dry-run against the card (train, phase 25's step): compute_s {rf['compute_s']:.6f} s "
         f"and memory_s {rf['memory_s']:.6f} s against phase 28's device time "
         f"{dev_s:.6f} s a step (compute roofline share {rf['compute_s'] / dev_s:.4f}, unfused "
         f"bytes at 3.35 TB/s {rf['memory_s'] / dev_s:.4f}) and phase 25's median step "
         f"{MEASURED.get('train_step_ms', float('nan')):.3f} ms; model_flops at 989 TFLOP/s "
         f"{rf['model_flops'] / 989e12:.6f} s, {rf['model_flops'] / 989e12 / dev_s:.4f} of the "
         f"device time (MFU of the device time); peak_bytes {tr['memory']['peak_bytes']:.6e} "
         f"against phase 25's torch.cuda.max_memory_allocated "
         f"{MEASURED.get('train_peak', float('nan')):.6e} (ratio "
         f"{tr['memory']['peak_bytes'] / MEASURED.get('train_peak', float('nan')):.4f}); "
         f"phase 52 (b) {time.perf_counter() - t0:.1f} s")


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
    """Phases 25-28 and 48: the training main path (full-width llama3.2-1b,
    then mamba2-130m; llama again under remat "dots" and "block"), the
    kernel against the plain attention in training, the
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
    MEASURED["train_peak"] = main["peak"]
    MEASURED["train_step_ms"] = float(np.median(main["step_ms"][1:]))
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

    # ---- 48. rematerialisation: dots and block beside phase 25's none -------
    _mark("48")
    launches += _remat_phase(torch, cfg, main, flash_attention_cuda)

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
    state = {"params": params, "opt": st}

    def run():
        state["params"], state["opt"], m = step(state["params"], state["opt"], batches[4])
        float(m["loss"])

    prof, _ = _profile(torch, run, "the training step")
    params, st = state["params"], state["opt"]
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
    MEASURED["train_device_ms"] = device_ms
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


def _card_cpu_phase() -> None:
    """Phase 6: small inputs on the card against the same runs on the CPU:
    identical finish ticks."""
    from repro_torch.scenarios import QUICK_OVERRIDES, get_scenario, run_scenario_fluid

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


def _random_phase(torch, dev, chunk_steps) -> tuple:
    """Phase 29: the random placement on the card, the paper batch of phase
    4 under ``placement="random"`` (the main path: launch count 0 just
    before, one launch per executed tick; the small batch is
    :func:`_random_small_phase`, ``monte_carlo_jct`` :func:`_mc_phase`).
    Returns (launches, executed ticks)."""
    res = _paper_batch("ada", "", "simulate_traces_batched", placement="random")
    ticks = _summary("paper ada random placement (simulate_traces_batched, CUDA graph)", res,
                     chunk_steps)
    _require(res["launches"] == ticks > 0, "random placement: one launch per executed tick")
    return res["launches"], ticks


def _random_small_phase() -> None:
    """Phase 29's small paper batch under the random placement, ada and
    srsf2, on the card and the CPU: identical finish ticks."""
    from repro_torch.scenarios import get_scenario, run_scenario_fluid

    small = get_scenario("paper", seed=1, n_jobs=24, min_iters=60, max_iters=300,
                         horizon_s=300.0)
    for comm in ("ada", "srsf2"):
        on_card = run_scenario_fluid(small, comm=comm, placement="random")
        on_cpu = run_scenario_fluid(small, comm=comm, placement="random", device="cpu")
        _require((on_card["finished"] == on_cpu["finished"]).all()
                 and (on_card["jct"] == on_cpu["jct"]).all(), f"random {comm}: card vs CPU")
        _log(f"paper (24 jobs, seed 1) {comm} random placement: card == CPU on every finish "
             f"tick ({int(on_card['finished'].sum())} jobs)")


def _mc_phase(cpu) -> None:
    """Phase 29's ``monte_carlo_jct``, on the card beside phases 31-32's
    workers, against ``cpu``, its CPU side (run in a worker process in
    phases 8-11): identical sampled traces and ``per_seed``."""
    card = _mc_worker("cuda")
    for k, v in card["traces"].items():
        _require((v == cpu["traces"][k]).all(), f"monte_carlo_jct traces: {k}")
    _require((card["per_seed"] == cpu["per_seed"]).all(), "monte_carlo_jct per_seed")
    _log(f"monte_carlo_jct(n_seeds={MC_JCT['n_seeds']}, n_jobs={MC_JCT['n_jobs']}): sampled "
         f"traces and per_seed identical on the card and the CPU; avg JCT "
         f"{card['avg_jct_mean']:.4f} +- {card['avg_jct_std']:.4f} s, finished "
         f"{card['finished_frac']}; wall card {card['wall']:.3f} s (beside the event "
         f"workers), CPU {cpu['wall']:.3f} s (a worker process)")


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



# ---------------------------------------------------------------------------
# The event engine and multi_job (phases 31-33)
# ---------------------------------------------------------------------------

#: phase 31: registered-size cells of the event engine, (scenario, comm,
#: placement), seed 0
EVENT_CELLS = (("paper", "ada", "lwf"), ("paper", "srsf1", "lwf"), ("paper", "srsf2", "lwf"),
               ("oversub_fabric", "ada", "lwf_rack"))
#: phase 32: phase 4's fluid batches and the event engine on the same jobs
EVENT_FLUID_COMMS = ("ada", "srsf1", "srsf2")
#: the reference's fluid-vs-event tolerance (tests/test_differential.py)
EVENT_FLUID_RATIO = 2.0
#: the JAX reference's fluid avg JCT per seed on phase 4's batches, on the CPU
#: (``scripts/fluid_event_reference.py``), which phase 32 holds the card's to
REFERENCE_FLUID_AVG_JCT = {
    "ada": (100.85907557010651, 86.27750918865203, 126.20032160282135,
        66.01844844818115, 134.65657732486724, 106.0162628531456,
        153.05688747167588, 95.34594995975495),
    "srsf1": (96.94782526493073, 87.1853239774704, 142.6275139093399,
        93.75282363891601, 154.1503271341324, 110.46782764196396,
        155.89251579046248, 97.96376307010651),
    "srsf2": (85.12563631534576, 67.4875113248825, 81.33313581943511,
        64.37188549041748, 113.87501194477082, 59.75407508611679,
        149.42251456975936, 89.55313646793365),
}
#: phase 33: run_multi_job at full width
#: (the reference's default job list; the MoE job at its reduced config, the
#: reference's own default for every job: at full width its init and the
#: profiling copies (bf16 weights, float32 moments) would hold ~136 GB)
MULTI_JOB = dict(jobs=("llama3.2-1b:4:300", "mamba2-130m:2:500", "olmoe-1b-7b:8:200"),
                 reduced=("olmoe-1b-7b",), batch=8, seq=512, policy="ada", fabric="10gbe",
                 execute_steps=4, timing_steps=3)
#: phase 33: jobs scheduled with the measured profiles beside MULTI_JOB's,
#: spanning servers of the 4 x 4 cluster so that their all-reduces contend
SPAN_JOBS = ("llama3.2-1b:8:300", "mamba2-130m:12:500")
#: worker processes of phases 31-32, 49 and 50's host runs (the main
#: process runs phase 50's fluid cells on the card meanwhile), and of
#: phase 50's event sweep
EVENT_WORKERS = 7
#: phase 49: (scenario, sched or None for the scenario's own), seed 0, ada
DYNAMIC_CELLS = (("preemption_gain", "static"), ("preemption_gain", "preemptive_srsf"),
                 ("elastic_surge", "static"), ("elastic_surge", "elastic"),
                 ("chaos_steady", None), ("chaos_recovery_storm", None),
                 ("chaos_stragglers", None), ("trace_replay_synth", None),
                 ("trace_replay_philly", None), ("trace_replay_alibaba", None))
#: the JAX reference's (avg JCT, preemptions, resizes, faults, cancelled,
#: censored) of each phase-49 cell, on the CPU
#: (``scripts/event_dynamic_reference.py``)
REFERENCE_DYNAMIC = {
    "preemption_gain/static": (186.3731798571446, 0, 0, 0, 0, 0),
    "preemption_gain/preemptive_srsf": (50.832682980952505, 14, 0, 0, 0, 0),
    "elastic_surge/static": (18.75590624999967, 0, 0, 0, 0, 0),
    "elastic_surge/elastic": (14.190570533333304, 0, 7, 0, 0, 0),
    "chaos_steady/static": (28.826776826732218, 1, 0, 1, 0, 0),
    "chaos_recovery_storm/static": (55.97712124472672, 11, 0, 4, 0, 0),
    "chaos_stragglers/static": (53.52164131097776, 0, 0, 3, 0, 0),
    "trace_replay_synth/static": (106.15214601361744, 0, 0, 0, 0, 0),
    "trace_replay_philly/static": (17.77224062499993, 0, 0, 0, 0, 0),
    "trace_replay_alibaba/static": (11.508681014999738, 0, 0, 0, 0, 0),
}
#: phase 50 (a): the sweep's fluid cells, phase 11's CARD_CPU_CELLS at their
#: overrides, seeds 0 and 1, under ada and srsf2
REST_FLUID = dict(scenarios=("fusion_sweep", "model_zoo"), comms=("ada", "srsf2"), seeds=(0, 1),
                  per_scenario_overrides={name: over for name, _, over in CARD_CPU_CELLS})
REST_FLUID_FIELDS = ("n_jobs", "n_finished", "avg_jct", "median_jct", "p95_jct", "p99_jct",
                     "makespan")
#: phase 50 (b): (tag, scenario, engine keywords, the incremental run it
#: equals: a phase-31 or phase-49 cell), seed 0, comm ada, registered size;
#: the longest first
REST_HOST_CELLS = (
    ("paper/comm_chunks=4", "paper", {"comm_chunks": 4}, None),
    ("paper/observed", "paper", {"observe": "full"}, "paper/ada"),
    ("paper/gating=rescan", "paper", {"gating": "rescan"}, "paper/ada/half"),
    ("paper/workloads=rescan", "paper", {"workloads": "rescan"}, "paper/ada"),
    ("paper/link", "paper", {"contention_domain": "link"}, None),
    ("preemption_gain/preemptive_srsf/gating=rescan", "preemption_gain",
     {"sched": "preemptive_srsf", "gating": "rescan"}, "preemption_gain/preemptive_srsf"),
    ("preemption_gain/preemptive_srsf/workloads=rescan", "preemption_gain",
     {"sched": "preemptive_srsf", "workloads": "rescan"}, "preemption_gain/preemptive_srsf"),
    ("chaos_recovery_storm/observed", "chaos_recovery_storm", {"observe": "full"},
     "chaos_recovery_storm/static"),
    ("trace_replay_philly/profile_phases", "trace_replay_philly", {"profile_phases": True},
     "trace_replay_philly/static"),
)
REPLAY_WINDOW_S = 60.0
#: scenario overrides of a phase-50 (b) run: the paper run under the gating
#: rescan runs at half its registered depth (iterations 500-3000; 98 s at
#: full depth on a slow host), held to the reference's run at the same
#: depth and to the incremental run beside it
REST_CUTS = {"paper/gating=rescan": dict(min_iters=500, max_iters=3000),
             "paper/ada/half": dict(min_iters=500, max_iters=3000)}
#: phase 50 (c): the event sweep at QUICK size
REST_EVENT = dict(scenarios=("paper", "oversub_fabric"), comms=("ada", "srsf1", "srsf2"))
#: the JAX reference's phase-50 results on the CPU
#: (``scripts/event_rest_reference.py``): (a) per fluid cell (scenario,
#: comm, seed) its n_jobs, n_finished, avg, median, p95 and p99 JCT and
#: makespan; (b) per host cell its avg JCT, events, preemptions, comm
#: starts, censored jobs and finish-time digest, the observed runs' mean
#: JCT parts and Chrome trace event count, the profiled replay's
#: ``replay_summary`` keys and values; (c) per event sweep record (scenario,
#: policy name) its avg JCT and the digest of its CSV_FIELDS but wall_s
REFERENCE_SWEEP_FLUID = {
    ('fusion_sweep', 'ada', 0):
        (6, 6, 117.88333702087402, 92.39999961853027, 312.3000183105469, 312.3000183105469, 312.3000183105469),
    ('fusion_sweep', 'ada', 1): (6, 6, 117.82499996821086, 91.05000114440918, 315.5, 315.5, 315.5),
    ('fusion_sweep', 'srsf2', 0):
        (6, 6, 117.88333702087402, 92.39999961853027, 312.3000183105469, 312.3000183105469, 312.3000183105469),
    ('fusion_sweep', 'srsf2', 1):
        (6, 6, 117.82499996821086, 91.05000114440918, 315.5, 315.5, 315.5),
    ('model_zoo', 'ada', 0):
        (12, 12, 234.68750762939453, 159.20001220703125, 863.4000244140625, 863.4000244140625, 1183.4000244140625),
    ('model_zoo', 'ada', 1):
        (12, 12, 153.4083366394043, 31.900009155273438, 1010.0, 1010.0, 1260.0),
    ('model_zoo', 'srsf2', 0):
        (12, 12, 234.68750762939453, 159.20001220703125, 863.4000244140625, 863.4000244140625, 1183.4000244140625),
    ('model_zoo', 'srsf2', 1):
        (12, 12, 153.4083366394043, 31.900009155273438, 1010.0, 1010.0, 1260.0),
}
REFERENCE_REST = {
    'paper/gating=rescan': {  # at half depth (REST_CUTS)
        'avg_jct': 1228.1472811544309,
        'events': 1197320,
        'preemptions': 0,
        'comm_contended': 19579,
        'comm_clean': 82537,
        'censored': 0,
        'finish_sha256': '7eec0b22c3243435ca1ecd4c44be5df0043c5ca1f907520009ffe0bbebdfd3f1',
    },
    'paper/comm_chunks=4': {
        'avg_jct': 2376.0394285773973,
        'events': 2885062,
        'preemptions': 0,
        'comm_contended': 0,
        'comm_clean': 765796,
        'censored': 0,
        'finish_sha256': 'd1d9e9a18abf04f8b2b115ad58d6773a35a975b874af5139e31b556c3f7696f4',
    },
    'paper/observed': {
        'avg_jct': 2777.5749093755935,
        'events': 2389581,
        'preemptions': 0,
        'comm_contended': 42255,
        'comm_clean': 161288,
        'censored': 0,
        'finish_sha256': '63f458f1eb3ea69d2b2e2b6bf38e0de49fb73b0b881253999b12b71caf62bf10',
        'mean_parts': {
            'jct': 2777.574909375593,
            'queue_wait': 444.32180165457487,
            'compute': 490.7551866468951,
            'comm_serial': 310.5035202438162,
            'comm_stretch': 60.49026078520436,
            'gating_wait': 1471.504140045103,
            'overhead_pf': 0.0,
        },
        'trace_events': 1000413,
    },
    'paper/workloads=rescan': {
        'avg_jct': 2777.5749093755935,
        'events': 2389581,
        'preemptions': 0,
        'comm_contended': 42255,
        'comm_clean': 161288,
        'censored': 0,
        'finish_sha256': '63f458f1eb3ea69d2b2e2b6bf38e0de49fb73b0b881253999b12b71caf62bf10',
    },
    'paper/link': {
        'avg_jct': 1351.273596907189,
        'events': 2378317,
        'preemptions': 0,
        'comm_contended': 10555,
        'comm_clean': 196542,
        'censored': 0,
        'finish_sha256': '638eb64f22d0e8dde4132b0ebc162a8dc83122f0c70222c2978e5d180daf81b3',
    },
    'preemption_gain/preemptive_srsf/gating=rescan': {
        'avg_jct': 50.832682980952505,
        'events': 25697,
        'preemptions': 14,
        'comm_contended': 0,
        'comm_clean': 1899,
        'censored': 0,
        'finish_sha256': 'b0673e4f2c67f9c5da4a56ce0bbd6f5f542551afb5686b53211aec64759632e8',
    },
    'preemption_gain/preemptive_srsf/workloads=rescan': {
        'avg_jct': 50.832682980952505,
        'events': 25697,
        'preemptions': 14,
        'comm_contended': 0,
        'comm_clean': 1899,
        'censored': 0,
        'finish_sha256': 'b0673e4f2c67f9c5da4a56ce0bbd6f5f542551afb5686b53211aec64759632e8',
    },
    'chaos_recovery_storm/observed': {
        'avg_jct': 55.97712124472672,
        'events': 18515,
        'preemptions': 11,
        'comm_contended': 194,
        'comm_clean': 1260,
        'censored': 0,
        'finish_sha256': '29fcca1827b797476baa62aee44ccb01782f6172ff71e0a87bcc5109b5fd3e6a',
        'mean_parts': {
            'jct': 55.97712124472671,
            'queue_wait': 0.0,
            'compute': 21.206305086423306,
            'comm_serial': 17.979227169999824,
            'comm_stretch': 2.012703630545419,
            'gating_wait': 14.021847667758115,
            'overhead_pf': 0.757037690000057,
        },
        'trace_events': 25926,
    },
    'trace_replay_philly/profile_phases': {
        'avg_jct': 17.77224062499993,
        'events': 19162,
        'preemptions': 0,
        'comm_contended': 0,
        'comm_clean': 1118,
        'censored': 0,
        'finish_sha256': '92899703888c9bcb37aba77308860144ef82e307b08fb29ab957919af96c1fdd',
        'replay_keys': [
            'window_s', 't_lo', 't_hi', 'n_windows', 'n_jobs', 'sustained_goodput',
            'sustained_jobs_per_sec', 'p99_jct', 'queueing_delay_mean', 'queueing_delay_p99',
            'makespan', 'n_finished', 'censored', 'goodput', 'events', 'peak_calendar',
            'phase_comm_advance_s', 'phase_dispatch_s', 'phase_gating_s', 'phase_gpu_schedule_s',
        ],
        'replay_values': {
            'window_s': 60.0,
            't_lo': 60.0,
            't_hi': 300.0,
            'n_windows': 4.0,
            'n_jobs': 34.0,
            'sustained_goodput': 54.858333333333334,
            'sustained_jobs_per_sec': 0.14166666666666666,
            'p99_jct': 69.15287679999986,
            'queueing_delay_mean': 0.0,
            'queueing_delay_p99': 0.0,
            'makespan': 329.2281934000008,
            'n_finished': 40.0,
            'censored': 0.0,
            'goodput': 54.68547457637009,
            'events': 19162.0,
            'peak_calendar': 30.0,
        },
    },
}
REFERENCE_SWEEP_EVENT = {
    ('paper', 'Ada-SRSF'):
        (51.374264205006114, '215879f87e12dd8a92d41d2c54abacd07739a17cae56ecd92e6e58f427dd2e6d'),
    ('paper', 'SRSF(1)'):
        (51.374264205006114, '720e50aa4c16833706f5d95c23e097511a572c76ffd2fedf5d7f8244ddbcc3ce'),
    ('paper', 'SRSF(2)'):
        (51.374264205006114, '734b29656a1d1059df2942c04392f55f9c5dad4ad3c79b8823dc9afade29b0db'),
    ('oversub_fabric', 'Ada-SRSF'):
        (58.07630516982587, '5d65e1526ae77a9e9d28085aee6e489b145be7be32ab2ec1f22e0c530a143539'),
    ('oversub_fabric', 'SRSF(1)'):
        (64.01274269875454, 'f1ddba07252f65f83b985268eab6d3d207040827b2e21cc17200140e641f6feb'),
    ('oversub_fabric', 'SRSF(2)'):
        (57.274407861863075, 'f02fd821d21c23991bd2654e304a0052c929f9558df8257722ce3f0258b7a8e0'),
}


def _host_cpu() -> str:
    """The host CPU's model name (``lscpu``, else ``/proc/cpuinfo``), its
    architecture and logical CPU count."""
    import os
    import platform

    name = ""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=10).stdout
        name = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                     if ln.startswith("Model name")), "")
    except (OSError, subprocess.SubprocessError):
        pass
    if not name:
        try:
            name = next((ln.split(":", 1)[1].strip()
                         for ln in Path("/proc/cpuinfo").read_text().splitlines()
                         if ln.startswith("model name")), "")
        except OSError:
            pass
    return f"{name or 'model name not reported'}, {platform.machine()}, {os.cpu_count()} CPUs"


def _finish_digest(res) -> str:
    """sha256 of a run's finish times in the result's order (as
    ``scripts/event_rest_reference.py`` digests the reference's)."""
    return hashlib.sha256(repr(list(res.finish.items())).encode()).hexdigest()


def _event_worker(name, seed, comm, placement, overrides) -> dict:
    """One event-engine run of a registered scenario (phases 31-32), on the
    host, in a worker process or this one."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.scenarios import get_scenario, run_scenario_event

    scn = get_scenario(name, seed=seed, **overrides)
    t0 = time.perf_counter()
    res = run_scenario_event(scn, comm=comm, placement=placement)
    wall = time.perf_counter() - t0
    return {"name": name, "seed": seed, "comm": comm, "placement": placement,
            "n_jobs": scn.n_jobs, "gpus": scn.total_gpus, "n_finished": len(res.jct),
            "censored": res.censored, "avg_jct": res.avg_jct() if res.jct else math.nan,
            "makespan": res.makespan, "events": res.events_processed, "wall": wall,
            "finish_sha256": _finish_digest(res)}


def _dynamic_worker(name, sched) -> dict:
    """One phase-49 run: a registered scenario at seed 0 under ada, with
    ``sched`` (None: the scenario's own), on the host."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.scenarios import get_scenario, run_scenario_event

    scn = get_scenario(name, seed=0)
    t0 = time.perf_counter()
    res = run_scenario_event(scn, comm="ada", **({} if sched is None else {"sched": sched}))
    wall = time.perf_counter() - t0
    return {"cell": f"{name}/{res.sched_name}", "n_jobs": scn.n_jobs, "gpus": scn.total_gpus,
            "streamed": scn.source is not None, "n_finished": len(res.jct),
            "values": (res.avg_jct() if res.jct else math.nan, res.preemptions, res.resizes,
                       res.faults, res.cancelled, res.censored),
            "work_lost": res.work_lost_samples, "events": res.events_processed,
            "peak_calendar": res.peak_calendar, "wall": wall,
            "finish_sha256": _finish_digest(res)}


def _rest_worker(tag, name, kw) -> dict:
    """One phase-50 (b) run on the host: a registered scenario at seed 0
    under ada with the engine keywords ``kw`` (``observe="full"`` arms
    ``ObsConfig.full()``).  An observed run's Chrome trace is written to a
    temporary file and loaded back; a profiled run's ``replay_summary`` is
    taken at ``REPLAY_WINDOW_S``."""
    import os

    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.obs import ObsConfig
    from repro_torch.scenarios import get_scenario, run_scenario_event
    from repro_torch.scenarios.metrics import replay_summary

    kw = dict(kw)
    if kw.get("observe") == "full":
        kw["observe"] = ObsConfig.full()
    scn = get_scenario(name, seed=0, **REST_CUTS.get(tag, {}))
    t0 = time.perf_counter()
    res = run_scenario_event(scn, comm="ada", **kw)
    wall = time.perf_counter() - t0
    row = {"tag": tag, "n_jobs": scn.n_jobs, "n_finished": len(res.jct), "wall": wall,
           "avg_jct": res.avg_jct(), "events": res.events_processed,
           "preemptions": res.preemptions, "comm_contended": res.comm_started_contended,
           "comm_clean": res.comm_started_clean, "censored": res.censored,
           "finish_sha256": _finish_digest(res)}
    if res.obs is not None:
        t0 = time.perf_counter()
        row["mean_parts"] = res.obs.mean_parts()
        row["closure"] = max(abs(p.parts_sum - p.jct) for p in res.obs.decomp.values())
        fd, path = tempfile.mkstemp(suffix=".perfetto.json")
        os.close(fd)
        try:
            res.obs.to_chrome_trace(path)
            row["trace_bytes"] = os.path.getsize(path)
            with open(path) as fh:
                trace = json.load(fh)
        finally:
            os.unlink(path)
        row["trace_events"] = len(trace["traceEvents"])
        row["trace_phases"] = sorted({e["ph"] for e in trace["traceEvents"]})
        row["report_wall"] = time.perf_counter() - t0
    if res.phase_seconds is not None:
        row["phase_seconds"] = res.phase_seconds
        summary = replay_summary(res, window_s=REPLAY_WINDOW_S)
        row["replay_keys"] = list(summary)
        row["replay_values"] = {k: v for k, v in summary.items() if not k.startswith("phase_")}
    return row


def _rest_fluid_sweep(device=None, scenarios=REST_FLUID["scenarios"]) -> list:
    """Phase 50 (a): the sweep's fluid cells of ``scenarios`` on ``device``
    (None: the card), one record dict per cell; on the CPU in worker
    processes of phases 10-11, one a scenario."""
    import torch

    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    if device == "cpu":
        torch.set_num_threads(1)
    from repro_torch.scenarios import sweep

    recs = sweep(list(scenarios), comms=REST_FLUID["comms"],
                 seeds=REST_FLUID["seeds"], backend="fluid",
                 per_scenario_overrides=REST_FLUID["per_scenario_overrides"], device=device)
    return [dataclasses.asdict(r) for r in recs]


def _submit_event_runs(pool) -> dict:
    """Phases 31-32's, 49's and 50's host runs, queued on ``pool`` (worker
    processes started when phase 29 ends, beside no card phase but phase
    50's fluid cells and phase 29's ``monte_carlo_jct``), the
    registered-size paper runs first."""
    rest = [pool.submit(_rest_worker, tag, name, kw) for tag, name, kw, _ in REST_HOST_CELLS[:5]]
    reg = [pool.submit(_event_worker, name, 0, comm, pl, {}) for name, comm, pl in EVENT_CELLS]
    cut = {(comm, s): pool.submit(_event_worker, "paper", s, comm, "lwf", PAPER_CUT)
           for comm in EVENT_FLUID_COMMS for s in SEEDS}
    dyn = [pool.submit(_dynamic_worker, name, sched) for name, sched in DYNAMIC_CELLS]
    rest += [pool.submit(_rest_worker, tag, name, kw) for tag, name, kw, _ in REST_HOST_CELLS[5:]]
    half = pool.submit(_rest_worker, "paper/ada/half", "paper", {})
    return {"registered": reg, "cut": cut, "dynamic": dyn, "rest": rest, "half": half}


def _dynamic_phase(futures) -> None:
    """Phase 49: the dynamic event engine (preemption, elastic resizing,
    fault injection, streamed trace replays) against the reference's
    constants."""
    cpu = _host_cpu()
    names = ("avg JCT", "preemptions", "resizes", "faults", "cancelled", "censored")
    for fut in futures["dynamic"]:
        r = fut.result()
        want = REFERENCE_DYNAMIC[r["cell"]]
        _log(f"event engine {r['cell']} ({r['n_jobs']} jobs, {r['gpus']} GPUs, seed 0, ada"
             f"{', arrivals streamed' if r['streamed'] else ''}): "
             + ", ".join(f"{n} {v}" for n, v in zip(names, r["values"]))
             + f"; the reference's {want}; work lost {r['work_lost']} samples, "
             f"{r['events']} events, calendar high-water {r['peak_calendar']}, "
             f"{r['wall']:.3f} s wall on the host ({cpu}, one of {EVENT_WORKERS} worker "
             f"processes)")
        _require(tuple(r["values"]) == want, f"{r['cell']}: equal to the reference's")
        _require(r["n_finished"] + r["values"][4] + r["values"][5] == r["n_jobs"],
                 f"{r['cell']}: finished, cancelled and censored jobs add up")
        if r["streamed"]:
            _require(r["peak_calendar"] < r["n_jobs"] + r["gpus"],
                     f"{r['cell']}: the streamed calendar stays O(cluster)")


def _same_value(a, b) -> bool:
    return a == b or (isinstance(a, float) and isinstance(b, float)
                      and math.isnan(a) and math.isnan(b))


def _rest_fluid_card(torch, chunk_steps) -> dict:
    """Phase 50 (a), the card side: ``sweep(backend="fluid")`` through
    ``run_cell`` on CUDA, the launch count set to 0 just before and read
    just after (in this process, while phases 31-32's workers run)."""
    from repro_torch.kernels.fluidstep import kernel as fs_kernel

    fs_kernel.fluid_step_core_cuda.launches = 0
    t0 = time.perf_counter()
    recs = _rest_fluid_sweep()
    torch.cuda.synchronize()
    return {"recs": recs, "wall": time.perf_counter() - t0,
            "launches": fs_kernel.fluid_step_core_cuda.launches,
            "ticks": sum(r["chunks"] for r in recs) * chunk_steps}


def _rest_fluid_phase(card, cpu_recs) -> int:
    """Phase 50 (a): each card record ``==`` the port's CPU record of the
    same cell (``wall_s`` aside) and within 1e-6 relative of the
    reference's, finished counts exact; one launch per executed tick.
    Returns the launches."""
    _require(len(card["recs"]) == len(cpu_recs) == len(REFERENCE_SWEEP_FLUID),
             "phase 50 (a): 8 fluid cells on each side")
    for rec, cpu in zip(card["recs"], cpu_recs):
        key = (rec["scenario"], rec["comm"], rec["seed"])
        want = REFERENCE_SWEEP_FLUID[key]
        got = tuple(rec[f] for f in REST_FLUID_FIELDS)
        rel = max(abs(g - w) / abs(w) for g, w in zip(got[2:], want[2:]))
        _log(f"sweep fluid {key} (run_cell on the card): {dict(zip(REST_FLUID_FIELDS, got))}, "
             f"chunks {rec['chunks']}, wall {rec['wall_s']:.3f} s; the port on the CPU "
             f"{cpu['wall_s']:.3f} s; the reference's {want} (max rel diff {rel:.3e})")
        _require(all(_same_value(rec[k], cpu[k]) for k in rec if k != "wall_s"),
                 f"sweep fluid {key}: card record == CPU record")
        _require(got[:2] == want[:2] and rec["n_finished"] == rec["n_jobs"],
                 f"sweep fluid {key}: finished counts equal the reference's")
        _require(rel <= 1e-6, f"sweep fluid {key}: within 1e-6 of the reference")
    _log(f"sweep fluid (phase 50 a): {len(card['recs'])} cells on the card in "
         f"{card['wall']:.3f} s wall, fluid_step_core launches {card['launches']} (counted over "
         f"graph replays), executed ticks {card['ticks']}")
    _require(card["launches"] == card["ticks"] > 0, "phase 50 (a): one launch per executed tick")
    return card["launches"]


def _rest_phase(futures) -> None:
    """Phase 50 (b): chunked all-reduces, the ring-edge reading, the rescan
    oracles, observed runs with their Perfetto export, and per-phase
    profiling on the host, against the reference's constants and the
    incremental, unobserved runs of phases 31 and 49."""
    cpu = _host_cpu()
    base = {}
    for fut in futures["registered"]:
        r = fut.result()
        base[f"{r['name']}/{r['comm']}"] = dict(r, values=(r["avg_jct"],))
    for fut in futures["dynamic"]:
        r = fut.result()
        base[r["cell"]] = r
    half = futures["half"].result()
    base[half["tag"]] = dict(half, values=(half["avg_jct"],))
    against = {tag: inc for tag, _, _, inc in REST_HOST_CELLS}
    for fut in futures["rest"]:
        r = fut.result()
        tag = r["tag"]
        want = REFERENCE_REST[tag]
        _log(f"event engine {tag} ({r['n_jobs']} jobs, seed 0, ada): avg JCT {r['avg_jct']}, "
             f"{r['events']} events, preemptions {r['preemptions']}, comm starts contended "
             f"{r['comm_contended']} clean {r['comm_clean']}, censored {r['censored']}; "
             f"the reference's avg JCT {want['avg_jct']}, {want['events']} events; "
             f"{r['wall']:.3f} s wall on the host ({cpu}, one of {EVENT_WORKERS} worker "
             f"processes)")
        for k in ("avg_jct", "events", "preemptions", "comm_contended", "comm_clean",
                  "censored", "finish_sha256"):
            _require(r[k] == want[k], f"{tag}: {k} equals the reference's")
        _require(r["n_finished"] + r["censored"] == r["n_jobs"], f"{tag}: every job counted")
        inc = base.get(against[tag])
        if against[tag] is not None:
            _require(r["avg_jct"] == inc["values"][0] and r["events"] == inc["events"]
                     and r["finish_sha256"] == inc["finish_sha256"],
                     f"{tag}: == the {against[tag]} run of phase 31, 49 or 50 (b)")
            _log(f"  == the incremental, unobserved {against[tag]} run (avg JCT, events, every "
                 f"finish time): {inc['wall']:.3f} s wall there, {r['wall']:.3f} s here")
        if "mean_parts" in want:
            _log(f"  observed ({cpu}): {r['wall']:.3f} s wall against {inc['wall']:.3f} s "
                 f"unobserved (another worker of the same pool); report and Perfetto export "
                 f"{r['report_wall']:.3f} s; mean JCT parts {r['mean_parts']}; closure "
                 f"max |parts - jct| {r['closure']:.3e} s; Chrome trace {r['trace_events']} "
                 f"events ({r['trace_bytes']} bytes, phases {r['trace_phases']}), the "
                 f"reference's {want['trace_events']}")
            _require(r["mean_parts"] == want["mean_parts"], f"{tag}: mean parts")
            _require(r["trace_events"] == want["trace_events"], f"{tag}: trace event count")
            _require({"X", "M", "C"} <= set(r["trace_phases"]), f"{tag}: trace event kinds")
        if "replay_keys" in want:
            _log(f"  profile_phases: {r['phase_seconds']} (wall seconds, {cpu}); "
                 f"replay_summary keys {r['replay_keys']}")
            _require(r["replay_keys"] == want["replay_keys"], f"{tag}: replay_summary keys")
            _require(all(_same_value(r["replay_values"][k], v)
                         for k, v in want["replay_values"].items())
                     and list(r["replay_values"]) == list(want["replay_values"]),
                     f"{tag}: replay_summary values")
            _require(list(r["phase_seconds"]) == ["comm_advance", "dispatch", "gating",
                                                  "gpu_schedule"]
                     and all(v >= 0.0 for v in r["phase_seconds"].values()),
                     f"{tag}: phase_seconds")


def _event_sweep_phase() -> None:
    """Phase 50 (c): the event sweep in a ``spawn`` pool of EVENT_WORKERS
    processes and in this process, after the card phases: every record
    ``==`` (``wall_s`` aside) and equal to the reference's."""
    from repro_torch.scenarios import QUICK_OVERRIDES, sweep
    from repro_torch.scenarios.metrics import CSV_FIELDS

    walls, runs = [], []
    for processes in (EVENT_WORKERS, None):
        t0 = time.perf_counter()
        runs.append(sweep(list(REST_EVENT["scenarios"]), comms=REST_EVENT["comms"],
                          per_scenario_overrides=QUICK_OVERRIDES, processes=processes))
        walls.append(time.perf_counter() - t0)
    pooled, serial = runs
    _require(len(pooled) == len(serial) == len(REFERENCE_SWEEP_EVENT), "phase 50 (c): 6 cells")
    for p, q in zip(pooled, serial):
        key = (p.scenario, p.comm)
        digest = hashlib.sha256(repr(tuple(getattr(p, f) for f in CSV_FIELDS
                                           if f != "wall_s")).encode()).hexdigest()
        want = REFERENCE_SWEEP_EVENT[key]
        _log(f"sweep event {key} (QUICK, {p.n_jobs} jobs): avg JCT {p.avg_jct}, finished "
             f"{p.n_finished}, the reference's {want[0]}")
        _require(all(_same_value(getattr(p, f.name), getattr(q, f.name))
                     for f in dataclasses.fields(p) if f.name != "wall_s"),
                 f"sweep event {key}: the pool's record == this process's")
        _require((p.avg_jct, digest) == want, f"sweep event {key}: equals the reference's")
    _log(f"sweep event (phase 50 c): {len(pooled)} cells, {walls[0]:.3f} s wall in "
         f"{EVENT_WORKERS} spawned processes (their start included), {walls[1]:.3f} s in this "
         f"process")


def _event_phases(futures, fluid_results) -> None:
    """Phase 31: the event engine at registered size; phase 32: the event
    engine against phase 4's fluid batches on the same job lists."""
    cpu = _host_cpu()
    for fut in futures["registered"]:
        r = fut.result()
        _log(f"event engine {r['name']} ({r['n_jobs']} jobs, {r['gpus']} GPUs, seed 0) "
             f"{r['comm']} {r['placement']}: finished {r['n_finished']}/{r['n_jobs']}, avg JCT "
             f"{r['avg_jct']} s, makespan {r['makespan']} s, {r['events']} events in "
             f"{r['wall']:.3f} s wall = {r['events'] / r['wall']:.1f} events/s on the host "
             f"({cpu}, one of {EVENT_WORKERS} worker processes, beside phases 50 (a)'s and "
             f"29's card runs in the main process)")
        _require(r["n_finished"] == r["n_jobs"] and r["censored"] == 0,
                 f"event engine {r['name']} {r['comm']}: every job finishes")
    for comm, fluid in zip(EVENT_FLUID_COMMS, fluid_results):
        ratios, walls, fluid_avg, event_avg = [], [], [], []
        for s, rec in zip(SEEDS, fluid["recs"]):
            ev = futures["cut"][(comm, s)].result()
            _require(ev["n_finished"] == ev["n_jobs"] == rec["n_jobs"] == rec["n_finished"],
                     f"paper {comm} seed {s}: both backends finish every job")
            ratios.append(rec["avg_jct"] / ev["avg_jct"])
            walls.append(ev["wall"])
            fluid_avg.append(rec["avg_jct"])
            event_avg.append(ev["avg_jct"])
        want = REFERENCE_FLUID_AVG_JCT[comm]
        _log(f"paper {comm} (160 jobs, iterations {PAPER_CUT['min_iters']}-"
             f"{PAPER_CUT['max_iters']}, 8 seeds): fluid avg JCT on the card (phase 4) / event "
             f"avg JCT on the host, per seed: {[round(x, 6) for x in ratios]} (the reference's "
             f"bound on its own cells: within {EVENT_FLUID_RATIO}x; printed, not held here); "
             f"fluid avg JCT per seed {fluid_avg}, the JAX reference's on the CPU {list(want)}; "
             f"event avg JCT per seed {event_avg}; event wall per seed "
             f"{[round(x, 3) for x in walls]} s")
        _require(tuple(fluid_avg) == want,
                 f"paper {comm}: fluid avg JCT per seed on the card equals the reference's")


def _multi_job_phase(torch) -> int:
    """Phase 33: ``run_multi_job`` on the card (llama3.2-1b and mamba2-130m
    at full width, olmoe-1b-7b reduced), the flash launch count reset just
    before it.  Returns those launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.launch.multi_job import JobRequest, run_multi_job, schedule_jobs
    from repro_torch.models.lm import LM

    mj = MULTI_JOB
    reqs = [JobRequest.parse(spec, arrival=2.0 * i) for i, spec in enumerate(mj["jobs"])]
    for r in reqs:
        r.batch, r.seq, r.reduced = mj["batch"], mj["seq"], r.arch in mj["reduced"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    out = run_multi_job(reqs, policy=mj["policy"], fabric=mj["fabric"],
                        execute_steps=mj["execute_steps"], timing_steps=mj["timing_steps"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    # attention layers per job: one flash launch each per step
    n_attn = [_attention_layers(LM(get_config(r.arch, reduced=r.reduced))) for r in reqs]
    expect = sum(n_attn) * (1 + mj["timing_steps"] + mj["execute_steps"])
    res = out["schedule"]
    _log(f"multi_job {list(mj['jobs'])} (reduced: {list(mj['reduced'])}, the rest at full "
         f"width), batch {mj['batch']} x seq {mj['seq']}, {mj['policy']} over {mj['fabric']}: "
         f"wall {wall:.3f} s ({len(reqs)} inits, 1 warm-up + {mj['timing_steps']} timed steps "
         f"each, the schedule, {mj['execute_steps']} executed steps each); "
         f"torch.cuda.max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB); flash kernel "
         f"launches {launches} (expected {n_attn} attention layers x (1 + "
         f"{mj['timing_steps']} + {mj['execute_steps']}) = {expect}); completion order "
         f"{out['order']}")
    _require(launches == expect, "multi_job: one flash launch per attention layer per step")
    _require(len(res.jct) == len(reqs) and res.censored == 0, "multi_job: every job completes")
    profiles = [out["profiles"][i] for i in range(len(reqs))]
    for jid, prof in enumerate(profiles):
        losses, warm = out["losses"][jid], out["warmup_losses"][jid]
        _log(f"  J{jid} {prof.name} on {reqs[jid].n_gpus} GPUs: t_f {prof.t_f} s, t_b {prof.t_b} "
             f"s (a third and two thirds of the timed step), size_bytes {prof.size_bytes}, "
             f"mem_mb {prof.mem_mb}; warm-up loss {warm!r}; executed losses {losses}")
        _require(len(losses) == mj["execute_steps"] and all(np.isfinite(losses)),
                 f"multi_job J{jid}: finite losses")
        _require(losses[0] == warm, f"multi_job J{jid}: the first executed loss is the warm-up's "
                 "(the same init on the same batch)")
    for policy in ("ada", "srsf1", "srsf2"):
        r = schedule_jobs(reqs, profiles, policy=policy, fabric=mj["fabric"])
        _log(f"multi_job schedule of the card's profiles, {r.policy_name} {r.placement_name}: avg "
             f"JCT {r.avg_jct()} s, JCTs {r.jct}, makespan {r.makespan} s, contended starts "
             f"{r.comm_started_contended}, clean starts {r.comm_started_clean}")
        _require(len(r.jct) == len(reqs), f"multi_job schedule {policy}: every job completes")
    span = reqs + [JobRequest.parse(spec, arrival=2.0 * (len(reqs) + i))
                   for i, spec in enumerate(SPAN_JOBS)]
    by_arch = {r.arch: prof for r, prof in zip(reqs, profiles)}
    for policy in ("ada", "srsf1", "srsf2"):
        r = schedule_jobs(span, [by_arch[q.arch] for q in span], policy=policy,
                          fabric=mj["fabric"])
        _log(f"multi_job schedule of the card's profiles with {list(SPAN_JOBS)} added, "
             f"{r.policy_name} {r.placement_name}: avg JCT {r.avg_jct()} s, JCTs {r.jct}, "
             f"makespan {r.makespan} s, contended starts {r.comm_started_contended}, clean "
             f"starts {r.comm_started_clean}")
        _require(len(r.jct) == len(span) and r.censored == 0,
                 f"multi_job schedule with spanning jobs, {policy}: every job completes")
        if policy == "ada":
            _require(r.comm_started_contended > 0,
                     "multi_job schedule with spanning jobs: ada gates a contended start")
    del out
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# The MoE and hybrid families (phases 34-38): olmoe-1b-7b and jamba-v0.1-52b
# ---------------------------------------------------------------------------

#: phase 34: the flash kernel at head dim 128, the shapes of olmoe's prefill
#: (batch 8 x 16 heads) and jamba's (batch 8 x 32 query heads, the 8 kv heads
#: repeated), prompt 512; the SSD step at jamba's shape (batch 8, 128 heads
#: of 64, state 128)
FLASH_D128 = {"olmoe-1b-7b": (128, 512, 512, 128), "jamba-v0.1-52b": (256, 512, 512, 128)}
SSD_H128 = (8, 128, 64, 128)
#: phase 36: jamba cut to one pattern block (8 of its 32 layers: 102 GB of
#: bf16 weights do not fit one 80 GB card)
JAMBA_LAYERS = 8
#: phase 38: olmoe trained at 4 of its 16 layers (at 16, bf16 weights and
#: grads with float32 moments alone take 6.82e9 x 12 B = 76 GiB)
OLMOE_TRAIN_LAYERS = 4
#: phase 39: the flash kernel at gemma-7b's prefill shape (batch 8 x 16
#: heads of 256, the DP-256 tensor-core instantiation) and arctic-480b's
#: (batch 8 x 64 padded query heads of 128, the 8 kv heads repeated)
FLASH_NEW = {"gemma-7b": (128, 512, 512, 256), "arctic-480b": (512, 512, 512, 128)}
#: the bf16 kernel against its emulation (tests/test_torch_flash_attention_cuda.py)
FLASH_EMULATION_TOL = 1e-2
#: phase 41: arctic cut to 1 of its 35 layers (one layer is 13.8e9 parameters,
#: 27.7 GB in bf16; two would leave no room for the init's peak)
ARCTIC_LAYERS = 1
#: phase 42: llama3.2-1b-swa8k served at batch 2: a prompt past the window
#: (the cache packed from its last 8,192 keys) and one whose decode wraps the
#: ring at step 32, inside the decode graph
SWA_BATCH = 2
SWA_PROMPTS = (12_288, 8_160)
#: phase 43: the reduced configs' sliding window, prompt and new tokens
SWA_REDUCED = dict(window=16, prompt=32, gen=8)
#: phase 44: the flash kernel under the full mask at the cross and encoder
#: attention of the two served models: the VLM's cross attention (batch 8 x
#: 32 query heads of 128, the 8 kv heads repeated, over 1,601 vision tokens:
#: 25 tiles of 64 keys and one of 1), seamless's encoder (batch 8 x 16
#: heads of 64 over 3,000 frames: 46 tiles and one of 56) and its decoder's
#: cross attention (a 512-token prompt over those frames)
FLASH_FULL = {"llama-3.2-vision-11b cross attention": (256, 512, 1601, 128),
              "seamless-m4t-large-v2 encoder": (128, 3000, 3000, 64),
              "seamless-m4t-large-v2 cross attention": (128, 512, 3000, 64)}
#: phase 47: the reduced vlm's cross gate (0 at init: the image would count
#: for nothing), and every attention's wq and wk scaled for both reduced
#: models, whose random init is chaotic even in float32 (ROADMAP R19)
CROSS_GATE = 0.5
TAME = 0.25


def _attention_layers(lm) -> int:
    """Attention layers of a model: one flash launch each per forward (an
    audio model's encoder layers and its decoder's self and cross
    attention; a vlm's cross layers are among its layers)."""
    cfg = lm.cfg
    if cfg.family == "ssm":
        return 0
    if cfg.family == "audio":
        return cfg.enc_layers + 2 * cfg.n_layers
    return lm.n_blocks if cfg.family == "hybrid" else cfg.n_layers


def _flash_masks(lm) -> dict:
    """Flash launches of one prefill of a vlm or audio model by mask:
    {"causal": self-attention layers, "full": encoder and cross layers}."""
    cfg = lm.cfg
    if cfg.family == "vlm":
        return {"causal": cfg.n_layers - lm.n_blocks, "full": lm.n_blocks}
    return {"causal": cfg.n_layers, "full": cfg.enc_layers + cfg.n_layers}


def _count_masks(run) -> dict:
    """{(causal, q shape, T): calls} of the flash kernel by the model's
    attention in one ``run()`` (outside the main path: a spy on the name
    ``models/attention.py`` calls, the kernel's own count untouched)."""
    from repro_torch.models import attention as attn_mod

    orig, calls = attn_mod.flash_attention, {}

    def spy(q, k, v, *, causal=True, **kw):
        key = (bool(causal), tuple(q.shape), k.shape[1])
        calls[key] = calls.get(key, 0) + 1
        return orig(q, k, v, causal=causal, **kw)

    attn_mod.flash_attention = spy
    try:
        run()
    finally:
        attn_mod.flash_attention = orig
    return calls


def _ssm_layers(lm) -> int:
    """SSD mixers of a model: one SSD launch each per decode step."""
    cfg = lm.cfg
    if cfg.family == "ssm":
        return cfg.n_layers
    return lm.n_blocks * (cfg.block_len - 1) if cfg.family == "hybrid" else 0


def _flash_shapes(torch, dev, shapes: dict, emulation=None, causal=True) -> list:
    """The flash kernel at each of ``shapes`` ({model: (BH, S, T, D)} of
    prefill attention; with ``causal`` False {path: (BH, S, T, D)} of the
    full mask) against its plain version in float32 (2e-5) and bf16 (3e-2)
    and, given ``emulation``, in bf16 against the tensor-core path's
    emulation (1e-2); then timed in CUDA graphs of 10 calls beside its
    bound, the plain version and SDPA.  Returns each shape's numbers."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention

    mask = "causal" if causal else "full mask"
    rows = []
    for arch, (bh, s, t, d) in shapes.items():
        where = f"{arch}'s prefill shape" if causal else arch
        max_abs = 0.0
        for name, dtype, tol in (("float32", torch.float32, 2e-5),
                                 ("bfloat16", torch.bfloat16, 3e-2)):
            q, k, v = _qkv(torch, bh + d, bh, s, t, d, dtype, dev)
            got = flash_attention(q, k, v, causal=causal)
            ref = flash_attention(q, k, v, causal=causal, impl="ref")
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs()
            err = float(diff.max())
            _log(f"flash parity at {where} BH={bh} S={s} T={t} D={d} {mask} "
                 f"{name}: max abs err {err} (bar {tol})")
            _require(bool((diff <= tol + tol * ref.float().abs()).all()),
                     f"flash kernel vs plain at {(bh, s, t, d, causal)} {name}")
            max_abs = max(max_abs, err)
            del ref, diff
            if emulation is not None and dtype == torch.bfloat16:
                emu = emulation(q, k, v, causal=causal)
                diff = (got.float() - emu.float()).abs()
                _log(f"flash at {where} bf16 against the tensor-core emulation: "
                     f"max abs err {float(diff.max())} (bar {FLASH_EMULATION_TOL})")
                _require(bool((diff <= FLASH_EMULATION_TOL
                               + FLASH_EMULATION_TOL * emu.float().abs()).all()),
                         f"flash kernel vs its emulation at {(bh, s, t, d, causal)}")
                del emu, diff
        q, k, v = _qkv(torch, bh, bh, s, t, d, torch.bfloat16, dev)
        fns = {"ref": lambda: flash_attention(q, k, v, causal=causal, impl="ref"),
               "cuda": lambda: flash_attention(q, k, v, causal=causal),
               "sdpa": lambda: F.scaled_dot_product_attention(
                   q[None], k[None], v[None], is_causal=causal)[0]}

        def run_of(fn, calls=10):
            def run():
                for _ in range(calls):
                    fn()
            return run

        timings = {}
        for impl in ("ref", "cuda", "sdpa", "sdpa", "cuda", "ref"):
            timings.setdefault(impl, []).append(_cuda_ms(torch, run_of(fns[impl]), True, 20) / 10)
        bound_ms, bound_by, nbytes, ops = _flash_bound(bh, s, t, d, 2, causal)
        kernel_ms, plain_ms, sdpa_ms = (min(timings[i]) for i in ("cuda", "ref", "sdpa"))
        _log(f"flash timing at {where} BH={bh} S={s} T={t} D={d} {mask} bf16 "
             f"(ms per call, device time in a CUDA graph of 10 calls, plain/kernel/sdpa/sdpa/"
             f"kernel/plain): kernel {timings['cuda']}, plain {timings['ref']}, "
             f"F.scaled_dot_product_attention {timings['sdpa']}; bound {bound_ms:.8f} ms "
             f"({bound_by}: {nbytes} B, {ops} ops), share of bound reached "
             f"{bound_ms / kernel_ms:.4f}, achieved {ops / kernel_ms / 1e9:.2f} TFLOP/s; kernel / "
             f"SDPA {kernel_ms / sdpa_ms:.4f}")
        label = (f"{arch} prefill BH {bh} S {s} D {d} bf16" if causal
                 else f"{arch} BH {bh} S {s} T {t} D {d} full mask bf16")
        rows.append({"shape": label, "max_abs_err": max_abs, "ms": kernel_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": sdpa_ms})
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def _new_shapes_phase(torch, dev) -> dict:
    """Phase 34: the flash kernel at the two D-128 prefill shapes and the
    SSD step at H 128 against their plain versions (float32 and bf16; the
    SSD step in place bit-equal to out of place), then timed with CUDA
    events beside their bounds (flash beside SDPA too).  Returns
    {"flash": [...], "ssd": [...]}: per shape, its numbers."""
    from repro_torch.kernels.ssd import ssd_decode_step

    out = {"flash": _flash_shapes(torch, dev, FLASH_D128), "ssd": []}
    b, h, p, n = SSD_H128
    max_abs = 0.0
    for name, dtype, tol in (("float32", torch.float32, 3 * 2e-5),
                             ("bfloat16", torch.bfloat16, 3 * 3e-2)):
        x = _ssd_inputs(torch, 128, b, h, p, n, dtype, dev)
        y, st = ssd_decode_step(*(x[key] for key in SSD_ORDER))
        y_ref, st_ref = ssd_decode_step(*(x[key] for key in SSD_ORDER), impl="ref")
        # in place on a view of a stacked (7, B, H, P, N) cache, as jamba's decode calls it
        stack = x["state"][None].repeat(7, 1, 1, 1, 1)
        view = stack[3]
        _require(view.is_contiguous() and view.data_ptr() % 16 == 0,
                 "the stacked cache's state view is contiguous and 16-byte aligned")
        y_in, st_in = ssd_decode_step(*(x[key] for key in SSD_ORDER[:-1]), view, out=view)
        torch.cuda.synchronize()
        _require(st_in is view and torch.equal(y_in, y) and torch.equal(view, st),
                 f"SSD in place on a cache view == out of place at H {h} {name}")
        _require(torch.equal(stack[2], x["state"]) and torch.equal(stack[4], x["state"]),
                 "the SSD step in place leaves the other mixers' states alone")
        diff_y = (y.float() - y_ref.float()).abs()
        diff_s = (st - st_ref).abs()
        _log(f"ssd parity at jamba's decode shape B={b} H={h} P={p} N={n} {name}: max abs err y "
             f"{float(diff_y.max())}, state {float(diff_s.max())}; in place on a view of the "
             f"stacked cache bit-equal to out of place")
        _require(bool((diff_y <= tol + tol * y_ref.float().abs()).all())
                 and bool((diff_s <= 1e-4 + 1e-4 * st_ref.abs()).all()),
                 f"SSD kernel vs plain at H {h} {name}")
        max_abs = max(max_abs, float(diff_y.max()), float(diff_s.max()))
    x = _ssd_inputs(torch, 129, b, h, p, n, torch.bfloat16, dev)
    others = [x[key] for key in SSD_ORDER[:-1]]
    k_states = max(2, int(np.ceil(COLD_BYTES / (b * h * p * n * 4))))
    states = [x["state"].clone() for _ in range(k_states)]

    def run_ssd(impl):
        def run():
            for st in states:
                if impl == "cuda":
                    ssd_decode_step(*others, st, out=st)
                else:
                    ssd_decode_step(*others, st, impl="ref")
        return run

    timings = {}
    for impl in ("ref", "cuda", "cuda", "ref"):
        timings.setdefault(impl, []).append(
            _cuda_ms(torch, run_ssd(impl), True, max(4, 320 // k_states)) / k_states)
    del states
    bound_ms, bound_by, nbytes, ops = _ssd_bound(b, h, p, n, 2)
    kernel_ms, plain_ms = min(timings["cuda"]), min(timings["ref"])
    _log(f"ssd timing at jamba's decode shape B={b} H={h} P={p} N={n} bf16 ({k_states} states "
         f"rotated, ms per call, device time in a CUDA graph, plain/kernel/kernel/plain): kernel "
         f"in place {timings['cuda']}, plain {timings['ref']}; bound {bound_ms:.8f} ms "
         f"({bound_by}: {nbytes} B, {ops} ops), share of bound reached "
         f"{bound_ms / kernel_ms:.4f}")
    out["ssd"].append({"shape": f"jamba decode B {b} H {h} P {p} N {n} bf16",
                       "max_abs_err": max_abs, "ms": kernel_ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    return out


def _family_serve_phase(torch, dev, arch: str, n_layers=None) -> dict:
    """Phases 35, 36, 40 and 41: ``serve_batch`` of ``arch`` at full width
    (cut to ``n_layers``), weights from PRNGKey(0) drawn on the card
    (timed), through the decode graph and eagerly (identical tokens), the
    flash and SSD launch counts over the graph's replays exact; sampled
    (temperature 0.8); then one prefill and decode steps under the
    profiler, every flash launch of the prefill the tensor-core
    instantiation of its head dim.  Returns the launches by kernel."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.ssd.kernel import ssd_decode_step_cuda
    from repro_torch.launch.serve import serve_batch, stub_embeddings
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.attention import _repeat_kv
    from repro_torch.models.common import param_count, tree_leaves
    from repro_torch.models.ffn import expert_capacity
    from repro_torch.models.lm import LM, RunFlags

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    bsz, plen, gen, seed = (SERVE[k] for k in ("batch", "prompt_len", "gen", "seed"))
    lm = LM(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(prng.PRNGKey(seed, dev), torch.bfloat16, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for _, t in tree_leaves(params))
    _require(n_params == param_count(lm.schema()), "parameters of the schema")
    _log(f"serve: {cfg.name} ({cfg.family}, {cfg.n_layers} layers"
         f"{f' of {get_config(arch).n_layers}' if n_layers else ''}, d_model {cfg.d_model}, "
         f"{cfg.n_heads} query heads"
         + (f" padded to {cfg.q_heads_padded}" if cfg.padded_heads else "")
         + f" over {cfg.n_kv_heads} kv heads of dim {cfg.head_dim_}, "
         + (f"{cfg.n_experts} experts top-{cfg.experts_per_token} of d_ff {cfg.moe_d_ff_} "
            f"(prefill capacity {expert_capacity(cfg, plen)} per sequence)" if cfg.n_experts
            else f"{cfg.act} d_ff {cfg.d_ff}")
         + (f", dense residual FFN of d_ff {cfg.d_ff}" if cfg.dense_residual else "")
         + (f", SSD {cfg.ssm_n_heads} heads x P {cfg.ssm_head_dim}, N {cfg.ssm_state}"
            if cfg.family == "hybrid" else "")
         + (f", gated cross attention every {cfg.cross_attn_every}th layer over "
            f"{cfg.vision_tokens} vision tokens" if cfg.family == "vlm" else "")
         + (f", {cfg.enc_layers} full-mask encoder layers over {cfg.audio_frames} frames, "
            f"cross attention in every decoder layer" if cfg.family == "audio" else "")
         + f", vocab {cfg.vocab_size}), {n_params} parameters ({cfg.param_count()} by the "
         f"analytic count), {param_bytes} B in bf16 from PRNGKey({seed}), drawn by the threefry "
         f"on the card in {init_s:.2f} s (peak {torch.cuda.max_memory_allocated()} B)")
    warm = serve_batch(cfg, bsz, plen, 2, seed, params=params)  # cuBLAS, allocator
    _log(f"serve warm-up (gen 2): prefill {warm['prefill_s']:.4f} s")
    del warm

    # ---- the main path, through the decode graph; then eagerly --------------
    res = _serve_both(torch, cfg.name, cfg, params, (flash_attention_cuda, ssd_decode_step_cuda))
    flash_n, ssd_n = res["launches"]
    want_flash, want_ssd = _attention_layers(lm), _ssm_layers(lm) * (gen - 1)
    _log(f"serve {cfg.name}: flash kernel launches {flash_n} (expected {want_flash}: one per "
         f"attention layer in prefill, none in decode), SSD kernel launches {ssd_n} over the "
         f"graph's replays (expected {_ssm_layers(lm)} mixers x {gen - 1} decode steps = "
         f"{want_ssd})")
    _require(flash_n == want_flash and ssd_n == want_ssd, f"{cfg.name}: exact launch counts")
    generated, logits = res["generated"], res["logits"]
    _require(generated.shape == (bsz, gen), "generated shape")
    _require(((generated >= 0) & (generated < cfg.vocab_size)).all(), "tokens in the vocab")
    _require(tuple(logits.shape) == (bsz, gen, cfg.vocab_size), "logits shape")
    _require(bool(torch.isfinite(logits).all()), "finite logits")
    # a decode step reads every weight (each expert's, at capacity 4 per
    # sequence) and the cache once; not the encoder's weights, nor the cross
    # sub-layers' wk and wv, whose keys and values the cache holds
    read_bytes = sum(t.numel() * t.element_size() for key, t in tree_leaves(params)
                     if not key.startswith("enc_") and not re.search(r"cross_attn/w[kv]$", key))
    cache = dict(tree_leaves(lm.init_cache(bsz, plen + gen, torch.bfloat16, dev)))
    cache_bytes = sum(t.numel() * t.element_size() for key, t in cache.items() if key != "pos")
    cross_bytes = sum(t.numel() * t.element_size() for key, t in cache.items()
                      if "/cross/" in key)
    del cache
    step_ms = res["decode_s"] / (gen - 1) * 1e3
    bound_ms = (read_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    _log(f"serve {cfg.name}: decode step through the graph {step_ms:.4f} ms (wall, capture "
         f"included) against its bytes bound {bound_ms:.4f} ms ({read_bytes} B of weights "
         f"read at decode + {cache_bytes} B of cache"
         + (f", of which {cross_bytes} B the cross keys and values" if cross_bytes else "")
         + f", at {HBM_BYTES_PER_S / 1e12} TB/s): {bound_ms / step_ms:.4f} of the bound")
    del logits, res
    sampled = serve_batch(cfg, bsz, plen, gen, seed, greedy=False, temperature=SAMPLE_T,
                          params=params)
    g = sampled["generated"]
    _require(g.shape == (bsz, gen) and ((g >= 0) & (g < cfg.vocab_size)).all(),
             f"{cfg.name}: sampled tokens in the vocab")
    _log(f"serve {cfg.name} sampled (temperature {SAMPLE_T}): decode "
         f"{sampled['decode_tok_per_s']:.1f} tok/s, "
         f"{sampled['decode_s'] / (gen - 1) * 1e3:.4f} ms per step (draw outside the graph); "
         f"sample tokens {g[0][:16].tolist()}")
    del sampled

    # ---- one prefill and decode steps under the profiler ---------------------
    flags = RunFlags(remat="none", q_chunk=min(512, plen))
    rng = np.random.default_rng(seed)  # serve_batch's draws: prompts, then the stub frontend's
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (bsz, plen)),
                             dtype=torch.int32).to(dev)
    inputs = {"tokens": tokens, **stub_embeddings(cfg, rng, bsz, torch.bfloat16, dev)}
    prefill = make_prefill_step(lm, plen + gen, flags)
    with torch.no_grad():
        _, cache0 = prefill(params, inputs)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            prefill(params, inputs)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        _, on_device = _profile(torch, lambda: prefill(params, inputs),
                                f"the {cfg.name} prefill", warmup=True,
                                complete=lambda on_device: sum(
                                    e.count for e in on_device if "flash_fwd" in e.key)
                                == want_flash)
        if cfg.family in ("vlm", "audio"):
            masks = _count_masks(lambda: prefill(params, inputs))
        if cfg.family == "audio":
            _, enc_on_device = _profile(torch, lambda: lm._encode(
                params, inputs["audio_embeds"], flags), f"the {cfg.name} encoder")
    device_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    flash_ms = sum(e.self_device_time_total for e in on_device if "flash_fwd" in e.key) / 1e3
    _require(flash_ms > 0, f"the profiler saw the {cfg.name} prefill's flash kernel")
    # bf16 pads the head dim to the tensor-core instantiation's 64, 128 or 256
    dp = next(x for x in (64, 128, 256) if cfg.head_dim_ <= x)
    flash_keys = {e.key: e.count for e in on_device if "flash_fwd" in e.key}
    _log(f"{cfg.name} prefill's flash kernels: {flash_keys}")
    _require(sum(flash_keys.values()) == want_flash
             and all(f"flash_fwd_tc_kernel<{dp}>" in key or f"flash_fwd_tc_kernelILi{dp}E" in key
                     for key in flash_keys),
             f"{cfg.name}: every prefill flash launch is the bf16 D-{dp} tensor-core kernel")
    _log(f"{cfg.name} prefill profile (batch {bsz}, prompt {plen}): wall {walls} ms = "
         f"{bsz * plen / min(walls) * 1e3:.1f} tok/s; device time {device_ms:.4f} ms in "
         f"{sum(e.count for e in on_device)} kernels and copies, of which the flash kernel "
         f"{flash_ms:.4f} ms ({flash_ms / device_ms:.4f}); device idle share "
         f"{1 - device_ms / min(walls):.4f}")
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:6]:
        _log(f"  {e.key[:80]}: {e.count} x, {e.self_device_time_total / 1e3:.4f} ms")
    if cfg.family in ("vlm", "audio"):
        by_mask = {"causal": sum(n for (c, _, _), n in masks.items() if c),
                   "full": sum(n for (c, _, _), n in masks.items() if not c)}
        _log(f"{cfg.name} prefill's flash launches by mask and (BH, S, D), T: "
             + "; ".join(f"{'causal' if c else 'full'} {shape}, T {t}: {n}"
                         for (c, shape, t), n in sorted(masks.items())))
        _require(by_mask == _flash_masks(lm),
                 f"{cfg.name}: flash launches by mask {by_mask}, expected {_flash_masks(lm)}")
    if cfg.family == "audio":
        enc_ms = sum(e.self_device_time_total for e in enc_on_device) / 1e3
        enc_flash = sum(e.self_device_time_total for e in enc_on_device
                        if "flash_fwd" in e.key) / 1e3
        _log(f"{cfg.name} encoder alone ({cfg.enc_layers} layers over {cfg.audio_frames} frames, "
             f"batch {bsz}): device time {enc_ms:.4f} ms, {enc_ms / device_ms:.4f} of the "
             f"prefill's; its flash kernel {enc_flash:.4f} ms ({enc_flash / enc_ms:.4f})")
    key, expect = ("ssd_step", True) if cfg.family == "hybrid" else ("flash_fwd", False)
    decode_ms = _decode_modes(torch, cfg.name, lm, params, cache0,
                              torch.as_tensor(generated[:, :1]).to(dev), flags, key, expect)
    if cfg.family == "vlm":
        # decode_cross_attention repeats each cross layer's 8 kv heads to 32
        # for every step: the copies alone, in a CUDA graph
        cross, n_rep = cache0["layers"]["cross"], cfg.q_heads_padded // cfg.n_kv_heads

        def repeat_cross():
            for i in range(lm.n_blocks):
                _repeat_kv(cross["k"][i], n_rep)
                _repeat_kv(cross["v"][i], n_rep)

        rep_ms = _cuda_ms(torch, repeat_cross, True, 20)
        rep_bytes = cross_bytes * (1 + n_rep)
        _log(f"{cfg.name} decode: the cross cache's head repeat ({lm.n_blocks} layers x k and v, "
             f"{cfg.n_kv_heads} -> {cfg.q_heads_padded} heads; {rep_bytes} B read and written) "
             f"alone in a CUDA graph {rep_ms:.4f} ms, {rep_ms / decode_ms['graph']:.4f} of the "
             f"graph's decode step device time {decode_ms['graph']:.4f} ms")
    del params, cache0
    torch.cuda.empty_cache()
    return {"flash": flash_n, "ssd": ssd_n}


def _reduced_family_phase(torch, dev, cfgs, prompt=32, gen=8, params_of=None) -> None:
    """Phases 37, 43 and 47: reduced configs in float32 on the plain path,
    served greedily and sampled (temperature 0.8) on the card and on the
    CPU: identical tokens.  ``params_of(cfg)``, where given, makes the
    weights both sides take (else each draws PRNGKey(0)'s)."""
    from repro_torch.launch.serve import serve_batch

    for red in cfgs:
        params = params_of(red) if params_of is not None else None
        for mode, kw in (("greedy", {}), ("sampled", dict(greedy=False, temperature=SAMPLE_T))):
            on_card = serve_batch(red, 2, prompt, gen, 0, device=dev, dtype=torch.float32,
                                  attn_impl="ref", ssd_impl="ref", params=params, **kw)
            on_cpu = serve_batch(red, 2, prompt, gen, 0, device="cpu", dtype=torch.float32,
                                 params=params, **kw)
            same = on_card["generated"] == on_cpu["generated"]
            diff = float((on_card["logits"].cpu() - on_cpu["logits"]).abs().max())
            if not same.all():
                step = int(np.nonzero(~same.all(0))[0][0])
                _log(f"{red.name} f32 {mode}: card and CPU part at step {step}: card "
                     f"{on_card['generated'][:, step].tolist()}, CPU "
                     f"{on_cpu['generated'][:, step].tolist()}; max abs logit difference {diff}")
            _require(same.all(), f"{red.name} f32 {mode}: card vs CPU tokens")
            window = f" (sliding window {red.sliding_window})" if red.sliding_window else ""
            _log(f"{red.name}{window} f32 {mode}, prompt {prompt}, plain path, card vs CPU: "
                 f"identical generated tokens {on_card['generated'].tolist()}, max abs logit "
                 f"difference {diff}")


def _cross_params(red):
    """Phase 47's weights of a reduced vlm or audio config, float32 on the
    CPU: PRNGKey(0)'s, every attention's wq and wk times ``TAME``, the
    vlm's cross gates at ``CROSS_GATE``."""
    import torch

    from repro_torch import prng
    from repro_torch.models.lm import LM

    params = LM(red).init(prng.PRNGKey(0), torch.float32, "cpu")

    def tame(tree):
        if "wq" in tree:
            tree["wq"].mul_(TAME)
            tree["wk"].mul_(TAME)
        for v in tree.values():
            if isinstance(v, dict):
                tame(v)

    tame(params)
    if red.family == "vlm":
        params["blocks"]["cross_gate"].fill_(CROSS_GATE)
    return params


def _sliding_serve_phase(torch, dev) -> None:
    """Phase 42: llama3.2-1b-swa8k (the reference's ``LONG_CONTEXT_VARIANT``)
    at full width, batch 2, 64 new tokens, through the decode graph and
    eagerly (identical tokens), for each of ``SWA_PROMPTS``; the sliding
    prefill is plain PyTorch (the flash kernel has no window): exactly 0
    flash launches.  Then one prefill and decode steps under the profiler
    at each prompt."""
    from repro_torch import prng
    from repro_torch.configs import llama32_1b
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.lm import LM, RunFlags

    cfg = llama32_1b.LONG_CONTEXT_VARIANT
    lm = LM(cfg)
    gen, seed = SERVE["gen"], SERVE["seed"]
    params = lm.init(prng.PRNGKey(seed, dev), torch.bfloat16, dev)
    _log(f"serve: {cfg.name} (window {cfg.sliding_window}, {cfg.n_layers} layers, d_model "
         f"{cfg.d_model}), batch {SWA_BATCH}, prompts {SWA_PROMPTS}, {gen} new tokens")
    for plen in SWA_PROMPTS:
        w = lm.kv_window(plen + gen)
        wrap = w - plen if plen < w < plen + gen else None
        flash_attention_cuda.launches = 0
        res = serve_batch(cfg, SWA_BATCH, plen, gen, seed, params=params)
        launches = flash_attention_cuda.launches
        torch.cuda.synchronize()
        eager = serve_batch(cfg, SWA_BATCH, plen, gen, seed, params=params, _graph=False)
        for mode, r in (("CUDA graph", res), ("eager", eager)):
            _log(f"serve {cfg.name} prompt {plen} (ring of {w} slots; "
                 + (f"wraps at decode step {wrap}" if wrap is not None else
                    f"packed from the last {w} of {plen} keys") + f"), decode {mode}: prefill "
                 f"{r['prefill_s']:.4f} s = {r['prefill_tok_per_s']:.1f} tok/s; "
                 f"{r['decode_s'] / (gen - 1) * 1e3:.4f} ms per decode step")
        _require(bool((res["generated"] == eager["generated"]).all()),
                 f"{cfg.name} prompt {plen}: tokens through the decode graph == eager tokens")
        _require(bool(torch.isfinite(res["logits"]).all()), f"{cfg.name}: finite logits")
        _log(f"serve {cfg.name} prompt {plen}: graph tokens identical to eager; flash launches "
             f"{launches} (expected 0: the sliding prefill is plain PyTorch); sample tokens "
             f"{res['generated'][0][:16].tolist()}")
        _require(launches == 0, f"{cfg.name}: no flash launch in the sliding prefill")
        del res, eager
        flags = RunFlags(remat="none", q_chunk=min(512, plen))
        tokens = torch.as_tensor(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (SWA_BATCH, plen)), dtype=torch.int32).to(dev)
        prefill = make_prefill_step(lm, plen + gen, flags)
        with torch.no_grad():
            _, cache0 = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
            _, on_device = _profile(torch, lambda: prefill(params, {"tokens": tokens}),
                                    f"the {cfg.name} prefill")
        device_ms = sum(e.self_device_time_total for e in on_device) / 1e3
        _log(f"{cfg.name} prefill profile (batch {SWA_BATCH}, prompt {plen}): wall {wall:.4f} ms; "
             f"device time {device_ms:.4f} ms in {sum(e.count for e in on_device)} kernels and "
             f"copies; device idle share {1 - device_ms / wall:.4f}")
        for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:6]:
            _log(f"  {e.key[:80]}: {e.count} x, {e.self_device_time_total / 1e3:.4f} ms")
        tok = torch.zeros((SWA_BATCH, 1), dtype=torch.int32, device=dev)
        _decode_modes(torch, f"{cfg.name} prompt {plen}", lm, params, cache0, tok, flags,
                      "flash_fwd", False)
        del cache0
    del params
    torch.cuda.empty_cache()


def _moe_train_phase(torch) -> int:
    """Phase 38: ``train`` of olmoe-1b-7b at full width, cut to
    ``OLMOE_TRAIN_LAYERS`` layers, the flash launch count reset just
    before it.  Returns those launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.models.common import param_count
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=OLMOE_TRAIN_LAYERS)
    n_params = param_count(LM(cfg).schema())
    _log(f"train {cfg.name} at {OLMOE_TRAIN_LAYERS} of its 16 layers: {n_params} parameters, "
         f"{n_params * 12} B of bf16 weights and grads with float32 moments")
    run = _train_main(torch, cfg, flash_attention_cuda)
    launches = run["launches"]
    expect = OLMOE_TRAIN_LAYERS * TRAIN["steps"]
    _log(f"train {cfg.name}: flash kernel launches {launches} (expected {OLMOE_TRAIN_LAYERS} "
         f"layers x {TRAIN['steps']} steps = {expect}); router aux losses {run['aux']}")
    _require(launches == expect, "one flash launch per layer per step")
    _require(len(run["aux"]) == TRAIN["steps"] and all(np.isfinite(run["aux"]))
             and min(run["aux"]) > 0, f"{cfg.name}: finite, positive aux losses")
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.core import fluidsim
    from repro_torch.kernels.fluidstep import fluid_step_core
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.fluidstep import kernel as fs_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.scenarios import (
        QUICK_OVERRIDES, fluid_config, get_scenario, monte_carlo_fluid,
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
    entries = _ptxas_entries(flash_kernel.build_info()["log"])
    for dp, used_by in ((64, "llama3.2-1b's serve and training shape"),
                        (128, "olmoe-1b-7b's, jamba-v0.1-52b's and arctic-480b's prefill shapes"),
                        (256, "gemma-7b's prefill shape")):
        tc = [v for name, v in entries.items() if f"flash_fwd_tc_kernelILi{dp}E" in name]
        _require(len(tc) == 1, f"the ptxas log names the bf16 D-{dp} tensor-core instantiation")
        regs, spill_st, spill_ld = tc[0]
        _log(f"build: flash_attention.cu bf16 D-{dp} tensor-core instantiation ({used_by}): "
             f"{regs} registers, {spill_st} bytes spill stores, {spill_ld} bytes spill loads")
        _require(spill_st == 0 and spill_ld == 0, f"the bf16 D-{dp} flash instantiation spills")

    # ---- 3. kernel vs plain version -----------------------------------------
    _mark("3")
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
    _mark("4-5")
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
    _mark("7")
    paper = [get_scenario("paper", seed=s, **PAPER_CUT) for s in SEEDS]
    cfg = fluid_config(paper[0], comm="ada", placement="lwf")
    batch = fluidsim.stack_traces(
        [fluidsim.trace_from_jobs(s.job_list(), device=dev) for s in paper]
    )
    paper_tick = _tick_cost(torch, "paper ada batch, 8 lanes x 160 jobs", batch, cfg,
                            blocks=(8, 16, 32, cfg.chunk_steps))

    # phases 8-11's worker processes: phase 29's CPU side of monte_carlo_jct
    # (the longest, no card work) from phase 8 on, the rest from phase 10;
    # the others start and import meanwhile (no CUDA call)
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(max_workers=WFBP_WORKERS,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        mc_cpu = pool.submit(_mc_worker, "cpu")
        for _ in range(WFBP_WORKERS - 1):
            pool.submit(_pool_imports)

        # ---- 8. the step kernel with its overlap plane ----------------------
        _mark("8")
        overlap_rows = _overlap_kernel_phase(torch, dev)

        # ---- 9. the WFBP and exact k-way main path ---------------------------
        _mark("9")
        t0 = time.perf_counter()
        wfbp_main, wfbp_launches, wfbp_ticks = _main_wfbp_phase(torch, chunk_steps)
        _log(f"main path, WFBP and k-way: {len(MAIN_WFBP)} batches, one at a time, wall "
             f"{time.perf_counter() - t0:.3f} s; fluid_step_core launches {wfbp_launches} "
             f"(counted over graph replays), executed ticks {wfbp_ticks}")
        _require(wfbp_launches == wfbp_ticks > 0, "one launch per executed tick")

        # ---- 10./11. plain core and eager; card against CPU ------------------
        _mark("10-11")
        mc_cpu, rest_cpu = _wfbp_checks_phase(torch, dev, {**wfbp_main, "paper ada": ada},
                                              chunk_steps, pool, mc_cpu)

    # ---- 12. per tick: one model_zoo chunk through the graph -----------------
    _mark("12")
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

    # ---- 13.-17. the SSD decode-step kernel and the serving path ----------
    _mark("13-17")
    ssd = _ssd_kernel_phase(torch, dev)
    ssd["launches"] = _serve_phases(torch, dev)

    # ---- 18.-23. the flash-attention kernel and dense serving --------------
    _mark("18-23")
    flash = _flash_kernel_phase(torch, dev)
    flash["launches"] = _dense_serve_phases(torch, dev)

    # ---- 24. the threefry: card against CPU ---------------------------------
    _mark("24")
    _prng_phase(torch, dev)

    # ---- 25.-28. training -------------------------------------------------
    _mark("25-28")
    mesh_pool, mesh_imports = _mesh_pool()  # phase 51's process imports meanwhile
    try:
        flash["launches"] += _train_phases(torch, dev)

        # ---- 51. training through a one-rank NCCL mesh (that process) --------
        _mark("51")
        flash["launches"] += _mesh_phase(mesh_pool, mesh_imports)
    finally:
        mesh_pool.shutdown()

    # ---- 29. the random placement ----------------------------------------------
    _mark("29")
    random_launches, random_ticks = _random_phase(torch, dev, chunk_steps)
    main_launches += random_launches

    # ---- 31./32. the event engine on the host, against the fluid path -------
    # in worker processes, beside no card phase but phase 50 (a)'s fluid cells
    # and phase 29's monte_carlo_jct
    _mark("31-32")
    with ProcessPoolExecutor(max_workers=EVENT_WORKERS,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        event_runs = _submit_event_runs(pool)
        # ---- 50 (a). the sweep's fluid cells on the card, meanwhile ----------
        _mark("50 (a), card side, beside the workers")
        rest_card = _rest_fluid_card(torch, chunk_steps)
        # ---- 29. monte_carlo_jct on the card, meanwhile ----------------------
        _mark("29 (monte_carlo_jct), card side, beside the workers")
        _mc_phase(mc_cpu)
        _mark("31-32, the workers' results")
        _event_phases(event_runs, results[:3])
        # ---- 49. the dynamic event engine, in the same worker processes ------
        _mark("49")
        _dynamic_phase(event_runs)
        # ---- 50 (b). chunks, ring edges, rescan, observed and profiled runs --
        _mark("50 (b)")
        _rest_phase(event_runs)
    _mark("50 (a)")
    rest_launches = _rest_fluid_phase(rest_card, rest_cpu)

    # ---- 30. sampled serving ------------------------------------------------
    _mark("30")
    _sampled_phase(torch, dev)

    # ---- 33. multi_job: real training jobs profiled on the card -------------
    _mark("33")
    flash["launches"] += _multi_job_phase(torch)

    # ---- 34. the flash kernel at D 128 and the SSD step at H 128 ------------
    _mark("34")
    shapes = _new_shapes_phase(torch, dev)
    flash["shapes"], ssd["shapes"] = shapes["flash"], shapes["ssd"]

    # ---- 35./36. olmoe-1b-7b and jamba-v0.1-52b served at full width ---------
    for phase, arch, n_layers in (("35", "olmoe-1b-7b", None),
                                  ("36", "jamba-v0.1-52b", JAMBA_LAYERS)):
        _mark(phase)
        served = _family_serve_phase(torch, dev, arch, n_layers)
        flash["launches"] += served["flash"]
        ssd["launches"] += served["ssd"]

    # ---- 37. the reduced MoE and hybrid configs: card against CPU -----------
    _mark("37")
    _reduced_family_phase(torch, dev, [get_config(a, reduced=True)
                                       for a in ("olmoe-1b-7b", "jamba-v0.1-52b")])

    # ---- 38. olmoe-1b-7b trained at 4 layers ----------------------------------
    _mark("38")
    flash["launches"] += _moe_train_phase(torch)

    # ---- 39. the flash kernel at gemma's D 256 and arctic's BH 512 -------------
    _mark("39")
    sys.path.insert(0, str(SRC.parent / "tests"))
    from test_torch_flash_attention_cuda import tensor_core_emulation

    flash["shapes"] += _flash_shapes(torch, dev, FLASH_NEW, tensor_core_emulation)

    # ---- 40./41. gemma-7b and arctic-480b served at full width ---------------
    for phase, arch, n_layers in (("40", "gemma-7b", None), ("41", "arctic-480b", ARCTIC_LAYERS)):
        _mark(phase)
        served = _family_serve_phase(torch, dev, arch, n_layers)
        flash["launches"] += served["flash"]
        ssd["launches"] += served["ssd"]

    # ---- 42. llama3.2-1b-swa8k: the sliding prefill and the ring's wrap -------
    _mark("42")
    _sliding_serve_phase(torch, dev)

    # ---- 43. the reduced configs of the new archs and windows: card vs CPU ----
    _mark("43")
    _reduced_family_phase(torch, dev, [get_config(a, reduced=True) for a in (
        "arctic-480b", "gemma-7b", "phi4-mini-3.8b", "yi-9b")])
    _reduced_family_phase(torch, dev, [
        dataclasses.replace(get_config(a, reduced=True), sliding_window=SWA_REDUCED["window"])
        for a in ("llama3.2-1b", "gemma-7b")], SWA_REDUCED["prompt"], SWA_REDUCED["gen"])

    # ---- 44. the flash kernel under the full mask: cross attention, encoder --
    _mark("44")
    flash["shapes"] += _flash_shapes(torch, dev, FLASH_FULL, tensor_core_emulation, causal=False)

    # ---- 45./46. llama-3.2-vision-11b and seamless-m4t-large-v2 at full width -
    for phase, arch in (("45", "llama-3.2-vision-11b"), ("46", "seamless-m4t-large-v2")):
        _mark(phase)
        served = _family_serve_phase(torch, dev, arch)
        flash["launches"] += served["flash"]
        ssd["launches"] += served["ssd"]

    # ---- 47. the reduced vision and audio configs: card against CPU ----------
    _mark("47")
    _reduced_family_phase(torch, dev, [get_config(a, reduced=True) for a in (
        "llama-3.2-vision-11b", "seamless-m4t-large-v2")], params_of=_cross_params)

    # ---- 50 (c). the event sweep in spawned processes and in this one ------
    _mark("50 (c)")
    _event_sweep_phase()

    # ---- 52 (b). the dry-run beside the card's measurements ------------------
    _mark("52 (b)")
    _dryrun_phase()

    line = {"kernels": [{
        "name": "fluid_step_core",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fluidstep/csrc/fluid_step.cu",
        "replaces": "src/repro/kernels/fluidstep/kernel.py:35",
        "launches": main_launches + wfbp_launches + rest_launches,
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
