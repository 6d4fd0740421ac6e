"""Multi-process helpers of the ``test_torch_sharding*`` files: spawn a
group of ``gloo`` ranks on the CPU (rendezvous through a ``file://`` store
under the test's temporary directory, never a fixed port: the suite runs
under several xdist workers), and the per-rank work the tests hold to the
reference.  The workers import torch and the port only (no JAX); each
writes what rank 0 saw into an ``.npz`` per case, which the test process
compares with the reference it computes meanwhile."""

import json
import os
from pathlib import Path

import numpy as np
import torch

#: batch and sequence of the sharded steps (the batch splits over 2 data ranks)
B, S = 2, 32
STEPS = 4
#: at the reference's init four chained float32 AdamW steps of the reduced
#: models with attention are chaotic (ROADMAP R8, R19, R24): their wq and
#: wk are scaled by 1/4 and the vlm's cross gate set to 0.5, as the vlm and
#: audio parity tests do, so the bars see the sharding, not the chaos
TAME, GATE = 0.25, 0.5


def start(fn, world: int, tmp: Path, *args):
    """``fn(rank, world, init_file, out_dir, *args)`` in ``world`` spawned
    processes, not waited for: returns the context to :func:`join`."""
    import torch.multiprocessing as mp

    out = Path(tmp)
    out.mkdir(parents=True, exist_ok=True)
    init = out / f"init_{fn.__name__}_{world}"
    return mp.start_processes(fn, args=(world, str(init), str(out)) + args, nprocs=world,
                              join=False, start_method="spawn")


def join(ctx, timeout: float = 600.0) -> None:
    import time

    t0 = time.monotonic()
    while not ctx.join(timeout=5):
        if time.monotonic() - t0 > timeout:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("the spawned ranks did not finish")


def init_group(rank: int, world: int, init_file: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)


def tame_params(params, family: str):
    """:data:`TAME` and :data:`GATE` applied to every family with attention
    (a power of two and a constant: the same values on both sides)."""
    if family == "ssm":
        return params

    def tame(t):
        if "wq" in t:
            return dict(t, wq=t["wq"] * TAME, wk=t["wk"] * TAME)
        return {k: tame(v) if isinstance(v, dict) else v for k, v in t.items()}

    params = tame(params)
    if family == "vlm":
        blocks = params["blocks"]
        params = dict(params, blocks=dict(blocks, cross_gate=blocks["cross_gate"] * 0 + GATE))
    return params


class FlashCount:
    """Counts the flash attention calls of the training path (the kernel's
    dispatch, ``ops.flash_attention``, which the autograd Function calls);
    installed once per process."""

    n = 0

    @classmethod
    def install(cls):
        from repro_torch.kernels.flash_attention import ops

        if not getattr(ops.flash_attention, "counted", False):
            fn = ops.flash_attention

            def counted(*a, **k):
                cls.n += 1
                return fn(*a, **k)

            counted.counted = True
            ops.flash_attention = counted
        return cls


def placement_strs(tree) -> dict:
    from repro_torch.models.common import tree_leaves

    return {k: [repr(p) for p in t.placements] for k, t in tree_leaves(tree)}


def run_steps(mesh, arch: str, strategy: str, steps: int = STEPS, remat: str = "none",
              loss_impl: str = "dense"):
    """``steps`` sharded float32 train steps of the reduced ``arch`` from
    ``PRNGKey(0)`` on ``mesh``: (metrics per step, full parameters as
    numpy, placements of the parameters and moments after each step,
    flash calls per step).  With ``mesh`` None the same steps on plain
    tensors (no placements)."""
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.lm import LM, RunFlags
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.sharding.rules import (
        ShardingStrategy, distribute, embeds_sharding, moment_shardings, param_shardings,
        token_sharding,
    )

    cfg = get_config(arch, reduced=True)
    lm = LM(cfg)
    params = tame_params(lm.init(prng.PRNGKey(0), torch.float32, "cpu"), cfg.family)
    ocfg = AdamWConfig()
    if mesh is None:
        opt = adamw_init(params, ocfg)
    else:
        st = ShardingStrategy.from_name(strategy)
        p_sh = param_shardings(lm.logical_axes(), params, mesh, st)
        m_sh = moment_shardings(p_sh, params, mesh, st)
        params = tree_map(distribute, params, p_sh)
        opt = adamw_init(params, ocfg, m_sh)
    step = make_train_step(lm, ocfg, RunFlags(remat=remat, q_chunk=S, loss_impl=loss_impl,
                                              loss_chunk=8))
    ds = SyntheticLMDataset(cfg, B, S)
    counter = FlashCount.install()
    metrics, placed, flash = [], [], []
    for i in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(i).items()}
        if mesh is not None:
            batch = {k: distribute(v, (token_sharding if v.ndim == 2 else embeds_sharding)(
                mesh, B)) for k, v in batch.items()}
        counter.n = 0
        params, opt, m = step(params, opt, batch)
        flash.append(counter.n)
        metrics.append({k: float(v) for k, v in m.items()})
        if mesh is not None:
            placed.append({"params": placement_strs(params), "m": placement_strs(opt["m"]),
                           "v": placement_strs(opt["v"])})
    full = {k: (t if mesh is None else t.full_tensor()).detach().numpy()
            for k, t in tree_leaves(params)}
    return metrics, full, placed, flash


def save_case(out_dir: str, name: str, metrics, full, placed, flash) -> None:
    np.savez(os.path.join(out_dir, f"{name}.npz"), **{f"p/{k}": v for k, v in full.items()},
             __json__=np.frombuffer(json.dumps({"metrics": metrics, "placed": placed,
                                                "flash": flash}).encode(), np.uint8))


def load_case(out_dir, name: str):
    with np.load(os.path.join(out_dir, f"{name}.npz")) as z:
        meta = json.loads(bytes(z["__json__"]).decode())
        full = {k[2:]: z[k] for k in z.files if k.startswith("p/")}
    return meta, full


def steps_worker(rank, world, init_file, out_dir, cases, local_checks=False):
    """Each case (name, mesh shape, arch, strategy, keywords of
    :func:`run_steps`) on its mesh over the same group; rank 0 saves.  With
    ``local_checks`` first :func:`check_local_shards` on every rank."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    init_group(rank, world, init_file)
    meshes = {}
    try:
        if local_checks:
            check_local_shards(rank, out_dir)
        for name, shape, arch, strategy, kw in cases:
            if shape not in meshes:
                meshes[shape] = make_host_mesh(*shape, device="cpu")
            res = run_steps(meshes[shape], arch, strategy, **kw)
            if rank == 0:
                save_case(out_dir, name, *res)
    finally:
        dist.destroy_process_group()


def _expected_slice(full: np.ndarray, spec, sizes: dict, coord: dict) -> np.ndarray:
    """The numpy slice of ``full`` that ``spec`` gives the rank at
    ``coord``: along each dim, the mesh axes its entry names split it
    major to minor in the order named."""
    idx = []
    for d, entry in enumerate(tuple(spec) + (None,) * (full.ndim - len(spec))):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
        n, k = 1, 0
        for a in axes:
            n, k = n * sizes[a], k * sizes[a] + coord[a]
        step = full.shape[d] // n
        idx.append(slice(k * step, (k + 1) * step))
    return full[tuple(idx)]


def check_local_shards(rank: int, out_dir: str) -> None:
    """On a (2, 2) ("data", "model") and a (2, 1, 2) ("pod", "data",
    "model") mesh of the 4 ranks: every leaf of the reduced llama and
    olmoe, distributed under tp and fsdp, holds on this rank the numpy
    slice its spec names.  Writes ``local_<rank>.json`` (leaves checked,
    mismatches)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.lm import LM
    from repro_torch.sharding.rules import ShardingStrategy, distribute, param_shardings

    meshes = {"2x2": init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model")),
              "2x1x2": init_device_mesh("cpu", (2, 1, 2),
                                        mesh_dim_names=("pod", "data", "model"))}
    checked, bad, tuples = 0, [], 0
    for arch in ("llama3.2-1b", "olmoe-1b-7b"):
        lm = LM(get_config(arch, reduced=True))
        params = lm.init(prng.PRNGKey(0), torch.float32, "cpu")
        for mname, mesh in meshes.items():
            sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
            coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
            for strategy in ("tp", "fsdp"):
                shs = dict(tree_leaves(param_shardings(lm.logical_axes(), params, mesh,
                                                       ShardingStrategy(strategy))))
                for k, t in tree_leaves(params):
                    sh = shs[k]
                    got = distribute(t, sh).to_local().numpy()
                    want = _expected_slice(t.numpy(), sh.spec, sizes, coord)
                    checked += 1
                    tuples += any(isinstance(e, tuple) for e in sh.spec)
                    if got.shape != want.shape or not np.array_equal(got, want):
                        bad.append(f"{arch} {mname} {strategy} {k} {sh.spec}")
    with open(os.path.join(out_dir, f"local_{rank}.json"), "w") as f:
        json.dump({"checked": checked, "bad": bad, "tuple_specs": tuples}, f)


#: ``train()`` cases of ``tests/test_torch_sharding_train.py``: reduced
#: llama in the trainer's bf16, batch 2 x 32, lr 3e-3 (so the loss falls)
TRAIN_KW = dict(batch=2, seq=32, lr=3e-3, log_every=0, device="cpu")
TRAIN_STEPS = 8


def train_worker(rank, world, init_file, out_dir):
    """On 2 ranks: ``train()`` at mesh (2, 1) and (1, 2); a (1, 2) run
    checkpointed at steps 2 and 4, resumed at (2, 1) to step 6, and its
    step-4 checkpoint restored into the (2, 1) tree (every leaf gathered
    whole); a 2-step (2, 1) run logged as the CLI logs.  Every rank writes
    ``train_<rank>.json``; rank 0 also ``restored.npz``."""
    import contextlib
    import io

    import torch.distributed as dist

    from repro_torch import prng
    from repro_torch.checkpoint.store import restore
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.sharding.rules import ShardingStrategy, distribute, param_shardings

    init_group(rank, world, init_file)
    cfg = get_config("llama3.2-1b", reduced=True)
    ckpt = os.path.join(out_dir, "ckpt")
    res = {}
    try:
        for shape in ((2, 1), (1, 2)):
            res[f"losses_{shape[0]}x{shape[1]}"] = train(cfg, steps=TRAIN_STEPS,
                                                         mesh_shape=shape, **TRAIN_KW)
        res["whole_1x2"] = train(cfg, steps=4, mesh_shape=(1, 2), ckpt_dir=ckpt, ckpt_every=2,
                                 **TRAIN_KW)
        res["resumed_2x1"] = train(cfg, steps=6, mesh_shape=(2, 1), ckpt_dir=ckpt, **TRAIN_KW)
        mesh = make_host_mesh(2, 1, device="cpu")
        lm = LM(cfg)
        params = lm.init(prng.PRNGKey(1), device="cpu")  # another seed: restore overwrites
        params = tree_map(distribute, params, param_shardings(
            lm.logical_axes(), params, mesh, ShardingStrategy("dp")))
        tree, step, _ = restore(ckpt, {"0": params, "1": adamw_init(params, AdamWConfig())},
                                step=4)
        res["restored_step"] = step
        res["restored_placements"] = sorted({repr(tuple(t.placements))
                                             for _, t in tree_leaves(tree) if hasattr(t, "placements")})
        full = {k: (t.full_tensor() if hasattr(t, "full_tensor") else t).float().numpy()
                for k, t in tree_leaves(tree)}
        if rank == 0:
            np.savez(os.path.join(out_dir, "restored.npz"), **full)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res["cli_like"] = train(cfg, steps=2, mesh_shape=(2, 1), **dict(TRAIN_KW, log_every=1))
        res["printed"] = buf.getvalue()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"train_{rank}.json"), "w") as f:
        json.dump(res, f)


def one_rank_worker(rank, world, init_file, out_dir):
    """chip_smoke.py's phase 51 on the CPU: the reduced llama trained plain
    (no process group), then through a one-rank mesh with ``train()``
    (``dp``) and under ``tp`` with ``make_train_step``; writes the three
    runs' losses to ``one_rank.json``."""
    import torch.distributed as dist

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset, make_train_iterator
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models.common import tree_map
    from repro_torch.models.lm import LM, RunFlags
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.sharding.rules import (
        ShardingStrategy, distribute, moment_shardings, param_shardings, token_sharding,
    )

    torch.set_num_threads(1)
    cfg = get_config("llama3.2-1b", reduced=True)
    kw = dict(TRAIN_KW, steps=4)
    res = {"plain": train(cfg, **kw)}
    init_group(rank, world, init_file)
    try:
        res["dp"] = train(cfg, mesh_shape=(1, 1), **kw)
        mesh = make_host_mesh(1, 1, device="cpu")
        lm, st, ocfg = LM(cfg), ShardingStrategy("tp"), AdamWConfig(lr=kw["lr"])
        params = lm.init(prng.PRNGKey(0), device="cpu")
        p_sh = param_shardings(lm.logical_axes(), params, mesh, st)
        params = tree_map(distribute, params, p_sh)
        opt = adamw_init(params, ocfg, moment_shardings(p_sh, params, mesh, st))
        step = make_train_step(lm, ocfg, RunFlags(remat="none", q_chunk=kw["seq"]))
        tok = token_sharding(mesh, kw["batch"])
        it = make_train_iterator(SyntheticLMDataset(cfg, kw["batch"], kw["seq"]), device="cpu",
                                 shardings={"tokens": tok, "labels": tok})
        res["tp"] = []
        try:
            for _ in range(kw["steps"]):
                params, opt, m = step(params, opt, next(it))
                res["tp"].append(float(m["loss"]))
        finally:
            it.close()
        res["tp_placements"] = sorted({repr(tuple(t.placements))
                                       for t in params["blocks"]["attn"].values()})
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, "one_rank.json"), "w") as f:
        json.dump(res, f)


#: the sharded serving cases' prompt, decode steps and cache length
SERVE_B, SERVE_S, SERVE_STEPS = 4, 16, 4
SERVE_MAX = SERVE_S + SERVE_STEPS


def serve_params(cfg, seed: int = 0):
    """float32 weights of the reduced ``cfg`` for the sharded serving and
    dry-run cases, drawn with ``torch.Generator(seed)`` by the schema's
    rule (normal * scale / sqrt(fan_in), zeros and ones as specified) and
    tamed (:func:`tame_params`): the cases hold the sharded port to the
    plain port on the same weights, so the threefry's reference draws (14 s
    a reduced model on the CPU) are not needed."""
    import math

    from repro_torch.models.common import tree_leaves, tree_unflatten
    from repro_torch.models.lm import LM

    gen = torch.Generator().manual_seed(seed)

    def make(spec):
        if spec.init in ("zeros", "ones"):
            return (torch.zeros if spec.init == "zeros" else torch.ones)(spec.shape)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        return torch.randn(spec.shape, generator=gen) * (spec.scale / math.sqrt(max(fan_in, 1)))

    # LM.init's layout: leaves in sorted-key order
    return tame_params(tree_unflatten({k: make(spec) for k, spec in tree_leaves(LM(cfg).schema())}),
                       cfg.family)


def serve_inputs(cfg, seed: int = 0):
    """The prompt (B, S), the teacher-forced decode tokens (B, steps) and
    the stub embeddings of the sharded serving cases, from ``seed``."""
    from repro_torch.launch.serve import stub_embeddings

    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, (SERVE_B, SERVE_S)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (SERVE_B, SERVE_STEPS)).astype(np.int32)
    embeds = {k: v.numpy() for k, v in
              stub_embeddings(cfg, rng, SERVE_B, torch.float32, "cpu").items()}
    return prompt, forced, embeds


def serve_run(cfg, params, mesh=None, strategy: str = "tp", mode: str = "auto",
              constrain: bool = False):
    """Prefill the serving cases' prompt, then decode its forced tokens
    through ``make_prefill_step`` / ``make_serve_step``: plain (``mesh``
    None) or with parameters placed by ``param_shardings`` under
    ``strategy``, the batch by ``token_sharding`` and the prefill's cache by
    ``place_cache(mode)``.  Returns (last-token logits of the prefill, the
    logits of each decode step) as numpy, and the cache's placements."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.lm import LM, RunFlags
    from repro_torch.sharding.rules import (
        ShardingStrategy, distribute, embeds_sharding, full, param_shardings, place_cache,
        token_sharding,
    )

    lm = LM(cfg)
    prompt, forced, embeds = serve_inputs(cfg)
    batch = {"tokens": torch.from_numpy(prompt),
             **{k: torch.from_numpy(v) for k, v in embeds.items()}}
    if mesh is not None:
        st = ShardingStrategy.from_name(strategy)
        params = tree_map(distribute, params, param_shardings(lm.logical_axes(), params, mesh, st))
        batch = {k: distribute(v, (token_sharding if v.dim() == 2 else embeds_sharding)(
            mesh, SERVE_B)) for k, v in batch.items()}
    flags = RunFlags(remat="none", q_chunk=SERVE_S, decode_constrain=constrain)
    logits, cache = make_prefill_step(lm, SERVE_MAX, flags)(params, batch)
    out = [full(logits).numpy()]
    placed = {}
    if mesh is not None:
        cache = place_cache(cache, mesh, SERVE_B, cfg, mode=mode)
        placed = {k: [repr(p) for p in t.placements] for k, t in tree_leaves(cache)}
    step = make_serve_step(lm, flags)
    for i in range(SERVE_STEPS):
        tok = torch.from_numpy(forced[:, i:i + 1].copy())
        if mesh is not None:
            tok = distribute(tok, token_sharding(mesh, SERVE_B))
        logits, cache = step(params, cache, tok)
        out.append(full(logits).numpy())
    return out, placed


def serve_worker(rank, world, init_file, out_dir, cases, train_cases=()):
    """Each serving case (name, mesh shape, arch, strategy, cache mode,
    decode_constrain) on its mesh over the same group, the reduced arch in
    float32 (:func:`serve_params`); rank 0 writes the logits to
    ``<name>.npz``.  Each train case (name, mesh shape, arch, strategy)
    runs one step with and without ``constrain_acts`` and writes both
    metrics to ``<name>.json``."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh

    init_group(rank, world, init_file)
    meshes = {}
    try:
        for name, shape, arch, strategy, mode, constrain in cases:
            if shape not in meshes:
                meshes[shape] = make_host_mesh(*shape, device="cpu")
            cfg = get_config(arch, reduced=True)
            params = serve_params(cfg)
            out, placed = serve_run(cfg, params, meshes[shape], strategy, mode, constrain)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{name}.npz"),
                         **{f"l{i}": v for i, v in enumerate(out)},
                         __json__=np.frombuffer(json.dumps(placed).encode(), np.uint8))
        for name, shape, arch, strategy in train_cases:
            if shape not in meshes:
                meshes[shape] = make_host_mesh(*shape, device="cpu")
            res = {}
            for on in (False, True):
                res[str(on)] = _constrained_step(meshes[shape], arch, strategy, on)
            if rank == 0:
                with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
                    json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _constrained_step(mesh, arch: str, strategy: str, on: bool) -> dict:
    """One sharded float32 train step of the reduced ``arch`` (step 0's
    batch, :func:`serve_params`) with ``RunFlags(constrain_acts=on)``: its
    metrics."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import tree_map
    from repro_torch.models.lm import LM, RunFlags
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.sharding.rules import (
        ShardingStrategy, distribute, embeds_sharding, moment_shardings, param_shardings,
        token_sharding,
    )

    cfg = get_config(arch, reduced=True)
    lm = LM(cfg)
    params = serve_params(cfg)
    st = ShardingStrategy.from_name(strategy)
    p_sh = param_shardings(lm.logical_axes(), params, mesh, st)
    params = tree_map(distribute, params, p_sh)
    ocfg = AdamWConfig()
    opt = adamw_init(params, ocfg, moment_shardings(p_sh, params, mesh, st))
    step = make_train_step(lm, ocfg, RunFlags(remat="none", q_chunk=S, constrain_acts=on))
    batch = {k: distribute(torch.from_numpy(v), (token_sharding if v.ndim == 2
                                                 else embeds_sharding)(mesh, B))
             for k, v in SyntheticLMDataset(cfg, B, S).batch_at(0).items()}
    _, _, m = step(params, opt, batch)
    return {k: float(v) for k, v in m.items()}


#: the collective-count cases: (name, world, mesh shape, strategy), reduced
#: llama, one train step at batch 4 x 32
COMM_CASES = (("dp2", 2, (2, 1), "dp"), ("tp2", 2, (1, 2), "tp"), ("fsdp2", 2, (2, 1), "fsdp"),
              ("dp4", 4, (4, 1), "dp"), ("tp4", 4, (2, 2), "tp"), ("fsdp4", 4, (2, 2), "fsdp"))
COMM_B = 4


def comm_step(mesh, strategy: str, meta: bool) -> dict:
    """One float32 train step of the reduced llama under ``strategy`` on
    ``mesh``, counted by ``launch.hlo.StepTrace``: every collective in
    order (kind, bytes, mesh dim), ``collective_bytes`` and the gradient
    bytes.  ``meta``: every input a meta shard (``abstract_place``), as the
    dry-run traces; else :func:`serve_params`' weights and step 0's batch."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.hlo import collective_bytes, trace_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.lm import LM, RunFlags
    from repro_torch.optim.adamw import AdamWConfig, abstract_opt_state, adamw_init
    from repro_torch.sharding.rules import (
        ShardingStrategy, abstract_place, distribute, moment_shardings, param_shardings,
        token_sharding,
    )

    cfg = get_config("llama3.2-1b", reduced=True)
    lm = LM(cfg)
    st, ocfg = ShardingStrategy.from_name(strategy), AdamWConfig()
    ap = lm.abstract_params(torch.float32)
    p_sh = param_shardings(lm.logical_axes(), ap, mesh, st)
    m_sh = moment_shardings(p_sh, ap, mesh, st)
    tok = token_sharding(mesh, COMM_B)
    raw = SyntheticLMDataset(cfg, COMM_B, S).batch_at(0)
    if meta:
        place = abstract_place
        params = tree_map(place, ap, p_sh)
        ao = abstract_opt_state(ap, ocfg)
        opt = {"m": tree_map(place, ao["m"], m_sh), "v": tree_map(place, ao["v"], m_sh),
               "step": ao["step"]}
        batch = {k: place(torch.empty(v.shape, dtype=torch.int32, device="meta"), tok)
                 for k, v in raw.items()}
    else:
        params = tree_map(distribute, serve_params(cfg), p_sh)
        opt = adamw_init(params, ocfg, m_sh)
        batch = {k: distribute(torch.from_numpy(v), tok) for k, v in raw.items()}
    step = make_train_step(lm, ocfg, RunFlags(remat="none", q_chunk=S))
    _, trace = trace_step(step, (params, opt, batch), mesh, donated=(params, opt))
    grad_bytes = sum(t.numel() * 4 for _, t in tree_leaves(ap))
    return {"records": [list(r) for r in trace.collectives], "bytes": collective_bytes(trace),
            "grad_bytes": grad_bytes}


def comm_worker(rank, world, init_file, out_dir):
    """The :data:`COMM_CASES` of this world size on real ``gloo`` ranks;
    rank 0 writes ``comm_gloo_<world>.json``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    init_group(rank, world, init_file)
    try:
        res = {name: comm_step(init_device_mesh("cpu", shape, mesh_dim_names=("data", "model")),
                               strategy, meta=False)
               for name, w, shape, strategy in COMM_CASES if w == world}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(out_dir, f"comm_gloo_{world}.json"), "w") as f:
            json.dump(res, f)


def flops_rows(trace) -> list:
    """A ``launch.hlo.StepTrace``'s FLOPs as [op, input shapes, FLOPs] rows."""
    return [[op, [list(s) for s in shp], n] for (op, shp), n in trace.flops_by_op.items()]


def weight_matrices(cfg, names) -> list:
    """The weights of ``cfg`` whose leaf is named in ``names``, as (rows,
    cols) matrices: their stacked dims ("layers", "sublayer") dropped, the
    first dim left (the input's) the rows."""
    import math

    from repro_torch.models.common import tree_leaves
    from repro_torch.models.lm import LM

    lm = LM(cfg)
    axes = dict(tree_leaves(lm.logical_axes()))
    out = set()
    for k, t in tree_leaves(lm.abstract_params()):
        if k.split("/")[-1] in names:
            dims = [d for d, a in zip(t.shape, axes[k]) if a not in ("layers", "sublayer")]
            out.add((dims[0], math.prod(dims[1:])))
    return sorted(out)


def weight_product_flops(rows, matrices) -> float:
    """The FLOPs of the :func:`flops_rows` ``rows`` that are products (no
    batch, or a batch of 1) of one of the weights ``matrices``: ``x @ W``,
    ``g @ W^T`` or the grad of ``W`` (an output of W's shape)."""

    def touches(a, b, w):
        if len(a) != len(b) or any(d != 1 for d in a[:-2]):
            return False
        return (b[-2], b[-1]) in (w, w[::-1]) or (a[-2], b[-1]) == w

    return sum(n for _, shp, n in rows if len(shp) == 2
               and any(touches(*shp, tuple(w)) for w in matrices))


def fake_worker(rank, world, init_file, out_dir, combos, part: int = 0):
    """In one process: with ``part`` 0 the :data:`COMM_CASES` as rank 0 of a
    ``fake`` process group of each world size, on meta shards
    (``comm_fake.json``); then ``dryrun.run_combo`` of each (arch,
    InputShape fields) in ``combos`` on the reduced config (this process's
    ``dryrun.config_for_shape`` returns it) over a fake (2, 2) mesh (``combos_<part>.json``: the result's counts, or the
    error; for a prefill or decode also the FLOPs by op and input shapes of
    the same step traced unsharded, on a fake one-rank mesh)."""
    import traceback

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.config import InputShape

    torch.set_num_threads(1)
    # the combos trace the reduced configs (this process only)
    dryrun.config_for_shape = lambda arch, shape: get_config(arch, reduced=True)
    res = {}
    for w in (2, 4) if part == 0 else ():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=w)
        try:
            for name, cw, shape, strategy in COMM_CASES:
                if cw == w:
                    res[name] = comm_step(init_device_mesh("cpu", shape,
                                                           mesh_dim_names=("data", "model")),
                                          strategy, meta=True)
        finally:
            dist.destroy_process_group()
    if part == 0:
        with open(os.path.join(out_dir, "comm_fake.json"), "w") as f:
            json.dump(res, f)
    out = {}
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
        for arch, fields in combos:
            shape = InputShape(*fields)
            try:
                r = dryrun.run_combo(arch, shape, mesh, dryrun.TUNED_PROFILES[arch])
                out[f"{arch}|{shape.name}"] = {k: r[k] for k in (
                    "status", "cost", "memory", "collectives", "roofline", "correction_deltas",
                    "flops_by_op") if k in r}
            except Exception:  # reported by the test
                out[f"{arch}|{shape.name}"] = {"status": "error",
                                               "error": traceback.format_exc()[-3000:]}
    finally:
        dist.destroy_process_group()
    # each prefill and decode again unsharded (the same global batch and
    # flags): its FLOPs by op and input shapes
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        one = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        for arch, fields in combos:
            shape, key = InputShape(*fields), f"{arch}|{fields[0]}"
            if shape.kind == "train" or out[key]["status"] != "ok":
                continue
            profile = dryrun.TUNED_PROFILES[arch]
            try:
                tr = dryrun._build_and_trace(get_config(arch, reduced=True), shape, one,
                                             profile, dryrun.run_flags(profile, shape))
                out[key]["unsharded"] = flops_rows(tr)
            except Exception:  # reported by the test
                out[key]["unsharded_error"] = traceback.format_exc()[-3000:]
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"combos_{part}.json"), "w") as f:
        json.dump(out, f)


# ---- the sharded step's reductions (test_torch_sharding_reductions.py) ----

#: the loss cases: logits (B, S, V_padded) and labels (B, S) with -1 and
#: values >= the vocab among them
LOSS_B, LOSS_S, LOSS_VOCAB, LOSS_VPAD = 4, 8, 60, 64
#: the MoE cases: batch x seq of the layer's input, the capacity factor
#: that makes it drop choices
MOE_B, MOE_S, MOE_CF = 4, 32, 0.25
#: the constrained decode: greedy tokens past the ring's wrap (window =
#: prompt + 4 slots)
DECODE_STEPS = 8


def loss_inputs(seed: int = 0):
    """float32 logits (B, S, V_padded), int64 labels (B, S) in [-1, V + 6)."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((LOSS_B, LOSS_S, LOSS_VPAD)) * 3).astype(np.float32)
    labels = rng.integers(-1, LOSS_VOCAB + 6, (LOSS_B, LOSS_S)).astype(np.int64)
    labels[0, :3] = (-1, LOSS_VOCAB, LOSS_VOCAB - 1)  # masked, masked, the vocab's last
    return logits, labels


def moe_setup(n_experts=None):
    """The reduced olmoe's config with :data:`MOE_CF` (and ``n_experts``
    where given), float32 weights of its MoE layer, the input x (B, S, D)
    and the output's cotangent, from numpy's ``default_rng(0)``."""
    import dataclasses
    import math

    from repro_torch.configs import get_config
    from repro_torch.models.ffn import moe_schema

    cfg = get_config("olmoe-1b-7b", reduced=True)
    cfg = dataclasses.replace(cfg, capacity_factor=MOE_CF, n_experts=n_experts or cfg.n_experts)
    rng = np.random.default_rng(0)
    params = {}
    for k, spec in sorted(moe_schema(cfg).items()):
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        params[k] = (rng.standard_normal(spec.shape) * spec.scale
                     / math.sqrt(fan_in)).astype(np.float32)
    x = rng.standard_normal((MOE_B, MOE_S, cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal((MOE_B, MOE_S, cfg.d_model)).astype(np.float32)
    return cfg, params, x, gy


def _loss_case(mesh):
    """The loss of :func:`loss_inputs` with the logits' batch split over
    "data" and the vocab over "model": (loss, logits grad) as numpy."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.common import cross_entropy_loss
    from repro_torch.sharding.rules import place

    logits, labels = loss_inputs()
    names = mesh.mesh_dim_names
    pl = [Shard(2) if n == "model" else Shard(0) for n in names]
    pb = [Replicate() if n == "model" else Shard(0) for n in names]
    x = place(torch.from_numpy(logits), mesh, pl).requires_grad_()
    loss = cross_entropy_loss(x, place(torch.from_numpy(labels), mesh, pb), LOSS_VOCAB)
    loss.backward()
    return loss.detach().full_tensor().numpy(), x.grad.full_tensor().numpy()


def _moe_case(mesh, n_experts):
    """:func:`repro_torch.models.ffn.moe` on :func:`moe_setup`'s inputs
    placed by the tp rules (the batch over "data"): y, aux, the routing ids
    and the grads of x and of each weight of ``(y * gy).sum() + aux``."""
    from repro_torch.models.common import tree_map
    from repro_torch.models.ffn import moe, moe_schema, route
    from repro_torch.sharding.rules import (
        ShardingStrategy, distribute, embeds_sharding, mesh_context, param_shardings,
    )

    cfg, params, x, gy = moe_setup(n_experts)
    axes = {k: s.axes for k, s in moe_schema(cfg).items()}
    p_t = {k: torch.from_numpy(v) for k, v in params.items()}
    sh = param_shardings(axes, p_t, mesh, ShardingStrategy("tp"))
    p_dt = tree_map(lambda t, s: distribute(t, s).requires_grad_(), p_t, sh)
    x_dt = distribute(torch.from_numpy(x), embeds_sharding(mesh, MOE_B)).requires_grad_()
    with mesh_context(p_dt):
        y, aux = moe(x_dt, p_dt, cfg)
        ids = route(x_dt, p_dt["router"], cfg.experts_per_token)[3]
        ((y * torch.from_numpy(gy)).sum() + aux).backward()
    out = {"y": y.full_tensor(), "aux": aux.full_tensor(), "ids": ids.full_tensor(),
           "g_x": x_dt.grad.full_tensor()}
    out.update({f"g_{k}": v.grad.full_tensor() for k, v in p_dt.items()})
    return {k: v.detach().numpy() for k, v in out.items()}


def greedy_decode(mesh=None):
    """The reduced llama (:func:`serve_params`) prefills the serving
    prompt, its cache window :data:`SERVE_S` + 4 slots, and decodes
    :data:`DECODE_STEPS` greedy tokens through ``make_serve_step``, past
    the ring's wrap: plain, or on ``mesh`` under ``tp`` with the cache
    placed sequence-sharded (``place_cache(mode="seq")``) and
    ``decode_constrain``.  Returns (tokens (B, steps), logits of each
    step) as numpy."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.common import tree_map
    from repro_torch.models.lm import LM, RunFlags
    from repro_torch.sharding.rules import (
        ShardingStrategy, distribute, full, param_shardings, place_cache, token_sharding,
    )

    cfg = get_config("llama3.2-1b", reduced=True)
    lm = LM(cfg)
    params = serve_params(cfg)
    prompt, _, _ = serve_inputs(cfg)
    tok = torch.from_numpy(prompt)
    if mesh is not None:
        params = tree_map(distribute, params, param_shardings(
            lm.logical_axes(), params, mesh, ShardingStrategy("tp")))
        tok = distribute(tok, token_sharding(mesh, SERVE_B))
    flags = RunFlags(remat="none", q_chunk=SERVE_S, decode_constrain=mesh is not None)
    logits, cache = make_prefill_step(lm, SERVE_S + 4, flags)(params, {"tokens": tok})
    if mesh is not None:
        cache = place_cache(cache, mesh, SERVE_B, cfg, mode="seq")
    step = make_serve_step(lm, flags)
    tokens, out = [], []
    for _ in range(DECODE_STEPS):
        nxt = torch.argmax(full(logits), dim=-1)[:, None].to(torch.int32)
        tokens.append(nxt[:, 0].numpy())
        if mesh is not None:
            nxt = distribute(nxt, token_sharding(mesh, SERVE_B))
        logits, cache = step(params, cache, nxt)
        out.append(full(logits).numpy())
    return np.stack(tokens, axis=1), out


def reductions_worker(rank, world, init_file, out_dir, cases):
    """Each case (name, kind, mesh shape, arg) on a ``gloo`` group of
    ``world`` ranks; rank 0 writes ``<name>.npz``.  Kinds: "loss"
    (:func:`_loss_case`; on a one-rank mesh also the plain port's loss and
    grad), "moe" (:func:`_moe_case`, ``arg`` the experts or None), "decode"
    (:func:`greedy_decode`)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    init_group(rank, world, init_file)
    try:
        for name, kind, shape, arg in cases:
            mesh = make_host_mesh(*shape, device="cpu")
            if kind == "loss":
                loss, grad = _loss_case(mesh)
                out = {"loss": loss, "grad": grad}
                if world == 1:
                    from repro_torch.models.common import cross_entropy_loss

                    logits, labels = loss_inputs()
                    x = torch.from_numpy(logits).requires_grad_()
                    plain = cross_entropy_loss(x, torch.from_numpy(labels), LOSS_VOCAB)
                    plain.backward()
                    out.update(plain_loss=plain.detach().numpy(), plain_grad=x.grad.numpy())
            elif kind == "moe":
                out = _moe_case(mesh, arg)
            else:
                tokens, logits = greedy_decode(mesh)
                out = {"tokens": tokens, **{f"l{i}": v for i, v in enumerate(logits)}}
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{name}.npz"), **out)
    finally:
        dist.destroy_process_group()


#: the reductions test's rank cases by world size: (name, kind, mesh
#: shape, arg) for :func:`reductions_worker`
REDUCTION_CASES = {1: [("loss_1x1", "loss", (1, 1), None)],
                   2: [("loss_1x2", "loss", (1, 2), None), ("moe_1x2", "moe", (1, 2), None),
                       ("decode_1x2", "decode", (1, 2), None)],
                   4: [("loss_2x2", "loss", (2, 2), None), ("loss_1x4", "loss", (1, 4), None),
                       ("moe_2x2", "moe", (2, 2), None), ("moe_1x4_ffn", "moe", (1, 4), 2)]}
#: the structural cases of the reductions test: (name, arch, InputShape
#: fields), each under its tuned profile (llama's decode constrained), on
#: a fake :data:`TRACE_MESH`
REDUCTION_TRACES = (("llama_train", "llama32_1b", ("train_p", 64, 8, "train")),
                    ("olmoe_train", "olmoe_1b_7b", ("train_p", 64, 8, "train")),
                    ("llama_decode", "llama32_1b", ("decode_p", 256, 8, "decode")))
TRACE_MESH = (2, 4)


def gathered_bytes(name: str, arch: str, fields) -> dict:
    """The per-rank bytes of the tensors a :data:`REDUCTION_TRACES` case's
    reductions would gather whole, on :data:`TRACE_MESH`: the float32
    (B, S, V) logits of a train step and, for olmoe, its (B, E*C, D)
    slots in the activations' bf16; the float32 (B, H, 1, W) logits of the
    decode step."""
    from repro_torch.configs import get_config
    from repro_torch.models.ffn import expert_capacity

    cfg = get_config(arch, reduced=True)
    seq, batch = fields[1], fields[2] // TRACE_MESH[0]
    if name.endswith("decode"):
        return {"decode logits": batch * cfg.q_heads_padded * seq * 4}
    out = {"logits": batch * seq * cfg.padded_vocab * 4}
    if cfg.family == "moe":
        out["slots"] = batch * cfg.n_experts * expert_capacity(cfg, seq) * cfg.d_model * 2
    return out


def reduction_trace_worker(rank, world, init_file, out_dir, mesh_shape):
    """:data:`REDUCTION_TRACES` traced as rank 0 of a fake group on the
    ("data", "model") mesh ``mesh_shape`` and unsharded on a fake one-rank
    mesh (``dryrun._build_and_trace``, reduced configs, tuned profiles);
    writes ``reduction_traces.json``: per case the sharded trace's
    collectives (kind, bytes, mesh dim) and both traces' FLOPs rows."""
    import math
    import traceback

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.config import InputShape

    torch.set_num_threads(1)
    out = {}
    for key, shape in (("sharded", tuple(mesh_shape)), ("whole", (1, 1))):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
        try:
            mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
            for name, arch, fields in REDUCTION_TRACES:
                rec = out.setdefault(name, {})
                ishape = InputShape(*fields)
                profile = dryrun.TUNED_PROFILES[arch]
                try:
                    tr = dryrun._build_and_trace(get_config(arch, reduced=True), ishape, mesh,
                                                 profile, dryrun.run_flags(profile, ishape))
                except Exception:  # reported by the case's test
                    rec["error"] = f"{key}: {traceback.format_exc()[-3000:]}"
                    continue
                rec[key] = flops_rows(tr)
                if key == "sharded":
                    rec["collectives"] = [list(c) for c in tr.collectives]
        finally:
            dist.destroy_process_group()
    with open(os.path.join(out_dir, "reduction_traces.json"), "w") as f:
        json.dump(out, f)


# ---- the sharded steps held to the plain port, for a host without JAX ----

_FAMILIES = {"dense": "llama3.2-1b", "ssm": "mamba2-130m", "moe": "olmoe-1b-7b",
             "hybrid": "jamba-v0.1-52b", "vlm": "llama-3.2-vision-11b",
             "audio": "seamless-m4t-large-v2"}
#: the sharded training cases of ``test_torch_sharding_steps.py`` (2 ranks)
#: and ``test_torch_sharding_mesh4.py`` (4 ranks): (name, mesh shape, arch,
#: strategy, keywords of :func:`run_steps`)
PLAIN_CHECK_CASES = {
    2: [(f"{fam}_{st}", shape, arch, st, {}) for st, shape in (("dp", (2, 1)), ("tp", (1, 2)))
        for fam, arch in _FAMILIES.items()]
    + [(f"dense_tp_{remat}", (1, 2), _FAMILIES["dense"], "tp",
        {"remat": remat, "loss_impl": loss, "steps": 2})
       for remat, loss in (("block", "dense"), ("dots", "dense"), ("none", "chunked"))],
    4: [("dense_tp_2x2", (2, 2), _FAMILIES["dense"], "tp", {}),
        ("dense_tp_1x4", (1, 4), _FAMILIES["dense"], "tp", {}),
        ("dense_fsdp_2x2", (2, 2), _FAMILIES["dense"], "fsdp", {}),
        ("moe_fsdp_2x2", (2, 2), _FAMILIES["moe"], "fsdp", {}),
        ("dense_zero1_2x2", (2, 2), _FAMILIES["dense"], "zero1", {}),
        ("moe_zero1_2x2", (2, 2), _FAMILIES["moe"], "zero1", {})],
}
#: the step tests' bars on the metrics (relative): loss, ce and aux; grad norm
METRIC_RTOL, GRAD_NORM_RTOL = 1e-5, 1e-3


def check_against_plain(out: Path) -> int:
    """:data:`PLAIN_CHECK_CASES` on 2 and then 4 spawned ``gloo`` ranks
    (:func:`steps_worker`) while this process runs the same steps on plain
    tensors (:func:`run_steps` with no mesh).  Prints each case's losses
    beside the plain ones; returns the number of cases whose metrics differ
    by more than :data:`METRIC_RTOL` / :data:`GRAD_NORM_RTOL`."""
    import time

    bad = 0
    for world, cases in PLAIN_CHECK_CASES.items():
        t0 = time.perf_counter()
        ctx = start(steps_worker, world, out / f"w{world}", cases)
        plain = {}
        try:
            for _, _, arch, _, kw in cases:
                key = (arch, tuple(sorted(kw.items())))
                if key not in plain:
                    plain[key] = run_steps(None, arch, "", **kw)[0]
        finally:
            join(ctx, 1800)
        for name, shape, arch, strategy, kw in cases:
            meta, _ = load_case(out / f"w{world}", name)
            want = plain[(arch, tuple(sorted(kw.items())))]
            worst = 0.0
            for got, ref in zip(meta["metrics"], want):
                for k in ("loss", "ce", "aux", "grad_norm"):
                    if k in ref:
                        lim = GRAD_NORM_RTOL if k == "grad_norm" else METRIC_RTOL
                        worst = max(worst, abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-30) / lim)
            ok = worst <= 1.0 and len(meta["metrics"]) == len(want)
            bad += not ok
            print(f"{'ok  ' if ok else 'FAIL'} {name} {shape} {strategy}: losses "
                  f"{[round(m['loss'], 6) for m in meta['metrics']]} against plain "
                  f"{[round(m['loss'], 6) for m in want]}; worst difference {worst:.3f} of "
                  f"its bar; flash calls {meta['flash']}", flush=True)
        print(f"{world} ranks: {len(cases)} cases in {time.perf_counter() - t0:.1f} s",
              flush=True)
    return bad


def _plain_reductions() -> dict:
    """The plain port's results for :data:`REDUCTION_CASES`: the loss and
    its logits grad, the MoE's outputs and grads (per expert count), the
    greedy decode's tokens and logits."""
    from repro_torch.models.common import cross_entropy_loss
    from repro_torch.models.ffn import moe, route

    logits, labels = loss_inputs()
    x = torch.from_numpy(logits).requires_grad_()
    loss = cross_entropy_loss(x, torch.from_numpy(labels), LOSS_VOCAB)
    loss.backward()
    out = {"loss": {"loss": loss.detach().numpy(), "grad": x.grad.numpy()}}
    for n in (None, 2):
        cfg, params, xx, gy = moe_setup(n)
        p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
        xt = torch.from_numpy(xx).requires_grad_()
        y, aux = moe(xt, p, cfg)
        ((y * torch.from_numpy(gy)).sum() + aux).backward()
        out[f"moe_{n}"] = {"y": y.detach().numpy(), "aux": aux.detach().numpy(),
                           "ids": route(xt, p["router"], cfg.experts_per_token)[3].numpy(),
                           "g_x": xt.grad.numpy(),
                           **{f"g_{k}": v.grad.numpy() for k, v in p.items()}}
    tokens, steps = greedy_decode()
    out["decode"] = {"tokens": tokens, **{f"l{i}": v for i, v in enumerate(steps)}}
    return out


def check_reductions(out: Path) -> int:
    """:data:`REDUCTION_CASES` on 1, 2 and 4 spawned ``gloo`` ranks and
    :data:`REDUCTION_TRACES` in a fake-group process, while this process
    computes the plain port's results: the reductions test's cases with
    the plain port in the reference's place, at its bars (the loss and its
    grad at 1e-6, one rank to the bit; the MoE's ids identical, y and
    grads at ``rtol=1e-4`` and 1e-5 of the scale, aux at ``rtol=1e-5``;
    the decode's tokens identical, its logits at 1e-5), and no trace's
    all-gather reaching :func:`gathered_bytes`.  Prints each case's worst
    difference and each trace's collective bytes; returns the number of
    failed checks."""
    ctxs = [start(reductions_worker, w, out, c) for w, c in REDUCTION_CASES.items()]
    ctxs.append(start(reduction_trace_worker, 1, out, TRACE_MESH))
    try:
        plain = _plain_reductions()
    finally:
        for ctx in ctxs:
            join(ctx, 900)
    bad = 0

    def check(ok, what):
        nonlocal bad
        bad += not ok
        print(f"{'ok  ' if ok else 'FAIL'} {what}", flush=True)

    def close(got, want, what, rtol, atol):
        scale = max(float(np.max(np.abs(want))), 1e-30)
        check(np.allclose(got, want, rtol=rtol, atol=atol * scale),
              f"{what}: max |diff| / scale {float(np.max(np.abs(got - want))) / scale:.3e}")

    for name, kind, shape, arg in (c for cs in REDUCTION_CASES.values() for c in cs):
        with np.load(out / f"{name}.npz") as z:
            got = {k: z[k] for k in z.files}
        if kind == "loss":
            want = plain["loss"]
            close(got["loss"], want["loss"], f"{name} loss", 1e-6, 1e-6)
            close(got["grad"], want["grad"], f"{name} grad", 1e-6, 1e-6)
            if "plain_loss" in got:
                check(got["loss"].tobytes() == got["plain_loss"].tobytes()
                      and got["grad"].tobytes() == got["plain_grad"].tobytes(),
                      f"{name}: the plain port's loss and grad to the bit")
        elif kind == "moe":
            want = plain[f"moe_{arg}"]
            check(np.array_equal(got["ids"], want["ids"]), f"{name}: routing ids identical")
            for k in want:
                if k != "ids":
                    close(got[k], want[k], f"{name} {k}", 1e-5 if k == "aux" else 1e-4,
                          0.0 if k == "aux" else 1e-5)
        else:
            want = plain["decode"]
            check(np.array_equal(got["tokens"], want["tokens"]),
                  f"{name}: greedy tokens identical {got['tokens'][0].tolist()}")
            for i in range(DECODE_STEPS):
                close(got[f"l{i}"], want[f"l{i}"], f"{name} step {i}", 1e-5, 1e-5)
    with open(out / "reduction_traces.json") as f:
        traces = json.load(f)
    for name, arch, fields in REDUCTION_TRACES:
        rec = traces[name]
        if "error" in rec:
            check(False, f"trace {name}: {rec['error']}")
            continue
        gathers = [b for kind, b, _ in rec["collectives"] if kind == "all-gather"]
        bars = gathered_bytes(name, arch, fields)
        check(max(gathers, default=0) < min(bars.values()),
              f"trace {name}: {sum(b for _, b, _ in rec['collectives'])} collective bytes a "
              f"rank, the largest all-gather {max(gathers, default=0)} B against {bars}")
    return bad


if __name__ == "__main__":
    # What the step and reductions tests hold to the JAX reference, held
    # here to the plain port instead (torch only):
    #     PYTHONPATH=src python tests/_torch_sharding.py [OUT_DIR]
    # Exits 1 where a case differs from the plain port beyond the bars.
    import sys
    import tempfile

    torch.set_num_threads(1)
    print(f"torch {torch.__version__}", flush=True)
    root = Path(sys.argv[1] if len(sys.argv) > 1 else
                tempfile.mkdtemp(prefix="sharding_plain_check_")).resolve()
    n_bad = check_reductions(root / "reductions")
    n_bad += check_against_plain(root)
    print("all cases match" if not n_bad else f"{n_bad} cases differ")
    sys.exit(1 if n_bad else 0)
