"""How far four chained float32 train steps drift at the reference's init
(ROADMAP R24), on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/sharding_init_chaos.py

1. The reduced jamba: the port's plain ``make_train_step`` against the
   JAX reference's jitted one, from the raw init and with every wq and wk
   scaled by 1/4 (``tame``).
2. The reduced llama under ``fsdp`` on a (2, 2) ``gloo`` mesh and under
   ``tp`` on a (1, 4) one (4 spawned ranks) against the port's plain step
   and the reference's, raw and tamed.

Prints, per step, each side's loss and grad norm and their relative
differences.  Imports the JAX package (the reference) beside the port.
"""

from __future__ import annotations

import os
import sys
import tempfile

import torch

B, S, STEPS = 2, 32, 4


def _tame(tree, scale):
    if "wq" in tree:
        return dict(tree, wq=tree["wq"] * scale, wk=tree["wk"] * scale)
    return {k: _tame(v, scale) if isinstance(v, dict) else v for k, v in tree.items()}


def _port_steps(arch, scale, mesh=None, strategy="dp"):
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import tree_map
    from repro_torch.models.lm import LM, RunFlags
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.sharding.rules import (
        ShardingStrategy, distribute, moment_shardings, param_shardings, token_sharding,
    )

    cfg = get_config(arch, reduced=True)
    lm = LM(cfg)
    params = _tame(lm.init(prng.PRNGKey(0), torch.float32, "cpu"), scale)
    moments = None
    if mesh is not None:
        st = ShardingStrategy.from_name(strategy)
        p_sh = param_shardings(lm.logical_axes(), params, mesh, st)
        moments = moment_shardings(p_sh, params, mesh, st)
        params = tree_map(distribute, params, p_sh)
    opt = adamw_init(params, AdamWConfig(), moments)
    step = make_train_step(lm, AdamWConfig(), RunFlags(remat="none", q_chunk=S))
    out = []
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v) for k, v in SyntheticLMDataset(cfg, B, S).batch_at(i).items()}
        if mesh is not None:
            batch = {k: distribute(v, token_sharding(mesh, B)) for k, v in batch.items()}
        params, opt, m = step(params, opt, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _reference_steps(arch, scale):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.data.pipeline import SyntheticLMDataset
    from repro.launch.steps import make_train_step
    from repro.models.lm import LM, RunFlags
    from repro.optim.adamw import AdamWConfig, adamw_init

    cfg = get_config(arch, reduced=True)
    params = _tame(LM(cfg).init(jax.random.PRNGKey(0), jnp.float32), scale)
    opt = adamw_init(params, AdamWConfig())
    step = jax.jit(make_train_step(LM(cfg), AdamWConfig(), RunFlags(remat="none", q_chunk=S)))
    out = []
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in SyntheticLMDataset(cfg, B, S).batch_at(i).items()}
        params, opt, m = step(params, opt, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _print(tag, a, b, names):
    for i, ((la, ga), (lb, gb)) in enumerate(zip(a, b)):
        print(f"{tag} step {i + 1}: loss {names[0]} {la!r} {names[1]} {lb!r} "
              f"(rel {abs(la - lb) / abs(lb):.3g}); grad norm {names[0]} {ga!r} {names[1]} "
              f"{gb!r} (rel {abs(ga - gb) / abs(gb):.3g})", flush=True)


def _mesh_worker(rank, world, init_file, out_file):
    import json

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        res = {}
        for shape, strategy in (((2, 2), "fsdp"), ((1, 4), "tp")):
            mesh = make_host_mesh(*shape, device="cpu")
            for scale in (1.0, 0.25):
                res[f"{strategy} {shape} {scale}"] = _port_steps("llama3.2-1b", scale, mesh,
                                                                 strategy)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_file, "w") as f:
            json.dump(res, f)


def main() -> None:
    import json

    import torch.multiprocessing as mp

    torch.set_num_threads(4)
    for scale in (1.0, 0.25):
        _print(f"jamba-v0.1-52b reduced, wq/wk x {scale}", _port_steps("jamba-v0.1-52b", scale),
               _reference_steps("jamba-v0.1-52b", scale), ("port", "reference"))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "sharded.json")
        mp.spawn(_mesh_worker, args=(4, os.path.join(tmp, "init"), out), nprocs=4)
        with open(out) as f:
            sharded = json.load(f)
    for scale in (1.0, 0.25):
        plain = _port_steps("llama3.2-1b", scale)
        ref = _reference_steps("llama3.2-1b", scale)
        _print(f"llama3.2-1b reduced, wq/wk x {scale}, plain", plain, ref, ("port", "reference"))
        for case in ("fsdp (2, 2)", "tp (1, 4)"):
            got = sharded[f"{case} {scale}"]
            _print(f"llama3.2-1b reduced, wq/wk x {scale}, {case} vs plain", got, plain,
                   (case.split()[0], "plain"))
            _print(f"llama3.2-1b reduced, wq/wk x {scale}, {case} vs reference", got, ref,
                   (case.split()[0], "reference"))


if __name__ == "__main__":
    sys.exit(main())
