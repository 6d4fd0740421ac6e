"""The collectives one sharded train step of the port issues, by where they
come from: DTensor's redistributions (sharding propagation inside an op,
an explicit ``redistribute``, a ``local_map``'s entry and exit) and the
gradient and optimizer reductions.

    PYTHONPATH=src python scripts/sharding_comms.py [--arch llama3.2-1b ...]

Spawns ``gloo`` ranks on the CPU (a ``file://`` rendezvous in a temporary
directory) and runs, for each reduced arch and each of ``dp`` (2, 1),
``tp`` (1, 2), ``fsdp`` (2, 2) and ``zero1`` (2, 2), one warm-up step and
then one step of ``launch.steps.make_train_step``'s work in its three
parts (the loss's forward, its backward, the grads' reduction with the
AdamW update) under a dispatch mode that counts every collective.  Each
collective is attributed to the innermost frame of ``repro_torch`` on the
Python stack (in the backward pass, where autograd runs without one, to
the last DTensor op dispatched).  Prints one line per (step part, origin,
collective) with its count on rank 0.  Counts, not times: what a step
asks of the interconnect, the same on any device.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import tempfile

import torch

STRATEGIES = {"dp": (2, 1), "tp": (1, 2), "fsdp": (2, 2), "zero1": (2, 2)}
B, S = 4, 32


def _origin(last_op: str) -> str:
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename.replace(os.sep, "/")
        if "/repro_torch/" in path:
            return f"{path.split('/repro_torch/')[1]}:{f.f_code.co_name}"
        f = f.f_back
    return f"(autograd) after {last_op}"


def _counter():
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.part, self.last = "", ""
            self.counts = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                self.last = str(func.overloadpacket)
                return NotImplemented
            ns = func.namespace
            name = func.overloadpacket.__name__
            if (ns in ("_c10d_functional", "c10d_functional", "c10d") and "wait" not in name
                    and not name.startswith("_wrap")):
                self.counts[(self.part, _origin(self.last), name)] += 1
            return func(*args, **(kwargs or {}))

    return Count()


def _worker(rank, world, init_file, arch, strategy, shape):
    import torch.distributed as dist

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.lm import LM, RunFlags
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.sharding.rules import (
        ShardingStrategy, distribute, embeds_sharding, like, mesh_context, moment_shardings,
        param_shardings, token_sharding,
    )

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        mesh = make_host_mesh(*shape, device="cpu")
        cfg = get_config(arch, reduced=True)
        lm = LM(cfg)
        params = lm.init(prng.PRNGKey(0), torch.float32, "cpu")
        st = ShardingStrategy.from_name(strategy)
        p_sh = param_shardings(lm.logical_axes(), params, mesh, st)
        params = tree_map(distribute, params, p_sh)
        ocfg = AdamWConfig()
        opt = adamw_init(params, ocfg, moment_shardings(p_sh, params, mesh, st))
        flags = RunFlags(remat="none", q_chunk=S)
        data = SyntheticLMDataset(cfg, B, S)

        def batch(i):
            return {k: distribute(torch.from_numpy(v), (token_sharding if v.ndim == 2
                                                        else embeds_sharding)(mesh, B))
                    for k, v in data.batch_at(i).items()}

        params, opt, _ = make_train_step(lm, ocfg, flags)(params, opt, batch(0))  # warm-up
        b = batch(1)
        mode = _counter()
        for _, p in tree_leaves(params):
            p.grad = None
        with mode, mesh_context(params):
            mode.part = "forward"
            loss, _ = lm.loss_fn(params, b, flags)
            mode.part = "backward"
            loss.backward()
            mode.part = "update"
            grads = tree_map(lambda p: like(p.grad, p), params)
            adamw_update(params, grads, opt, ocfg)
        if rank == 0:
            for (part, where, coll), n in sorted(mode.counts.items()):
                print(f"{arch} {strategy} {shape}: {part:8s} {where} {coll} x{n}", flush=True)
            print(f"{arch} {strategy} {shape}: total {sum(mode.counts.values())} collectives",
                  flush=True)
    finally:
        dist.destroy_process_group()


def main() -> None:
    import torch.multiprocessing as mp

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["llama3.2-1b", "olmoe-1b-7b", "mamba2-130m"])
    ap.add_argument("--strategy", nargs="+", default=list(STRATEGIES))
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        for arch in args.arch:
            for strategy in args.strategy:
                shape = STRATEGIES[strategy]
                world = shape[0] * shape[1]
                init = os.path.join(tmp, f"{arch}_{strategy}")
                mp.spawn(_worker, args=(world, init, arch, strategy, shape), nprocs=world)


if __name__ == "__main__":
    main()
