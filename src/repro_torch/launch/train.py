"""Training driver (port of ``repro/launch/train.py``): one device, or a
mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch llama3.2-1b --reduced --steps 100 --batch 8 --seq 128 \
        [--ckpt-dir DIR --ckpt-every 50] [--log-every 10] [--device cpu]

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --arch llama3.2-1b --reduced \
        --mesh-data 2 [--mesh-model 1] --device cpu

Runs on CUDA unless asked for the CPU.  The weights are the reference's
for the same seed (``LM.init(PRNGKey(seed))``, bf16), the optimizer
AdamW with float32 moments, the data the synthetic Zipf stream of
``repro_torch.data``.  Checkpoints hold the tree ``(params, opt_state)``
under the reference's flat keys (``0/...``, ``1/...``), so a run resumes
from either package's checkpoint.  The attention of the dense, moe and
hybrid families runs the CUDA flash-attention kernel forward on the card.
For MoE models each logged step also prints ``aux``, the router losses
(``make_train_step``'s metric), which the loss includes.

Under a mesh (``mesh_shape`` = (data, model), a process group of that
many ranks) the parameters, moments and batches are DTensors placed by
``repro_torch.sharding``'s rules: ``tp`` where the model axis is wider
than 1, else ``dp``, the reference's choice.  Every rank builds the same
weights and the same global batch from the seed and keeps its slice; the
flash kernel runs on each rank's local heads.  ``main()`` joins the
process group from ``torch.distributed.run``'s environment (``nccl`` on
the card, ``gloo`` with ``--device cpu``) when the mesh has more than one
rank.  Each rank of a card needs a GPU of its own.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch.distributed as dist

from repro_torch import prng
from repro_torch.checkpoint.store import latest_step, restore, save
from repro_torch.configs import served_config
from repro_torch.data import SyntheticLMDataset, make_train_iterator
from repro_torch.device import rank_device, resolve_device, synchronize
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM, RunFlags
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.sharding.rules import (
    ShardingStrategy, distribute, embeds_sharding, moment_shardings, param_shardings,
    token_sharding,
)


def train(
    cfg: ModelConfig,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-4,
    seed: int = 0,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    log_every: int = 10,
    mesh_shape=(1, 1),
    remat: str = "none",
    device=None,
) -> List[float]:
    """Train ``cfg`` from ``PRNGKey(seed)`` (or the latest checkpoint in
    ``ckpt_dir``) up to step ``steps``; returns the loss of every step run.

    ``mesh_shape`` (data, model): with no process group, (1, 1) is the
    plain single-device path and anything else raises ``ValueError``; with
    an initialised default group (world size data * model, else
    ``ValueError``) the run goes through a ``DeviceMesh`` and DTensors, (1,
    1) included.  The returned losses, and what rank 0 prints, are alike on
    every rank."""
    mesh = None
    if tuple(mesh_shape) != (1, 1) or (dist.is_available() and dist.is_initialized()):
        mesh = make_host_mesh(*mesh_shape, device=device)
    dev = resolve_device(device) if mesh is None else rank_device(device)
    rank0 = mesh is None or dist.get_rank() == 0
    lm = LM(cfg)
    opt_cfg = AdamWConfig(lr=lr)
    flags = RunFlags(remat=remat, q_chunk=min(512, seq))

    params = lm.init(prng.PRNGKey(seed), device=dev)
    moments = None
    if mesh is not None:
        strategy = ShardingStrategy.from_name("tp" if mesh_shape[1] > 1 else "dp")
        p_sh = param_shardings(lm.logical_axes(), params, mesh, strategy)
        moments = moment_shardings(p_sh, params, mesh, strategy)
        params = tree_map(distribute, params, p_sh)
    opt_state = adamw_init(params, opt_cfg, moments)
    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        tree, start, _ = restore(ckpt_dir, {"0": params, "1": opt_state})
        params, opt_state = tree["0"], tree["1"]
        if rank0:
            print(f"[train] resumed from step {start}")

    step_fn = make_train_step(lm, opt_cfg, flags)
    shardings = None
    if mesh is not None:
        tok = token_sharding(mesh, batch)
        shardings = {"tokens": tok, "labels": tok, "audio_embeds": embeds_sharding(mesh, batch),
                     "image_embeds": embeds_sharding(mesh, batch)}
    it = make_train_iterator(SyntheticLMDataset(cfg, batch, seq, seed=seed),
                             start_step=start, device=dev, shardings=shardings)
    n_params = sum(p.numel() for _, p in tree_leaves(params))
    if rank0:
        where = "" if mesh is None else f", mesh {tuple(mesh_shape)} {strategy.name}"
        print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
              f"{steps} steps, batch {batch} x seq {seq}{where}")

    losses: List[float] = []
    try:
        synchronize(dev)
        t0 = time.perf_counter()
        for step in range(start, steps):
            params, opt_state, metrics = step_fn(params, opt_state, next(it))
            losses.append(float(metrics["loss"]))  # waits for the step
            if rank0 and log_every and (step + 1) % log_every == 0:
                dt = time.perf_counter() - t0
                aux = f"aux={float(metrics['aux']):.6g} " if cfg.n_experts else ""
                print(f"[train] step {step+1}: loss={losses[-1]:.4f} {aux}"
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"tok/s={log_every * batch * seq / dt:.0f}")
                t0 = time.perf_counter()
            if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
                save(ckpt_dir, step + 1, {"0": params, "1": opt_state}, {"loss": losses[-1]})
    finally:
        it.close()
    if ckpt_dir and losses:
        save(ckpt_dir, steps, {"0": params, "1": opt_state}, {"loss": losses[-1]})
    return losses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (plain PyTorch path)")
    args = ap.parse_args()
    cfg = served_config(args.arch, reduced=args.reduced)
    joined = args.mesh_data * args.mesh_model > 1 and not dist.is_initialized()
    if joined:
        # the rank, world size and rendezvous from torch.distributed.run's environment
        dist.init_process_group("gloo" if args.device == "cpu" else "nccl")
    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        losses = train(
            cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr, seed=args.seed,
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, log_every=args.log_every,
            mesh_shape=(args.mesh_data, args.mesh_model), remat=args.remat, device=args.device,
        )
    finally:
        if joined:
            dist.destroy_process_group()
    if losses and rank == 0:
        print(f"[train] done: first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")

if __name__ == "__main__":
    main()
