"""Training driver: single-process training on one device (port of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch llama3.2-1b --reduced --steps 100 --batch 8 --seq 128 \
        [--ckpt-dir DIR --ckpt-every 50] [--log-every 10] [--device cpu]

Runs on CUDA unless asked for the CPU.  The weights are the reference's
for the same seed (``LM.init(PRNGKey(seed))``, bf16), the optimizer
AdamW with float32 moments, the data the synthetic Zipf stream of
``repro_torch.data``.  Checkpoints hold the tree ``(params, opt_state)``
under the reference's flat keys (``0/...``, ``1/...``), so a run resumes
from either package's checkpoint.  The dense family's attention runs the
CUDA flash-attention kernel forward on the card.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch import prng
from repro_torch.checkpoint.store import latest_step, restore, save
from repro_torch.configs import served_config
from repro_torch.data import SyntheticLMDataset, make_train_iterator
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.common import tree_leaves
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM, RunFlags
from repro_torch.optim.adamw import AdamWConfig, adamw_init


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    ``mesh_shape`` other than (1, 1) raises: sharding is not ported."""
    if tuple(mesh_shape) != (1, 1):
        raise NotImplementedError(
            f"mesh_shape={tuple(mesh_shape)}: the port trains on one device; sharding "
            "waits (ROADMAP queue 1, item 10)")
    dev = resolve_device(device)
    lm = LM(cfg)
    opt_cfg = AdamWConfig(lr=lr)
    flags = RunFlags(remat=remat, q_chunk=min(512, seq))

    params = lm.init(prng.PRNGKey(seed), device=dev)
    opt_state = adamw_init(params, opt_cfg)
    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        tree, start, _ = restore(ckpt_dir, {"0": params, "1": opt_state})
        params, opt_state = tree["0"], tree["1"]
        print(f"[train] resumed from step {start}")

    step_fn = make_train_step(lm, opt_cfg, flags)
    it = make_train_iterator(SyntheticLMDataset(cfg, batch, seq, seed=seed),
                             start_step=start, device=dev)
    n_params = sum(p.numel() for _, p in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{steps} steps, batch {batch} x seq {seq}")

    losses: List[float] = []
    try:
        _sync(dev)
        t0 = time.perf_counter()
        for step in range(start, steps):
            params, opt_state, metrics = step_fn(params, opt_state, next(it))
            losses.append(float(metrics["loss"]))  # waits for the step
            if log_every and (step + 1) % log_every == 0:
                dt = time.perf_counter() - t0
                print(f"[train] step {step+1}: loss={losses[-1]:.4f} "
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
    losses = train(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr, seed=args.seed,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, log_every=args.log_every,
        mesh_shape=(args.mesh_data, args.mesh_model), remat=args.remat, device=args.device,
    )
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
