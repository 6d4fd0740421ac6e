"""One rank's counted FLOPs of one dry-run combo, split by op and by op
and input shapes, beside ``model_flops``: what sets a combo's useful
ratio, under this process's torch.

    PYTHONPATH=src python scripts/dryrun_flops_by_op.py \\
        [--arch llama32_1b] [--shape train_4k] [--mesh single] [--top 12]

Runs anywhere ``launch/dryrun.py`` runs (meta shards on a fake process
group; no card is needed).  Prints the torch version, the rank's FLOPs,
the global count and ``model_flops``, then the largest ops.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))


def main() -> None:
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch import hlo
    from repro_torch.launch.mesh import make_production_mesh, n_chips
    from repro_torch.launch.roofline import config_for_shape, model_flops
    from repro_torch.models.config import INPUT_SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama32_1b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    torch.set_num_threads(1)
    shape = INPUT_SHAPES[args.shape]
    cfg = config_for_shape(args.arch, shape)
    profile = dryrun.TUNED_PROFILES[args.arch]
    mesh = make_production_mesh(multi_pod=args.mesh == "multi")
    t0 = time.perf_counter()
    trace = dryrun._build_and_trace(cfg, shape, mesh, profile, dryrun.run_flags(profile, shape))
    chips = n_chips(mesh)
    mf = model_flops(cfg, shape)
    print(f"torch {torch.__version__}: {args.arch}|{args.shape}|{args.mesh}|tuned "
          f"({chips} ranks, {time.perf_counter() - t0:.1f} s to trace): {trace.flops:.6e} "
          f"FLOPs a rank, {trace.flops * chips:.6e} in all, model_flops {mf:.6e}, useful ratio "
          f"{mf / (trace.flops * chips):.4f}")
    print("by op:")
    for op, n in list(hlo.flops_by_op(trace).items())[:args.top]:
        print(f"  {op}: {n:.6e} ({n / trace.flops:.4f})")
    print("by op and input shapes:")
    for (op, shapes), n in list(hlo.flops_by_op(trace, shapes=True).items())[:args.top]:
        print(f"  {op} {list(shapes)}: {n:.6e} ({n / trace.flops:.4f})")


if __name__ == "__main__":
    main()
