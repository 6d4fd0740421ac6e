"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload paper-ada-mc64 --seed 7 --seconds 10 --trace 0

Runs the cell's Monte-Carlo batches through ``repro_torch`` on the card
for ``--seconds`` (the batch in flight finishes), checks a sample of the
finished lanes against the plain reference, and prints the result as one
JSON line, last on standard output; the compared numbers and their limits
are the last lines on standard error.  ``--trace 1`` profiles set chunks
and reports the per-layer metrics in place of the end-to-end ones.
Exits non-zero, with no result, without enough CUDA devices, without the
port's sources beside this folder, or when ``jax``, ``jaxlib``, ``flax``
or ``repro`` was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of a run lives at a fixed path inside the checkout
    cache = ROOT / ".portbench_cache"
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "cuda"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))

    from portbench.harness import bench, spec

    cell = spec.load_cell(args.workload)
    try:
        import repro_torch.scenarios  # noqa: F401
    except ImportError as e:
        return _fail(f"the port's sources are not beside the benchmark ({e})", 4)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return _fail(f"{args.workload} needs {cell.chips} CUDA device(s), found {n}", 2)

    out = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = bench.forbidden_modules()
    if bad:
        return _fail(f"modules that may not be loaded were loaded: {bad}", 3)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
