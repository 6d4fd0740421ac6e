"""One run of one cell: set-up, the measured window, the correctness
check, the metrics and the result line."""

from __future__ import annotations

import gc
import sys
import time

from portbench.harness import check, spec, trace, traffic, window

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str,
             t_start: float) -> dict:
    """Run the cell and return its result line (a dict), ``checks`` last."""
    import torch

    on_card = device.startswith("cuda")
    record = window.RunRecord(config=cell.config, traffic=cell.traffic)
    window.warm_up(cell, seed, device)
    record.setup_s = time.perf_counter() - t_start

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    window.run_window(cell, seed, seconds, device, record)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if traced and on_card:
        # the first batch again under the profiler, up to its last sampled chunk
        profiles = trace.ChunkProfiler(cell.traffic, cell.config).run(
            window.sweep_module().monte_carlo_fluid, cell.config["scenario"],
            record.batches[0].seeds, **window.entry_kwargs(cell, device))
        record.profiles = [p for p in profiles if p["window"] is not None]
        for p in record.profiles:
            print(f"portbench: {trace.describe(p)}", file=sys.stderr)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    pairs = traffic.check_sample(window.makespans(record), cell.traffic["check_lanes"], seed)
    seeds_of = {(b, l): record.batches[b].seeds[l] for b, l in pairs}
    numbers = check.check_lanes(cell.config, cell.traffic, pairs, seeds_of,
                                window.results(record))

    print(f"portbench: setup {record.setup_s:.3f} s, window {record.window_s:.3f} s over "
          f"{len(record.batches)} batch(es) of {[round(b.wall_s, 3) for b in record.batches]} s, "
          f"reference check of {len(pairs)} lane(s) "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    metrics = spec.read_metrics(cell.per_layer if traced else cell.end_to_end, record)
    dev = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name() if on_card else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    out = {"correct": check.verdict(numbers), "attempted": window.lanes_done(record),
           "failed": 0, "metrics": metrics, "device": dev}
    if traced:
        busy, span = trace.busy_and_window(record.profiles)
        dev["busy_s"], dev["window_s"] = busy, span
        out["breakdown"] = trace.breakdown(record.profiles)
    out["checks"] = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in numbers.items()}
    return out
