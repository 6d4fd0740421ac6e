"""The measured window: Monte-Carlo batches through the port's entry
``repro_torch.scenarios.sweep.monte_carlo_fluid``, back to back, until
``--seconds`` have passed; the batch in flight finishes and counts.

The harness wraps two of the port's calls for the length of a run, and
changes nothing they do: the entry's call of ``simulate_traces_batched``
(its raw result planes, the driver's ``chunks`` and ``captures``, and
the host clock when the entry hands the stacked traces over and gets
them back), and, in a traced run once the window has closed,
``_ChunkRunner.run_chunk`` (the profiler's start and stop around the
sampled chunks).
"""

from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Dict, List, Optional

import numpy as np

from portbench.harness import traffic as traffic_mod
from portbench.harness.trace import CHUNK_TICKS


@dataclasses.dataclass
class Batch:
    seeds: List[int]
    wall_s: float
    prep_s: float  # entry start -> traces handed to the simulator (synchronised)
    out: dict  # the simulator's result planes, chunks and captures


@dataclasses.dataclass
class RunRecord:
    """What a run measured, for the metric readers."""

    config: dict
    traffic: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    batches: List[Batch] = dataclasses.field(default_factory=list)
    #: sampled chunks (traced runs): dicts of ``chunk``, ``window`` (start,
    #: end) us, ``device`` [(name, start, end)] us, ``host`` [(name, start,
    #: end)] us, ``ticks`` and ``shape`` (L, J, S, D, overlap)
    profiles: List[dict] = dataclasses.field(default_factory=list)


def sweep_module():
    # the package re-exports a function named ``sweep``: take the module
    return importlib.import_module("repro_torch.scenarios.sweep")


def entry_kwargs(cell, device: str, max_steps: Optional[int] = None) -> dict:
    cfg, tr = cell.config, cell.traffic
    return dict(
        comm=tr["policy"], placement=tr["placement"],
        overrides={k: cfg[k] for k in cfg["program_overrides"]},
        dt=cfg["dt"], max_steps=max_steps or cfg["max_steps"], device=device,
    )


class _Recorder:
    """Wraps the entry's ``simulate_traces_batched`` while a run lasts."""

    def __init__(self, sync):
        self.mod = sweep_module()
        self.orig = self.mod.simulate_traces_batched
        self.sync = sync
        self.calls: List[dict] = []

    def __call__(self, traces, cfg, **kw):
        self.sync()
        t_in = time.perf_counter()
        out = self.orig(traces, cfg, **kw)
        self.calls.append({"out": out, "t_in": t_in, "chunk_steps": cfg.chunk_steps})
        return out

    def __enter__(self):
        self.mod.simulate_traces_batched = self
        return self

    def __exit__(self, *exc):
        self.mod.simulate_traces_batched = self.orig


def _sync(device: str):
    if device.startswith("cuda"):
        import torch

        return torch.cuda.synchronize
    return lambda: None


def warm_up(cell, seed: int, device: str) -> None:
    """One batch of the cell's shapes, cut to a few chunks: builds or loads
    the kernel library, starts CUDA and its libraries, and captures the
    first batch shape once."""
    entry = sweep_module().monte_carlo_fluid
    steps = cell.traffic["warmup_chunks"] * CHUNK_TICKS
    entry(cell.config["scenario"], traffic_mod.batch_seeds(cell.traffic, seed, 1 << 20),
          **entry_kwargs(cell, device, max_steps=steps))
    _sync(device)()


def run_window(cell, seed: int, seconds: float, device: str, record: RunRecord) -> None:
    """Batches until ``seconds`` have passed since the window opened."""
    entry = sweep_module().monte_carlo_fluid
    sync = _sync(device)
    kw = entry_kwargs(cell, device)
    with _Recorder(sync) as rec:
        t_open = time.perf_counter()
        b = 0
        while True:
            seeds = traffic_mod.batch_seeds(cell.traffic, seed, b)
            t0 = time.perf_counter()
            entry(cell.config["scenario"], seeds, **kw)
            sync()
            t1 = time.perf_counter()
            call = rec.calls[-1]
            record.batches.append(Batch(seeds=seeds, wall_s=t1 - t0,
                                        prep_s=call["t_in"] - t0, out=call["out"]))
            b += 1
            if t1 - t_open >= seconds:
                break
        record.window_s = t1 - t_open


def lanes_done(record: RunRecord) -> int:
    return sum(len(b.seeds) for b in record.batches)


def makespans(record: RunRecord) -> List[np.ndarray]:
    return [np.asarray(b.out["makespan"]) for b in record.batches]


def results(record: RunRecord) -> Dict[tuple, dict]:
    """(batch, lane) -> that lane's jct, finished and makespan."""
    return {(i, l): {"jct": b.out["jct"][l], "finished": b.out["finished"][l],
                     "makespan": b.out["makespan"][l]}
            for i, b in enumerate(record.batches) for l in range(len(b.seeds))}
