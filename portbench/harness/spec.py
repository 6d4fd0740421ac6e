"""What a run measures, found by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic file (``workloads/<traffic>.json``) and
the reader of each metric (``metrics/<metric>.py``)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = _load_json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(by_name)}")
    w = by_name[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=workload,
        chips=w["chips"],
        config=_load_json(root / configs[w["config"]]["file"]),
        traffic=_load_json(BENCH_DIR / "workloads" / f"{w['traffic']}.json"),
        end_to_end=bench["end_to_end"],
        per_layer=bench["per_layer"],
    )


def reader(metric: str) -> Callable:
    """``read(run)`` of ``metrics/<metric>.py``: the metric's value from a
    :class:`~portbench.harness.window.RunRecord`, or None where the run
    holds nothing to read."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(specs: List[dict], run) -> Dict[str, dict]:
    out = {}
    for m in specs:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
