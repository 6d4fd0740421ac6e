"""A whole run on the CPU at a tiny size: the result line's keys, the
modules it loads, and ``correct`` coming out false when the timed path
is broken underneath (the faults a Monte-Carlo cell on one chip can
have)."""

import importlib
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench.harness import bench, spec

TINY_CONFIG = dict(n_jobs=24, min_iters=20, max_iters=60, max_steps=30_000)
CELLS = ("paper-ada-mc64", "paper-ada-mc8")


def tiny_cell(name: str = "paper-ada-mc8", lanes: int = 4):
    cell = spec.load_cell(name)
    cell.config.update(TINY_CONFIG)
    cell.traffic.update(lanes=lanes, check_lanes=lanes, warmup_chunks=1)
    return cell


def run(cell, seed=12_345_678_901):
    return bench.run_cell(cell, seed, 0.0, False, "cpu", time.perf_counter())


@pytest.fixture
def sweep():
    return importlib.import_module("repro_torch.scenarios.sweep")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_has_the_contract_keys(cell):
    out = run(tiny_cell(cell))
    assert out["correct"] is True
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] == 4 and out["failed"] == 0
    assert set(out["metrics"]) == {"traces_per_s", "setup_s"}
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    assert all(c["value"] == 0 for c in out["checks"].values())
    json.dumps(out)


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    from repro_torch.core import fluidsim

    def stuck(tr, c, st, k, cfg):  # only the clock moves
        i = st["i"] + 1
        return {**st, "i": i, "t": i.to(torch.float32) * cfg.dt}

    monkeypatch.setattr(fluidsim, "_lane_step", stuck)
    out = run(tiny_cell())
    assert out["correct"] is False and out["checks"]["finished_mismatch"]["value"] > 0


def test_half_the_batch_left_out_is_caught(monkeypatch, sweep):
    orig = sweep.simulate_traces_batched

    def half(traces, cfg, **kw):  # simulates the first half, reports it twice
        n = next(iter(traces.values())).shape[0]
        out = orig({k: v[: n // 2] for k, v in traces.items()}, cfg, **kw)
        for k in ("jct", "finished", "makespan"):
            out[k] = np.concatenate([out[k], out[k]])[:n]
        return out

    monkeypatch.setattr(sweep, "simulate_traces_batched", half)
    assert run(tiny_cell())["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_is_caught(monkeypatch, sweep, cell):
    orig = sweep.simulate_traces_batched

    def late(traces, cfg, **kw):  # one job of each lane finishes a tick late
        out = orig(traces, cfg, **kw)
        out["jct"] = out["jct"].copy()
        out["jct"][:, 0] += np.float32(cfg.dt)
        return out

    monkeypatch.setattr(sweep, "simulate_traces_batched", late)
    out = run(tiny_cell(cell))
    assert out["correct"] is False and out["checks"]["jct_gap_ticks"]["value"] >= 0.99


@pytest.mark.parametrize("seeds", ([5, 6, 7], [2_147_483_901, 2_147_483_902]))
def test_the_control_fails_the_comparison(seeds):
    """The reference in bfloat16 state in the program's place."""
    from portbench.harness import check

    cell = tiny_cell()
    want = check.run_reference(cell.config, seeds, "ada", "lwf", workers=1)
    got = check.run_reference(cell.config, seeds, "ada", "lwf", prec="bf16_state", workers=1)
    numbers = check.compare([got[s] for s in seeds], [want[s] for s in seeds], cell.config["dt"])
    assert not check.verdict(numbers)
    assert numbers["jct_gap_ticks"] >= 1


def test_the_run_loads_no_jax_and_no_reference_package(root):
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from portbench.tests.test_portbench_run import tiny_cell, run\n"
        "from portbench.harness import bench\n"
        "if __name__ == '__main__':\n"
        "    assert run(tiny_cell('paper-ada-mc64'))['correct']\n"
        "    print(bench.forbidden_modules(), 'repro_torch' in sys.modules)\n"
    ) % (str(root), str(root / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[] True"


def test_batches_draw_fresh_seeds_from_the_seed_and_the_batch():
    from portbench.harness import traffic

    tr = {"lanes": 64}
    big = 2**31 + 12_345
    first, second = traffic.batch_seeds(tr, big, 0), traffic.batch_seeds(tr, big, 1)
    assert first == traffic.batch_seeds(tr, big, 0)
    assert len(set(first)) == 64 and not set(first) & set(second)
    assert not set(first) & set(traffic.batch_seeds(tr, big + 1, 0))
    assert all(0 <= s < 2**31 for s in first + second)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import types

    assert "repro_torch" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert bench.forbidden_modules() == ["repro"]


def test_without_the_ports_sources_there_is_no_result(root, tmp_path):
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(root / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "paper-ada-mc8",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_the_reference_pool_leaves_no_process():
    import gc
    import multiprocessing
    from multiprocessing import resource_tracker

    from portbench.harness import check

    cell = tiny_cell()
    check.run_reference(cell.config, [5, 6], "ada", "lwf", workers=2)
    gc.collect()
    assert multiprocessing.active_children() == []
    assert resource_tracker._resource_tracker._pid is None
