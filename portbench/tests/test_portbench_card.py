"""On the card (``python -m pytest -m cuda portbench/tests -s`` from the
repository's root): every cell's run is correct, and the control, the
reference in bfloat16 state put in the program's place, fails the
comparison at the cells' own sizes on three seeds."""

import json
import subprocess
import sys

import pytest

from portbench.harness import check, spec, traffic

CELLS = ("paper-ada-mc64", "paper-ada-mc8")
CONTROL_SEEDS = (3_000_000_001, 3_000_000_002, 3_000_000_003)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_run_is_correct(cuda, root, cell):
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "2900000001", "--seconds", "1"],
                         capture_output=True, text=True, cwd=root, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    print(cell, json.dumps(out["metrics"]), json.dumps(out["checks"]))
    assert out["correct"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ("paper-ada-mc64",))
def test_control_fails_at_the_cells_size(cuda, cell):
    c = spec.load_cell(cell)
    for seed in CONTROL_SEEDS:
        lanes = traffic.batch_seeds(c.traffic, seed, 0)[: c.traffic["check_lanes"]]
        want = check.run_reference(c.config, lanes, "ada", "lwf")
        got = check.run_reference(c.config, lanes, "ada", "lwf", prec="bf16_state")
        numbers = check.compare([got[s] for s in lanes], [want[s] for s in lanes],
                                c.config["dt"])
        print(cell, seed, json.dumps(numbers))
        assert not check.verdict(numbers)
