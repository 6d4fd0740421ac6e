"""The port's event engine against the reference's under the exact k-way
lookahead (kway2, kway3), on every scenario the port registers at
``QUICK_OVERRIDES`` and the regression seed: every ``SimResult`` field
exactly equal (see ``tests/test_torch_engine.py``)."""

import pytest

from test_torch_engine import NAMES, assert_same_result, run, scenario


@pytest.mark.parametrize("comm", ["kway2", "kway3"])
@pytest.mark.parametrize("name", NAMES)
def test_cell_equals_reference(name, comm):
    got = run("port", name, comm)
    assert got.censored == 0 and len(got.jct) == scenario("port", name).n_jobs
    assert_same_result(got, run("ref", name, comm))
