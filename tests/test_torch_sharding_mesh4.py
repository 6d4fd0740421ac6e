"""Sharded training on 4 ``gloo`` ranks, on the CPU: the DTensor
placements of the rules against numpy slices, and train steps on (2, 2)
and (1, 4) meshes against the JAX reference's jitted ``make_train_step``
on one device.

* Placements: every leaf of the reduced llama and olmoe, distributed
  under ``tp`` and ``fsdp`` on a (2, 2) ("data", "model") mesh and a
  (2, 1, 2) ("pod", "data", "model") one, holds on every rank exactly the
  numpy slice its spec names; on the 3-D mesh fsdp's ("pod", "data")
  entries split the embed dim pod-major, as JAX does.
* Steps (four, float32, the bars of ``tests/test_torch_sharding_steps.py``):
  the dense model under ``tp`` at (2, 2) (batch and heads both split) and at
  (1, 4), where the divisibility guard keeps its 2 kv heads replicated
  beside 8 query heads split 4 ways; the dense and moe models at (2, 2)
  under ``fsdp`` (the embed dim of every weight split over "data") and
  ``zero1`` (the moments split over "data" where the parameters are
  replicated there).  After each step the parameters and moments keep
  the rules' placements.
"""

import json

import pytest

from repro_torch.configs import get_config
from repro_torch.models.common import tree_leaves
from repro_torch.models.lm import LM
from repro_torch.optim import adamw as padamw
from _torch_sharding import STEPS, join, load_case, start, steps_worker
from test_torch_sharding_steps import FAMILIES, _check, _port_tree, _reference
from test_torch_train import _assert_params_after_steps

CASES = {
    "dense_tp_2x2": ((2, 2), "dense", "tp"),
    "dense_tp_1x4": ((1, 4), "dense", "tp"),
    "dense_fsdp_2x2": ((2, 2), "dense", "fsdp"),
    "moe_fsdp_2x2": ((2, 2), "moe", "fsdp"),
    "dense_zero1_2x2": ((2, 2), "dense", "zero1"),
    "moe_zero1_2x2": ((2, 2), "moe", "zero1"),
}

N_LEAVES = {fam: len(list(tree_leaves(LM(get_config(FAMILIES[fam], reduced=True)).schema())))
            for fam in ("dense", "moe")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_mesh4")
    cases = [(name, shape, FAMILIES[fam], strat, {}) for name, (shape, fam, strat)
             in CASES.items()]
    ctx = start(steps_worker, 4, out, cases, True)
    try:
        refs = {fam: _reference(fam) for fam in ("dense", "moe")}
    finally:
        join(ctx)
    return out, refs


def test_local_shards_are_the_specs_slices(runs):
    out, _ = runs
    for rank in range(4):
        res = json.loads((out / f"local_{rank}.json").read_text())
        assert res["bad"] == [], f"rank {rank}"
        # every leaf of the 2 archs, on 2 meshes under 2 strategies
        assert res["checked"] == 4 * (N_LEAVES["dense"] + N_LEAVES["moe"])
        assert res["tuple_specs"] > 0  # fsdp's ("pod", "data") entries were met


@pytest.mark.parametrize("name", list(CASES))
def test_four_steps_match_reference(runs, name):
    out, refs = runs
    shape, family, strategy = CASES[name]
    meta, full = load_case(out, name)
    ref = refs[family]
    _check(meta, ref, STEPS, family, FAMILIES[family], strategy, shape)
    _assert_params_after_steps(_port_tree(full), ref["params"], padamw.AdamWConfig().lr, STEPS)
    if strategy == "zero1":
        params, moments = meta["placed"][-1]["params"], meta["placed"][-1]["m"]
        split = [k for k in params if params[k][0] == "Replicate()"
                 and moments[k][0].startswith("Shard(")]
        assert split, "zero1 splits some moments over data beside replicated parameters"
    if strategy == "fsdp":
        assert any(p[0].startswith("Shard(") for p in meta["placed"][-1]["params"].values())
