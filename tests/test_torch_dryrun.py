"""The port's dry-run (``repro_torch.launch.dryrun``) and its counters
(``repro_torch.launch.hlo``).

* The profiles ``==`` the reference's, field for field; the reference's
  module is read in a subprocess (at import it forces 512 XLA host
  devices, which must not reach this process's later JAX tests).
* ``normalize_cost`` and ``memory_stats`` on programs counted by hand: a
  matmul, a matmul and a relu, an in-place update of a donated input, the
  transcendentals of an exp; ``flops_by_op``; a trace on FakeTensors is
  refused.
* ``collective_bytes`` of one ``dp``, ``tp`` and ``fsdp`` train step of the
  reduced llama on a fake 2-rank and 4-rank group (meta shards, as the
  dry-run traces) ``==`` the same step's count on real ``gloo`` ranks,
  collective for collective (kind, bytes, mesh dim, in order): the fake
  group sees what real ranks do.  Under ``dp`` the gradients' all-reduces
  carry exactly the gradient bytes.
* ``run_combo`` of each family's reduced config for a train, a prefill and
  a decode shape on a fake (2, 2) mesh under its tuned profile: status
  "ok", counts positive, ``useful_flops_ratio`` <= 1 (for a prefill
  ``run_useful_ratio`` <= 1: ``model_flops`` counts the vocab projection
  of every prompt token, the step projects each sequence's last) and
  ``run_useful_ratio`` no more than ``useful_flops_ratio``, the FLOPs by op
  adding up; a prefill's and a decode's 4 ranks' FLOPs equal, within 1 %,
  to those of the same step traced unsharded on a fake one-rank mesh,
  plus the products of the weights that the rules leave replicated over
  "model" (:data:`REPLICATED`) once more, as each rank runs them on its
  batch shard: no rank repeats another's work.

The spawned processes (2 and 4 ``gloo`` ranks, two fake-group processes)
start together when the module's first test needs them.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _torch_sharding import (
    COMM_CASES, comm_worker, fake_worker, join, start, weight_matrices, weight_product_flops,
)
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, hlo

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = {"dense": "llama32_1b", "ssm": "mamba2_130m", "moe": "olmoe_1b_7b",
            "hybrid": "jamba_v01_52b", "vlm": "llama32_vision_11b",
            "audio": "seamless_m4t_large_v2"}
SHAPES = {"train": ("train_s", 32, 4, "train"), "prefill": ("prefill_s", 32, 4, "prefill"),
          "decode": ("decode_s", 32, 4, "decode")}
#: the weights that the rules leave replicated over the (2, 2) mesh's
#: "model" axis, by family (the hybrid's SSM B and C projections)
REPLICATED = {"hybrid": ("w_B", "w_C")}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    combos = [(arch, SHAPES[k]) for arch in FAMILIES.values() for k in SHAPES]
    half = len(combos) // 2
    ctxs = [start(comm_worker, 2, tmp), start(comm_worker, 4, tmp),
            start(fake_worker, 1, tmp, combos[:half], 0),
            start(fake_worker, 1, tmp, combos[half:], 1)]
    for ctx in ctxs:
        join(ctx, 600)

    def load(name):
        with open(tmp / name) as f:
            return json.load(f)

    return {"gloo": {**load("comm_gloo_2.json"), **load("comm_gloo_4.json")},
            "fake": load("comm_fake.json"),
            "combos": {**load("combos_0.json"), **load("combos_1.json")}}


def test_profiles_equal_the_reference():
    code = ("import dataclasses, json; from repro.launch import dryrun as d; "
            "print(json.dumps({n: {a: dataclasses.asdict(p) for a, p in t.items()} for n, t in "
            "(('baseline', d.BASELINE_PROFILES), ('tuned', d.TUNED_PROFILES))}))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    ref = json.loads(out.strip().splitlines()[-1])
    port = {n: {a: dataclasses.asdict(p) for a, p in t.items()} for n, t in
            (("baseline", dryrun.BASELINE_PROFILES), ("tuned", dryrun.TUNED_PROFILES))}
    assert port == ref
    assert [f.name for f in dataclasses.fields(dryrun.Profile)] == list(
        ref["tuned"]["llama32_1b"])


def _trace(fn, args, donated=()):
    return hlo.trace_step(fn, args, donated=donated)


def test_matmul_counts():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    out, tr = _trace(lambda a, b: a @ b, (a, b))
    assert hlo.normalize_cost(tr) == {"flops": 2.0 * 8 * 16 * 4,
                                      "bytes_accessed": 4.0 * (8 * 16 + 16 * 4 + 8 * 4),
                                      "transcendentals": 0.0}
    assert hlo.memory_stats(tr) == {"argument_bytes": 4.0 * (8 * 16 + 16 * 4),
                                    "output_bytes": 4.0 * 8 * 4, "temp_bytes": 0.0,
                                    "alias_bytes": 0.0,
                                    "peak_bytes": 4.0 * (8 * 16 + 16 * 4 + 8 * 4)}
    assert hlo.collective_bytes(tr) == {"total": 0.0, "op_counts": {}, "by_axis": {}}


def test_matmul_relu_counts():
    """The product's output is live while the relu's is made: a temporary
    of its size."""
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    _, tr = _trace(lambda a, b: torch.relu(a @ b), (a, b))
    mn = 4.0 * 8 * 4
    args = 4.0 * (8 * 16 + 16 * 4)
    assert hlo.normalize_cost(tr) == {"flops": 2.0 * 8 * 16 * 4,
                                      "bytes_accessed": args + mn + 2 * mn,
                                      "transcendentals": 0.0}
    assert hlo.memory_stats(tr) == {"argument_bytes": args, "output_bytes": mn,
                                    "temp_bytes": mn, "alias_bytes": 0.0,
                                    "peak_bytes": args + 2 * mn}


def test_in_place_update_is_aliased():
    """A donated input updated in place and returned: aliased, no
    temporary; the exp's elements are transcendentals."""
    x, y = torch.ones(32), torch.ones(32)

    def step(x, y):
        x.add_(torch.exp(y))
        return x

    _, tr = _trace(step, (x, y), donated=(x,))
    assert hlo.normalize_cost(tr) == {"flops": 0.0, "bytes_accessed": 4.0 * (2 * 32 + 3 * 32),
                                      "transcendentals": 32.0}
    mem = hlo.memory_stats(tr)
    assert mem["alias_bytes"] == mem["output_bytes"] == 128.0
    assert mem["argument_bytes"] == 256.0
    assert mem["peak_bytes"] == 256.0 + mem["temp_bytes"] == 256.0 + 128.0  # exp's output


def test_flops_by_op():
    """The FLOPs split by op, and by op and input shapes, add up to the
    total."""
    a, b, c = torch.ones(8, 16), torch.ones(16, 4), torch.ones(2, 8, 16)
    _, tr = _trace(lambda a, b, c: (a @ b, torch.bmm(c, c.transpose(1, 2))), (a, b, c))
    mm, bmm = 2.0 * 8 * 16 * 4, 2.0 * 2 * 8 * 16 * 8
    assert hlo.flops_by_op(tr) == {"aten.bmm": bmm, "aten.mm": mm}
    assert hlo.flops_by_op(tr, shapes=True) == {
        ("aten.bmm", ((2, 8, 16), (2, 16, 8))): bmm, ("aten.mm", ((8, 16), (16, 4))): mm}
    assert sum(hlo.flops_by_op(tr).values()) == hlo.normalize_cost(tr)["flops"]


def test_fake_tensors_are_refused():
    """Ops on FakeTensors are DTensor's shape propagation to the counter,
    so a step on fakes would count nothing: the trace refuses them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        a, b = torch.ones(8, 16), torch.ones(16, 4)
    with pytest.raises(ValueError, match="FakeTensor"):
        _trace(lambda a, b: a @ b, (a, b))


@pytest.mark.parametrize("case", [c[0] for c in COMM_CASES])
def test_fake_group_counts_what_gloo_ranks_do(spawned, case):
    fake, gloo = spawned["fake"][case], spawned["gloo"][case]
    assert fake["records"] and fake["records"] == gloo["records"]
    assert fake["bytes"] == gloo["bytes"]


@pytest.mark.parametrize("case", ["dp2", "dp4"])
def test_dp_all_reduces_carry_the_gradients(spawned, case):
    """Under dp every parameter is replicated: its gradient is all-reduced
    whole, once.  The 0-dim all-reduces of the loss and the metrics aside,
    the all-reduce bytes are the gradient bytes."""
    r = spawned["gloo"][case]
    grads = sum(b for kind, b, _ in r["records"] if kind == "all-reduce" and b > 8)
    assert grads == r["grad_bytes"]
    assert {kind for kind, _, _ in r["records"]} == {"all-reduce"}


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_reduced_run_combo(spawned, family, kind):
    r = spawned["combos"][f"{FAMILIES[family]}|{SHAPES[kind][0]}"]
    assert r["status"] == "ok", r.get("error")
    assert r["cost"]["flops"] > 0 and r["cost"]["bytes_accessed"] > 0
    assert r["memory"]["peak_bytes"] > 0 and r["memory"]["argument_bytes"] > 0
    # the ratio of what the step runs (the same ratio but for a prefill)
    ratio = "run_useful_ratio" if kind == "prefill" else "useful_flops_ratio"
    assert 0 < r["roofline"][ratio] <= 1
    assert 0 < r["roofline"]["run_useful_ratio"] <= r["roofline"]["useful_flops_ratio"]
    assert sum(r["flops_by_op"].values()) == r["cost"]["flops"]
    assert r["roofline"]["chips"] == 4
    if kind != "train":  # a train step: tests/test_torch_sharding_products.py
        assert "unsharded_error" not in r, r["unsharded_error"]
        whole = sum(n for _, _, n in r["unsharded"])
        repl = weight_product_flops(r["unsharded"], weight_matrices(
            get_config(FAMILIES[family], reduced=True), REPLICATED.get(family, ())))
        assert bool(repl) == (family in REPLICATED)
        want = whole + repl  # the replicated products run on both "model" ranks
        got = 4 * r["cost"]["flops"]
        assert abs(got - want) <= 0.01 * want, f"4 ranks x FLOPs {got:.4e} against {want:.4e}"
    if kind == "train":  # every strategy but dp reduces something; dp all-reduces its grads
        assert r["collectives"]["total"] > 0
