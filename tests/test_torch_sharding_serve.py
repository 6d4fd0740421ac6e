"""Sharded serving: ``make_prefill_step`` and ``make_serve_step`` on DTensor
parameters placed by ``param_shardings``, the prefill's cache placed by
``sharding.place_cache`` under the reference's ``cache_shardings``,
against the plain port on the same float32 weights, on 2 and 4 ``gloo``
ranks (spawned, ``file://`` rendezvous).

The reduced archs of all six families (wq and wk x 1/4 and the vlm's gate
0.5 where the sharding tests tame, R19/R24; weights from
``_torch_sharding.serve_params``) prefill a 16-token prompt at batch 4
and decode 4 teacher-forced tokens: the prefill's last-token logits and
each decode step's logits within ``rtol=1e-4`` and ``1e-5`` of the
logits' scale of the plain port's (sums split over ranks reorder float32
round-off), under ``dp`` (2, 1), ``tp`` (1, 2) and, on 4 ranks, ``fsdp``
and ``zero1`` (2, 2), in the cache modes ``auto``, ``seq`` and ``batch``
and with ``decode_constrain`` on and off.  The placed cache holds the
placements the rules give.  ``constrain_acts`` leaves a sharded train
step's metrics unchanged (fsdp, (2, 2)).
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_sharding import join, serve_params, serve_run, serve_worker, start
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models.common import tree_leaves
from repro_torch.models.lm import LM
from repro_torch.sharding import rules as prules

torch.set_num_threads(1)

FAMILIES = {"dense": "llama3.2-1b", "ssm": "mamba2-130m", "moe": "olmoe-1b-7b",
            "hybrid": "jamba-v0.1-52b", "vlm": "llama-3.2-vision-11b",
            "audio": "seamless-m4t-large-v2"}
TWO = ([(f"{fam}_dp", (2, 1), arch, "dp", "auto", False) for fam, arch in FAMILIES.items()]
       + [(f"{fam}_tp", (1, 2), arch, "tp", "auto", False) for fam, arch in FAMILIES.items()]
       + [("dense_tp_seq_constrain", (1, 2), FAMILIES["dense"], "tp", "seq", True),
          ("dense_tp_batch", (1, 2), FAMILIES["dense"], "tp", "batch", False),
          ("dense_dp_constrain", (2, 1), FAMILIES["dense"], "dp", "auto", True),
          ("hybrid_tp_seq_constrain", (1, 2), FAMILIES["hybrid"], "tp", "seq", True),
          ("vlm_tp_seq_constrain", (1, 2), FAMILIES["vlm"], "tp", "seq", True),
          ("audio_tp_batch_constrain", (1, 2), FAMILIES["audio"], "tp", "batch", True)])
FOUR = ([(f"{fam}_fsdp", (2, 2), arch, "fsdp", "auto", fam in ("dense", "moe"))
         for fam, arch in FAMILIES.items()]
        + [(f"{fam}_zero1", (2, 2), arch, "zero1", "seq" if fam == "dense" else "auto",
            fam in ("dense", "vlm")) for fam, arch in FAMILIES.items()])
TRAIN = [("dense_fsdp_acts", (2, 2), FAMILIES["dense"], "fsdp"),
         ("moe_fsdp_acts", (2, 2), FAMILIES["moe"], "fsdp")]
CASES = {c[0]: c for c in TWO + FOUR}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sharded runs' output directory and the plain port's logits per
    arch, computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("serve")
    ctxs = [start(serve_worker, 2, tmp, TWO), start(serve_worker, 4, tmp, FOUR, TRAIN)]
    plain = {}
    for arch in FAMILIES.values():
        cfg = get_config(arch, reduced=True)
        plain[arch] = serve_run(cfg, serve_params(cfg))[0]
    for ctx in ctxs:
        join(ctx, 600)
    return tmp, plain


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_matches_plain(runs, name):
    tmp, plain = runs
    _, shape, arch, strategy, mode, constrain = CASES[name]
    with np.load(os.path.join(tmp, f"{name}.npz")) as z:
        got = [z[f"l{i}"] for i in range(len(plain[arch]))]
        placed = json.loads(bytes(z["__json__"]).decode())
    for i, (g, w) in enumerate(zip(got, plain[arch])):
        scale = float(np.max(np.abs(w)))
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=f"{name}: {'prefill' if i == 0 else f'decode {i}'}")
    # the placed cache holds the rules' placements
    cfg = get_config(arch, reduced=True)
    from _torch_sharding import SERVE_B, SERVE_MAX

    mesh = make_abstract_mesh(shape, ("data", "model"))
    meta = LM(cfg).init_cache(SERVE_B, SERVE_MAX, torch.float32, "meta")
    want = {k: [repr(p) for p in prules.placements(sh.spec, mesh)]
            for k, sh in tree_leaves(prules.cache_shardings(meta, mesh, SERVE_B, cfg, mode))}
    assert placed == want


@pytest.mark.parametrize("name", [t[0] for t in TRAIN])
def test_constrain_acts_leaves_the_step_unchanged(runs, name):
    tmp, _ = runs
    with open(os.path.join(tmp, f"{name}.json")) as f:
        res = json.load(f)
    off, on = res["False"], res["True"]
    assert off.keys() == on.keys()
    for k in off:
        assert on[k] == pytest.approx(off[k], rel=1e-5, abs=1e-7), k
