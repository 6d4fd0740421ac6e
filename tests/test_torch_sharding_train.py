"""``launch.train.train`` and its CLI through a mesh, on the CPU over 2
``gloo`` ranks: the reduced llama3.2-1b in the trainer's bf16 weights
(``PRNGKey(0)``), batch 2 x 32, lr 3e-3.

* ``train(mesh_shape=(2, 1))`` (``dp``) and ``(1, 2)`` (``tp``) return
  the same losses on both ranks; their first loss is the port's
  unsharded ``train()``'s to ``rtol=1e-3`` (bf16 partial sums reorder),
  every later one within the repo's bf16 bar (0.15 of its scale: AdamW's
  sign steps, ROADMAP R11), and both fall.
* A checkpoint written at (1, 2) resumes a (2, 1) run, which repeats the
  (1, 2) run's steps 5-6 within the same bars; restored into the (2, 1)
  tree its leaves equal, bit for bit, the reference's ``restore`` of the
  same file and the port's unsharded one.
* ``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
  repro_torch.launch.train ... --mesh-data 2 --device cpu``: rank 0 prints
  the losses of the same run in this package, rank 1 prints none.
* A mesh wider than one rank with no process group raises ``ValueError``.
* chip_smoke.py's phase 51 on the CPU: through a one-rank mesh, where every
  collective is the identity, ``train()`` (``dp``) and ``tp`` steps give
  the plain run's losses bit for bit.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jrestore
from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch.checkpoint.store import restore
from repro_torch.configs import get_config
from repro_torch.launch.train import train
from repro_torch.models.common import tree_leaves
from _torch_sharding import TRAIN_KW, TRAIN_STEPS, join, one_rank_worker, start, train_worker

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BF16_BAR = 0.15


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank's results, and the unsharded run's losses (computed while
    the ranks run)."""
    out = tmp_path_factory.mktemp("sharded_train")
    ctx = start(train_worker, 2, out)
    try:
        one = start(one_rank_worker, 1, out)
        try:
            plain = train(get_config("llama3.2-1b", reduced=True), steps=TRAIN_STEPS,
                          **TRAIN_KW)
        finally:
            join(one)
    finally:
        join(ctx)
    ranks = [json.loads((out / f"train_{r}.json").read_text()) for r in range(2)]
    return out, ranks, plain


def _close_bf16(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3, err_msg=what)
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_BAR * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("shape", ["2x1", "1x2"])
def test_train_on_mesh(runs, shape):
    _, ranks, plain = runs
    got = ranks[0][f"losses_{shape}"]
    assert ranks[1][f"losses_{shape}"] == got  # alike on every rank
    assert len(got) == TRAIN_STEPS
    _close_bf16(got, plain, shape)
    assert np.mean(got[-3:]) < got[0] and np.mean(plain[-3:]) < plain[0]


def test_checkpoint_crosses_meshes_and_packages(runs):
    out, ranks, _ = runs
    r0 = ranks[0]
    assert ranks[1]["resumed_2x1"] == r0["resumed_2x1"]
    assert len(r0["whole_1x2"]) == 4 and len(r0["resumed_2x1"]) == 2
    assert r0["restored_step"] == 4
    assert r0["restored_placements"] == ["(Replicate(), Replicate())"]
    # steps 5-6 as the uninterrupted (1, 2) run of TRAIN_STEPS had them
    _close_bf16(r0["resumed_2x1"], r0["losses_1x2"][4:6], "resumed")
    assert r0["whole_1x2"] == r0["losses_1x2"][:4]  # the same run, checkpointed

    ckpt = str(out / "ckpt")
    with np.load(out / "restored.npz") as z:
        sharded = {k: z[k] for k in z.files}
    # the reference's restore into its own (params, opt_state) tree
    jcfg = jax_get_config("llama3.2-1b", reduced=True)
    jp = jlm.LM(jcfg).init(jax.random.PRNGKey(1))
    (jp, jo), step, _ = jrestore(ckpt, (jp, jadamw.adamw_init(jp, jadamw.AdamWConfig())), step=4)
    assert step == 4
    ref = {f"0/{k}": v for k, v in _jflat(jp).items()}
    ref.update({f"1/{k}": v for k, v in _jflat(jo).items()})
    assert set(ref) == set(sharded)
    for k, v in ref.items():
        np.testing.assert_array_equal(sharded[k], np.asarray(v, np.float32), err_msg=k)
    # and the port's unsharded restore
    from repro_torch import prng
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    pp = LM(get_config("llama3.2-1b", reduced=True)).init(prng.PRNGKey(1), device="cpu")
    tree, _, _ = restore(ckpt, {"0": pp, "1": adamw_init(pp, AdamWConfig())}, step=4)
    for k, t in tree_leaves(tree):
        np.testing.assert_array_equal(sharded[k], t.float().numpy(), err_msg=k)


def _jflat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_cli_rank0_prints_the_in_process_losses(runs, tmp_path):
    _, ranks, _ = runs
    want = [f"{v:.4f}" for v in ranks[0]["cli_like"]]
    assert re.findall(r"loss=([0-9.]+)", ranks[0]["printed"]) == want
    assert ranks[1]["printed"] == ""  # rank 1 logs nothing
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b", "--reduced",
           "--mesh-data", "2", "--device", "cpu", "--steps", "2", "--batch",
           str(TRAIN_KW["batch"]), "--seq", str(TRAIN_KW["seq"]), "--lr", str(TRAIN_KW["lr"]),
           "--log-every", "1"]
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert re.findall(r"step \d+: loss=([0-9.]+)", proc.stdout) == want
    assert proc.stdout.count("[train] done") == 1
    assert "mesh (2, 1) dp" in proc.stdout


def test_mesh_without_process_group_raises():
    cfg = dataclasses.replace(get_config("llama3.2-1b", reduced=True), n_layers=1)
    with pytest.raises(ValueError, match="no process group"):
        train(cfg, steps=1, mesh_shape=(2, 1), device="cpu")
    with pytest.raises(ValueError, match="no process group"):
        train(cfg, steps=1, mesh_shape=(1, 2), device="cpu")


def test_one_rank_mesh_is_bit_identical(runs):
    out, _, _ = runs
    res = json.loads((out / "one_rank.json").read_text())
    assert len(res["plain"]) == 4
    assert res["dp"] == res["plain"]
    assert res["tp"] == res["plain"]
    # tp on the one-rank mesh: the (stacked) heads sharded over the size-1 "model" dim
    assert res["tp_placements"] == ["(Replicate(), Shard(dim=1))", "(Replicate(), Shard(dim=2))"]
