"""The port's training stack (``repro_torch.models.lm.LM.loss_fn``,
``repro_torch.optim``, ``repro_torch.data``, ``launch.steps.make_train_step``,
``launch.train.train`` and the flash-attention autograd Function) against
the JAX reference on the CPU, at the REDUCED ``llama32_1b`` (dense) and
``mamba2_130m`` (ssm) configs, weights from the same seed through the
threefry (no weights carried across).

Bars, float32 unless stated:
* the loss and ``cross_entropy_loss``: ``rtol=1e-6`` (the same operations,
  sums in another order);
* grads: 1e-4 of each leaf's scale, the float32 bar of the LM tests (the
  reduced dense model's peaked softmax magnifies round-off, ROADMAP R8);
* ``adamw_update`` on identical grads: ``rtol=1e-6, atol=1e-8``; bf16
  moments within one bf16 step (2**-8 of the leaf's largest moment) per
  update (a float32 value one ulp apart may cast to the neighbouring bf16
  value, and the moment carries it on; near a cancellation the relative
  difference is larger);
* chained train steps and ``train``: AdamW divides each moment by the root
  of the second, so a gradient entry whose size is within the round-off of
  its leaf moves its parameter by a full ``lr`` step in a direction set by
  that round-off (ROADMAP R11).  Losses are held at ``rtol=1e-5`` for
  ``make_train_step`` in float32; parameters to ``rtol=1e-4, atol=1e-5``
  (a thirtieth of one step of the default ``lr``) but for at most 0.1 % of
  a leaf's entries, each within ``2 * lr`` per step.  ``train`` in bf16 (the reference's default weights): its first
  loss to 1e-3 (bf16 rounding and ROADMAP R7 in the forward), every loss
  within the repo's bf16 bar (0.15 of its scale), and both falling.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLMDataset as JDataset
from repro.launch import steps as jsteps
from repro.launch.train import train as jtrain
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset, make_train_iterator
from repro_torch.kernels.flash_attention import flash_attention_train
from repro_torch.kernels.flash_attention.ref import attention_reference
from repro_torch.launch import steps as psteps
from repro_torch.launch import train as ptrain_mod
from repro_torch.models import common as pcommon
from repro_torch.models import lm as plm
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw as padamw

torch.set_num_threads(1)

ARCHS = {"dense": "llama3.2-1b", "ssm": "mamba2-130m"}
B, S = 2, 32


def _cfgs(family):
    return get_config(ARCHS[family], reduced=True), jax_get_config(ARCHS[family], reduced=True)


def _batch(cfg, step=0):
    b = JDataset(cfg, B, S).batch_at(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _params(family, seed=0, dtype="float32"):
    cfg, jcfg = _cfgs(family)
    jp = jlm.LM(jcfg).init(jax.random.PRNGKey(seed), getattr(jnp, dtype))
    pp = plm.LM(cfg).init(prng.PRNGKey(seed), getattr(torch, dtype), "cpu")
    return jp, pp


def _flat(jtree, like):
    """The reference's leaves keyed as the port's flat keys."""
    return dict(zip([k for k, _ in tree_leaves(like)], jax.tree.leaves(jtree)))


def _close_scaled(got, ref, bar, what):
    ref = np.asarray(ref, np.float32)
    scale = max(1e-30, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=bar, atol=bar * scale, err_msg=what)


class TestLoss:
    def test_cross_entropy_loss(self):
        rng = np.random.default_rng(0)
        logits = rng.standard_normal((3, 9, 40)).astype(np.float32) * 3
        labels = rng.integers(-2, 42, (3, 9)).astype(np.int32)  # some masked
        ref = jcommon.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), 37)
        got = pcommon.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), 37)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
        none_valid = pcommon.cross_entropy_loss(torch.from_numpy(logits),
                                                torch.full((3, 9), -1), 37)
        assert float(none_valid) == 0.0

    @pytest.mark.parametrize("loss_impl, chunk", [("dense", 512), ("chunked", 8),
                                                  ("chunked", 12)])
    @pytest.mark.parametrize("family", list(ARCHS))
    def test_loss_fn(self, family, loss_impl, chunk):
        cfg, jcfg = _cfgs(family)
        jp, pp = _params(family)
        jb, pb = _batch(jcfg)
        jflags = jlm.RunFlags(remat="none", q_chunk=S, loss_impl=loss_impl, loss_chunk=chunk)
        pflags = plm.RunFlags(remat="none", q_chunk=S, loss_impl=loss_impl, loss_chunk=chunk)
        ref, rm = jlm.LM(jcfg).loss_fn(jp, jb, jflags)
        got, gm = plm.LM(cfg).loss_fn(pp, pb, pflags)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
        np.testing.assert_allclose(float(gm["ce"]), float(rm["ce"]), rtol=1e-6)
        assert float(gm["aux"]) == float(rm["aux"]) == 0.0

    @pytest.mark.parametrize("family", list(ARCHS))
    def test_grads_match_jax_grad(self, family):
        cfg, jcfg = _cfgs(family)
        jp, pp = _params(family)
        jb, pb = _batch(jcfg, 1)
        jflags = jlm.RunFlags(remat="none", q_chunk=S)
        grads = jax.grad(lambda p: jlm.LM(jcfg).loss_fn(p, jb, jflags)[0])(jp)
        for _, t in tree_leaves(pp):
            t.requires_grad_()
        loss, _ = plm.LM(cfg).loss_fn(pp, pb, plm.RunFlags(remat="none", q_chunk=S))
        loss.backward()
        ref = _flat(grads, pp)
        for k, t in tree_leaves(pp):
            assert t.grad is not None and t.grad.dtype == torch.float32, k
            _close_scaled(t.grad.numpy(), ref[k], 1e-4, k)

    @pytest.mark.parametrize("family", list(ARCHS))
    def test_block_remat_and_chunked_loss_grads(self, family):
        """remat="block" (torch.utils.checkpoint per block) and the chunked
        loss recompute their forward in the backward pass: the same loss and
        grads as remat="none" with the dense loss, bit for bit."""
        cfg, jcfg = _cfgs(family)
        _, pb = _batch(jcfg, 2)
        out = {}
        for remat, loss_impl in (("none", "dense"), ("block", "dense"), ("none", "chunked")):
            _, pp = _params(family)
            for _, t in tree_leaves(pp):
                t.requires_grad_()
            loss, _ = plm.LM(cfg).loss_fn(pp, pb, plm.RunFlags(remat=remat, loss_impl=loss_impl,
                                                               loss_chunk=8))
            loss.backward()
            out[remat, loss_impl] = (loss.detach(), {k: t.grad for k, t in tree_leaves(pp)})
        base_loss, base = out["none", "dense"]
        for key in (("block", "dense"), ("none", "chunked")):
            loss, grads = out[key]
            if key[1] == "dense":
                assert torch.equal(loss, base_loss), key
            else:  # the chunked loss sums per chunk: another order
                torch.testing.assert_close(loss, base_loss, rtol=1e-6, atol=0)
            for k, g in grads.items():
                if key[1] == "dense":
                    assert torch.equal(g, base[k]), (key, k)
                else:
                    _close_scaled(g.numpy(), base[k].numpy(), 1e-5, k)

    def test_remat_dots_raises(self):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 9"):
            plm.RunFlags(remat="dots")
        with pytest.raises(ValueError, match="loss_impl"):
            plm.RunFlags(loss_impl="sparse")


def _grads_like(pp, seed, scale):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(t.shape) * scale).astype(np.float32)
            for k, t in tree_leaves(pp)}


class TestAdamW:
    @pytest.mark.parametrize("moment", ["float32", "bfloat16"])
    @pytest.mark.parametrize("grad_scale", [1e-4, 1.0], ids=["unclipped", "clipped"])
    def test_three_steps_on_identical_grads(self, grad_scale, moment):
        jp, pp = _params("dense", dtype="float32")
        jcfg = jadamw.AdamWConfig(lr=1e-2, moment_dtype=getattr(jnp, moment))
        pcfg = padamw.AdamWConfig(lr=1e-2, moment_dtype=getattr(torch, moment))
        jst, pst = jadamw.adamw_init(jp, jcfg), padamw.adamw_init(pp, pcfg)
        assert pst["step"].dtype == torch.int32 and int(pst["step"]) == 0
        keys = [k for k, _ in tree_leaves(pp)]
        for step in range(3):
            g = _grads_like(pp, step, grad_scale)
            jg = jax.tree.unflatten(jax.tree.structure(jp), [jnp.asarray(g[k]) for k in keys])
            pg = pcommon.tree_unflatten({k: torch.from_numpy(v) for k, v in g.items()})
            jp, jst, jm = jadamw.adamw_update(jp, jg, jst, jcfg)
            pp, pst, pm = padamw.adamw_update(pp, pg, pst, pcfg)
            np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]),
                                       rtol=1e-6)
            assert int(pst["step"]) == int(jst["step"]) == step + 1
        clipped = float(jm["grad_norm"]) > jcfg.grad_clip
        assert clipped == (grad_scale == 1.0)
        for tree, ptree, what in ((jp, pp, "param"), (jst["m"], pst["m"], "m"),
                                  (jst["v"], pst["v"], "v")):
            ref = _flat(tree, ptree)
            for k, t in tree_leaves(ptree):
                r = np.asarray(ref[k])
                if t.dtype == torch.bfloat16:
                    # bf16 moments: the same float32 value cast; where the
                    # float32 values differ in the last bit a cast may step
                    # one bf16 ulp
                    r32 = r.astype(np.float32)
                    np.testing.assert_allclose(
                        t.float().numpy(), r32, rtol=0,
                        atol=3 * 2**-8 * float(np.abs(r32).max()), err_msg=f"{what} {k}")
                elif moment == "bfloat16":
                    # a moment one bf16 ulp (2**-8) apart moves the next
                    # update by as much, relative: lr * 2**-7 per step
                    np.testing.assert_allclose(t.numpy(), r, rtol=1e-6,
                                               atol=3 * jcfg.lr * 2**-7, err_msg=f"{what} {k}")
                else:
                    np.testing.assert_allclose(t.numpy(), r, rtol=1e-6, atol=1e-8,
                                               err_msg=f"{what} {k}")

    def test_global_norm_and_abstract_state(self):
        jp, pp = _params("ssm")
        np.testing.assert_allclose(float(padamw.global_norm(pp)),
                                   float(jadamw.global_norm(jp)), rtol=1e-6)
        meta = padamw.abstract_opt_state(pp, padamw.AdamWConfig(moment_dtype=torch.bfloat16))
        for (k, t), (_, m) in zip(tree_leaves(pp), tree_leaves(meta["m"])):
            assert m.device.type == "meta" and m.shape == t.shape and m.dtype == torch.bfloat16
        assert meta["step"].dtype == torch.int32

    @pytest.mark.parametrize("warmup, total", [(0, 10), (5, 20), (10, 10)])
    def test_cosine_schedule(self, warmup, total):
        ref = jadamw.cosine_schedule(3e-4, warmup, total)
        got = padamw.cosine_schedule(3e-4, warmup, total)
        for step in range(total + 3):
            np.testing.assert_allclose(float(got(torch.tensor(step, dtype=torch.int32))),
                                       float(ref(jnp.asarray(step, jnp.int32))), rtol=1e-6)


class TestData:
    @pytest.mark.parametrize("family", list(ARCHS))
    def test_batch_at_equal(self, family):
        cfg, jcfg = _cfgs(family)
        ref, got = JDataset(jcfg, 3, 17, seed=5), SyntheticLMDataset(cfg, 3, 17, seed=5)
        for step in range(4):
            r, g = ref.batch_at(step), got.batch_at(step)
            assert r.keys() == g.keys()
            for k in r:
                assert g[k].dtype == np.int32
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)

    def test_iterator_prefetches_and_resumes(self):
        cfg, _ = _cfgs("dense")
        ds = SyntheticLMDataset(cfg, 2, 8, seed=1)
        it = make_train_iterator(ds, start_step=3, device="cpu")
        try:
            for step in (3, 4, 5):
                b = next(it)
                for k, v in ds.batch_at(step).items():
                    assert torch.equal(b[k], torch.from_numpy(v)), (step, k)
        finally:
            it.close()
        assert not it._thread.is_alive()

    def test_iterator_default_device_is_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("checks the behaviour where CUDA is absent")
        with pytest.raises(RuntimeError, match="CUDA"):
            make_train_iterator(SyntheticLMDataset(_cfgs("dense")[0], 1, 4))


def _assert_params_after_steps(pp, jp, lr, steps):
    """Round-off but for AdamW's sign steps (ROADMAP R11)."""
    ref = _flat(jp, pp)
    for k, t in tree_leaves(pp):
        got, want = t.detach().float().numpy(), np.asarray(ref[k], np.float32)
        d = np.abs(got - want)
        off = d > 1e-5 + 1e-4 * np.abs(want)
        assert off.sum() <= max(1, off.size // 1000), (k, int(off.sum()), off.size)
        assert d.max() <= 2 * lr * steps, (k, float(d.max()))


class TestTrainStep:
    @pytest.mark.parametrize("family", list(ARCHS))
    def test_four_steps_match_jitted_reference(self, family):
        cfg, jcfg = _cfgs(family)
        jp, pp = _params(family)
        ocfg_j, ocfg_p = jadamw.AdamWConfig(), padamw.AdamWConfig()
        jo, po = jadamw.adamw_init(jp, ocfg_j), padamw.adamw_init(pp, ocfg_p)
        jstep = jax.jit(jsteps.make_train_step(jlm.LM(jcfg), ocfg_j,
                                               jlm.RunFlags(remat="none", q_chunk=S)))
        pstep = psteps.make_train_step(plm.LM(cfg), ocfg_p, plm.RunFlags(remat="none", q_chunk=S))
        ptrs = [t.data_ptr() for _, t in tree_leaves(pp)]
        for step in range(4):
            jb, pb = _batch(jcfg, step)
            jp, jo, jm = jstep(jp, jo, jb)
            pp, po, pm = pstep(pp, po, pb)
            assert set(pm) == {"loss", "ce", "aux", "grad_norm"}
            np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
            np.testing.assert_allclose(float(pm["ce"]), float(jm["ce"]), rtol=1e-5)
            assert float(pm["aux"]) == 0.0
            np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
        assert int(po["step"]) == int(jo["step"]) == 4
        # the parameters are the same leaf tensors, updated in place, grads cleared
        assert [t.data_ptr() for _, t in tree_leaves(pp)] == ptrs
        assert all(t.requires_grad and t.grad is None for _, t in tree_leaves(pp))
        _assert_params_after_steps(pp, jp, ocfg_p.lr, 4)


TINY = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256)


class TestTrainDriver:
    def test_matches_reference_train_and_resumes(self, tmp_path):
        """``tests/test_launch_integration.py``'s tiny config from seed 0
        alone, the reference's default bf16 weights; then resume from the
        step-12 and the step-6 checkpoint."""
        jcfg = dataclasses.replace(jax_get_config("llama3.2-1b", reduced=True), **TINY)
        cfg = dataclasses.replace(get_config("llama3.2-1b", reduced=True), **TINY)
        kw = dict(steps=12, batch=2, seq=32, lr=3e-3, log_every=0)
        ref = np.array(jtrain(jcfg, **kw))
        got = np.array(ptrain_mod.train(cfg, ckpt_dir=str(tmp_path), ckpt_every=6,
                                        device="cpu", **kw))
        assert len(got) == 12 and np.isfinite(got).all()
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-3)
        np.testing.assert_allclose(got, ref, rtol=0.15, atol=0.15)
        assert got[-3:].mean() < got[0] and ref[-3:].mean() < ref[0]
        # resume continues from the step-12 checkpoint
        more = ptrain_mod.train(cfg, steps=14, batch=2, seq=32, lr=3e-3, ckpt_dir=str(tmp_path),
                                log_every=0, device="cpu")
        assert len(more) == 2
        # from the step-6 checkpoint, the uninterrupted run's losses again
        for step in (12, 14):
            (tmp_path / f"step_{step:08d}.npz").unlink()
        again = ptrain_mod.train(cfg, steps=8, batch=2, seq=32, lr=3e-3, ckpt_dir=str(tmp_path),
                                 log_every=0, device="cpu")
        assert again == got[6:8].tolist()

    def test_options_and_device(self):
        cfg = dataclasses.replace(get_config("llama3.2-1b", reduced=True), **TINY)
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 10"):
            ptrain_mod.train(cfg, steps=1, mesh_shape=(2, 1), device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                ptrain_mod.train(cfg, steps=1)
            # LM.init made its weights on the CPU by default before; now
            # its device, like every entry point's, resolves None to CUDA
            with pytest.raises(RuntimeError, match="CUDA"):
                plm.LM(cfg).init(prng.PRNGKey(0))

    def test_cli_on_cpu(self, monkeypatch, capsys):
        monkeypatch.setattr("sys.argv", ["train", "--arch", "mamba2-130m", "--reduced",
                                         "--steps", "2", "--batch", "1", "--seq", "16",
                                         "--log-every", "1", "--device", "cpu"])
        ptrain_mod.main()
        out = capsys.readouterr().out
        assert "[train] step 2: loss=" in out and "tok/s=" in out and "[train] done" in out


class TestFlashAttentionFunction:
    def test_gradcheck_float64(self):
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.standard_normal((2, 5, 4))).requires_grad_()
                   for _ in range(3))
        assert torch.autograd.gradcheck(
            lambda q, k, v: flash_attention_train(q, k, v, impl="ref"), (q, k, v))

    @pytest.mark.parametrize("impl", ["ref", ""])
    def test_matches_plain_autograd(self, impl):
        rng = np.random.default_rng(1)
        arrays = [rng.standard_normal((3, 16, 8)).astype(np.float32) for _ in range(4)]
        a = [torch.from_numpy(x).requires_grad_() for x in arrays[:3]]
        b = [torch.from_numpy(x).requires_grad_() for x in arrays[:3]]
        g = torch.from_numpy(arrays[3])
        out = flash_attention_train(*a, impl=impl)
        want = attention_reference(*b)
        assert torch.equal(out, want)
        out.backward(g)
        want.backward(g)
        for x, y in zip(a, b):
            assert torch.equal(x.grad, y.grad)
