"""The port's roofline arithmetic (``repro_torch.launch.roofline``) against
the JAX reference's: ``config_for_shape`` (the ``-swa8k`` switch and the
skipped combos), ``model_flops`` ``==`` for all 10 architectures x 4
input shapes, and ``roofline_terms`` fed the same result with the
reference's TPU v5e constants patched into the port's mesh module:
every key of the reference's ``==`` (the port adds ``run_flops`` and
``run_useful_ratio``, checked on their own).  The port's own H100
constants are checked against the data sheet's values.
"""

import pytest

from repro.configs import get_config as jax_get_config
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroof
from repro.models import config as jconfig
from repro_torch.configs import ARCH_IDS
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import roofline as proof
from repro_torch.models import config as pconfig

SHAPES = tuple(jconfig.INPUT_SHAPES)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_and_model_flops(arch, shape):
    js, ps = jconfig.INPUT_SHAPES[shape], pconfig.INPUT_SHAPES[shape]
    jcfg, pcfg = jroof.config_for_shape(arch, js), proof.config_for_shape(arch, ps)
    assert (jcfg is None) == (pcfg is None)
    if jcfg is None:  # skipped combos: the base config's count all the same
        jcfg, pcfg = jax_get_config(arch), proof.get_config(arch)
    assert pcfg.name == jcfg.name and pcfg.sliding_window == jcfg.sliding_window
    assert proof.model_flops(pcfg, ps) == jroof.model_flops(jcfg, js)


def test_long_context_switch():
    """Dense archs take their sliding-window variant at long_500k only."""
    ps = pconfig.INPUT_SHAPES
    for arch in ("llama32_1b", "phi4_mini_3_8b", "gemma_7b", "yi_9b"):
        cfg = proof.config_for_shape(arch, ps["long_500k"])
        assert cfg.name.endswith("-swa8k") and cfg.sliding_window == 8192
        assert not proof.config_for_shape(arch, ps["decode_32k"]).sliding_window
    for arch in ("olmoe_1b_7b", "seamless_m4t_large_v2", "llama32_vision_11b"):
        assert proof.config_for_shape(arch, ps["long_500k"]) is None
    for arch in ("mamba2_130m", "jamba_v01_52b"):
        assert proof.config_for_shape(arch, ps["long_500k"]).name == jax_get_config(arch).name


def _res(i: int) -> dict:
    cc = {"flops": 1.5e13 * (i + 1), "bytes_accessed": 3.25e11 + i, "transcendentals": 7e9,
          "collective_total": 2.5e9 * (i % 3)}
    return {"cost_corrected": cc, "memory": {"peak_bytes": 9.5e9 + 1e8 * i}}


@pytest.mark.parametrize("chips", [256, 512])
def test_roofline_terms_with_reference_constants(monkeypatch, chips):
    """The reference's v5e constants in the port's mesh module (one rate
    for both links): every term ``==`` the reference's for the same
    per-device result."""
    monkeypatch.setattr(pmesh, "PEAK_FLOPS_BF16", jmesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(pmesh, "HBM_BW", jmesh.HBM_BW)
    monkeypatch.setattr(pmesh, "HBM_BYTES", jmesh.HBM_BYTES)
    monkeypatch.setattr(pmesh, "NVLINK_BW", jmesh.ICI_BW)
    monkeypatch.setattr(pmesh, "NET_BW", jmesh.ICI_BW)
    i = 0
    for arch in ARCH_IDS:
        for shape in SHAPES:
            jcfg = jroof.config_for_shape(arch, jconfig.INPUT_SHAPES[shape])
            if jcfg is None:
                continue
            pcfg = proof.config_for_shape(arch, pconfig.INPUT_SHAPES[shape])
            res = _res(i)
            i += 1
            want = jroof.roofline_terms(jcfg, jconfig.INPUT_SHAPES[shape], chips, res)
            got = proof.roofline_terms(pcfg, pconfig.INPUT_SHAPES[shape], chips, res)
            assert {k: got[k] for k in want} == want, (arch, shape)
            assert set(got) - set(want) == {"run_flops", "run_useful_ratio"}


def test_h100_constants_and_link_split():
    assert pmesh.PEAK_FLOPS_BF16 == 989e12 and pmesh.HBM_BW == 3.35e12
    assert pmesh.HBM_BYTES == 80 * 1024**3 and pmesh.GPUS_PER_NODE == 8
    assert pmesh.NVLINK_BW == 450e9 and pmesh.NET_BW == 50e9
    assert pmesh.SINGLE_POD_SHAPE == (32, 8) and pmesh.MULTI_POD_SHAPE == (2, 32, 8)
    cfg = proof.config_for_shape("llama32_1b", pconfig.INPUT_SHAPES["train_4k"])
    res = _res(0)
    res["cost_corrected"]["collective_total"] = 9e9
    res["cost_corrected"]["collective_model"] = 4.5e9
    t = proof.roofline_terms(cfg, pconfig.INPUT_SHAPES["train_4k"], 256, res)
    assert t["collective_s"] == pytest.approx(4.5e9 / 450e9 + 4.5e9 / 50e9, rel=1e-12)
    assert t["compute_s"] == pytest.approx(1.5e13 / 989e12, rel=1e-12)
    assert t["hbm_peak_frac"] == 9.5e9 / (80 * 1024**3)


@pytest.mark.parametrize("shape", SHAPES)
def test_run_flops(shape):
    """``run_flops`` is ``model_flops`` but for a prefill, which runs the
    vocab projection of each sequence's last token only."""
    ps = pconfig.INPUT_SHAPES[shape]
    for arch in ARCH_IDS:
        cfg = proof.config_for_shape(arch, ps)
        if cfg is None:
            continue
        mf, rf = proof.model_flops(cfg, ps), proof.run_flops(cfg, ps)
        head = 2.0 * cfg.vocab_size * cfg.d_model * (ps.seq_len - 1) * ps.global_batch
        assert rf == (mf - head if ps.kind == "prefill" else mf), arch
        assert 0 < rf <= mf
        t = proof.roofline_terms(cfg, ps, 256, _res(0))
        assert t["run_flops"] == rf
        assert t["run_useful_ratio"] == rf / t["hlo_flops_global"]
