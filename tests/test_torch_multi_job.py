"""The port's multi-job launcher (``repro_torch.launch.multi_job``) against
the reference's (``repro.launch.multi_job``), on the CPU: the reduced
llama3.2-1b and mamba2-130m configs at batch 2, seq 32.

* ``profile_job``'s message size and memory equal the reference's, and it
  returns the job's initial state (the port's train step updates in place,
  so the profiling steps run on copies);
* with the same fixed profiles injected into both packages, the schedule
  (every ``SimResult`` field, hence the completion order) is identical
  under ada, srsf2 and kway2;
* ``run_multi_job``'s first executed loss per job equals the loss of the
  first step from a fresh init: exactly the port's own warm-up step, and in
  float32 within 1e-5 of the reference's jitted step;
* ``FABRICS`` and ``DEFAULT_JOBS`` equal the reference's, and the MoE
  job of the default list profiles on the CPU.
"""

import ast
import dataclasses
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.multi_job as R
from repro.configs import get_config as ref_config
from repro.core import cluster as rcl
from repro.core.placement import PlacementPolicy as RPlacement
from repro.core.simulator import ClusterSimulator as RSim
from repro.core.simulator import comm_policy_from_name as ref_comm
from repro.launch.steps import make_train_step as ref_train_step
from repro.models.lm import LM as RLM
from repro.models.lm import RunFlags as RFlags
from repro.optim.adamw import AdamWConfig as RAdamW
from repro.optim.adamw import adamw_init as ref_adamw_init
import repro_torch.launch.multi_job as P
from repro_torch import prng
from repro_torch.core import cluster as pcl
from repro_torch.models.common import tree_leaves
from test_torch_engine import assert_same_result

ARCHS = ("llama3.2-1b", "mamba2-130m")


def request(mod, arch, **kw):
    return mod.JobRequest(arch, n_gpus=4, iterations=50, batch=2, seq=32, **kw)


@pytest.fixture(scope="module")
def profiled():
    return {arch: P.profile_job(request(P, arch), seed=3, timing_steps=1, device="cpu")
            for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_profile_sizes_equal_reference(profiled, arch):
    ref = R.profile_job(request(R, arch), seed=3, timing_steps=1).profile
    got = profiled[arch].profile
    assert got.size_bytes == ref.size_bytes and got.mem_mb == ref.mem_mb
    assert got.name == ref.name and got.batch_size == ref.batch_size == 2
    assert 0 < got.t_f < got.t_b  # a third and two thirds of the timed step


@pytest.mark.parametrize("arch", ARCHS)
def test_profile_returns_the_init(profiled, arch):
    """The profiling steps trained copies: the returned parameters are the
    init from the seed, the moments zero and the step 0."""
    pj = profiled[arch]
    fresh = pj.lm.init(prng.PRNGKey(3), device="cpu")
    got = dict(tree_leaves(pj.params))
    for k, v in tree_leaves(fresh):
        assert torch.equal(got[k].detach(), v), k
    for k, v in tree_leaves(pj.opt_state):
        assert not v.any(), k


def _profiles(mod):
    """Fixed profiles, as if measured: two 1B-class jobs, a small one."""
    return [
        mod.ModelProfile("llama", 2.474e9, 37120.0, 8, 0.0987, 0.1974),
        mod.ModelProfile("mamba", 2.58e8, 3870.0, 8, 0.0411, 0.0822),
        mod.ModelProfile("small", 9.92e7, 3213.0, 16, 0.025, 0.0374),
    ]


REQS = [("llama3.2-1b", 4, 300, 0.0), ("mamba2-130m", 2, 500, 2.0), ("llama3.2-1b", 8, 120, 4.0),
        ("mamba2-130m", 4, 400, 4.5), ("llama3.2-1b", 2, 200, 7.0), ("mamba2-130m", 6, 150, 9.0)]


@pytest.mark.parametrize("fabric", ["10gbe", "tpu-dcn"])
@pytest.mark.parametrize("policy", ["ada", "srsf2", "kway2"])
def test_schedule_equals_reference(policy, fabric):
    reqs = [P.JobRequest(a, n, it, arrival=t) for a, n, it, t in REQS]
    pprof, rprof = _profiles(pcl), _profiles(rcl)
    pick = [0, 1, 0, 2, 0, 1]
    got = P.schedule_jobs(reqs, [pprof[i] for i in pick], policy=policy, fabric=fabric)
    # the reference's run_multi_job, from its source, with these profiles
    specs = [rcl.JobSpec(i, t, n, it, rprof[pick[i]]) for i, (_, n, it, t) in enumerate(REQS)]
    ref = RSim(specs, cluster=rcl.Cluster(4, 4, gpu_mem_mb=64000.0),
               placement=RPlacement("lwf", kappa=1), comm_policy=ref_comm(policy),
               params=R.FABRICS[fabric]).run()
    assert_same_result(got, ref)
    assert len(got.jct) == len(REQS)
    assert sorted(got.finish, key=got.finish.get) == sorted(ref.finish, key=ref.finish.get)


def _ref_first_loss(arch, seed, dtype):
    cfg = ref_config(arch, reduced=True)
    lm = RLM(cfg)
    params = lm.init(jax.random.PRNGKey(seed), dtype)
    opt_cfg = RAdamW()
    step = jax.jit(ref_train_step(lm, opt_cfg, RFlags(remat="none", q_chunk=32)))
    ds = R.SyntheticLMDataset(cfg, 2, 32, seed=seed)
    batch = {k: jnp.asarray(v) for k, v in ds.batch_at(0).items()}
    _, _, m = step(params, ref_adamw_init(params, opt_cfg), batch)
    return float(m["loss"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_first_executed_loss_is_the_init_loss(dtype):
    reqs = [request(P, "llama3.2-1b"), request(P, "mamba2-130m", arrival=1.0)]
    out = P.run_multi_job(reqs, policy="ada", execute_steps=2, timing_steps=1, seed=5,
                          device="cpu", dtype=dtype)
    res = out["schedule"]
    assert len(res.jct) == 2 and out["order"] == sorted(res.finish, key=res.finish.get)
    for jid, losses in out["losses"].items():
        assert len(losses) == 2 and np.isfinite(losses).all()
        # the first executed step is the warm-up step again: same init, batch
        assert losses[0] == out["warmup_losses"][jid], jid
        if dtype == torch.float32:
            ref = _ref_first_loss(reqs[jid].arch, 5 + jid, jnp.float32)
            assert losses[0] == pytest.approx(ref, rel=1e-5, abs=1e-5), jid


def test_fabrics_equal_reference():
    assert set(P.FABRICS) == set(R.FABRICS) == {"10gbe", "tpu-dcn"}
    for k, p in P.FABRICS.items():
        r = R.FABRICS[k]
        assert (p.a, p.b, p.eta, p.server_bandwidth) == (r.a, r.b, r.eta, r.server_bandwidth)
        assert p.dual_threshold == r.dual_threshold


def test_parse_and_defaults():
    got = P.JobRequest.parse("llama3.2-1b:4:300", arrival=2.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        R.JobRequest.parse("llama3.2-1b:4:300", arrival=2.0))
    # the reference's default job list, the MoE job included
    assert list(P.DEFAULT_JOBS) == ["llama3.2-1b:4:300", "mamba2-130m:2:500",
                                    "olmoe-1b-7b:8:200"]
    # ... read from the reference's argparse default
    ref_src = inspect.getsource(R.main)
    ref_default = re.search(r'"--jobs",.*?default=(\[.*?\])', ref_src, re.S).group(1)
    assert list(P.DEFAULT_JOBS) == ast.literal_eval(ref_default)
    pj = P.profile_job(P.JobRequest.parse("olmoe-1b-7b:8:200"), timing_steps=1, device="cpu")
    assert pj.lm.cfg.family == "moe" and pj.lm.cfg.name == "olmoe-reduced"
    assert np.isfinite(pj.warmup_loss) and pj.profile.t_f > 0 and pj.profile.t_b > 0
    assert pj.profile.size_bytes == 2 * sum(t.numel() for _, t in tree_leaves(pj.params))


def test_needs_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.profile_job(request(P, "mamba2-130m"))
    with pytest.raises(RuntimeError, match="CUDA"):
        P.run_multi_job([request(P, "mamba2-130m")])
