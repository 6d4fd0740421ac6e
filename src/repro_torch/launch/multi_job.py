"""Multi-job launcher: Ada-SRSF scheduling real training jobs (port of
``repro/launch/multi_job.py``).

The counterpart of the paper's PyTorch prototype: a set of training jobs
— real models, real train steps — is admitted to a cluster, placed by
LWF-kappa, and their gradient all-reduces are gated by AdaDUAL under the
Eq. (5) contention model.  The network is virtual (the 10GbE constants of
the paper, or the reference's ``tpu-dcn`` set); the compute profile of
every job is real: its train step runs and is timed on the device, and
its all-reduce message is its parameter byte count.  The schedule comes
from the port's event engine (:mod:`repro_torch.core.simulator`), on the
host.

    PYTHONPATH=src python -m repro_torch.launch.multi_job \
        --jobs llama3.2-1b:4:300 mamba2-130m:2:500 olmoe-1b-7b:8:200 \
        --policy ada --fabric 10gbe

Runs on CUDA unless given ``--device cpu`` (``device="cpu"``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import prng
from repro_torch.configs import served_config
from repro_torch.core.cluster import Cluster, JobSpec, ModelProfile
from repro_torch.core.contention import TPU_DCN_A, TPU_DCN_B, TPU_DCN_ETA, ContentionParams
from repro_torch.core.placement import PlacementPolicy
from repro_torch.core.simulator import ClusterSimulator, SimResult, comm_policy_from_name
from repro_torch.data import SyntheticLMDataset
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.steps import make_train_step
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.lm import LM, RunFlags
from repro_torch.optim.adamw import AdamWConfig, adamw_init

#: The reference's virtual fabrics, unchanged: the paper's 10GbE fit and
#: the reference's TPU-DCN set.
FABRICS = {
    "10gbe": ContentionParams(),
    "tpu-dcn": ContentionParams(a=TPU_DCN_A, b=TPU_DCN_B, eta=TPU_DCN_ETA),
}

#: The reference's default ``--jobs``.
DEFAULT_JOBS = ("llama3.2-1b:4:300", "mamba2-130m:2:500", "olmoe-1b-7b:8:200")


@dataclasses.dataclass
class JobRequest:
    arch: str
    n_gpus: int
    iterations: int
    arrival: float = 0.0
    batch: int = 4
    seq: int = 64
    reduced: bool = True

    @classmethod
    def parse(cls, spec: str, arrival: float = 0.0) -> "JobRequest":
        arch, n, iters = spec.split(":")
        return cls(arch=arch, n_gpus=int(n), iterations=int(iters), arrival=arrival)


@dataclasses.dataclass
class ProfiledJob:
    """A profiled job.  ``params`` and ``opt_state`` are the job's initial
    state, untouched by the profiling steps (which ran on copies);
    ``warmup_loss`` is the loss of the first (warm-up) step from it."""

    request: JobRequest
    lm: LM
    params: object
    opt_state: object
    step_fn: object
    dataset: SyntheticLMDataset
    profile: ModelProfile
    warmup_loss: float


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in tree_leaves(tree))


def device_batch(dataset: SyntheticLMDataset, step: int, device: torch.device):
    return {k: torch.from_numpy(v).to(device) for k, v in dataset.batch_at(step).items()}


def profile_job(req: JobRequest, seed: int = 0, timing_steps: int = 3,
                device=None, dtype: torch.dtype = torch.bfloat16) -> ProfiledJob:
    """Build the job's train step and measure (t_f + t_b, message size,
    memory) on ``device`` (None = CUDA), weights in ``dtype`` (the
    reference's bf16 by default).  One warm-up step, then
    ``timing_steps`` timed steps, the device synchronized before each clock
    read.  The port's train step updates its parameters and moments in
    place, so the steps run on copies and the returned state is the init,
    as the reference's (which JAX never mutates)."""
    dev = resolve_device(device)
    cfg = served_config(req.arch, reduced=req.reduced)
    lm = LM(cfg)
    opt_cfg = AdamWConfig()
    flags = RunFlags(remat="none", q_chunk=min(256, req.seq))
    params = lm.init(prng.PRNGKey(seed), dtype, device=dev)
    opt_state = adamw_init(params, opt_cfg)
    step_fn = make_train_step(lm, opt_cfg, flags)
    ds = SyntheticLMDataset(cfg, req.batch, req.seq, seed=seed)

    batch = device_batch(ds, 0, dev)
    p, o = tree_map(torch.clone, params), tree_map(torch.clone, opt_state)
    p, o, m = step_fn(p, o, batch)  # warm-up (the reference's compile step)
    warmup_loss = float(m["loss"])
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(timing_steps):
        p, o, m = step_fn(p, o, batch)
    synchronize(dev)
    t_iter = (time.perf_counter() - t0) / timing_steps
    del p, o, m

    size_bytes = float(_nbytes(params))
    # params + optimizer state, x3 for activations headroom (the reference's)
    mem_mb = (_nbytes(params) + _nbytes(opt_state)) / 1e6 * 3.0
    profile = ModelProfile(
        name=cfg.name,
        size_bytes=size_bytes,
        mem_mb=mem_mb,
        batch_size=req.batch,
        t_f=t_iter / 3.0,  # fwd ~1/3, bwd + update ~2/3 of a step
        t_b=t_iter * 2.0 / 3.0,
    )
    return ProfiledJob(req, lm, params, opt_state, step_fn, ds, profile, warmup_loss)


def schedule_jobs(
    requests: Sequence[JobRequest],
    profiles: Sequence[ModelProfile],
    policy: str = "ada",
    fabric: str = "10gbe",
    kappa: int = 1,
    n_servers: int = 4,
    gpus_per_server: int = 4,
) -> SimResult:
    """The schedule of ``run_multi_job``: one job per request with its
    measured profile, on an ``n_servers x gpus_per_server`` cluster of
    64 GB GPUs, LWF-kappa placement and ``policy`` gating over ``fabric``."""
    specs = [
        JobSpec(i, r.arrival, r.n_gpus, r.iterations, prof)
        for i, (r, prof) in enumerate(zip(requests, profiles))
    ]
    sim = ClusterSimulator(
        specs,
        cluster=Cluster(n_servers, gpus_per_server, gpu_mem_mb=64000.0),
        placement=PlacementPolicy("lwf", kappa=kappa),
        comm_policy=comm_policy_from_name(policy),
        params=FABRICS[fabric],
    )
    return sim.run()


def run_multi_job(
    requests: List[JobRequest],
    policy: str = "ada",
    fabric: str = "10gbe",
    kappa: int = 1,
    n_servers: int = 4,
    gpus_per_server: int = 4,
    execute_steps: int = 8,
    seed: int = 0,
    timing_steps: int = 3,
    device=None,
    dtype: torch.dtype = torch.bfloat16,
) -> Dict:
    """Profile every job on ``device`` (None = CUDA), schedule them with
    ``policy``, then run ``execute_steps`` real training steps of each job,
    from its initial state, in the order the schedule completes them."""
    dev = resolve_device(device)
    profiled = [profile_job(r, seed=seed + i, timing_steps=timing_steps, device=dev,
                            dtype=dtype)
                for i, r in enumerate(requests)]
    res = schedule_jobs(requests, [pj.profile for pj in profiled], policy=policy,
                        fabric=fabric, kappa=kappa, n_servers=n_servers,
                        gpus_per_server=gpus_per_server)

    losses: Dict[int, List[float]] = {}
    order = sorted(res.finish, key=res.finish.get)
    for jid in order:
        pj = profiled[jid]
        p, o = pj.params, pj.opt_state
        losses[jid] = []
        for s in range(execute_steps):
            p, o, m = pj.step_fn(p, o, device_batch(pj.dataset, s, dev))
            losses[jid].append(float(m["loss"]))
    return {
        "schedule": res,
        "losses": losses,
        "warmup_losses": {i: pj.warmup_loss for i, pj in enumerate(profiled)},
        "profiles": {i: pj.profile for i, pj in enumerate(profiled)},
        "order": order,
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", nargs="+", default=list(DEFAULT_JOBS),
                    help="arch:n_gpus:iterations")
    ap.add_argument("--policy", default="ada")
    ap.add_argument("--fabric", default="10gbe", choices=list(FABRICS))
    ap.add_argument("--kappa", type=int, default=1)
    ap.add_argument("--execute-steps", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (plain PyTorch path)")
    args = ap.parse_args(argv)
    reqs = [JobRequest.parse(s, arrival=2.0 * i) for i, s in enumerate(args.jobs)]
    out = run_multi_job(
        reqs, policy=args.policy, fabric=args.fabric, kappa=args.kappa,
        execute_steps=args.execute_steps, device=args.device,
    )
    res = out["schedule"]
    print(f"[multi-job] policy={res.policy_name} placement={res.placement_name}")
    for jid, prof in out["profiles"].items():
        jct = res.jct.get(jid, float("nan"))
        ls = out["losses"][jid]
        print(
            f"  J{jid} {prof.name}: t_iter={prof.t_iter_compute*1e3:.1f}ms "
            f"sigma={prof.size_bytes/1e6:.1f}MB virtual-JCT={jct:.1f}s "
            f"loss {ls[0]:.3f}->{ls[-1]:.3f}"
        )
    print(
        f"[multi-job] avg JCT {res.avg_jct():.1f}s util {res.gpu_util:.1%} "
        f"contended-starts {res.comm_started_contended}"
    )


if __name__ == "__main__":
    main()
