"""The dry-run: trace every (architecture x input shape) on a production
mesh and record its cost, memory and collectives (port of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --mesh single [multi] \\
        --out results/dryrun_torch.json [--profile tuned] [--resume]

The reference lowers and compiles each step with XLA on 512 forced host
devices.  The port has no compiler to ask, so it runs the step once as
rank 0 of a fake process group of the mesh's size on a "cuda" mesh
(``launch/mesh.py::make_production_mesh``): parameters, moments, batch
and cache are meta tensors (shapes and dtypes, no data, no memory; no
card is needed), each rank's shard of them wrapped as a DTensor by the
port's sharding rules, and the step dispatches what the card would run
(the flash and SSD custom ops' fake implementations, the backward's
recompute of the plain attention, DTensor's collectives as the card's
NCCL group would issue them) while ``launch/hlo.py``'s counters count one
rank's FLOPs, bytes, transcendentals, collectives and live storages.
The shards are meta tensors rather than ``FakeTensorMode``'s fakes:
DTensor's own index arithmetic for a ``_StridedShard`` (a batch-sharded
dim folded with a sequence-sharded one) reads small real tensors, which
a fake mode would turn into fakes with no values.  ``compile_s`` is the
trace's seconds.

The port traces every block (its layers are a Python loop, not a scan),
so ``cost_corrected`` is the trace's own count; ``correction_deltas``
are per block, the difference between the traces of ``min(4, n_blocks)``
blocks and one block fewer (``--no-correction`` skips them).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.configs import ARCH_IDS, canonical, get_config
from repro_torch.launch import hlo as hlo_mod
from repro_torch.launch.mesh import make_production_mesh, n_chips
from repro_torch.launch.roofline import config_for_shape, model_flops  # noqa: F401
from repro_torch.launch.roofline import roofline_terms as _roofline_terms
from repro_torch.launch.specs import decode_specs, supports_shape, train_like_specs
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models.common import tree_map
from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models.lm import LM, RunFlags
from repro_torch.optim.adamw import AdamWConfig, abstract_opt_state
from repro_torch.sharding.rules import (
    ShardingStrategy, abstract_place, embeds_sharding, moment_shardings, param_shardings,
    place_cache, token_sharding,
)

# ---------------------------------------------------------------------------
# Per-arch runtime profiles, copied from the reference.
#
# "baseline" is the naive first config (tensor-parallel everywhere, f32
# moments, no remat); "tuned" the reference's profile after its iterations.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Profile:
    strategy: str = "tp"          # tp | fsdp | zero1 | dp
    moment_dtype: str = "float32"  # float32 | bfloat16
    remat: str = "none"            # none | block | dots
    q_chunk: int = 512
    include_model_in_dp: bool = False
    # the hill-climb's knobs (scripts/dryrun_hillclimb.py)
    loss_impl: str = "dense"       # dense | chunked
    loss_chunk: int = 512
    capacity_factor: float = 0.0   # 0 -> keep the config's value
    decode_cache_mode: str = "auto"  # auto | seq | batch
    decode_constrain: bool = False
    constrain_acts: bool = False


BASELINE_PROFILES: Dict[str, Profile] = {a: Profile() for a in ARCH_IDS}
BASELINE_PROFILES["mamba2_130m"] = Profile(strategy="dp", include_model_in_dp=True)

# decode_constrain is set exactly on the GQA archs whose kv heads do not
# divide the reference's 16-way model axis (their caches are seq-sharded);
# constrain_acts pins the residual stream batch-sharded.
TUNED_PROFILES: Dict[str, Profile] = {
    "mamba2_130m": Profile(strategy="dp", include_model_in_dp=True, remat="block"),
    "llama32_1b": Profile(strategy="zero1", remat="block", decode_constrain=True),
    "phi4_mini_3_8b": Profile(strategy="zero1", remat="block", decode_constrain=True),
    "gemma_7b": Profile(strategy="zero1", remat="block"),
    "yi_9b": Profile(strategy="zero1", remat="block", decode_constrain=True),
    "olmoe_1b_7b": Profile(strategy="zero1", remat="block"),
    "seamless_m4t_large_v2": Profile(strategy="zero1", remat="block"),
    "llama32_vision_11b": Profile(strategy="zero1", remat="block", decode_constrain=True),
    "jamba_v01_52b": Profile(strategy="zero1", remat="block", decode_constrain=True),
    "arctic_480b": Profile(
        strategy="fsdp", moment_dtype="bfloat16", remat="block",
        decode_constrain=True, constrain_acts=True,
    ),
}


def with_n_blocks(cfg: ModelConfig, nb: int) -> ModelConfig:
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=nb * cfg.block_len)
    if cfg.family == "vlm":
        return dataclasses.replace(cfg, n_layers=nb * cfg.cross_attn_every)
    if cfg.family == "audio":
        return dataclasses.replace(cfg, n_layers=nb, enc_layers=nb)
    return dataclasses.replace(cfg, n_layers=nb)


# ---------------------------------------------------------------------------
# Trace one variant
# ---------------------------------------------------------------------------


def _batch_shardings(batch, mesh, shape: InputShape, inc: bool):
    return {k: (token_sharding(mesh, shape.global_batch, include_model=inc) if v.dim() == 2
                else embeds_sharding(mesh, shape.global_batch, include_model=inc))
            for k, v in batch.items()}


def _build_and_trace(cfg, shape: InputShape, mesh, profile: Profile, flags: RunFlags):
    """One step of ``cfg`` at ``shape`` on ``mesh`` under ``profile``, traced
    (the counterpart of the reference's ``_build_and_lower``): parameters,
    moments, batch and cache made as meta tensors and placed by the
    sharding rules, each rank's shard a meta tensor; the parameters and
    moments (train) and the cache (decode) donated.  Returns the
    :class:`launch.hlo.StepTrace`."""
    if profile.capacity_factor:
        cfg = dataclasses.replace(cfg, capacity_factor=profile.capacity_factor)
    lm = LM(cfg)
    strategy = ShardingStrategy.from_name(profile.strategy)
    ap = lm.abstract_params()
    p_sh = param_shardings(lm.logical_axes(), ap, mesh, strategy)
    inc = profile.include_model_in_dp

    def place(tree, shardings):
        return tree_map(abstract_place, tree, shardings)

    params = place(ap, p_sh)
    if shape.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=getattr(torch, profile.moment_dtype))
        ao = abstract_opt_state(ap, opt_cfg)
        m_sh = moment_shardings(p_sh, ap, mesh, strategy)
        opt = {"m": place(ao["m"], m_sh), "v": place(ao["v"], m_sh), "step": ao["step"]}
        batch = train_like_specs(cfg, shape)
        batch = place(batch, _batch_shardings(batch, mesh, shape, inc))
        step = make_train_step(lm, opt_cfg, flags)
        return hlo_mod.trace_step(step, (params, opt, batch), mesh, donated=(params, opt))[1]
    if shape.kind == "prefill":
        batch = train_like_specs(cfg, shape)
        batch = place(batch, _batch_shardings(batch, mesh, shape, inc))
        step = make_prefill_step(lm, max_seq=shape.seq_len, flags=flags)
        return hlo_mod.trace_step(step, (params, batch), mesh)[1]
    cache, token = decode_specs(lm, shape)
    cache = place_cache(cache, mesh, shape.global_batch, cfg, mode=profile.decode_cache_mode)
    token = abstract_place(token, token_sharding(mesh, shape.global_batch, include_model=inc))
    step = make_serve_step(lm, flags)
    return hlo_mod.trace_step(step, (params, cache, token), mesh, donated=(cache,))[1]


def _trace_and_analyze(trace) -> Dict[str, Any]:
    """The reference's ``_compile_and_analyze`` on a trace: cost, memory and
    collectives of one rank, and its FLOPs by op."""
    res = {"cost": hlo_mod.normalize_cost(trace), "memory": hlo_mod.memory_stats(trace),
           "collectives": hlo_mod.collective_bytes(trace),
           "largest_collectives": hlo_mod.largest_collectives(trace),
           "flops_by_op": hlo_mod.flops_by_op(trace)}
    gc.collect()
    return res


def run_flags(profile: Profile, shape: InputShape) -> RunFlags:
    """The step's ``RunFlags`` under ``profile`` at ``shape``."""
    return RunFlags(
        remat=profile.remat,
        q_chunk=profile.q_chunk,
        loss_impl=profile.loss_impl,
        loss_chunk=profile.loss_chunk,
        decode_constrain=profile.decode_constrain and shape.kind == "decode",
        constrain_acts=profile.constrain_acts and shape.kind != "decode",
    )


def run_combo(
    arch: str,
    shape: InputShape,
    mesh,
    profile: Profile,
    correct_scan: bool = True,
) -> Dict[str, Any]:
    """Full dry-run of one (arch, shape, mesh): trace the production model
    and, with ``correct_scan``, the per-block deltas."""
    cfg = config_for_shape(arch, shape)
    if cfg is None:
        _, note = supports_shape(get_config(arch), shape)
        return {"status": "skipped", "note": note}

    flags = run_flags(profile, shape)
    t0 = time.time()
    res = _trace_and_analyze(_build_and_trace(cfg, shape, mesh, profile, flags))
    res["compile_s"] = round(time.time() - t0, 1)

    coll = res["collectives"]
    res["cost_corrected"] = {
        "flops": res["cost"]["flops"],
        "bytes_accessed": res["cost"]["bytes_accessed"],
        "transcendentals": res["cost"]["transcendentals"],
        "collective_total": coll["total"],
        "collective_model": coll["by_axis"].get("model", 0.0),
    }
    nb_full = LM(cfg).n_blocks
    if correct_scan and nb_full > 1:
        nb_small = min(4, nb_full)
        u2 = _trace_and_analyze(_build_and_trace(with_n_blocks(cfg, nb_small), shape, mesh,
                                                 profile, flags))
        u1 = _trace_and_analyze(_build_and_trace(with_n_blocks(cfg, nb_small - 1), shape, mesh,
                                                 profile, flags))
        res["correction_deltas"] = {
            "per_layer_flops": u2["cost"]["flops"] - u1["cost"]["flops"],
            "per_layer_bytes": u2["cost"]["bytes_accessed"] - u1["cost"]["bytes_accessed"],
            "per_layer_collective": u2["collectives"]["total"] - u1["collectives"]["total"],
        }

    res["roofline"] = _roofline_terms(cfg, shape, n_chips(mesh), res)
    res["status"] = "ok"
    res["config"] = cfg.name
    res["profile"] = dataclasses.asdict(profile)
    return res


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main() -> None:
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["all"])
    ap.add_argument("--shape", nargs="+", default=["all"])
    ap.add_argument("--mesh", nargs="+", default=["single"], choices=["single", "multi"])
    ap.add_argument("--profile", default="tuned", choices=["baseline", "tuned"])
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-correction", action="store_true")
    args = ap.parse_args()

    archs = list(ARCH_IDS) if args.arch == ["all"] else [canonical(a) for a in args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == ["all"] else args.shape
    profiles = BASELINE_PROFILES if args.profile == "baseline" else TUNED_PROFILES

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results: Dict[str, Any] = {}
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    torch.set_num_threads(1)
    for mesh_name in args.mesh:
        if dist.is_initialized():  # this process's fake group of the last mesh
            dist.destroy_process_group()
        mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
        for arch in archs:
            for shape_name in shapes:
                shape = INPUT_SHAPES[shape_name]
                key = f"{arch}|{shape_name}|{mesh_name}|{args.profile}"
                if args.resume and results.get(key, {}).get("status") in ("ok", "skipped"):
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                t0 = time.time()
                try:
                    res = run_combo(arch, shape, mesh, profiles[arch],
                                    correct_scan=not args.no_correction)
                except Exception as e:  # record failures, keep going
                    res = {
                        "status": "error",
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-2000:],
                    }
                res["wall_s"] = round(time.time() - t0, 1)
                results[key] = res
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                status = res["status"]
                extra = ""
                if status == "ok":
                    r = res["roofline"]
                    extra = (
                        f" dominant={r['dominant']} compute={r['compute_s']:.4f}s "
                        f"mem={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s "
                        f"hbm={r['hbm_peak_frac']:.2f} useful={r['useful_flops_ratio']:.2f} "
                        f"run_useful={r['run_useful_ratio']:.2f}"
                    )
                elif status == "error":
                    extra = " " + res["error"][:160]
                print(f"[dryrun] {key}: {status}{extra} ({res['wall_s']}s)", flush=True)

    n_ok = sum(1 for r in results.values() if r.get("status") == "ok")
    n_skip = sum(1 for r in results.values() if r.get("status") == "skipped")
    n_err = sum(1 for r in results.values() if r.get("status") == "error")
    print(f"[dryrun] done: ok={n_ok} skipped={n_skip} error={n_err}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
