"""Named dry-run variants for three (arch x shape) pairs, each recorded as
the port's full dry-run analysis (the counterpart of the JAX package's
``benchmarks/hillclimb.py``: the same ``PAIRS`` and ``VARIANTS`` over
``repro_torch.launch.dryrun.run_combo`` on the fake (32, 8) H100 mesh).

    PYTHONPATH=src python scripts/dryrun_hillclimb.py --pair arctic_train --variant v1_chunked_ce
    PYTHONPATH=src python scripts/dryrun_hillclimb.py --pair arctic_train --all

Results go to ``--out`` (``results/dryrun_hillclimb.json``), keyed
``pair|variant``; each line printed gives the roofline terms, the peak's
share of the card's 80 GiB, the per-rank temporaries and the useful-FLOP
ratio.  Traced on meta shards on the CPU: no card is needed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.launch.dryrun import TUNED_PROFILES, run_combo
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import INPUT_SHAPES

# The reference's three pairs: arctic's training step (memory-dominant),
# the VLM's decode (collective-bound through the cache's resharding), and
# jamba's training step (its gradient all-reduce payload); and the port's
# two whose collectives the loss and the MoE dispatch set: llama's and
# olmoe's training steps.
PAIRS = {
    "arctic_train": ("arctic_480b", "train_4k"),
    "vlm_decode": ("llama32_vision_11b", "decode_32k"),
    "jamba_train": ("jamba_v01_52b", "train_4k"),
    "llama_train": ("llama32_1b", "train_4k"),
    "olmoe_train": ("olmoe_1b_7b", "train_4k"),
}

# Variants: name -> Profile fields (the Profile carries every knob).
VARIANTS = {
    # the naive starting point: tensor-parallel, f32 moments, no remat
    "v0_baseline": dict(strategy="tp", moment_dtype="float32", remat="none"),
    # the tuned profile of the 40-combo table
    "v0_tuned": None,  # dryrun.TUNED_PROFILES[arch]
    # memory ladder
    "v1_chunked_ce": dict(loss_impl="chunked"),
    "v2_dots_remat": dict(remat="dots"),
    "v3_capacity_1_0": dict(capacity_factor=1.0),
    "v4_q_chunk_256": dict(q_chunk=256),
    "v5_constrain_acts": dict(constrain_acts=True),
    "v6_acts_plus_chunked_ce": dict(constrain_acts=True, loss_impl="chunked"),
    # collective ladder
    "c1_no_zero1": dict(strategy="tp"),
    "c2_moments_bf16": dict(moment_dtype="bfloat16"),
    "c3_fsdp": dict(strategy="fsdp"),
    # decode ladder
    "d1_seq_major_cache": dict(decode_cache_mode="seq"),
    "d2_batch_only_cache": dict(decode_cache_mode="batch"),
    "d3_constrained_attn": dict(decode_constrain=True),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", required=True, choices=list(PAIRS))
    ap.add_argument("--variant", nargs="+", choices=list(VARIANTS))
    ap.add_argument("--all", action="store_true", help="every variant")
    ap.add_argument("--out", default="results/dryrun_hillclimb.json")
    ap.add_argument("--no-correction", action="store_true")
    args = ap.parse_args()
    names = list(VARIANTS) if args.all else (args.variant or [])
    if not names:
        ap.error("name a --variant or pass --all")

    arch, shape_name = PAIRS[args.pair]
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=False)
    tuned = TUNED_PROFILES[arch]

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    for name in names:
        overrides = VARIANTS[name]
        profile = tuned if overrides is None else dataclasses.replace(tuned, **overrides)
        key = f"{args.pair}|{name}"
        print(f"[hillclimb] {key}: profile={profile}", flush=True)
        t0 = time.time()
        try:
            res = run_combo(arch, shape, mesh, profile, correct_scan=not args.no_correction)
        except Exception as e:  # recorded, the next variant runs
            res = {"status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-1500:]}
        res["wall_s"] = round(time.time() - t0, 1)
        results[key] = res
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        if res["status"] == "ok":
            r, m = res["roofline"], res["memory"]
            print(f"[hillclimb] {key}: compute={r['compute_s']:.3f}s mem={r['memory_s']:.3f}s "
                  f"coll={r['collective_s']:.3f}s dominant={r['dominant']} "
                  f"hbm={r['hbm_peak_frac']:.2f} temp={m['temp_bytes'] / 2**30:.1f}GiB "
                  f"useful={r['useful_flops_ratio']:.3f}", flush=True)
        else:
            print(f"[hillclimb] {key}: {res['status']} {res.get('error', '')[:200]}", flush=True)


if __name__ == "__main__":
    main()
