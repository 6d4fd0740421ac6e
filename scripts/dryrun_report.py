"""Markdown tables from the port's dry-run results (the counterpart of the
JAX package's ``benchmarks/report.py``).

    PYTHONPATH=src python scripts/dryrun_report.py [--json results/dryrun_torch.json]

Prints the Dry-run table (per-rank arguments and temporaries, the peak's
share of the H100's 80 GiB, collective payload by kind, trace seconds)
and the Roofline table (compute, memory and collective seconds on the
(32, 8) H100 mesh, the dominant term, ``model_flops``, the useful
ratio and the useful ratio of what the step runs), the rooflines re-derived from each result's ``cost_corrected``
with ``repro_torch.launch.roofline``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024 or unit == "TB":
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}TB"


def recompute_rooflines(data: Dict, mesh: str = "single") -> Dict:
    """The roofline block of each "ok" result re-derived from its stored
    ``cost_corrected`` and ``memory`` (the table stays consistent when the
    constants or ``model_flops`` change after a sweep)."""
    from repro_torch.launch.mesh import MULTI_POD_SHAPE, SINGLE_POD_SHAPE
    from repro_torch.launch.roofline import config_for_shape, roofline_terms
    from repro_torch.models.config import INPUT_SHAPES

    chips = 1
    for n in (SINGLE_POD_SHAPE if mesh == "single" else MULTI_POD_SHAPE):
        chips *= n
    for key, res in data.items():
        if res.get("status") != "ok" or f"|{mesh}|" not in key:
            continue
        arch, shape_name, _, _ = key.split("|")
        cfg = config_for_shape(arch, INPUT_SHAPES[shape_name])
        res["roofline"] = roofline_terms(cfg, INPUT_SHAPES[shape_name], chips, res)
    return data


def render(data: Dict, mesh: str = "single", profile: str = "tuned") -> str:
    data = recompute_rooflines(data, mesh)
    rows = []
    for key in sorted(data):
        arch, shape, m, p = key.split("|")
        if m != mesh or p != profile:
            continue
        res = data[key]
        if res.get("status") == "skipped":
            rows.append((arch, shape, "skipped", res.get("note", "")))
        elif res.get("status") == "ok":
            rows.append((arch, shape, "ok", res))
        else:
            rows.append((arch, shape, "ERROR", res.get("error", "")[:80]))

    chips = next((r["roofline"]["chips"] for _, _, st, r in rows if st == "ok"), "?")
    out = [f"### Dry-run ({mesh}-pod H100 mesh, profile={profile})\n",
           "| arch | shape | status | per-rank args | per-rank temp | HBM frac "
           "| collectives (per-rank payload) | trace |",
           "|---|---|---|---|---|---|---|---|"]
    for arch, shape, status, res in rows:
        if status != "ok":
            out.append(f"| {arch} | {shape} | {status} | — | — | — | {res} | — |")
            continue
        mem, coll = res["memory"], res["collectives"]
        kinds = ", ".join(f"{k}:{fmt_bytes(v)}" for k, v in coll.items()
                          if k not in ("total", "op_counts", "by_axis") and v > 0) or "none"
        out.append(f"| {arch} | {shape} | ok | {fmt_bytes(mem['argument_bytes'])} "
                   f"| {fmt_bytes(mem['temp_bytes'])} | {res['roofline']['hbm_peak_frac']:.2f} "
                   f"| {kinds} | {res.get('compile_s', '?')}s |")

    out += [f"\n### Roofline ({mesh}-pod, {chips} H100s, per step)\n",
            "| arch | shape | compute [s] | memory [s] | collective [s] | dominant "
            "| MODEL_FLOPS | useful ratio | run useful ratio | next move |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    moves = {
        "compute": "raise arithmetic intensity / bigger per-rank batch",
        "memory": "fuse (the byte count is unfused) and cut remat",
        "collective": "reshard (cut all-gathers), overlap collectives",
    }
    for arch, shape, status, res in rows:
        if status != "ok":
            continue
        r = res["roofline"]
        out.append(f"| {arch} | {shape} | {r['compute_s']:.4f} | {r['memory_s']:.4f} "
                   f"| {r['collective_s']:.4f} | **{r['dominant']}** "
                   f"| {r['model_flops']:.3e} | {r['useful_flops_ratio']:.3f} "
                   f"| {r['run_useful_ratio']:.3f} | {moves[r['dominant']]} |")
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="results/dryrun_torch.json")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--profile", default="tuned")
    args = ap.parse_args()
    with open(args.json) as f:
        data = json.load(f)
    print(render(data, args.mesh, args.profile))


if __name__ == "__main__":
    main()
