"""The collectives in the JAX reference's compiled train step, for the
reduced configs on an 8-device CPU mesh: what GSPMD partitions the
reference's loss and MoE dispatch into, for the port's sharded step to
be held against (its counts: ``repro_torch.launch.hlo``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_collectives.py [arch ...]

For each arch (default ``llama32_1b olmoe_1b_7b``) lowers and compiles
``repro.launch.dryrun._build_and_lower``'s train step (seq 64, batch 8,
the arch's tuned profile with strategy ``tp``) on a ("data", "model")
mesh of (2, 4) host devices, and prints each collective of the compiled
HLO by kind and output shape, with its count.  Runs the reference on the
CPU only (importing ``repro.launch.dryrun`` forces 512 XLA host
devices); a minute or two.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import sys

import repro.launch.dryrun as dryrun  # sets the host device count first
from repro.configs import get_config
from repro.launch.mesh import make_mesh_compat
from repro.models.config import InputShape
from repro.models.lm import RunFlags

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def collectives(arch: str) -> collections.Counter:
    """(kind, output type) -> count in the compiled train step of ``arch``."""
    mesh = make_mesh_compat((2, 4), ("data", "model"))
    profile = dataclasses.replace(dryrun.TUNED_PROFILES[arch], strategy="tp")
    shape = InputShape("reduced_train", 64, 8, "train")
    flags = RunFlags(remat=profile.remat, q_chunk=profile.q_chunk)
    text = dryrun._build_and_lower(get_config(arch, reduced=True), shape, mesh, profile,
                                   flags).compile().as_text()
    pattern = re.compile(r"= (.+?) (" + "|".join(KINDS) + r")(?:-start)?\(")
    out: collections.Counter = collections.Counter()
    for line in text.splitlines():
        m = pattern.search(line)
        if m:
            out[(m.group(2), m.group(1))] += 1
    return out


def main() -> None:
    for arch in sys.argv[1:] or ["llama32_1b", "olmoe_1b_7b"]:
        print(arch)
        for (kind, typ), n in sorted(collectives(arch).items()):
            print(f"  {kind} {typ} x{n}")


if __name__ == "__main__":
    main()
