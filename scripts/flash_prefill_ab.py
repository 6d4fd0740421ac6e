"""A full-width prefill (llama3.2-1b, or ``--arch``) with two builds of the
flash-attention kernel, in turns, in one process on one NVIDIA GPU.

Run from the repository root::

    python3 scripts/flash_prefill_ab.py --baseline OTHER/csrc/flash_attention.cu [--arch gemma-7b]

``--baseline`` is another version of ``flash_attention.cu`` with the same
C interface (for example the parent commit's, unpacked with ``git
archive`` into a git-ignored directory).  Both sources are built with
``nvcc`` (sm_90a), then the port's flash wrapper is pointed at each in the
order baseline, current, current, baseline, and each turn measures, at
batch 8, prompt 512, random bf16 weights from seed 0:

- the kernel alone at llama3.2-1b's serve shape (BH 256, S = T 512, D 64,
  causal, bf16) and gemma-7b's prefill shape (BH 128, S = T 512, D 256):
  device ms per call in a CUDA graph of 10 calls;
- the prefill step (``make_prefill_step``): wall ms of five synchronised
  runs and prompt tok/s from the fastest;
- one prefill under the profiler: device ms, the flash kernel's ms and
  share, the device idle share against the fastest wall.

Prints one line per turn, the card's name and power limit, and last a
JSON object of all turns.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCH, PROMPT, GEN, SEED = 8, 512, 64, 0
#: (BH, D) of the kernel alone, S = T 512: llama3.2-1b's and gemma-7b's prefill
KERNEL_SHAPES = ((256, 64), (128, 256))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="another flash_attention.cu with the same C interface")
    ap.add_argument("--arch", default="llama3.2-1b", help="the model whose prefill is timed")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_prefill_ab: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _cuda_ms

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.nvcc import NvccLibrary
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.lm import LM, RunFlags

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    libs = {"baseline": NvccLibrary(args.baseline.resolve(), "flashattn_baseline", fk._bind),
            "current": fk._LIB}
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib.load) for lib in libs.values()]:
            f.result()

    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    lm = LM(cfg)
    params = lm.init(prng.PRNGKey(SEED, dev), torch.bfloat16, dev)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(SEED)).to(dev)
    prefill = make_prefill_step(lm, PROMPT + GEN, RunFlags(remat="none", q_chunk=PROMPT,
                                                           attn_impl="cuda"))
    gq = torch.Generator(device=dev).manual_seed(SEED)
    qkv = {d: [torch.randn(bh, 512, d, device=dev, generator=gq).to(torch.bfloat16)
               for _ in range(3)] for bh, d in KERNEL_SHAPES}

    turns = []
    for name in ("baseline", "current", "current", "baseline"):
        fk._LIB = libs[name]
        with torch.no_grad():
            kernel_ms = {f"D{d}": _cuda_ms(torch, lambda: [flash_attention(*qkv[d], causal=True)
                                                           for _ in range(10)], True, 20) / 10
                         for _, d in KERNEL_SHAPES}
            prefill(params, {"tokens": tokens})  # warm
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prefill(params, {"tokens": tokens})
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                prefill(params, {"tokens": tokens})
                torch.cuda.synchronize()
        on_device = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in on_device) / 1e3
        flash_ms = sum(e.self_device_time_total for e in on_device if "flash_fwd" in e.key) / 1e3
        if device_ms <= 0 or flash_ms <= 0:
            raise RuntimeError("the profiler saw no device time of the prefill or its kernel")
        turn = {"build": name, "kernel_ms": kernel_ms, "prefill_wall_ms": walls,
                "prefill_tok_per_s": BATCH * PROMPT / (min(walls) / 1e3),
                "device_ms": device_ms, "flash_ms": flash_ms,
                "flash_share": flash_ms / device_ms, "idle_share": 1 - device_ms / min(walls)}
        turns.append(turn)
        print(f"{name}: kernel {kernel_ms} ms (CUDA graph); {cfg.name} prefill wall "
              f"{[round(w, 4) for w in walls]} ms = {turn['prefill_tok_per_s']:.1f} tok/s; "
              f"device {device_ms:.4f} ms, flash {flash_ms:.4f} ms "
              f"({turn['flash_share']:.4f}); idle share {turn['idle_share']:.4f}", flush=True)
    print(smi)
    print(json.dumps({"card": smi, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
