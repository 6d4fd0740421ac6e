"""Serving entry point: batched prefill + greedy decode with the KV or SSM
cache (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch {mamba2-130m,llama3.2-1b} [--reduced] \
        [--batch 4 --prompt-len 64 --gen 32] [--device cpu]

Runs on CUDA unless asked for the CPU.  The prompts are the reference's
draws for the same seed.  Without ``params`` the weights are initialised
from a ``torch.Generator`` seeded with ``seed`` (not JAX's threefry draws,
ROADMAP queue 1, item 3); pass the reference's weights (``models/
convert.py``) to serve the same model as ``repro.launch.serve``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models.common import tree_map
from repro_torch.models.lm import LM, RunFlags


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(
    cfg, batch: int = 4, prompt_len: int = 64, gen: int = 32, seed: int = 0,
    greedy: bool = True, params=None, device=None, dtype: torch.dtype = torch.bfloat16,
    ssd_impl: str = "", attn_impl: str = "",
):
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then decode
    ``gen`` tokens greedily.  Returns the reference's dict (``generated``
    (B, gen) int32 numpy, ``prefill_s``, ``decode_s``, ``decode_tok_per_s``,
    ``prefill_tok_per_s``) plus ``logits``, every step's logits
    (B, gen, vocab) on the device.  ``dtype`` is the weights' dtype when
    they are initialised here; ``ssd_impl`` and ``attn_impl`` as in
    ``RunFlags``."""
    if not greedy:
        raise NotImplementedError(
            "sampling (jax.random.categorical in the reference) waits for the "
            "threefry port (ROADMAP queue 1, item 3); serve with greedy=True"
        )
    dev = resolve_device(device)
    lm = LM(cfg)
    if params is None:
        params = lm.init(torch.Generator().manual_seed(seed), dtype, dev)
    else:
        params = tree_map(lambda t: t.to(dev), params)
    flags = RunFlags(remat="none", q_chunk=min(512, prompt_len), ssd_impl=ssd_impl,
                     attn_impl=attn_impl)

    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
                             dtype=torch.int32).to(dev)
    prefill = make_prefill_step(lm, max_seq=prompt_len + gen, flags=flags)
    decode = make_serve_step(lm, flags)

    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": tokens})
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        def sample(lg):
            return torch.argmax(lg, dim=-1)[:, None].to(torch.int32)

        tok = sample(logits)
        out_tokens, out_logits = [tok], [logits]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            logits, cache = decode(params, cache, tok)
            tok = sample(logits)
            out_tokens.append(tok)
            out_logits.append(logits)
        _sync(dev)
        t_decode = time.perf_counter() - t0

    return {
        "generated": torch.cat(out_tokens, dim=1).cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
        "prefill_tok_per_s": batch * prompt_len / max(t_prefill, 1e-9),
        "logits": torch.stack(out_logits, dim=1),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (plain PyTorch path)")
    args = ap.parse_args()
    cfg = get_config(args.arch, reduced=args.reduced)
    res = serve_batch(cfg, args.batch, args.prompt_len, args.gen, args.seed,
                      device=args.device)
    print(
        f"[serve] {cfg.name}: prefill {res['prefill_tok_per_s']:.0f} tok/s, "
        f"decode {res['decode_tok_per_s']:.1f} tok/s "
        f"(batch {args.batch}, {args.gen} new tokens)"
    )
    print(f"[serve] sample tokens: {res['generated'][0][:16].tolist()}")


if __name__ == "__main__":
    main()
