"""Serving entry point: batched prefill + greedy or sampled decode with the
KV or SSM cache (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch {mamba2-130m,llama3.2-1b,olmoe-1b-7b,llama-3.2-vision-11b,...} [--reduced] \
        [--batch 4 --prompt-len 64 --gen 32] [--device cpu]

Runs on CUDA unless asked for the CPU.  On the card each decode step is
replayed from a CUDA graph (:class:`_DecodeRunner`), the port's counterpart
of the reference's jitted step with its donated cache; on the CPU the same
steps run eagerly.  The prompts are the reference's draws for the same
seed, and without ``params`` the weights are the reference's too
(``LM.init(PRNGKey(seed))``, the threefry of ``repro_torch.prng``).  The
audio and vlm archs also take the stub frontend's output, drawn as the
reference draws it (:func:`stub_embeddings`).  With
``greedy=False`` each token is drawn by ``categorical`` from the logits over
``temperature``, the first from ``PRNGKey(seed)`` and each later one from a
split of it, as the reference draws; the draw runs outside the decode
step's graph and overwrites the graph's token buffer.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs import served_config
from repro_torch.device import resolve_device
from repro_torch.kernels.ssd.kernel import ssd_decode_step_cuda
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models.common import tree_map
from repro_torch.models.lm import LM, RunFlags


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stub_embeddings(cfg, rng: np.random.Generator, batch: int, dtype: torch.dtype,
                    device) -> Dict[str, torch.Tensor]:
    """The stub frontend's output that the audio and vlm families take with
    the prompt, drawn as the reference's ``serve_batch`` draws it: standard
    normals from ``rng`` (right after the prompt's tokens), (batch,
    audio_frames, d_model) ``audio_embeds`` or (batch, vision_tokens,
    d_model) ``image_embeds``, rounded to bf16, then cast to ``dtype``
    (the weights' dtype: where it is float32 the values stay the bf16
    ones, as the reference's einsums promote them).  {} for the other
    families."""
    if cfg.family not in ("audio", "vlm"):
        return {}
    name, length = (("audio_embeds", cfg.audio_frames) if cfg.family == "audio"
                    else ("image_embeds", cfg.vision_tokens))
    draw = rng.standard_normal((batch, length, cfg.d_model)).astype(np.float32)
    return {name: torch.from_numpy(draw).to(torch.bfloat16).to(device=device, dtype=dtype)}


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)


class _DecodeRunner:
    """Greedy decode steps over a cache the runner owns (the prefill's,
    donated): each step runs ``decode_fn`` on the static token buffer,
    which updates the cache in place, and writes the argmax back into the
    token buffer.

    With ``graph`` (CUDA only) the first step runs eagerly on a side stream
    (it builds and loads the kernel libraries, warms the allocator and
    cuBLAS, and is the real first step), then one step is captured as a
    CUDA graph and every later step replays it.  The graph reads its inputs
    by address: the weights, the cache and the token buffer live as long
    as the runner.  ``ssd_decode_step_cuda.launches`` advances at capture,
    not at replay, so the runner takes back the launches the capture added
    and adds them once per replay.  A capture or replay that fails raises.
    """

    def __init__(self, decode, params, cache, token: torch.Tensor, *,
                 graph: bool = False) -> None:
        if graph and token.device.type != "cuda":
            raise ValueError("a CUDA graph needs the decode on a CUDA device")
        self.decode, self.params, self.cache = decode, params, cache
        self.token = token.clone()  # (B, 1) int32, the graph's input and output
        self.use_graph = graph
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None  # the graph's logits
        self.launches_per_replay = 0
        #: seconds of the eager first step, of recording the captured step,
        #: and of ending the capture (graph instantiation)
        self.timing: Dict[str, float] = {}

    def _step(self) -> torch.Tensor:
        logits, _ = self.decode(self.params, self.cache, self.token)
        self.token.copy_(_greedy(logits))
        return logits

    def _capture(self) -> torch.Tensor:
        """The eager first step, then the capture; returns the first step's
        logits."""
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            first = self._step()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        before = ssd_decode_step_cuda.launches
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits = self._step()
            t2 = time.perf_counter()
        torch.cuda.synchronize()
        self.launches_per_replay = ssd_decode_step_cuda.launches - before
        ssd_decode_step_cuda.launches = before  # nothing ran at capture
        self.timing = {"warmup_s": t1 - t0, "capture_s": t2 - t1,
                       "instantiate_s": time.perf_counter() - t2}
        return first

    def step(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """One decode step from the token buffer: (logits (B, vocab), next
        token (B, 1) int32).  Both may be the runner's own buffers, which
        the next step overwrites: copy them to keep them."""
        if not self.use_graph:
            return self._step(), self.token
        if self.graph is None:
            return self._capture(), self.token
        self.graph.replay()
        ssd_decode_step_cuda.launches += self.launches_per_replay
        return self.logits, self.token

    def release(self) -> None:
        """Free the graph and its memory pool."""
        if self.graph is not None:
            self.graph.reset()
            self.graph, self.logits = None, None


def serve_batch(
    cfg, batch: int = 4, prompt_len: int = 64, gen: int = 32, seed: int = 0,
    greedy: bool = True, temperature: float = 1.0, params=None, device=None,
    dtype: torch.dtype = torch.bfloat16, ssd_impl: str = "", attn_impl: str = "",
    _graph: Optional[bool] = None,
):
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then decode
    ``gen`` tokens, greedily or (``greedy=False``) sampled at
    ``temperature``.  Returns the reference's dict (``generated``
    (B, gen) int32 numpy, ``prefill_s``, ``decode_s``, ``decode_tok_per_s``,
    ``prefill_tok_per_s``) plus ``logits``, every step's logits
    (B, gen, vocab) on the device, and ``capture_s``, the seconds of
    recording and instantiating the decode step's CUDA graph (inside
    ``decode_s``; 0 when there is none).  ``dtype`` is the weights' dtype
    when they are initialised here; ``ssd_impl`` and ``attn_impl`` as in
    ``RunFlags``.

    ``_graph`` is for the tests and chip_smoke.py: None (the default)
    replays each decode step from a CUDA graph on the card and runs it
    eagerly on the CPU; False runs it eagerly on the card too; True on the
    CPU raises."""
    dev = resolve_device(device)
    graph = dev.type == "cuda" if _graph is None else bool(_graph)
    if graph and dev.type != "cuda":
        raise ValueError("_graph=True needs a CUDA device: the CPU decodes eagerly")
    lm = LM(cfg)
    key = prng.PRNGKey(seed, dev)
    if params is None:
        params = lm.init(key, dtype, dev)
    else:
        params = tree_map(lambda t: t.to(dev), params)
    flags = RunFlags(remat="none", q_chunk=min(512, prompt_len), ssd_impl=ssd_impl,
                     attn_impl=attn_impl)

    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
                             dtype=torch.int32).to(dev)
    inputs = {"tokens": tokens,
              **stub_embeddings(cfg, rng, batch, params["embed"].dtype, dev)}
    prefill = make_prefill_step(lm, max_seq=prompt_len + gen, flags=flags)
    decode = make_serve_step(lm, flags)

    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, inputs)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        def sample(lg, k):
            if greedy:
                return _greedy(lg)
            # a tensor divisor in the logits' dtype: the reference divides by
            # its weakly typed scalar in that dtype, and a Python divisor would
            # be a multiply by the reciprocal on the card
            temp = torch.tensor(temperature, dtype=lg.dtype, device=lg.device)
            return prng.categorical(k, lg / temp)[:, None]

        tok = sample(logits, key)
        out_tokens, out_logits = [tok], [logits]
        t0 = time.perf_counter()
        runner = _DecodeRunner(decode, params, cache, tok, graph=graph)
        for _ in range(gen - 1):
            if not greedy:
                key, sub = prng.split(key)
            logits, tok = runner.step()
            if not greedy:  # replaces the step's greedy token
                tok = sample(logits, sub)
                runner.token.copy_(tok)
            out_tokens.append(tok.clone())
            out_logits.append(logits.clone())
        _sync(dev)
        t_decode = time.perf_counter() - t0
        runner.release()

    return {
        "generated": torch.cat(out_tokens, dim=1).cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
        "prefill_tok_per_s": batch * prompt_len / max(t_prefill, 1e-9),
        "logits": torch.stack(out_logits, dim=1),
        "capture_s": runner.timing.get("capture_s", 0.0) + runner.timing.get("instantiate_s", 0.0),
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
    cfg = served_config(args.arch, reduced=args.reduced)
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
