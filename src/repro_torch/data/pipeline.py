"""Deterministic synthetic LM data with a prefetching device loader (port
of ``repro/data/pipeline.py``).

:class:`SyntheticLMDataset` is the reference's numpy code, unchanged: a
step maps to the same batch in both packages (Zipf-like unigram tokens,
the shifted labels and the stub frontend's embeddings of the audio and
vlm families).  :func:`make_train_iterator` replaces the reference's
``jax.device_put`` with a host thread that builds each batch ahead, pins
it and copies it to the device with ``non_blocking=True``; under a mesh
each rank copies only its slice and receives DTensors.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class SyntheticLMDataset:
    """step -> batch pure function (Zipf-ish unigram tokens + shifted labels)."""

    cfg: ModelConfig
    batch: int
    seq_len: int
    seed: int = 0

    def __post_init__(self):
        v = self.cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._probs = p / p.sum()

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """tokens and labels (batch, seq_len) int32; for ``audio`` also
        ``audio_embeds`` (batch, audio_frames, d_model), for ``vlm``
        ``image_embeds`` (batch, vision_tokens, d_model), float32, drawn
        from the same generator right after the tokens."""
        cfg = self.cfg
        rng = np.random.default_rng(np.uint64(self.seed * 1_000_003 + step))
        seq = rng.choice(
            cfg.vocab_size, size=(self.batch, self.seq_len + 1), p=self._probs
        ).astype(np.int32)
        out = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        if cfg.family == "audio":
            # the reference casts these to numpy's bfloat16 where numpy has one;
            # it has none (hasattr(np, "bfloat16") is False), so they stay float32
            out["audio_embeds"] = rng.standard_normal(
                (self.batch, cfg.audio_frames, cfg.d_model), dtype=np.float32)
        if cfg.family == "vlm":
            out["image_embeds"] = rng.standard_normal(
                (self.batch, cfg.vision_tokens, cfg.d_model), dtype=np.float32)
        return out


class _Prefetcher:
    """Iterator over device batches from ``start_step`` on, built by a
    daemon thread up to ``prefetch`` ahead; :meth:`close` stops it.

    With ``shardings`` ({key: ``NamedSharding``} on a ``DeviceMesh``) every
    rank builds the same global batch from the seed, the thread cuts and
    copies this rank's slice of each key named there (numpy slicing, no
    communication: no collective is issued from the thread), and
    :meth:`__next__`, in the consuming thread, wraps each slice as a DTensor
    of the global shape (``DTensor.from_local``, unchecked)."""

    def __init__(self, ds: SyntheticLMDataset, start_step: int, device: torch.device,
                 prefetch: int, shardings: Optional[Dict[str, Any]] = None) -> None:
        self._ds, self._device = ds, device
        self._shardings = {k: (sh.mesh, sh.placements) for k, sh in (shardings or {}).items()}
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, args=(start_step,), daemon=True)
        self._thread.start()

    def _produce(self, step: int) -> Dict[str, Any]:
        from repro_torch.sharding.rules import local_shard

        out = {}
        for k, v in self._ds.batch_at(step).items():
            full = v.shape
            if k in self._shardings:
                v = local_shard(v, self._shardings[k][1], self._shardings[k][0])
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self._device.type == "cuda":
                t = t.pin_memory().to(self._device, non_blocking=True)
            out[k] = (t, full)
        return out

    def _wrap(self, item: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        from repro_torch.sharding.rules import wrap_local

        return {k: wrap_local(t, *self._shardings[k], full) if k in self._shardings else t
                for k, (t, full) in item.items()}

    def _work(self, step: int) -> None:
        while not self._stop.is_set():
            item = self._produce(step)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> "_Prefetcher":
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        return self._wrap(self._q.get())

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


def make_train_iterator(ds: SyntheticLMDataset, start_step: int = 0, device=None,
                        prefetch: int = 2, shardings: Optional[Dict[str, Any]] = None
                        ) -> Iterator[Dict[str, torch.Tensor]]:
    """Prefetching iterator of device batches, resumable via ``start_step``;
    ``device`` None = CUDA.  ``shardings`` ({key: ``NamedSharding``}, as the
    reference's): those keys come as DTensors of this rank's slices, the
    others as plain tensors."""
    return _Prefetcher(ds, start_step, resolve_device(device), prefetch, shardings)
