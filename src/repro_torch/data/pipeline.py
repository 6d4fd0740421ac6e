"""Deterministic synthetic LM data with a prefetching device loader (port
of ``repro/data/pipeline.py``).

:class:`SyntheticLMDataset` is the reference's numpy code, unchanged: a
step maps to the same batch in both packages (Zipf-like unigram tokens and
the shifted labels).  :func:`make_train_iterator` replaces the reference's
``jax.device_put`` with a host thread that builds each batch ahead, pins
it and copies it to the device with ``non_blocking=True``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

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
        """tokens and labels (batch, seq_len) int32.  The port's families
        (``ssm``, ``dense``) take no modality embeddings."""
        rng = np.random.default_rng(np.uint64(self.seed * 1_000_003 + step))
        seq = rng.choice(
            self.cfg.vocab_size, size=(self.batch, self.seq_len + 1), p=self._probs
        ).astype(np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


class _Prefetcher:
    """Iterator over device batches from ``start_step`` on, built by a
    daemon thread up to ``prefetch`` ahead; :meth:`close` stops it."""

    def __init__(self, ds: SyntheticLMDataset, start_step: int, device: torch.device,
                 prefetch: int) -> None:
        self._ds, self._device = ds, device
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, args=(start_step,), daemon=True)
        self._thread.start()

    def _produce(self, step: int) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in self._ds.batch_at(step).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self._device.type == "cuda":
                t = t.pin_memory().to(self._device, non_blocking=True)
            out[k] = t
        return out

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
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


def make_train_iterator(ds: SyntheticLMDataset, start_step: int = 0, device=None,
                        prefetch: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Prefetching iterator of device batches, resumable via ``start_step``;
    ``device`` None = CUDA."""
    return _Prefetcher(ds, start_step, resolve_device(device), prefetch)
