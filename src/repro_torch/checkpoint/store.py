"""Checkpointing: flat-key npz store with atomic writes and step indexing
(port of ``repro/checkpoint/store.py``).

The file format is the reference's, so checkpoints cross between the two
packages: one npz per step (``step_%08d.npz``), one entry per leaf under
its ``/``-joined key path (dict keys in sorted order), and a ``__meta__``
entry holding ``{"step", "dtypes", "extra"}`` as JSON bytes.  bfloat16
leaves are stored as uint16 views with ``"bfloat16"`` in the dtype
sidecar, since npz has no native bf16.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_unflatten


def leaf_to_numpy(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """(array as stored, dtype sidecar entry): bfloat16 becomes its uint16
    bit pattern and ``"bfloat16"``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    return np.asarray(leaf), None


def leaf_from_numpy(arr: np.ndarray, sidecar: Optional[str] = None) -> torch.Tensor:
    """Inverse of :func:`leaf_to_numpy`; also takes ``ml_dtypes.bfloat16``
    arrays (what the reference's arrays turn into under ``np.asarray``)."""
    arr = np.asarray(arr)
    if sidecar == "bfloat16" or arr.dtype.name == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf must be 2 bytes wide, got {arr.dtype}")
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for k, leaf in tree_leaves(tree):
        arr, sidecar = leaf_to_numpy(leaf)
        if sidecar:
            dtypes[k] = sidecar
        arrays[k] = arr
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    meta = {"step": step, "dtypes": dtypes, "extra": extra or {}}
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrays)
        os.replace(tmp, path)  # atomic publish
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(f[len("step_") : -len(".npz")])
        for f in os.listdir(ckpt_dir)
        if f.startswith("step_") and f.endswith(".npz")
    ]
    return max(steps) if steps else None


def restore(ckpt_dir: str, target_tree, step: Optional[int] = None) -> Tuple[Any, int, dict]:
    """Restore into the structure of ``target_tree`` (shapes must match;
    each leaf lands on its target's device with the stored dtype).
    Returns (tree, step, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    restored = {}
    with np.load(os.path.join(ckpt_dir, f"step_{step:08d}.npz")) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        for k, ref in tree_leaves(target_tree):
            t = leaf_from_numpy(data[k], meta["dtypes"].get(k))
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch for {k}: {tuple(t.shape)} vs {tuple(ref.shape)}")
            if isinstance(ref, torch.Tensor):
                t = t.to(ref.device)
            restored[k] = t
    return tree_unflatten(restored), meta["step"], meta["extra"]
