"""Weights and caches carried between the JAX reference and the port.

:func:`params_from_numpy` turns the reference's parameters into the
port's: a nested dict of numpy arrays (``jax.tree.map(np.asarray,
params)``), or the flat ``/``-keyed mapping of a checkpoint npz
(``np.load(path)``, ``__meta__`` dtype sidecar included).  bfloat16 arrives
either as ``ml_dtypes.bfloat16`` arrays or as uint16 bit patterns named in
the sidecar.  :func:`cache_to_numpy` goes the other way for comparisons.
Both are generic over the tree: every family's leaves cross under the
reference's keys, the audio encoder's ``enc_blocks`` and ``enc_norm``, the
vlm's stacked ``self_*`` sub-layers, ``cross_attn`` and ``cross_gate``, and
a cache's ``cross`` keys and values included.
"""

from __future__ import annotations

import json
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import leaf_from_numpy
from repro_torch.device import resolve_device
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten


def params_from_numpy(tree_or_flat: Mapping[str, Any], device=None,
                      dtype: Optional[torch.dtype] = None):
    """Nested dict of tensors on ``device`` (None = CUDA; cast to ``dtype``
    where given and the leaf is floating point)."""
    device = resolve_device(device)
    keys = list(tree_or_flat.keys())
    if "__meta__" in keys or any("/" in k for k in keys):
        sidecar = {}
        if "__meta__" in keys:
            sidecar = json.loads(bytes(np.asarray(tree_or_flat["__meta__"])).decode())["dtypes"]
        flat = {k: leaf_from_numpy(tree_or_flat[k], sidecar.get(k))
                for k in keys if k != "__meta__"}
    else:
        flat = {k: leaf_from_numpy(v) for k, v in tree_leaves(dict(tree_or_flat))}

    def place(t: torch.Tensor) -> torch.Tensor:
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return tree_map(place, tree_unflatten(flat))


def cache_to_numpy(tree):
    """Nested dict of numpy arrays; bfloat16 leaves become float32 (exact)."""

    def conv(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(conv, tree)
