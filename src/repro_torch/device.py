"""Device selection for the port's entry points.

There is no silent CPU path: without an explicit device the port runs on
CUDA, and raises where CUDA is absent.  The CPU is used only when the caller
asks for it (``device="cpu"``), as the CPU parity tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises ``RuntimeError`` when CUDA is absent);
    anything else is taken as given, with the same check for CUDA devices."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA unless asked otherwise, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: expected 'cuda' or 'cpu'")
    return dev
