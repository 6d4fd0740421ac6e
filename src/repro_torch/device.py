"""Device selection for the port's entry points.

There is no silent CPU path: without an explicit device the port runs on
CUDA, and raises where CUDA is absent.  The CPU is used only when the caller
asks for it (``device="cpu"``), as the CPU parity tests do.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises ``RuntimeError`` when CUDA is absent);
    anything else is taken as given, with the same check for CUDA devices.
    ``meta`` (shapes and dtypes, no memory) is taken too, for the sharding
    rules' abstract trees."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA unless asked otherwise, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}: expected 'cuda', 'cpu' or 'meta'")
    return dev


def rank_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device of this rank of the default process group: the CPU when
    ``device`` asks for it, else ``cuda:LOCAL_RANK`` (the rank itself where
    the launcher set no ``LOCAL_RANK``).  Raises ``RuntimeError`` where
    CUDA is absent, or where the ranks on this host outnumber its visible
    GPUs: two ranks are never put on one card, and nothing falls back to
    the CPU."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    visible = torch.cuda.device_count()
    if local_world > visible or local_rank >= visible:
        raise RuntimeError(
            f"{local_world} ranks on this host but {visible} visible GPU(s): each rank needs "
            "a card of its own (pass device='cpu' to run the ranks on the CPU)")
    return torch.device("cuda", local_rank)


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU): call it
    before reading a clock around device work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
