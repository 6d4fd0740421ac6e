"""Mamba-2 SSD decode step (port of ``repro.kernels.ssd``): a CUDA kernel
for CUDA tensors, its plain PyTorch version for CPU tensors."""

from repro_torch.kernels.ssd.ops import SSD_IMPLS, ssd_decode_step

__all__ = ["SSD_IMPLS", "ssd_decode_step"]
