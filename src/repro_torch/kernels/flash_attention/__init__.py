"""Flash attention (port of ``repro.kernels.flash_attention``): a CUDA
kernel for CUDA tensors, its plain PyTorch version for CPU tensors."""

from repro_torch.kernels.flash_attention.ops import (
    FLASH_IMPLS, flash_attention, flash_attention_train,
)

__all__ = ["FLASH_IMPLS", "flash_attention", "flash_attention_train"]
