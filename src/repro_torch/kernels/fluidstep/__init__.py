"""Fused per-tick contention/rate core of the fluid simulator (port of
``repro.kernels.fluidstep``): a CUDA kernel for CUDA tensors, its plain
PyTorch version for CPU tensors."""

from repro_torch.kernels.fluidstep.ops import FLUID_KERNEL_IMPLS, fluid_step_core

__all__ = ["FLUID_KERNEL_IMPLS", "fluid_step_core"]
