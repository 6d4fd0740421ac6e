"""PyTorch/CUDA port of the fluid scheduling simulator (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its module
paths for the slices that have been ported so far:

* the fluid simulator's main path (``scenarios.sweep`` -> ``core.fluidsim``
  -> ``kernels.fluidstep``) for monolithic traces, threshold gating
  policies (ada, srsfN) and the deterministic gang placements;
* serving the ``ssm`` family, mamba2-130m (``launch.serve`` ->
  ``launch.steps`` -> ``models.lm`` -> ``models.ssm`` -> ``kernels.ssd``),
  with the flat-key checkpoint store (``checkpoint``);
* serving the ``dense`` family, llama3.2-1b (``launch.serve`` ->
  ``models.lm`` -> ``models.attention`` -> ``kernels.flash_attention``
  for the prefill attention, ``models.ffn`` for the MLP);
* training both families (``launch.train`` -> ``launch.steps`` ->
  ``optim.adamw``), with weights from the threefry (``prng``);
* the exact event engine on the host, with every option of the
  reference's (``scenarios.sweep.run_scenario_event`` -> ``core.simulator``
  -> ``core.engine`` -> ``core.schedpolicy``, ``core.placement``,
  ``core.adadual``, ``core.clusterindex``, ``core.chaos``), its
  observability recorder (``obs``) and the sweep runner
  (``scenarios.sweep.sweep``), and ``launch.multi_job``, which profiles
  real training jobs on the device and schedules them with it.

It imports nothing of ``repro`` or JAX: the plain-Python pieces it needs
are trimmed copies, held against the originals by the
``tests/test_torch_*.py`` files.

Entry points run on CUDA unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
