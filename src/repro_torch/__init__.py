"""repro_torch: the PyTorch/CUDA port of the LUNA-CIM serving system.

A package of its own beside the JAX reference ``repro``: it imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.  The module
layout mirrors ``repro`` so each port module's counterpart can be found by
path (``repro_torch.core.quant`` <-> ``repro.core.quant``).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).  On the card the decode
projections of the frozen 4-bit LUT path, every projection under the
model-level LUNA / NF4 modes and mamba2's SSD prefill scan run on
hand-written Hopper kernels (:mod:`repro_torch.kernels.lut_gemm`,
:mod:`repro_torch.kernels.luna_mm`, :mod:`repro_torch.kernels.ssd_scan`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
