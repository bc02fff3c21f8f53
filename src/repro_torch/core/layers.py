"""``quant_matmul``: the one matmul every projection routes through
(mirrors ``repro.core.layers``).

Two cases are ported: a frozen :class:`QuantizedWeight` goes to the LUT
GEMM dispatch (``kernels.lut_gemm.ops.quantized_matmul``), and everything
else is a plain ``x @ w``.  The model-level dynamic quant modes (int8,
int4_dequant, lut_nf4, luna_*) are ROADMAP queue 1 item 8.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.quant import QuantizedWeight


@dataclass(frozen=True)
class QuantConfig:
    """Model-level quantization; only ``mode="bf16"`` (none) is ported."""
    mode: str = "bf16"

    def __post_init__(self):
        if self.mode != "bf16":
            raise NotImplementedError(
                f"model-level quant mode {self.mode!r} is not ported yet: "
                "ROADMAP queue 1 item 8")


def quant_matmul(x: torch.Tensor, w, cfg: QuantConfig | None = None,
                 group: str = "mlp") -> torch.Tensor:
    """``x @ w``; ``w`` may be a frozen :class:`QuantizedWeight` (the
    engine's 4-bit decode tree), evaluated by the LUT GEMM its ``kernel``
    tag selects.  Output dtype follows ``x``."""
    del cfg, group    # bf16 only: nothing to select on yet
    if isinstance(w, QuantizedWeight):
        from repro_torch.kernels.lut_gemm import ops as lut_ops
        return lut_ops.quantized_matmul(x, w)
    return x @ w
