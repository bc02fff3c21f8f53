"""Feed-forward blocks: SwiGLU and GELU (mirrors ``repro.models.mlp``).

Every projection routes through ``core.layers.quant_matmul``, so a frozen
4-bit leaf (the engine's decode tree) runs the LUT GEMM.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.layers import quant_matmul
from repro_torch.models.common import set_leaf
from repro_torch.parallel import tensor_parallel as tp


def mlp_shapes(cfg, d_ff: int | None = None, mlp_type: str | None = None
               ) -> dict[str, tuple[int, int]]:
    """``d_ff``: the hidden width (default ``cfg.d_ff``; the moe family's
    leading dense blocks use ``cfg.moe.dense_ff``, the hybrid's shared
    block ``cfg.hybrid.shared_d_ff``); ``mlp_type``: default
    ``cfg.mlp_type``."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    shapes = {"w_up": (d, ff), "w_down": (ff, d)}
    if (mlp_type or cfg.mlp_type) == "swiglu":
        shapes["w_gate"] = (d, ff)
    return shapes


class MLP(nn.Module):
    """``mlp_type``: an override of ``cfg.mlp_type`` (JAX's ``mlp``
    keyword; the hybrid's shared block is SwiGLU).  ``split`` (set by
    ``tensor_parallel.plan``): the block computes its ``model`` shard of
    the hidden dimension, ``w_gate``/``w_up`` columns and ``w_down`` rows,
    between ``tensor_parallel.copy`` and ``reduce`` (Megatron's MLP)."""

    def __init__(self, cfg, params: dict, *, mlp_type: str | None = None):
        super().__init__()
        self.cfg = cfg
        self.mlp_type = mlp_type or cfg.mlp_type
        self.split = False
        for name in mlp_shapes(cfg, mlp_type=self.mlp_type):
            set_leaf(self, name, params[name])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if self.split:
            x = tp.copy(x)
        up = quant_matmul(x, self.w_up, cfg.quant, "mlp")
        if self.mlp_type == "swiglu":
            gate = quant_matmul(x, self.w_gate, cfg.quant, "mlp")
            h = F.silu(gate) * up
        else:
            h = F.gelu(up, approximate="tanh")
        out = quant_matmul(h, self.w_down, cfg.quant, "mlp", self.split)
        return tp.reduce(out) if self.split else out
