"""Model-facing wrapper of the SSD chunk scan (mirrors
``repro.kernels.ssd_scan.ops``).

JAX's ``ssd_chunked_kernel`` flattens (B, S, H, P) into head-streams and
repeats B and C once per head before its Pallas kernel.  The Hopper
kernel takes the (B, S, H, P) layout as it is and reads each head's group
of B and C in place, so this wrapper only makes the operands contiguous
f32 and calls :func:`~repro_torch.kernels.ssd_scan.ssd_scan.ssd_scan`
(the kernel on CUDA tensors, ``models.ssm._ssd_chunked`` on CPU tensors).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan


def ssd_chunked_kernel(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128,
                       initial_state: torch.Tensor | None = None,
                       mask: torch.Tensor | None = None):
    """x: (B,S,H,P); dt: (B,S,H); a: (H,); b/c: (B,S,G,N) with G | H.

    ``initial_state``: optional (B,H,P,N) carried state to continue from;
    ``mask``: optional (B,S) validity mask (pad columns are inert).
    Returns (y (B,S,H,P) f32, final_state (B,H,P,N) f32), the values of
    ``repro_torch.models.ssm._ssd_chunked``.
    """
    def f32(t):
        return None if t is None else t.float().contiguous()

    return ssd_scan(f32(x), f32(dt), f32(a), f32(b), f32(c), chunk=chunk,
                    initial_state=f32(initial_state),
                    mask=None if mask is None else mask.bool().contiguous())
