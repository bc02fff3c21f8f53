"""Model-facing wrapper of the SSD chunk scan (mirrors
``repro.kernels.ssd_scan.ops``).

JAX's ``ssd_chunked_kernel`` flattens (B, S, H, P) into head-streams and
repeats B and C once per head before its Pallas kernel.  The Hopper
kernel takes the (B, S, H, P) layout as it is and reads each head's group
of B and C in place, so this wrapper only makes the operands contiguous
f32 and calls :func:`~repro_torch.kernels.ssd_scan.ssd_scan.ssd_scan`
(the kernel on CUDA tensors, ``models.ssm._ssd_chunked`` on CPU tensors).

Under autograd (grad enabled and an operand that requires grad) the call
goes through :class:`SSDScanFn`: forward ``ssd_scan``, backward
``ssd_scan_bwd`` (on the card the kernels ``ssd_scan_tc.cu`` and
``ssd_scan_bwd.cu``, the latter redesigned for the TF32 tensor cores; on
the CPU ``_ssd_chunked`` and ``ref.ssd_scan_bwd_ref``).  JAX
differentiates its jnp scan with ``jax.grad``; the port's gradient is the
same vector-Jacobian product.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan, ssd_scan_bwd


class SSDScanFn(torch.autograd.Function):
    """``ssd_scan`` with ``ssd_scan_bwd`` as its backward.  The forward's
    workspace (C·Bᵀ and the chunk states, CUDA only) is saved for the
    backward, so a remat recompute saves it anew and nothing else is
    recomputed.  ``mask`` and ``chunk`` take no gradient."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, initial_state, mask, chunk):
        y, final, ws = ssd_scan(x, dt, a, b, c, chunk=chunk,
                                initial_state=initial_state, mask=mask,
                                keep_workspace=True)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, a, b, c, initial_state, mask, ws)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, a, b, c, initial_state, mask, ws = ctx.saved_tensors
        dx, ddt, da, db, dc, d_init = ssd_scan_bwd(
            x, dt, a, b, c, dy.contiguous(), dfinal.contiguous(),
            chunk=ctx.chunk, initial_state=initial_state, mask=mask,
            workspace=ws)
        return dx, ddt, da, db, dc, d_init, None, None


def ssd_chunked_kernel(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128,
                       initial_state: torch.Tensor | None = None,
                       mask: torch.Tensor | None = None):
    """x: (B,S,H,P); dt: (B,S,H); a: (H,); b/c: (B,S,G,N) with G | H.

    ``initial_state``: optional (B,H,P,N) carried state to continue from;
    ``mask``: optional (B,S) validity mask (pad columns are inert).
    Returns (y (B,S,H,P) f32, final_state (B,H,P,N) f32), the values of
    ``repro_torch.models.ssm._ssd_chunked``; differentiable through
    :class:`SSDScanFn`.
    """
    def f32(t):
        return None if t is None else t.float().contiguous()

    ops = [f32(t) for t in (x, dt, a, b, c, initial_state)]
    mask = None if mask is None else mask.bool().contiguous()
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ops):
        return SSDScanFn.apply(*ops, mask, chunk)
    x, dt, a, b, c, initial_state = ops
    return ssd_scan(x, dt, a, b, c, chunk=chunk,
                    initial_state=initial_state, mask=mask)
