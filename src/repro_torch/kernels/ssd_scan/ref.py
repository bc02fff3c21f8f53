"""Sequential oracle for the SSD chunk scan (mirrors
``repro.kernels.ssd_scan.ref``): the naive token-by-token recurrence.
The chunked plain version the kernel repeats is
``repro_torch.models.ssm._ssd_chunked``."""
from __future__ import annotations

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor,
            initial_state: torch.Tensor | None = None,
            mask: torch.Tensor | None = None):
    """Sequential state-space recurrence, one token at a time.

    x: (BH, S, P); dt: (BH, S); a: (BH,); b/c: (BH, S, N).
    y_t = C_t^T S_t;  S_t = exp(dt_t a) S_{t-1} + dt_t B_t x_t^T.
    ``initial_state``: optional (BH, N, P) carried state (zeros when None);
    ``mask``: optional (BH, S) validity mask (invalid positions leave the
    state untouched: dt is zeroed there).
    Returns (y (BH,S,P), final_state (BH,N,P)), f32.
    """
    bh, s, p = x.shape
    n = b.shape[-1]
    x, dt, a, b, c = (t.float() for t in (x, dt, a, b, c))
    if mask is not None:
        dt = torch.where(mask, dt, torch.zeros((), device=dt.device))
    state = (torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)[:, None, None]
        state = (decay * state
                 + dt[:, t, None, None] * b[:, t, :, None] * x[:, t, None, :])
        ys.append(torch.einsum("zn,znp->zp", c[:, t], state))
    return torch.stack(ys, 1), state
