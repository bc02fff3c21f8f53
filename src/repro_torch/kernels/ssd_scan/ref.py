"""Sequential oracle for the SSD chunk scan (mirrors
``repro.kernels.ssd_scan.ref``): the naive token-by-token recurrence.
The chunked plain version the kernel repeats is
``repro_torch.models.ssm._ssd_chunked``.

:func:`ssd_scan_bwd_ref` is the plain version of the scan's backward (its
vector-Jacobian product, the kernel ``csrc/ssd_scan_bwd.cu`` computes):
the chunked formulas in f32, pass by pass as the kernel takes them.

:func:`ssd_scan_tc_emulate` is the Hopper kernels' arithmetic
(``csrc/ssd_scan_tc.cu``) on any device: its four passes, every product
split 3xTF32 (:func:`tf32_split`), with switches for the faults its tests
must catch.
"""
from __future__ import annotations

import torch

#: the kernels against :func:`ssd_scan_tc_emulate` on the card, as a share
#: of the output's scale (``ssd_scan.scaled_err``): both take the same
#: 3xTF32 products and differ in the order of their sums and in exp (the
#: kernels' ``__expf`` in L); 3.2e-6 at mamba2's widths, S = 448, on an
#: H100, against ``KERNEL_TOL`` = 1e-4
EMULATE_TOL = 1e-5


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


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 explicit mantissa bits), ties away
    from zero: ``cvt.rna.tf32.f32``, by bit operations on finite f32."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (tf32(t), tf32(t - hi)): t = hi + lo within 2^-22 |t|."""
    hi = tf32_round(t)
    return hi, tf32_round(t.float() - hi)


def _mm3(a: torch.Tensor, b: torch.Tensor, lo_terms: bool,
         acc: torch.Tensor | None = None) -> torch.Tensor:
    """``acc + a @ b`` as the kernels take it: a_lo b_hi, a_hi b_lo, a_hi
    b_hi into one f32 accumulator (lo·lo dropped); ``lo_terms=False``: one
    TF32 product, a_hi b_hi."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    out = torch.zeros((), device=a.device) if acc is None else acc
    if lo_terms:
        out = out + al @ bh
        out = out + ah @ bl
    return out + ah @ bh


def ssd_scan_tc_emulate(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, c: torch.Tensor, *, chunk: int,
                        initial_state: torch.Tensor | None = None,
                        mask: torch.Tensor | None = None,
                        lo_terms: bool = True,
                        skip_decay_chunk: int | None = None,
                        diagonal: bool = True):
    """``csrc/ssd_scan_tc.cu``'s arithmetic, pass by pass.

    x: (B,S,H,P); dt: (B,S,H); a: (H,); b/c: (B,S,G,N) with G | H;
    ``initial_state`` (B,H,P,N), ``mask`` (B,S) as in
    :func:`~repro_torch.kernels.ssd_scan.ssd_scan.ssd_scan`.  The passes:

    1. ``ssd_cb``: CB = C·Bᵀ per (b, group, chunk);
    2. ``ssd_chunk_state``: masked dt, da = cumsum(dt·a) per chunk,
       seg_end = exp(da[-1] - da), Sloc = ((x·dt)ᵀ (seg_end ⊙ B)) (P x N)
       and the chunk decay exp(da[-1]);
    3. ``ssd_state_pass``: S_enter[c] = S; S = decay_c·S + Sloc_c, from the
       initial state (or zero); S at the end is the final state;
    4. ``ssd_chunk_out``: y = (C·S_enterᵀ)·exp(da) + (CB ⊙ L)(x·dt), L =
       exp(da_i - da_j) for j <= i, masked before exp.

    Every product is split 3xTF32 (:func:`_mm3`); positions past S are
    zeros, as the kernels' zero-filled tiles.  Faults: ``lo_terms=False``
    takes one TF32 product (lo terms dropped); ``skip_decay_chunk=k`` lets
    the state pass skip chunk k's decay; ``diagonal=False`` drops the
    diagonal from the causal mask.  Returns (y (B,S,H,P), final (B,H,P,N)).
    """
    bb, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hg = h // g
    x, dt, a, b, c = (t.float() for t in (x, dt, a, b, c))
    if mask is not None:
        dt = torch.where(mask[..., None], dt, torch.zeros((), device=dt.device))
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, 0, 0, pad))
    # (B, nc, group or head, Q, ·) streams
    xq = x.reshape(bb, nc, chunk, h, p).permute(0, 1, 3, 2, 4)
    dtq = dt.reshape(bb, nc, chunk, h).permute(0, 1, 3, 2)
    bq = b.reshape(bb, nc, chunk, g, n).permute(0, 1, 3, 2, 4)
    cq = c.reshape(bb, nc, chunk, g, n).permute(0, 1, 3, 2, 4)

    cb = _mm3(cq, bq.transpose(-1, -2), lo_terms)             # 1: (B,nc,G,Q,Q)

    da = torch.cumsum(dtq * a[None, None, :, None], dim=-1)  # 2: (B,nc,H,Q)
    da_last = da[..., -1:]
    seg_end = torch.exp(da_last - da)
    xdt = xq * dtq[..., None]                                 # (B,nc,H,Q,P)
    bh = bq.repeat_interleave(hg, dim=2)                      # (B,nc,H,Q,N)
    sloc = _mm3(xdt.transpose(-1, -2), seg_end[..., None] * bh,
                lo_terms)                                     # (B,nc,H,P,N)
    decay = torch.exp(da_last[..., 0])                        # (B,nc,H)

    state = (torch.zeros((bb, h, p, n), device=x.device)      # 3
             if initial_state is None else initial_state.float())
    enter = []
    for ci in range(nc):
        enter.append(state)
        d = (torch.ones((), device=x.device) if ci == skip_decay_chunk
             else decay[:, ci, :, None, None])
        state = d * state + sloc[:, ci]

    ch = cq.repeat_interleave(hg, dim=2)                      # 4: (B,nc,H,Q,N)
    s_enter = torch.stack(enter, 1)                           # (B,nc,H,P,N)
    inter = _mm3(ch, s_enter.transpose(-1, -2), lo_terms) \
        * torch.exp(da)[..., None]                            # (B,nc,H,Q,P)
    rows = torch.arange(chunk, device=x.device)
    causal = (rows[:, None] >= rows[None, :]) if diagonal \
        else (rows[:, None] > rows[None, :])
    rel = da[..., :, None] - da[..., None, :]                 # (B,nc,H,Q,Q)
    L = torch.exp(torch.where(causal, rel,
                              torch.full((), -torch.inf, device=x.device)))
    cbh = cb.repeat_interleave(hg, dim=2)
    y = _mm3(cbh * L, xdt, lo_terms, acc=inter)               # (B,nc,H,Q,P)
    y = y.permute(0, 1, 3, 2, 4).reshape(bb, nc * chunk, h, p)[:, :s]
    return y, state


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                     dfinal: torch.Tensor | None = None, *, chunk: int,
                     initial_state: torch.Tensor | None = None,
                     mask: torch.Tensor | None = None):
    """The vector-Jacobian product of ``_ssd_chunked(x, dt, a, b, c, chunk,
    initial_state, mask)`` for the output gradients ``dy`` (B,S,H,P) and
    ``dfinal`` (B,H,P,N) (zeros when None); f32.

    Per (row, head), with dt zeroed at masked positions, cum = the
    chunk-restarted cumsum of dt·a, xdt = x·dt, L[q,k] = exp(cum_q - cum_k)
    (q >= k), CB = C·Bᵀ, seg_end = exp(cum_last - cum), the state S_c
    entering chunk c and Gx_c = dL/d(state leaving chunk c):

    1. Ploc_c = Σ_q exp(cum_q) dy_q ⊗ C_q, each chunk alone;
    2. Gx_last = dfinal; Gx_{c-1} = exp(cum_last,c) Gx_c + Ploc_c, in
       reverse; d initial_state = exp(cum_last,0) Gx_0 + Ploc_0;
    3. per chunk, with D = (dy·xdtᵀ) ⊙ L and W = D ⊙ CB:
       dxdt = (CB ⊙ L)ᵀ dy + seg_end ⊙ (B Gxᵀ),
       dB_h = Dᵀ C + seg_end ⊙ (xdt Gx),
       dC_h = D B + exp(cum) ⊙ (dy S),
       d cum_q = Σ_k W_qk - Σ_k W_kq + C_q·dC_inter,q - xdt_q·dxdt_inter,q,
       and the chunk's last position also takes exp(cum_last)⟨Gx, S⟩ +
       Σ_k xdt_k·dxdt_inter,k (the state's decay and seg_end);
    4. d(dt·a) = the reverse cumsum of d cum within each chunk; ddt = a
       d(dt·a) + ⟨x, dxdt⟩ (0 where masked), dx = dt dxdt, da = Σ dt
       d(dt·a); dB and dC summed over the heads of each group.

    Returns (dx, ddt, da, db, dc, d_initial_state); the last is None when
    ``initial_state`` is None.
    """
    bb, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hg = h // g
    x, dt, a, b, c, dy = (t.float() for t in (x, dt, a, b, c, dy))
    if mask is not None:
        dt = torch.where(mask[..., None], dt, torch.zeros((), device=dt.device))
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x, dy = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                 for t in (x, dy))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b, c = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                for t in (b, c))
    # (B, nc, H, Q, ·) streams; B and C repeated over their group's heads
    xq = x.reshape(bb, nc, chunk, h, p).permute(0, 1, 3, 2, 4)
    dyq = dy.reshape(bb, nc, chunk, h, p).permute(0, 1, 3, 2, 4)
    dtq = dt.reshape(bb, nc, chunk, h).permute(0, 1, 3, 2)
    bq = (b.reshape(bb, nc, chunk, g, n).permute(0, 1, 3, 2, 4)
          .repeat_interleave(hg, dim=2))
    cq = (c.reshape(bb, nc, chunk, g, n).permute(0, 1, 3, 2, 4)
          .repeat_interleave(hg, dim=2))
    cum = torch.cumsum(dtq * a[None, None, :, None], dim=-1)  # (B,nc,H,Q)
    decay = torch.exp(cum[..., -1])                           # (B,nc,H)
    seg_end = torch.exp(cum[..., -1:] - cum)
    xdt = xq * dtq[..., None]
    # the states entering each chunk (the forward's state pass)
    sloc = (xdt * seg_end[..., None]).transpose(-1, -2) @ bq  # (B,nc,H,P,N)
    state = (torch.zeros((bb, h, p, n), device=x.device)
             if initial_state is None else initial_state.float())
    enter = []
    for ci in range(nc):
        enter.append(state)
        state = decay[:, ci, :, None, None] * state + sloc[:, ci]
    s_in = torch.stack(enter, 1)                              # (B,nc,H,P,N)
    # 1: each chunk's own adjoint; 2: carried in reverse
    ploc = (dyq * torch.exp(cum)[..., None]).transpose(-1, -2) @ cq
    g_state = (torch.zeros((bb, h, p, n), device=x.device)
               if dfinal is None else dfinal.float())
    exits = [None] * nc
    for ci in reversed(range(nc)):
        exits[ci] = g_state
        g_state = decay[:, ci, :, None, None] * g_state + ploc[:, ci]
    gx = torch.stack(exits, 1)                                # (B,nc,H,P,N)
    d_init = g_state if initial_state is not None else None
    # 3: within each chunk
    rows = torch.arange(chunk, device=x.device)
    causal = rows[:, None] >= rows[None, :]
    L = torch.exp(torch.where(causal, cum[..., :, None] - cum[..., None, :],
                              torch.full((), -torch.inf, device=x.device)))
    cb = cq @ bq.transpose(-1, -2)                            # (B,nc,H,Q,Q)
    D = (dyq @ xdt.transpose(-1, -2)) * L
    W = D * cb
    dxdt_inter = seg_end[..., None] * (bq @ gx.transpose(-1, -2))
    dxdt = (cb * L).transpose(-1, -2) @ dyq + dxdt_inter
    db_h = D.transpose(-1, -2) @ cq + seg_end[..., None] * (xdt @ gx)
    dc_inter = torch.exp(cum)[..., None] * (dyq @ s_in)
    dc_h = D @ bq + dc_inter
    t_k = (xdt * dxdt_inter).sum(-1)
    dcum = (W.sum(-1) - W.sum(-2) + (cq * dc_inter).sum(-1) - t_k)
    last = decay * (gx * s_in).sum((-1, -2)) + t_k.sum(-1)
    dcum = torch.cat([dcum[..., :-1], dcum[..., -1:] + last[..., None]], -1)
    # 4: the reverse cumsum, dt, x, a, and the group sums
    dda = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = a[None, None, :, None] * dda + (xq * dxdt).sum(-1)
    dx = dxdt * dtq[..., None]
    da = (dtq * dda).sum((0, 1, 3))

    def unchunk(t):                     # (B,nc,H,Q,·) -> (B,S,H,·)
        t = t.permute(0, 1, 3, 2, *range(4, t.ndim))
        return t.reshape(bb, nc * chunk, *t.shape[3:])[:, :s]
    ddt = unchunk(ddt)
    if mask is not None:
        ddt = torch.where(mask[..., None], ddt, torch.zeros((), device=x.device))
    db = unchunk(db_h).reshape(bb, s, g, hg, n).sum(3)
    dc = unchunk(dc_h).reshape(bb, s, g, hg, n).sum(3)
    return unchunk(dx), ddt, da, db, dc, d_init
