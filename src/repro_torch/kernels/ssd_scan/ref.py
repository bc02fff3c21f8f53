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
must catch.  :func:`ssd_scan_bwd_tc_emulate` is the same for the
backward's kernels (``csrc/ssd_scan_bwd.cu``).
"""
from __future__ import annotations

from types import SimpleNamespace

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
    2. ``ssd_chunk_state``: masked dt, da = cumsum(dt·a) per chunk (in the
       kernels' scan order, :func:`_kernel_cumsum`),
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
    f = _tc_forward(x, dt, a, b, c, chunk, initial_state, mask, lo_terms,
                    skip_decay_chunk)
    inter = _mm3(f.ch, f.s_in.transpose(-1, -2), lo_terms) \
        * torch.exp(f.cum)[..., None]                         # 4: (B,nc,H,Q,P)
    rows = torch.arange(chunk, device=x.device)
    causal = (rows[:, None] >= rows[None, :]) if diagonal \
        else (rows[:, None] > rows[None, :])
    rel = f.cum[..., :, None] - f.cum[..., None, :]           # (B,nc,H,Q,Q)
    L = torch.exp(torch.where(causal, rel,
                              torch.full((), -torch.inf, device=x.device)))
    cbh = f.cb.repeat_interleave(h // b.shape[2], dim=2)
    y = _mm3(cbh * L, f.xdt, lo_terms, acc=inter)             # (B,nc,H,Q,P)
    y = y.permute(0, 1, 3, 2, 4).reshape(bb, -1, h, p)[:, :s]
    return y, f.final


def _streams(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B,S,K[,D]) -> (B,nc,K,Q[,D]) chunk streams, S right-padded with
    zeros to the chunk grid (the kernels' zero-filled tiles)."""
    s = t.shape[1]
    nc = -(-s // chunk)
    t = torch.nn.functional.pad(t, [0, 0] * (t.ndim - 2) + [0, nc * chunk - s])
    t = t.reshape(t.shape[0], nc, chunk, *t.shape[2:])
    return t.permute(0, 1, 3, 2, *range(4, t.ndim))


def _tc_forward(x, dt, a, b, c, chunk, initial_state, mask, lo_terms,
                skip_decay_chunk=None) -> SimpleNamespace:
    """Passes 1–3 of ``csrc/ssd_scan_tc.cu`` (C·Bᵀ, the chunk-local states
    and the state pass, cum in the kernels' scan order), as
    :func:`ssd_scan_tc_emulate` takes them and the backward reads them from
    the forward's workspace: the chunk streams (xq, dtq, bq, cq and the
    heads' bh, ch), cb, cum, seg_end, xdt, decay, the states entering each
    chunk (s_in, (B,nc,H,P,N)) and the final state."""
    x, dt, a, b, c = (t.float() for t in (x, dt, a, b, c))
    if mask is not None:
        dt = torch.where(mask[..., None], dt, torch.zeros((), device=dt.device))
    f = SimpleNamespace()
    f.xq, f.dtq, f.bq, f.cq = (_streams(t, chunk) for t in (x, dt, b, c))
    hg = x.shape[2] // b.shape[2]
    f.bh, f.ch = (t.repeat_interleave(hg, dim=2) for t in (f.bq, f.cq))
    f.cb = _mm3(f.cq, f.bq.transpose(-1, -2), lo_terms)       # 1: (B,nc,G,Q,Q)
    f.cum = _kernel_cumsum(f.dtq * a[None, None, :, None])    # 2: (B,nc,H,Q)
    f.seg_end = torch.exp(f.cum[..., -1:] - f.cum)
    f.xdt = f.xq * f.dtq[..., None]                           # (B,nc,H,Q,P)
    sloc = _mm3(f.xdt.transpose(-1, -2), f.seg_end[..., None] * f.bh,
                lo_terms)                                     # (B,nc,H,P,N)
    f.decay = torch.exp(f.cum[..., -1])                       # (B,nc,H)
    state = (torch.zeros_like(sloc[:, 0]) if initial_state is None  # 3
             else initial_state.float())
    enter = []
    for ci in range(sloc.shape[1]):
        enter.append(state)
        d = (torch.ones((), device=x.device) if ci == skip_decay_chunk
             else f.decay[:, ci, :, None, None])
        state = d * state + sloc[:, ci]
    f.s_in, f.final = torch.stack(enter, 1), state
    return f


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


#: heads of a group whose D blocks ``ssd_bwd_dd`` sums in one block
#: (mirrors RUN in csrc/ssd_scan_bwd.cu)
RUN_HEADS = 16
#: positions the kernels' block scans run over (QMAX in the sources)
_QMAX = 256


def _lane_shift(t: torch.Tensor, off: int, up: bool) -> torch.Tensor:
    """``__shfl_up_sync`` (up) or ``__shfl_down_sync`` by ``off`` over the
    last dim (32 lanes), lanes with no source taking 0: adding that 0 is
    what the kernels' ``if (lane >= off)`` leaves out, bitwise."""
    z = torch.zeros_like(t[..., :off])
    return (torch.cat([z, t[..., :-off]], -1) if up
            else torch.cat([t[..., off:], z], -1))


def _kernel_cumsum(v: torch.Tensor) -> torch.Tensor:
    """The inclusive cumsum over the last dim (at most ``_QMAX``) in the
    kernels' order (``chunk_cumsum``: two entries a thread, a warp scan
    over the pair sums, the warp totals added in order), bitwise."""
    q = v.shape[-1]
    v = torch.nn.functional.pad(v, (0, _QMAX - q)).reshape(
        *v.shape[:-1], 4, 32, 2)
    v0, v1 = v[..., 0], v[..., 1]
    tot = v0 + v1
    incl = tot
    for off in (1, 2, 4, 8, 16):
        incl = incl + _lane_shift(incl, off, up=True)
    excl = _lane_shift(incl, 1, up=True)
    wsum = incl[..., 31]
    base = [torch.zeros_like(wsum[..., 0])]
    for w in range(1, 4):
        base.append(base[-1] + wsum[..., w - 1])
    base = torch.stack(base, -1)[..., None] + excl
    out = torch.stack([base + v0, base + tot], -1)
    return out.reshape(*out.shape[:-3], _QMAX)[..., :q]


def _kernel_rev_cumsum(v: torch.Tensor) -> torch.Tensor:
    """The reverse inclusive cumsum over the last dim (at most ``_QMAX``)
    in ``ssd_bwd_reduce``'s order: one position a thread, warp scans, the
    later warps' totals added from the last down, bitwise."""
    q = v.shape[-1]
    v = torch.nn.functional.pad(v, (0, _QMAX - q)).reshape(
        *v.shape[:-1], 8, 32)
    incl = v
    for off in (1, 2, 4, 8, 16):
        incl = incl + _lane_shift(incl, off, up=False)
    wsum = incl[..., 0]
    base = [torch.zeros_like(wsum[..., 0])]
    for w in range(6, -1, -1):
        base.insert(0, base[0] + wsum[..., w + 1])
    out = torch.stack(base, -1)[..., None] + incl
    return out.reshape(*out.shape[:-2], _QMAX)[..., :q]


def _kernel_block_sum(v: torch.Tensor) -> torch.Tensor:
    """``block_sum`` of ``_QMAX`` values (the last dim, padded with 0): xor
    butterflies in each warp, then the warp totals in order, bitwise."""
    v = torch.nn.functional.pad(v, (0, _QMAX - v.shape[-1])).reshape(
        *v.shape[:-1], 8, 32)
    lanes = torch.arange(32, device=v.device)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ off]
    out = v[..., 0, 0]
    for w in range(1, 8):
        out = out + v[..., w, 0]
    return out


def ssd_scan_bwd_tc_emulate(x: torch.Tensor, dt: torch.Tensor,
                            a: torch.Tensor, b: torch.Tensor,
                            c: torch.Tensor, dy: torch.Tensor,
                            dfinal: torch.Tensor | None = None, *,
                            chunk: int,
                            initial_state: torch.Tensor | None = None,
                            mask: torch.Tensor | None = None,
                            lo_terms: bool = True,
                            skip_decay_chunk: int | None = None,
                            diagonal: bool = True):
    """``csrc/ssd_scan_bwd.cu``'s arithmetic, pass by pass: the same
    vector-Jacobian product as :func:`ssd_scan_bwd_ref`, every product
    split 3xTF32 (:func:`_mm3`), every scaled operand split after its
    scale, as the kernels stage it.

    C·Bᵀ and the chunk states are the forward's (:func:`_tc_forward`, as
    the kernels read them from the forward's workspace).  Per (row, chunk,
    head), with the names of :func:`ssd_scan_bwd_ref`:

    1. ``ssd_bwd_adj``: cum, decay, Ploc = (exp(cum) ⊙ dy)ᵀ C;
    2. ``ssd_bwd_pass``: Gx in reverse, d initial_state;
    3. ``ssd_bwd_dxdt``: dxdt = (seg_end ⊙ B)·Gxᵀ, then += (CB ⊙ L)ᵀ dy
       in the same accumulator; xdot = ⟨x, dxdt⟩, dx = dt dxdt;
    4. ``ssd_bwd_dd``: D = (dy·xdtᵀ) ⊙ L per head, W = D ⊙ CB's row and
       column sums rintra and cintra, and D summed over each run of
       ``RUN_HEADS`` heads of a group;
    5. ``ssd_bwd_db`` / ``ssd_bwd_dc``: dB = Σ_runs (ΣD)ᵀ C, then + each
       head's (seg_end ⊙ xdt)·Gx in head order, and dC = Σ_runs (ΣD)·B,
       then + each head's (exp(cum) ⊙ dy)·S: the group sums, with no
       per-head dB or dC kept; of each head's product its row term, T =
       ⟨B, ·⟩ (= ⟨xdt, dxdt_inter⟩) and rinter = ⟨C, ·⟩ (= C·dC_inter);
    6. ``ssd_bwd_reduce``: d cum = rintra + rinter − cintra − T, the last
       position + decay ⟨Gx, S⟩ + Σ T; its reverse cumsum, ddt, da, in the
       kernels' orders.  W's sums, the row terms and this pass run in f64,
       as the kernels take them: where L is near diagonal (large dt·|a|)
       d cum's terms nearly cancel, and da sums d cum's reverse cumsum
       over every position.

    Faults: ``lo_terms=False`` takes one TF32 product; ``skip_decay_chunk
    =k`` lets the reverse state pass skip chunk k's decay;
    ``diagonal=False`` drops the diagonal from the causal mask of D and of
    CB ⊙ L.  Returns (dx, ddt, da, db, dc, d_initial_state) as
    :func:`ssd_scan_bwd_ref` does.
    """
    bb, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hg = h // g
    nc = -(-s // chunk)
    zero = torch.zeros((), device=x.device)
    # the forward's workspace: C·Bᵀ and the states entering each chunk
    f = _tc_forward(x, dt, a, b, c, chunk, initial_state, mask, lo_terms)
    xq, dtq, bq, cq, bh, ch = f.xq, f.dtq, f.bq, f.cq, f.bh, f.ch
    cb, cum, seg_end, xdt, decay, s_in = (f.cb, f.cum, f.seg_end, f.xdt,
                                          f.decay, f.s_in)
    cbh = cb.repeat_interleave(hg, dim=2)
    dyq = _streams(dy.float(), chunk)
    a = a.float()

    # 1: each chunk's adjoint; 2: carried in reverse
    ec = torch.exp(cum)
    ploc = _mm3((dyq * ec[..., None]).transpose(-1, -2), ch, lo_terms)
    g_state = (torch.zeros((bb, h, p, n), device=x.device)
               if dfinal is None else dfinal.float())
    exits = [None] * nc
    for ci in reversed(range(nc)):
        exits[ci] = g_state
        d = (torch.ones((), device=x.device) if ci == skip_decay_chunk
             else decay[:, ci, :, None, None])
        g_state = d * g_state + ploc[:, ci]
    gx = torch.stack(exits, 1)                                # (B,nc,H,P,N)
    d_init = g_state if initial_state is not None else None

    # 3: dxdt per head
    rows = torch.arange(chunk, device=x.device)
    causal = (rows[:, None] >= rows[None, :]) if diagonal \
        else (rows[:, None] > rows[None, :])
    L = torch.exp(torch.where(causal, cum[..., :, None] - cum[..., None, :],
                              torch.full((), -torch.inf, device=x.device)))
    dxdt = _mm3(seg_end[..., None] * bh, gx.transpose(-1, -2), lo_terms)
    dxdt = _mm3((cbh * L).transpose(-1, -2), dyq, lo_terms, acc=dxdt)
    xdot = (xq * dxdt).sum(-1)

    # 4: D per head, its row term, and its sums over runs of heads
    dd = _mm3(dyq, xdt.transpose(-1, -2), lo_terms) * L       # (B,nc,H,Q,Q)
    w = dd.double() * cbh.double()            # W's sums in f64, as kernel 4's
    rintra, cintra = w.sum(-1), w.sum(-2)
    dd = dd.reshape(bb, nc, g, hg, chunk, chunk)
    runs = -(-hg // RUN_HEADS)
    per = -(-hg // runs)
    dsum = [dd[:, :, :, r * per:(r + 1) * per].sum(3) for r in range(runs)]

    # 5: dB and dC of each group: the runs' products, then each head's
    # (whose row terms T and rinter are taken before it is added)
    db_h = _mm3(seg_end[..., None] * xdt, gx, lo_terms)       # (B,nc,H,Q,N)
    dc_h = _mm3(ec[..., None] * dyq, s_in, lo_terms)
    t_k = (bh.double() * db_h.double()).sum(-1)
    rinter = (ch.double() * dc_h.double()).sum(-1)
    db = dc = None
    for r in range(runs):
        db = _mm3(dsum[r].transpose(-1, -2), cq, lo_terms, acc=db)
        dc = _mm3(dsum[r], bq, lo_terms, acc=dc)
    db_h = db_h.reshape(bb, nc, g, hg, chunk, n)
    dc_h = dc_h.reshape(bb, nc, g, hg, chunk, n)
    for j in range(hg):
        db = db + db_h[:, :, :, j]
        dc = dc + dc_h[:, :, :, j]

    # 6: d cum, its reverse cumsum, dt, a (the reduce kernel's orders, in
    # f64: d cum's terms nearly cancel where L is near diagonal)
    dcum = rintra + rinter - cintra - t_k
    qc = s - (nc - 1) * chunk                 # the last chunk's real length
    gs = (gx.double() * s_in.double()).sum((-1, -2))
    last = decay.double() * gs + _kernel_block_sum(t_k)
    ends = torch.full((nc,), chunk - 1, device=x.device)
    ends[-1] = qc - 1
    at_end = rows[None, :] == ends[:, None]                   # (nc, Q)
    dcum = dcum + torch.where(at_end[None, :, None], last[..., None],
                              zero.double())
    dda = _kernel_rev_cumsum(dcum)
    ddt = (a.double()[None, None, :, None] * dda + xdot.double()).float()
    dx = dxdt * dtq[..., None]
    share = _kernel_block_sum(dtq.double() * dda)             # (B,nc,H)
    da = share[0, 0]
    for r in range(1, bb * nc):
        da = da + share[r // nc, r % nc]
    da = da.float()

    def unchunk(t):                     # (B,nc,K,Q,·) -> (B,S,K,·)
        t = t.permute(0, 1, 3, 2, *range(4, t.ndim))
        return t.reshape(bb, nc * chunk, *t.shape[3:])[:, :s]
    ddt = unchunk(ddt)
    if mask is not None:
        ddt = torch.where(mask[..., None], ddt, zero)
    return unchunk(dx), ddt, da, unchunk(db), unchunk(dc), d_init
