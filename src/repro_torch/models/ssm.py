"""Mamba2 (SSD, state-space duality) mixer block: chunked prefill and the
O(1) decode recurrence (mirrors ``repro.models.ssm``).

Prefill (S > 1) runs the SSD chunk scan: within chunks of Q positions the
output is a masked quadratic form, across chunks an (H, P, N) state is
carried.  On CUDA tensors the scan is the hand-written Hopper kernel
(:mod:`repro_torch.kernels.ssd_scan`); on CPU tensors the kernel's wrapper
takes :func:`_ssd_chunked`, the plain PyTorch version below, operation
for operation JAX's jnp scan.  Decode (S == 1 with a cache) is the
per-token recurrence on (conv_state, ssm_state), plain tensor ops as in
JAX (no kernel there).

Parameters of one layer are a dict (:func:`mamba2_shapes`); the layer
module :class:`Mamba2` holds them as leaves so a frozen 4-bit
``QuantizedWeight`` can stand in for ``w_in``/``w_out``.  The prefix
cache keeps per-row state snapshots (:func:`snapshot_row`), copies that
later decode ticks cannot overwrite.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.layers import quant_matmul
from repro_torch.kernels.ssd_scan.ops import ssd_chunked_kernel
from repro_torch.models.common import dense_init, dtype_of, set_leaf


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, conv_dim-1, conv_channels), model dtype
    state: torch.Tensor  # (B, H, P, N) f32


def snapshot_row(cache: SSMCache, row: int = 0) -> SSMCache:
    """One batch row of a layer's recurrent cache, keepdim: the fixed-size
    state the prefix cache stores at a prompt boundary (JAX's
    ``snapshot_row``).  A COPY: the engine writes its slab in place, and a
    view would follow the row's later decode ticks.  The SSD scan takes an
    initial state, so a prefill seeded from the snapshot resumes exactly
    where the cached prefix left off."""
    return SSMCache(cache.conv[row:row + 1].clone(),
                    cache.state[row:row + 1].clone())


def _dims(cfg) -> tuple[int, int, int]:
    """(d_inner, SSD heads, conv channels)."""
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    nheads = d_inner // sc.head_dim
    conv_ch = d_inner + 2 * sc.num_groups * sc.state_dim
    return d_inner, nheads, conv_ch


def mamba2_shapes(cfg) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """name -> (shape, dtype) of one layer's mixer parameters."""
    sc = cfg.ssm
    d_inner, nheads, conv_ch = _dims(cfg)
    dt = dtype_of(cfg)
    in_dim = 2 * d_inner + 2 * sc.num_groups * sc.state_dim + nheads
    return {
        "w_in": ((cfg.d_model, in_dim), dt),
        "conv_w": ((sc.conv_dim, conv_ch), dt),
        "conv_b": ((conv_ch,), dt),
        "A_log": ((nheads,), torch.float32),
        "D": ((nheads,), torch.float32),
        "dt_bias": ((nheads,), torch.float32),
        "norm_w": ((d_inner,), dt),
        "w_out": ((d_inner, cfg.d_model), dt),
    }


@torch.no_grad()
def init_mamba2(gen: torch.Generator, p: dict) -> dict:
    """Fill one layer's parameters in place, as JAX's ``init_mamba2``
    draws them: N(0, 1/fan_in) projections, N(0, 0.2^2) conv taps, zero
    biases, ``A_log = log(linspace(1, 16, H))``, unit ``D`` and norm."""
    dense_init(gen, p["w_in"])
    dense_init(gen, p["conv_w"], scale=0.2)
    dense_init(gen, p["w_out"])
    p["conv_b"].zero_()
    nheads = p["A_log"].shape[0]
    p["A_log"].copy_(torch.log(torch.linspace(1.0, 16.0, nheads)))
    p["D"].fill_(1.0)
    p["dt_bias"].zero_()
    p["norm_w"].fill_(1.0)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None,
                 last_pos: torch.Tensor | None = None):
    """Depthwise causal conv1d.  x: (B, S, C); w: (K, C).

    Returns (silu(conv + b), new_state) where the state holds the last
    K-1 inputs.  ``last_pos``: optional (B,) index of each row's last REAL
    input (right-padded prefill): the state window is gathered at each
    row's own valid end, so pad columns never enter the carried state.
    """
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                      # (B, S+K-1, C)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0][None, None]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i][None, None]
    if last_pos is None:
        new_state = xp[:, -(k - 1):]
    else:
        # a row of valid length L keeps xp[L : L+K-1] (xp[i] is the input
        # at position i-(K-1))
        lengths = last_pos.long() + 1
        idx = lengths[:, None] + torch.arange(k - 1, device=x.device)[None]
        new_state = torch.gather(
            xp, 1, idx[..., None].expand(-1, -1, xp.shape[2]))
    return F.silu(y + b[None, None]), new_state


def _ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None, mask=None):
    """The SSD chunk scan's plain PyTorch version (JAX's ``_ssd_chunked``).

    x: (B,S,H,P); dt: (B,S,H); A: (H,) (negative); B/C: (B,S,G,N).
    ``initial_state``: optional (B,H,P,N) carried state the scan continues
    from; ``mask``: optional (B,S) validity mask (dt is zeroed at invalid
    positions: their decay is 1 and x*dt vanishes, so the state freezes).
    The sequence is right-padded internally to the chunk grid with inert
    dt = 0.  Returns (y (B,S,H,P), final_state (B,H,P,N)), f32.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if mask is not None:
        dt = torch.where(mask[..., None], dt, torch.zeros((), dtype=dt.dtype,
                                                          device=dt.device))
    pad = -s % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    nc = sp // chunk
    hg = h // g
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, g, n)
    Cc = C.reshape(b, nc, chunk, g, n)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for i in range(nc):
        xq, dtq, Bq, Cq = xc[:, i], dtc[:, i], Bc[:, i], Cc[:, i]
        dA_cum = torch.cumsum(dtq * A[None, None, :], dim=1)      # (B,Q,H)
        seg_start = torch.exp(dA_cum)                             # decay 0..i
        seg_end = torch.exp(dA_cum[:, -1:, :] - dA_cum)           # decay i..end
        chunk_decay = torch.exp(dA_cum[:, -1, :])                 # (B,H)
        xdt = xq * dtq[..., None]                                 # (B,Q,H,P)
        Bh = Bq.repeat_interleave(hg, dim=2)                      # (B,Q,H,N)
        Ch = Cq.repeat_interleave(hg, dim=2)
        # intra-chunk: L[q,k] = exp(dA_cum[q]-dA_cum[k]) for q >= k; the
        # upper triangle is masked BEFORE exp (exp of it overflows)
        rel = dA_cum[:, :, None, :] - dA_cum[:, None, :, :]       # (B,Q,Q,H)
        L = torch.exp(torch.where(causal[None, :, :, None], rel,
                                  torch.full((), -1e30, device=x.device)))
        cb = torch.einsum("bqgn,bkgn->bqkg", Cq, Bq)              # (B,Q,Q,G)
        cb = cb.repeat_interleave(hg, dim=-1)                     # (B,Q,Q,H)
        y_intra = torch.einsum("bqkh,bkhp->bqhp", cb * L, xdt)
        # inter-chunk from the carried state
        y_inter = torch.einsum("bqh,bqhn,bhpn->bqhp", seg_start, Ch, state)
        state = (state * chunk_decay[..., None, None]
                 + torch.einsum("bqh,bqhn,bqhp->bhpn", seg_end, Bh, xdt))
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, 1).reshape(b, sp, h, p)[:, :s]
    return y, state


def mamba2_block(p: dict, x: torch.Tensor, cfg, cache: SSMCache | None = None,
                 last_pos: torch.Tensor | None = None):
    """x: (B, S, D) -> (y, new_cache).  S == 1 with a cache is the decode
    recurrence; otherwise the SSD chunk scan (the ``ssd_scan`` kernel on
    CUDA tensors, :func:`_ssd_chunked` on CPU tensors).

    Prefill CONTINUES the carried (conv, state) of ``cache`` (fresh caches
    are zeros).  ``last_pos``: optional (B,) index of each row's last REAL
    token; pad columns beyond it are masked out of the recurrent state.
    """
    sc = cfg.ssm
    d_inner, nheads, conv_ch = _dims(cfg)
    b, s, _ = x.shape
    gn = sc.num_groups * sc.state_dim

    zxbcdt = quant_matmul(x, p["w_in"], cfg.quant, "mlp")
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_ch]
    dt_raw = zxbcdt[..., d_inner + conv_ch:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None])   # (B,S,H)
    A = -torch.exp(p["A_log"])                                   # (H,) < 0

    xbc, new_conv = _causal_conv(
        xbc, p["conv_w"], p["conv_b"],
        cache.conv if cache is not None else None,
        last_pos=last_pos if s > 1 else None)
    xs = xbc[..., :d_inner].reshape(b, s, nheads, sc.head_dim)
    B_ = xbc[..., d_inner:d_inner + gn].reshape(b, s, sc.num_groups,
                                                sc.state_dim)
    C_ = xbc[..., d_inner + gn:].reshape(b, s, sc.num_groups, sc.state_dim)

    if s == 1 and cache is not None:
        # --- O(1) decode step ---
        hg = nheads // sc.num_groups
        dA = torch.exp(dt[:, 0] * A[None])                       # (B,H)
        # f32 operands: JAX's einsum promotes bf16 x f32 to f32
        Bh = B_[:, 0].float().repeat_interleave(hg, dim=1)       # (B,H,N)
        Ch = C_[:, 0].float().repeat_interleave(hg, dim=1)
        xdt = xs[:, 0] * dt[:, 0][..., None]                     # (B,H,P)
        final_state = (cache.state * dA[..., None, None]
                       + torch.einsum("bhn,bhp->bhpn", Bh, xdt).to(
                           cache.state.dtype))
        y = torch.einsum("bhn,bhpn->bhp", Ch, final_state.float())
        y = y[:, None]                                           # (B,1,H,P)
    else:
        seq_mask = None
        if last_pos is not None:
            seq_mask = (torch.arange(s, device=x.device)[None, :]
                        <= last_pos.long()[:, None])
        y, final_state = ssd_chunked_kernel(
            xs.float(), dt, A, B_.float(), C_.float(),
            chunk=min(sc.chunk_size, s),
            initial_state=cache.state if cache is not None else None,
            mask=seq_mask)
        if cache is not None:
            final_state = final_state.to(cache.state.dtype)

    y = y + p["D"][None, None, :, None] * xs.float()
    y = y.reshape(b, s, d_inner).to(x.dtype)
    # gated RMSNorm (mamba2)
    y = y * F.silu(z)
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + cfg.norm_eps)
         * p["norm_w"].float()).to(x.dtype)
    out = quant_matmul(y, p["w_out"], cfg.quant, "mlp")
    new_cache = None
    if cache is not None:
        new_cache = SSMCache(new_conv.to(cache.conv.dtype), final_state)
    return out, new_cache


class Mamba2(nn.Module):
    """One layer's mixer parameters as leaves; ``forward`` is
    :func:`mamba2_block`."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        for name in mamba2_shapes(cfg):
            set_leaf(self, name, params[name])

    def params_tree(self) -> dict:
        return {name: getattr(self, name) for name in mamba2_shapes(self.cfg)}

    def forward(self, x, cache=None, last_pos=None):
        return mamba2_block(self.params_tree(), x, self.cfg, cache, last_pos)


def ssm_cache_shape(cfg, batch: int):
    """((conv state shape), (SSD state shape)) of one layer."""
    sc = cfg.ssm
    _, nheads, conv_ch = _dims(cfg)
    return ((batch, sc.conv_dim - 1, conv_ch),
            (batch, nheads, sc.head_dim, sc.state_dim))

