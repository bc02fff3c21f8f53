"""Wrapper of the hand-written Hopper SSD chunk-scan kernels.

:func:`ssd_scan` — the mamba2 prefill's state-space scan over (B, S, H, P)
streams, resumable (``initial_state``) and maskable (``mask``).  Replaces
the Pallas ``repro/kernels/ssd_scan/ssd_scan.py:81 ssd_scan``.

A CUDA tensor launches the kernels (``csrc/ssd_scan_tc.cu``, built on
first use) on ``torch.cuda.current_stream()``, or the call raises; a CPU
tensor takes the plain version, ``repro_torch.models.ssm._ssd_chunked``
(JAX's jnp scan); a ``meta`` tensor (the dry run,
``repro_torch.launch.dryrun``) returns empty outputs of the kernel's
shapes and records its cost formula (``launch.cost``), computing nothing.
Nothing falls back.  A call is four device kernels:
``ssd_cb`` (C·Bᵀ per group and chunk, causal tiles only),
``ssd_chunk_state`` (each chunk's cumsum and its chunk-local state, all
chunks in parallel), ``ssd_state_pass`` (the state carried across chunks,
elementwise, the only sequential part) and ``ssd_chunk_out`` (y per 64-row
tile; launched twice where S spans more than one chunk: chunk 0's tiles,
which need only ``ssd_cb``, run on a side stream beside the middle two);
every product on the TF32 tensor cores, three products each (the 3xTF32
split, f32 accuracy).  The workspace (one buffer) comes from
``torch.empty``, so a CUDA graph takes it from its pool.
``ref.ssd_scan_tc_emulate`` is the same arithmetic on the CPU.  The
wrapper counts its public calls that launch the kernels in a plain integer
attribute, ``launches`` (one a call).

:func:`ssd_scan_bwd` — the scan's backward (its vector-Jacobian
product), which no TPU kernel has: JAX differentiates its jnp scan.  A
CUDA call is eight kernels of ``csrc/ssd_scan_bwd.cu`` (nine where the dB
and dC kernels split K; built on first use; redesigned for the tensor
cores: every product on TF32 ``mma.sync`` with the 3xTF32 split, D built
once per causal tile pair and head, dB and dC summed over a group's heads
without a per-head workspace) that read the forward's C·Bᵀ and chunk
states from the workspace ``ssd_scan(..., keep_workspace=True)`` returns;
a CPU call takes its plain version, ``ref.ssd_scan_bwd_ref``.
``ref.ssd_scan_bwd_tc_emulate`` is the kernels' arithmetic on any device.
Nothing falls back; it counts its CUDA calls in ``ssd_scan_bwd.launches``.
Under autograd, ``ops.SSDScanFn`` runs the two; ``ssd_scan`` itself raises
on CUDA tensors that require grad (it would return a detached result).

Tolerance of kernel against plain version on the card: ``KERNEL_TOL``
= 1e-4 of the output's scale, ``max|kernel - plain| <= KERNEL_TOL *
max(1, max|plain|)`` (:func:`scaled_err`), for y and the final state
alike, and for every gradient of :func:`ssd_scan_bwd` against autograd
of the plain version; 1e-4 is the bound JAX holds its Pallas kernel to
against the jnp scan (``tests/test_ssd_kernel.py``).  The backward takes
the same 3xTF32 products, summing each 64 of K on the tensor cores and
those sums in f32, and d cum's nearly cancelling terms and da's sums in
f64: ~4e-6 of each gradient's scale.  The forward's products split
each
f32 operand into two TF32 parts (hi·hi + hi·lo + lo·hi, lo·lo dropped:
each product within ~2^-21 of the f32 one) and sum them in the tensor
cores' order; the plain version sums true f32 products with the
library's tiling.  At mamba2's widths an output sums ~N + Q = 384
products of magnitude up to ~10, which moves results by ~1e-6 of their
scale (a single TF32 product would move them by ~5e-4).  The scale, not
each element, is the reference because outputs near zero are sums of
cancelling terms of that scale.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.launch import cost

KERNEL_TOL = 1e-4

#: the kernels' limits (mirrors the constants in csrc/ssd_scan_tc.cu;
#: the backward, csrc/ssd_scan_bwd.cu, also takes head dims up to PMAX)
QMAX = 256
NMAX = 128
PMAX = 64


def scaled_err(out: torch.Tensor, plain: torch.Tensor) -> float:
    """``max|out - plain| / max(1, max|plain|)``: the error
    ``KERNEL_TOL`` bounds."""
    scale = max(1.0, plain.abs().max().item())
    return (out - plain).abs().max().item() / scale


def _lib():
    """The built library, its entry points typed on first use."""
    from repro_torch.kernels._build import load_library
    lib = load_library("ssd_scan_tc")
    if lib.ssd_scan_tc_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_tc_workspace.argtypes = [i] * 7 + [
            ctypes.POINTER(ctypes.c_longlong)]
        lib.ssd_scan_tc_workspace.restype = ctypes.c_int
        lib.ssd_scan_tc_launch.argtypes = [p] * 10 + [i] * 7 + [p]
        lib.ssd_scan_tc_launch.restype = ctypes.c_int
        lib.ssd_scan_tc_layout.argtypes = [i] * 7 + [
            ctypes.POINTER(ctypes.c_longlong)] * 2
        lib.ssd_scan_tc_layout.restype = ctypes.c_int
        limits = (lib.ssd_scan_tc_qmax(), lib.ssd_scan_tc_nmax())
        if limits != (QMAX, NMAX):
            raise RuntimeError(f"ssd_scan_tc.cu limits {limits} differ from "
                               "the wrapper's")
    return lib


def _bwd_lib():
    """The backward's built library, typed on first use."""
    from repro_torch.kernels._build import load_library
    lib = load_library("ssd_scan_bwd")
    if lib.ssd_scan_bwd_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_bwd_workspace.argtypes = [i] * 7 + [
            ctypes.POINTER(ctypes.c_longlong)]
        lib.ssd_scan_bwd_workspace.restype = ctypes.c_int
        lib.ssd_scan_bwd_launch.argtypes = [p] * 18 + [i] * 7 + [p]
        lib.ssd_scan_bwd_launch.restype = ctypes.c_int
        limits = (lib.ssd_scan_bwd_qmax(), lib.ssd_scan_bwd_pmax(),
                  lib.ssd_scan_bwd_nmax())
        if limits != (QMAX, PMAX, NMAX):
            raise RuntimeError(f"ssd_scan_bwd.cu limits {limits} differ "
                               "from the wrapper's")
    return lib


def _check(x, dt, a, b, c, chunk, initial_state, mask):
    if x.ndim != 4 or b.ndim != 4 or c.shape != b.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)}: want (B,S,H,P) and (B,S,G,N)")
    bb, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    want = {"dt": (dt, (bb, s, h)), "a": (a, (h,)), "b": (b, (bb, s, g, n))}
    if initial_state is not None:
        want["initial_state"] = (initial_state, (bb, h, p, n))
    for name, (t, shape) in {"x": (x, x.shape), **want}.items():
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be float32 of shape "
                             f"{tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if mask is not None and (mask.dtype != torch.bool
                             or tuple(mask.shape) != (bb, s)):
        raise ValueError(f"mask must be bool of shape {(bb, s)}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if h % g:
        raise ValueError(f"{g} groups do not divide {h} heads")
    if not 1 <= chunk <= QMAX or n > NMAX:
        raise ValueError(f"chunk {chunk} must be in [1, {QMAX}] and state "
                         f"dim {n} at most {NMAX}")
    ops = [t for t in (x, dt, a, b, c, initial_state, mask) if t is not None]
    devs = {t.device for t in ops}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def _launch(x, dt, a, b, c, chunk, initial_state, mask):
    """(y, final state, the workspace: C·Bᵀ and the chunk states)."""
    ops = (x, dt, a, b, c, initial_state, mask)
    if not all(t.is_contiguous() for t in ops if t is not None):
        raise ValueError("ssd_scan takes contiguous operands")
    bb, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    sizes = (bb, s, h, p, g, n, chunk)
    y = torch.empty_like(x)
    final = torch.empty((bb, h, p, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        lib = _lib()
        nbytes = ctypes.c_longlong()
        err = lib.ssd_scan_tc_workspace(*sizes, ctypes.byref(nbytes))
        if err == 0:
            # C·Bᵀ, the chunks' states and their decays
            ws = torch.empty(nbytes.value, dtype=torch.uint8, device=x.device)
            err = lib.ssd_scan_tc_launch(
                x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), None if mask is None else mask.data_ptr(),
                None if initial_state is None else initial_state.data_ptr(),
                ws.data_ptr(), y.data_ptr(), final.data_ptr(), *sizes, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError_t "
                           f"{err}")
    return y, final, ws


def _sizes(x, b) -> tuple[int, ...]:
    """(B, S, H, P, G, N) of a call."""
    return (*x.shape, *b.shape[2:])


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int,
             initial_state: torch.Tensor | None = None,
             mask: torch.Tensor | None = None,
             keep_workspace: bool = False):
    """SSD over (B, S, H, P) streams in chunks of ``chunk`` positions.

    x: (B,S,H,P) f32; dt: (B,S,H) f32; a: (H,) f32 negative decay rates;
    b/c: (B,S,G,N) f32 with G | H (head h reads group h // (H/G));
    ``initial_state``: optional (B,H,P,N) f32 carried state (zeros when
    None); ``mask``: optional (B,S) bool validity mask (invalid positions
    are inert: dt is zeroed).  S need not be a multiple of ``chunk``.
    Returns (y (B,S,H,P) f32, final_state (B,H,P,N) f32), and with
    ``keep_workspace`` a third item for :func:`ssd_scan_bwd`: the CUDA
    call's workspace (its C·Bᵀ and chunk states), None on the CPU.  On
    CUDA tensors that require grad (grad enabled) it raises: the kernels'
    result has no ``grad_fn``; ``ops.ssd_chunked_kernel`` differentiates
    the scan through ``ops.SSDScanFn``.
    """
    _check(x, dt, a, b, c, chunk, initial_state, mask)
    if x.device.type == "cpu":
        from repro_torch.models.ssm import _ssd_chunked
        out = _ssd_chunked(x, dt, a, b, c, chunk,
                           initial_state=initial_state, mask=mask)
        return (*out, None) if keep_workspace else out
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan runs on cuda, cpu or meta, not "
                         f"{x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, b, c, initial_state)):
        raise RuntimeError(
            "ssd_scan's kernels return no grad_fn: differentiate the scan "
            "through repro_torch.kernels.ssd_scan.ops.ssd_chunked_kernel "
            "(SSDScanFn, whose backward is ssd_scan_bwd)")
    if cost.ACTIVE is not None:
        cost.ACTIVE.kernel("ssd_scan", *cost.ssd_scan_cost(
            *_sizes(x, b), chunk, mask is not None,
            initial_state is not None, initial_state is not None))
    if x.device.type == "meta":
        bb, _, h, p = x.shape
        final = torch.empty((bb, h, p, b.shape[3]), dtype=torch.float32,
                            device="meta")
        y = torch.empty_like(x)
        return (y, final, None) if keep_workspace else (y, final)
    y, final, ws = _launch(x, dt, a, b, c, chunk, initial_state, mask)
    ssd_scan.launches += 1
    return (y, final, ws) if keep_workspace else (y, final)


ssd_scan.launches = 0


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                 dfinal: torch.Tensor | None = None, *, chunk: int,
                 initial_state: torch.Tensor | None = None,
                 mask: torch.Tensor | None = None,
                 workspace: torch.Tensor | None = None):
    """The backward of ``ssd_scan(x, dt, a, b, c, chunk=chunk,
    initial_state=initial_state, mask=mask)`` for the output gradients
    ``dy`` (B,S,H,P) f32 and ``dfinal`` (B,H,P,N) f32 (zeros when None).

    CUDA tensors launch ``csrc/ssd_scan_bwd.cu`` (head dim at most
    ``PMAX``; redesigned for the TF32 tensor cores) on
    ``torch.cuda.current_stream()`` and need ``workspace``,
    the third item of ``ssd_scan(..., keep_workspace=True)`` on the same
    inputs; CPU tensors take ``ref.ssd_scan_bwd_ref``.  Returns (dx, ddt,
    da, db, dc, d_initial_state), f32 in the inputs' shapes;
    d_initial_state is None when ``initial_state`` is.
    """
    _check(x, dt, a, b, c, chunk, initial_state, mask)
    bb, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    grads = {"dy": (dy, (bb, s, h, p))}
    if dfinal is not None:
        grads["dfinal"] = (dfinal, (bb, h, p, n))
    for name, (t, shape) in grads.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != x.device):
            raise ValueError(f"{name} must be float32 of shape {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if x.device.type == "cpu":
        from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref
        return ssd_scan_bwd_ref(x, dt, a, b, c, dy, dfinal, chunk=chunk,
                                initial_state=initial_state, mask=mask)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan_bwd runs on cuda, cpu or meta, not "
                         f"{x.device}")
    if cost.ACTIVE is not None:
        cost.ACTIVE.kernel("ssd_scan_bwd", *cost.ssd_scan_bwd_cost(
            *_sizes(x, b), chunk, mask is not None,
            initial_state is not None, initial_state is not None))
    if x.device.type == "meta":
        return (torch.empty_like(x), torch.empty_like(dt),
                torch.empty_like(a), torch.empty_like(b),
                torch.empty_like(c), None if initial_state is None
                else torch.empty_like(initial_state))
    if p > PMAX:
        raise ValueError(f"ssd_scan_bwd takes head dims up to {PMAX}, not "
                         f"{p}")
    ops = (x, dt, a, b, c, dy, dfinal, initial_state, mask)
    if not all(t.is_contiguous() for t in ops if t is not None):
        raise ValueError("ssd_scan_bwd takes contiguous operands")
    sizes = (bb, s, h, p, g, n, chunk)
    with torch.cuda.device(x.device):
        fwd = _lib()
        cb_at, st_at = ctypes.c_longlong(), ctypes.c_longlong()
        fwd_bytes = ctypes.c_longlong()
        err = fwd.ssd_scan_tc_workspace(*sizes, ctypes.byref(fwd_bytes))
        if err == 0:
            err = fwd.ssd_scan_tc_layout(*sizes, ctypes.byref(cb_at),
                                         ctypes.byref(st_at))
        if err != 0:
            raise RuntimeError(f"ssd_scan_tc layout failed: cudaError_t "
                               f"{err}")
        if (workspace is None or workspace.dtype != torch.uint8
                or workspace.numel() != fwd_bytes.value
                or workspace.device != x.device):
            raise ValueError(
                "ssd_scan_bwd on CUDA needs the forward's workspace: "
                "ssd_scan(..., keep_workspace=True) on the same inputs")
        lib = _bwd_lib()
        nbytes = ctypes.c_longlong()
        err = lib.ssd_scan_bwd_workspace(*sizes, ctypes.byref(nbytes))
        if err != 0:
            raise RuntimeError(f"ssd_scan_bwd workspace failed: cudaError_t "
                               f"{err}")
        ws = torch.empty(nbytes.value, dtype=torch.uint8, device=x.device)
        dx = torch.empty_like(x)
        ddt = torch.empty_like(dt)
        da = torch.empty_like(a)
        db = torch.empty_like(b)
        dc = torch.empty_like(c)
        d_init = (None if initial_state is None
                  else torch.empty_like(initial_state))
        base = workspace.data_ptr()
        stream = torch.cuda.current_stream(x.device).cuda_stream

        def ptr(t):
            return None if t is None else t.data_ptr()
        err = lib.ssd_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), ptr(mask), ptr(initial_state), base + cb_at.value,
            base + st_at.value, dy.data_ptr(), ptr(dfinal), ws.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(),
            dc.data_ptr(), ptr(d_init), *sizes, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: cudaError_t "
                           f"{err}")
    ssd_scan_bwd.launches += 1
    return dx, ddt, da, db, dc, d_init


ssd_scan_bwd.launches = 0
