"""What a step of the port costs, counted from the code it runs: the
port's replacement for XLA's ``compiled.cost_analysis()``.

:class:`CostMode` is a ``TorchDispatchMode``.  Inside it every aten op the
port issues is counted, on any device (``meta`` for the dry run, the card
for a check against it):

* **FLOPs** by ``torch.utils.flop_counter``'s registered formulas (the
  matmuls, convolutions and attention ops; ``_int_mm`` added here as
  2·M·K·N).  Elementwise work counts no FLOPs;
* **bytes**: each op that computes reads its inputs once and writes its
  outputs once (a stride-0 dimension is read once).  The port runs
  eagerly and fuses nothing, so this is its HBM traffic to first order.
  Views, ``empty`` and other ops that move no data count nothing;
* **collectives** by kind (``c10d`` ops), as counts and payload bytes: the
  whole tensor the collective acts on (an all-gather's output, an
  all-reduce's buffer, a reduce-scatter's input).  They are what
  ``parallel/fsdp.py``, ``parallel/act_sharding.py``,
  ``parallel/collectives.py``, ``optim/adamw.py`` and
  ``serve/decode_attention.py`` issue.

The hand-written kernels run through ctypes, which the dispatcher does not
see, so each kernel wrapper records its own ``(flops, bytes)`` while a
mode is active (:data:`ACTIVE`; outside a mode the wrapper's check is one
``is None``).  The formulas are below, one a kernel: the same functions
``chip_smoke.py``'s bound column reads.  On a ``meta`` operand a wrapper
returns empty outputs of its kernel's shapes and records its formula
without running the plain version's arithmetic.
"""
from __future__ import annotations

import math
from dataclasses import fields, is_dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

#: the innermost active :class:`CostMode` (None outside one): the kernel
#: wrappers record into it
ACTIVE: "CostMode | None" = None

#: c10d op name -> ledger kind
_C10D_KIND = {
    "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "allgather_coalesced_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "alltoall_": "all_to_all", "alltoall_base_": "all_to_all",
    "broadcast_": "broadcast",
}
COLLECTIVES = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all",
               "broadcast")

#: ops that allocate or alias without moving data
_FREE = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_unsafe_view", "lift_fresh", "lift_fresh_copy",
    "scalar_tensor", "_local_scalar_dense", "resize_", "set_",
    "record_stream"})


def _int_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    m, k = a_shape
    return 2 * m * k * b_shape[1]


def _flops(func, args, kwargs, out) -> int:
    packet = func._overloadpacket
    if packet is torch.ops.aten._int_mm:
        return _int_mm_flops(tuple(args[0].shape), tuple(args[1].shape))
    formula = flop_registry.get(packet)
    if formula is None:
        return 0
    if func._overloadname == "dtype":       # mm/bmm(..., out_dtype)
        args = tuple(a for a in args if isinstance(a, torch.Tensor))
        kwargs = {}
    return int(formula(*args, **kwargs, out_val=out))


def distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` addresses (a stride-0
    dimension, an expand, counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _moves_data(func) -> bool:
    if func._opname in _FREE or func.is_view:
        return False
    return not any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)


class CostMode(TorchDispatchMode):
    """Counts FLOPs, bytes and collectives of everything run inside it
    (the module docstring).  ``flops``/``bytes`` include the kernels';
    ``kernels``: {name: {"launches", "flops", "bytes"}};
    ``collectives``: {kind: {"count", "bytes"}}."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernels: dict[str, dict] = {}
        self.collectives = {k: {"count": 0, "bytes": 0}
                            for k in COLLECTIVES}
        self._prev = None

    def __enter__(self):
        global ACTIVE
        self._prev, ACTIVE = ACTIVE, self
        return super().__enter__()

    def __exit__(self, *exc):
        global ACTIVE
        ACTIVE = self._prev
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            kind = _C10D_KIND.get(func._opname)
            if kind is not None:
                # (outputs, inputs) or (buffers, group, ...): the larger
                # side is the whole tensor
                c = self.collectives[kind]
                c["count"] += 1
                c["bytes"] += max(sum(distinct_bytes(t) for t in
                                      _tensors(a)) for a in args[:2])
            return out
        self.flops += _flops(func, args, kwargs, out)
        if _moves_data(func):
            self.bytes += (sum(distinct_bytes(t) for t in
                               _tensors((args, kwargs)))
                           + sum(distinct_bytes(t) for t in _tensors(out)))
        return out

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One launch of a hand-written kernel (its wrapper calls this)."""
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0,
                                           "bytes": 0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def record(self) -> dict:
        """The counts as plain numbers (a dry-run record's fields)."""
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": sum(c["bytes"] for c in
                                        self.collectives.values()),
                "collectives": {k: dict(v) for k, v in
                                self.collectives.items()},
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


class SavedBytes:
    """A context counting the bytes autograd saves for the backward
    (``torch.autograd.graph.saved_tensors_hooks``), each storage once;
    parameters, which the step's arguments already hold, are left out.
    Inside a non-reentrant ``checkpoint`` block the checkpoint's own hooks
    take the saves (the block is recomputed), so they are not counted."""

    def __init__(self):
        self.bytes = 0
        self._seen: set = set()
        self._hooks = torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                                 _unpack)

    def _pack(self, t: torch.Tensor):
        if not (t.is_leaf and t.requires_grad):
            key = t.untyped_storage()._cdata
            if key not in self._seen:
                self._seen.add(key)
                self.bytes += t.untyped_storage().nbytes()
        return t

    def __enter__(self):
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        return self._hooks.__exit__(*exc)


def _unpack(t):
    return t


# ---------------------------------------------------------------------------
# the hand-written kernels' formulas: (operations, bytes) of one call
# ---------------------------------------------------------------------------

#: digit planes each LUNA mode's products run (luna_mm)
LUNA_PLANES = {"conventional": 1, "dc": 2, "opt_dc": 2, "approx_dc": 1,
               "approx_dc2": 1}
#: table bytes of the LUT GEMMs: lut_gemm_dc's HI and LO (4 f32 each),
#: lut_gemm_dc_res's plus RES (16), lut_gemm's codebook (16)
DC_TABLE_BYTES, DC_RES_TABLE_BYTES, FULL_TABLE_BYTES = 32, 96, 64


def lut_gemm_cost(m: int, k: int, n: int, x_bytes: int, table_bytes: int,
                  vec_bytes: int = 8, ops: float | None = None
                  ) -> tuple[float, int]:
    """One LUT GEMM call (``lut_gemm_dc``, ``lut_gemm_dc_res``,
    ``lut_gemm``): x, the int8 codes, the tables and ``vec_bytes`` per
    output channel read once, the f32 output written once; ``ops``
    (default 2MKN)."""
    nbytes = m * k * x_bytes + k * n + table_bytes + vec_bytes * n + m * n * 4
    return (2 * m * k * n if ops is None else ops), nbytes


def luna_mm_cost(m: int, k: int, n: int, mode: str) -> tuple[float, int]:
    """One ``luna_mm`` call: y and w (int8) read once and the int32 output
    written once; 2MKN int8 operations per digit plane the mode runs (plus
    K N adds of approx_dc2's colsum)."""
    ops = (2 * m * k * n * LUNA_PLANES[mode]
           + (k * n if mode == "approx_dc2" else 0))
    return lut_gemm_cost(m, k, n, 1, 0, 0, ops)


def ssd_flops(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
              carried: bool) -> int:
    """Operations the chunk scan needs over the real positions: per chunk
    of q positions, C·Bᵀ once per group on the causal triangle, and per
    head the decay mask, the intra-chunk (C·Bᵀ ⊙ L)(x·dt), the
    inter-chunk C·S with its decay, and the state update
    (seg_end·B)ᵀ(x·dt) with its decay; a multiply-add counts 2.  Chunk 0
    meets the initial state, so its inter-chunk C·S and state decay count
    only when that state is ``carried`` non-zero; a zero state needs none
    of them."""
    total = 0
    for c in range(-(-s // chunk)):
        q = min(chunk, s - c * chunk)
        tri = q * (q + 1) // 2
        total += g * 2 * tri * n
        total += h * (tri + 2 * tri * p + 2 * q * n * p + q * n)
        if c > 0 or carried:
            total += h * (2 * q * n * p + q * p + n * p)
    return b * total


def ssd_scan_cost(b, s, h, p, g, n, chunk, masked: bool, init: bool,
                  carried: bool) -> tuple[int, int]:
    """One ``ssd_scan`` call: x, dt, a, B, C, the mask (when ``masked``)
    and the initial state (when ``init`` passes one) read once, y and the
    final state written once (f32); :func:`ssd_flops`."""
    nbytes = (4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * g * n
                   + (1 + init) * b * h * p * n)
              + masked * b * s)
    return ssd_flops(b, s, h, p, g, n, chunk, carried), nbytes


def ssd_bwd_flops(b: int, s: int, h: int, p: int, g: int, n: int,
                  chunk: int, carried: bool, per_head: bool = False) -> int:
    """Operations the scan's backward needs over the real positions: per
    chunk of q positions and head, the chunk's adjoint Σ exp(cum) dy ⊗ C
    (2qPN), D = dy·xdtᵀ ⊙ L on the causal triangle (2·tri·P + tri), the
    intra-chunk dxdt (2·tri·P + tri), the state's dxdt and dB terms (2qNP
    each), dC's inter term (2qPN, where a state enters: chunk 0 only from a
    carried initial state) and the reverse state pass (2PN); per group, dB's
    and dC's intra-chunk products (2·tri·N each) on D summed over the
    group's heads (``per_head``: per head, as the f32-FMA kernels took
    them).  C·Bᵀ and the states are the forward's.  A multiply-add counts
    2."""
    total = 0
    for c in range(-(-s // chunk)):
        q = min(chunk, s - c * chunk)
        tri = q * (q + 1) // 2
        per = (2 * q * p * n + 2 * (2 * tri * p + tri) + 4 * q * n * p
               + 2 * p * n)
        if c > 0 or carried:
            per += 2 * q * p * n
        total += h * per + (h if per_head else g) * 4 * tri * n
    return b * total


def ssd_scan_bwd_cost(b, s, h, p, g, n, chunk, masked: bool, init: bool,
                      carried: bool) -> tuple[int, int]:
    """One ``ssd_scan_bwd`` call: x, dt, a, B, C, dy, the final state's
    cotangent, the mask and the initial state read once, the forward's
    C·Bᵀ (its causal tiles) and chunk states read once, dx, ddt, da, dB,
    dC and the initial state's gradient written once (f32);
    :func:`ssd_bwd_flops`."""
    nc = -(-s // chunk)
    tri = sum(min(chunk, s - c * chunk) * (min(chunk, s - c * chunk) + 1)
              // 2 for c in range(nc))
    floats = (3 * b * s * h * p                # x, dy; dx
              + 2 * (b * s * h + h)              # dt, a; ddt, da
              + 4 * b * s * g * n                # B, C; dB, dC
              + b * h * p * n                    # the final state's cotangent
              + b * g * tri                      # the forward's C·Bᵀ
              + b * (nc - 1) * h * p * n         # its chunk states
              + (2 * b * h * p * n if init else 0))
    return (ssd_bwd_flops(b, s, h, p, g, n, chunk, carried),
            4 * floats + masked * b * s)


def flash_cost(b: int, s: int, h: int, hkv: int, d: int, itemsize: int,
               causal: bool) -> tuple[float, int]:
    """One ``flash_attention`` call: q, k, v read once and o written once;
    the operations the mask leaves (4 B H S² D, halved when causal)."""
    nbytes = itemsize * (2 * b * s * h * d + 2 * b * s * hkv * d)
    return 4 * b * h * s * s * d * (0.5 if causal else 1.0), nbytes


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a tree (dicts, lists, tuples, dataclass
    leaves such as ``QuantizedWeight`` and ``KVCache``)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if is_dataclass(tree):
        return sum(tree_bytes(getattr(tree, f.name)) for f in fields(tree))
    return 0


def shard_bytes(shape: tuple, itemsize: int, spec: tuple, mesh) -> int:
    """Bytes of one rank's block of a ``shape`` leaf under ``spec`` (a
    spec of :mod:`repro_torch.parallel.sharding`) on ``mesh`` (any object
    with ``shape``: {axis: size})."""
    n = math.prod(shape)
    for ax in spec:
        if ax is not None:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n //= mesh.shape[a]
    return n * itemsize
