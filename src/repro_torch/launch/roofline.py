"""Roofline terms of a step (mirrors ``repro.launch.roofline``).

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs            / (chips x 989e12 FLOP/s)   [bf16 dense]
    memory     = bytes            / (chips x 3.35e12 B/s)     [HBM3]
    collective = collective bytes / (chips x 450e9 B/s)       [NVLink 4]

The constants are the NVIDIA H100 SXM data sheet's dense figures: 989.4
TFLOP/s of bf16 on the tensor cores (without sparsity), 3.35 TB/s of HBM3,
and 900 GB/s of NVLink 4 all to all per card, i.e. 450 GB/s each way.
The f32, TF32 and int8 peaks below are the same sheet's.  They are spec
figures: every time this module returns is a bound computed from them,
never a measurement.

The FLOPs, bytes and collective bytes come from
:mod:`repro_torch.launch.cost`, which counts what the port's own code
issues.  JAX's ``collective_bytes`` parses compiled HLO, which the port
does not have; the cost mode's collective ledger takes its place.
"""
from __future__ import annotations

import math

PEAK_FLOPS = 989e12          # bf16 dense, per card (H100 SXM data sheet)
HBM_BW = 3.35e12             # B/s per card (HBM3)
ICI_BW = 450e9               # B/s per card each way (NVLink 4, 900 GB/s)
#: the sheet's other peaks, for the hand-written kernels' bounds
INT8_OPS = 1979e12           # int8 tensor-core operations
TF32_FLOPS = 494.7e12        # TF32 tensor cores (dense)
F32_FLOPS = 67e12            # f32 outside the tensor cores


def bound_ms(ops: float, nbytes: float, peak: float = PEAK_FLOPS
             ) -> tuple[float, str]:
    """Least time of one call on one card, in ms, and what bounds it: the
    larger of ``nbytes`` over the HBM rate and ``ops`` over ``peak``."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   chips: int) -> dict:
    compute = flops / (chips * PEAK_FLOPS)
    memory = bytes_accessed / (chips * HBM_BW)
    collective = coll_bytes / (chips * ICI_BW)
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    bound = max(compute, memory, collective)
    terms["dominant"] = dom
    terms["step_time_lb_s"] = bound
    terms["roofline_fraction"] = compute / bound if bound > 0 else 0.0
    return terms


def model_flops(cfg, shape, n_params: int, n_active: int | None = None
                ) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for a prefill, 2·N per
    decoded token."""
    n = n_active if n_active is not None else n_params
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def analytic_flops(cfg, shape) -> float:
    """JAX's closed-form FLOP estimate of an SSD-family step (matmul FLOPs
    only, 2·M·N·K, x4 for training: forward, full-remat recompute and 2x
    forward for the backward).  The dry run keeps it as a cross-check of
    the counted FLOPs (``analytic_ratio``)."""
    t = shape.global_batch * shape.seq_len if shape.kind != "decode" \
        else shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    d = cfg.d_model
    sc = cfg.ssm
    f = 0.0
    if sc is not None:
        d_inner = sc.expand * d
        h = d_inner // sc.head_dim
        gn = sc.num_groups * sc.state_dim
        conv_ch = d_inner + 2 * gn
        in_dim = 2 * d_inner + 2 * gn + h
        per_tok = (2 * d * in_dim + 2 * conv_ch * sc.conv_dim
                   + 2 * d_inner * d)
        q = min(sc.chunk_size, s)
        ssd_per_tok = (2 * q * gn
                       + 2 * q * h * sc.head_dim / max(h, 1) * h
                       + 4 * h * sc.head_dim * sc.state_dim)
        n_ssm = cfg.num_layers
        f += t * n_ssm * (per_tok + ssd_per_tok)
    if cfg.hybrid is not None:
        hc = cfg.hybrid
        hd = d // hc.shared_num_heads
        n_app = (cfg.num_layers + hc.period - 1) // hc.period
        qkvo = 2 * d * hd * (2 * hc.shared_num_heads
                             + 2 * hc.shared_num_kv_heads)
        mlp3 = 3 * 2 * d * hc.shared_d_ff
        scores = 4 * s * hc.shared_num_heads * hd
        f += t * n_app * (qkvo + mlp3 + scores)
    f += 2.0 * t * d * cfg.vocab_size          # logits
    if shape.kind == "train":
        f *= 4.0                                # remat + backward
    return f


def _shapes(node):
    """Every leaf shape of a module's parameters, or of a tree (dicts,
    lists, tuples) whose leaves are tensors or shape tuples."""
    if hasattr(node, "parameters") and callable(node.parameters):
        for p in node.parameters():
            yield tuple(p.shape)
    elif isinstance(node, dict):
        for v in node.values():
            yield from _shapes(v)
    elif isinstance(node, tuple) and all(isinstance(d, int) for d in node):
        yield node                         # a shape: () or (d0, d1, ...)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _shapes(v)
    elif node is not None:
        yield tuple(node.shape)


def count_params(params_shape) -> int:
    """Elements of a module's parameters, or of a tree of tensors or shape
    tuples (JAX's ``count_params`` of an ``eval_shape`` tree)."""
    return int(sum(math.prod(s) for s in _shapes(params_shape)))


def active_params(cfg, n_params: int) -> int:
    """MoE: subtract non-activated expert weight (top_k+shared of E)."""
    if cfg.moe is None:
        return n_params
    mc = cfg.moe
    per_expert = 3 * cfg.d_model * mc.d_expert
    n_moe_layers = cfg.num_layers - mc.first_dense
    routed_total = n_moe_layers * mc.num_experts * per_expert
    routed_active = n_moe_layers * mc.top_k * per_expert
    return n_params - routed_total + routed_active
