"""Exact cost accounting via layer-count probes (mirrors
``repro.launch.accounting``).

The dry run (:mod:`repro_torch.launch.dryrun`) counts a step of a shallow
probe of the model (1, 2, ... layers) and solves the linear system

    metric(probe_i) = sum_c counts_i[c] * cost[c]

for the per-component costs, then extrapolates to the full layer stack.
The port always unrolls its layers in Python, so JAX's ``scan_layers``
override has no counterpart here; the probes exist because a full-depth
step is counted layer by layer, and a probe's few layers are enough to
fix the per-layer arithmetic.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import EncDecConfig
from repro_torch.launch.cost import COLLECTIVES

METRICS = ("flops", "bytes", "collective_bytes",
           *(f"coll_{k}" for k in COLLECTIVES),
           *(f"n_{k}" for k in COLLECTIVES), "saved_bytes")


def probe_plan(cfg, kind: str):
    """Returns (probes, full_counts): probes = [(cfg_overrides, counts)]
    (JAX's probes and counts, less its ``scan_layers`` override)."""
    fam = cfg.family
    L = cfg.num_layers
    if fam in ("dense", "ssm", "vlm"):
        probes = [({"num_layers": 1}, {"base": 1, "layer": 1}),
                  ({"num_layers": 2}, {"base": 1, "layer": 2})]
        full = {"base": 1, "layer": L}
    elif fam == "moe":
        nd = cfg.moe.first_dense
        probes = [({"num_layers": nd + 1}, {"base": 1, "moe": 1}),
                  ({"num_layers": nd + 2}, {"base": 1, "moe": 2})]
        full = {"base": 1, "moe": L - nd}
    elif fam == "hybrid":
        per = cfg.hybrid.period
        # L=1/L=per isolate the mamba marginal; L=per+1 adds a 2nd shared-
        # attention application
        probes = [
            ({"num_layers": 1}, {"base": 1, "attn": 1, "mamba": 1}),
            ({"num_layers": per}, {"base": 1, "attn": 1, "mamba": per}),
            ({"num_layers": per + 1}, {"base": 1, "attn": 2,
                                       "mamba": per + 1}),
        ]
        n_groups = (L + per - 1) // per
        full = {"base": 1, "attn": n_groups, "mamba": L}
    elif fam == "encdec":
        es = cfg.encdec.enc_seq
        if kind == "decode":
            probes = [({"num_layers": 1}, {"base": 1, "dec": 1}),
                      ({"num_layers": 2}, {"base": 1, "dec": 2})]
            full = {"base": 1, "dec": L}
        else:
            probes = [
                ({"num_layers": 1,
                  "encdec": EncDecConfig(1, es)}, {"base": 1, "enc": 1,
                                                   "dec": 1}),
                ({"num_layers": 1,
                  "encdec": EncDecConfig(2, es)}, {"base": 1, "enc": 2,
                                                   "dec": 1}),
                ({"num_layers": 2,
                  "encdec": EncDecConfig(1, es)}, {"base": 1, "enc": 1,
                                                   "dec": 2}),
            ]
            full = {"base": 1, "enc": cfg.encdec.enc_layers, "dec": L}
    else:
        raise ValueError(fam)
    return probes, full


def _metrics_of(rec: dict) -> np.ndarray:
    return np.array([float(rec.get(m, 0.0)) for m in METRICS])


def extrapolate(probe_recs: list[dict], probes, full_counts) -> dict:
    """The full stack's :data:`METRICS` from the probes' records (each a
    dict with those keys; a missing key counts 0), by JAX's least-squares
    solve, with its ``probe_residual``."""
    comps = sorted({c for _, counts in probes for c in counts})
    A = np.array([[counts.get(c, 0) for c in comps] for _, counts in probes],
                 dtype=np.float64)
    F = np.stack([_metrics_of(r) for r in probe_recs])       # (P, M)
    X, *_ = np.linalg.lstsq(A, F, rcond=None)                # (C, M)
    fvec = np.array([full_counts.get(c, 0) for c in comps], np.float64)
    total = fvec @ X                                         # (M,)
    total = np.maximum(total, 0.0)
    out = dict(zip(METRICS, total.tolist()))
    out["probe_residual"] = float(np.abs(A @ X - F).max() /
                                  (np.abs(F).max() + 1e-9))
    return out
