"""Paper Fig 13 end-to-end on the port: train MLPs whose forward pass uses
each LUNA multiplier mode (QAT via the STE, ``ste_luna_matmul``) and
compare final task MAE — the paper's "separate neural networks for each
method" experiment.  The counterpart of ``examples/fig13_nn_accuracy.py``,
with its constants and assertions.

Extended with the serving-side PTQ columns: the f32-trained ("ideal") net
re-evaluated with its weights frozen to 4-bit ``QuantizedWeight`` leaves
through ``kernels.lut_gemm.ops.quantized_matmul`` — exactly what
``EngineConfig(quant=...)`` does to decode projections.

* affine pair (``lut4`` vs ``int4``): both reconstruct the same uniform
  grid, so their MAE is identical; documented bound ``MAE(ptq) <=
  PTQ_MAE_BOUND * MAE(ideal)``.
* non-affine pair (``nf4`` vs the direct full-table NF4 dequant oracle):
  ``|MAE(nf4) - MAE(nf4_direct)| <= NF4_DC_VS_DIRECT_TOL``.
* pruned residual (``nf4p``): ``MAE(nf4p) <= MAE(nf4) +
  NF4P_MAE_DELTA_BOUND``; the residual-table bytes saved are reported.

On the card (the default device) the QAT forward runs the ``luna_mm``
kernel (``__dp4a``: K = 8 and N = 1 are off the tensor-core route),
``lut4`` the ``lut_gemm_dc`` kernel and ``nf4``/``nf4p``
``lut_gemm_dc_res`` (f32 x: ``lut_gemm.cu``), while ``int4`` and the
direct NF4 oracle are cuBLAS f32 products of the dequantized weight.
The two affine MAEs still come out equal there (K = 8 and 16: the sums
are short; checked on an H100 by ``chip_smoke.py`` phase 15c), so the
equality is asserted on every device, as JAX asserts it.

The initial weights are drawn from ``torch.Generator`` seed 0 (JAX's come
from ``PRNGKey(0)``; ``train_one(init=...)`` takes any numpy start, and
the tests carry JAX's across).

Run:  PYTHONPATH=src python examples/fig13_nn_accuracy_torch.py --device cpu
      python examples/fig13_nn_accuracy_torch.py        # on the card
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.lut import (NF4_CODEBOOK, dc_decompose_codebook,  # noqa: E402
                                  prune_residual, residual_table_bytes)
from repro_torch.core.quant import (NF4P_PRUNE_THRESHOLD,  # noqa: E402
                                    quantize_weight, ste_luna_matmul)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.lut_gemm.ops import quantized_matmul  # noqa: E402

MODES = ["ideal", "opt_dc", "approx_dc2", "approx_dc"]

#: documented PTQ accuracy bound: frozen-4-bit MAE vs the f32-trained MAE
PTQ_MAE_BOUND = 1.25

#: documented bound: residual-corrected D&C NF4 vs direct full-table NF4
#: dequant — the correction is exact up to float rounding, so the two MAEs
#: may differ only by accumulation noise.
NF4_DC_VS_DIRECT_TOL = 1e-4

#: documented bound on the MAE cost of pruning the NF4 residual sub-table
#: at ``NF4P_PRUNE_THRESHOLD`` (absolute MAE delta vs unpruned nf4).
NF4P_MAE_DELTA_BOUND = 0.05

def make_data(n=512, d=8, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w_true = rng.normal(size=(d, 1)).astype(np.float32)
    y = np.tanh(x @ w_true) + 0.05 * rng.normal(size=(n, 1))
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(y.astype(np.float32)).to(device))


def init_params(seed=0) -> dict:
    """The port's own start: N(0, 0.3^2) weights from ``torch.Generator``
    ``seed``, zero biases (JAX's shapes)."""
    gen = torch.Generator().manual_seed(seed)
    return {"w1": (torch.randn((8, 16), generator=gen) * 0.3).numpy(),
            "b1": np.zeros((16,), np.float32),
            "w2": (torch.randn((16, 1), generator=gen) * 0.3).numpy(),
            "b2": np.zeros((1,), np.float32)}


def mlp_fwd(params, x, mode):
    mm = ((lambda a, b: a @ b) if mode == "ideal"
          else (lambda a, b: ste_luna_matmul(a, b, mode, 4)))
    h = torch.tanh(mm(x, params["w1"]) + params["b1"])
    return mm(h, params["w2"]) + params["b2"]


def loss_and_grads(params, x, y, mode):
    """JAX's ``loss_fn`` and its gradients: (loss, {name: grad})."""
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = torch.mean((mlp_fwd(p, x, mode) - y) ** 2)
    grads = torch.autograd.grad(loss, list(p.values()))
    return loss.detach(), dict(zip(p, grads))


def train_one(mode, steps=300, lr=3e-2, device="cpu", init=None):
    """Plain gradient descent on the MSE (JAX's ``train_one``) from
    ``init`` (numpy arrays; default :func:`init_params`).  Returns (final
    MAE, params)."""
    x, y = make_data(device=device)
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
              for k, v in (init or init_params()).items()}
    for _ in range(steps):
        _, g = loss_and_grads(params, x, y, mode)
        params = {k: params[k] - lr * g[k] for k in params}
    with torch.no_grad():
        mae = float(torch.abs(mlp_fwd(params, x, mode) - y).mean())
    return mae, params


def ptq_mae(params, kernel="lut_dc", prune_threshold=None, device="cpu"):
    """MAE of the f32-trained net with weights frozen to 4-bit codes —
    the serving engine's ``quant="lut4"|"int4"|"nf4"|"nf4p"`` transform."""
    x, y = make_data(device=device)
    q1 = quantize_weight(params["w1"], kernel, prune_threshold)
    q2 = quantize_weight(params["w2"], kernel, prune_threshold)
    with torch.no_grad():
        h = torch.tanh(quantized_matmul(x, q1) + params["b1"])
        out = quantized_matmul(h, q2) + params["b2"]
    return float(torch.abs(out - y).mean())


def nf4p_table_report(threshold=NF4P_PRUNE_THRESHOLD):
    """Residual sub-table cost: dense (16,) f32 vs pruned sparse storage."""
    _, _, residual = dc_decompose_codebook(NF4_CODEBOOK)
    kept_idx, _ = prune_residual(residual, threshold)
    dense, pruned = residual_table_bytes(int(kept_idx.shape[0]))
    return {"kept": int(kept_idx.shape[0]), "dense_bytes": dense,
            "pruned_bytes": pruned, "bytes_saved": dense - pruned}


def main(argv=None, init=None):
    """Train, evaluate and assert the bounds; returns the results.
    ``init``: every mode's starting weights (numpy; default
    :func:`init_params`)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"mode,final_MAE  (paper Fig 13: exact < ApproxD&C2 < ApproxD&C)"
          f"  [{device}]")
    results = {}
    trained = {}
    for mode in MODES:
        mae, params = train_one(mode, device=device, init=init)
        results[mode] = mae
        trained[mode] = params
        print(f"  {mode:>10}: MAE {mae:.4f}")
    ptq = (("lut_dc", None, "ptq_lut4"), ("dequant", None, "ptq_int4"),
           ("nf4_dc", None, "ptq_nf4"),
           ("nf4_dequant", None, "ptq_nf4_direct"),
           ("nf4_dc", NF4P_PRUNE_THRESHOLD, "ptq_nf4p"))
    for kernel, prune, label in ptq:
        results[label] = ptq_mae(trained["ideal"], kernel, prune, device)
        print(f"  {label:>14}: MAE {results[label]:.4f}")
    tab = nf4p_table_report()
    print(f"  nf4p residual table: kept {tab['kept']}/16 entries, "
          f"{tab['pruned_bytes']}B vs {tab['dense_bytes']}B dense "
          f"({tab['bytes_saved']}B saved)")
    assert results["ideal"] <= results["approx_dc"] * 1.2
    assert results["ptq_lut4"] <= results["ideal"] * PTQ_MAE_BOUND, \
        (results["ptq_lut4"], results["ideal"])
    assert results["ptq_lut4"] == results["ptq_int4"]   # same affine grid
    # non-affine: residual-corrected D&C matches direct dequant up to
    # float rounding; pruning costs a bounded MAE delta and saves bytes
    assert abs(results["ptq_nf4"] - results["ptq_nf4_direct"]) \
        <= NF4_DC_VS_DIRECT_TOL, \
        (results["ptq_nf4"], results["ptq_nf4_direct"])
    assert results["ptq_nf4p"] <= results["ptq_nf4"] + NF4P_MAE_DELTA_BOUND, \
        (results["ptq_nf4p"], results["ptq_nf4"])
    assert tab["bytes_saved"] > 0
    results["nf4p_table"] = tab
    return results


if __name__ == "__main__":
    main()
