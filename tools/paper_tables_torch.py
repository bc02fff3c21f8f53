#!/usr/bin/env python3
"""Every LUNA-CIM table and figure from the port (one function each): the
counterpart of ``benchmarks/paper_tables.py``, the same functions, CSV
rows and assertions.

    python3 tools/paper_tables_torch.py                 # on the card
    PYTHONPATH=src python tools/paper_tables_torch.py --device cpu

Each function prints ``name,us_per_call,derived`` CSV rows (derived = the
paper-comparable quantity) and returns a dict for programmatic use; every
function takes the device (``ALL``'s uniform call), which only fig13 and
fig14 compute on.  Fig 13 runs the LUNA float GEMM on the device
(``core.quant.ste_luna_matmul``'s forward): on the card the hand-written
``luna_mm`` kernel (``kernels.luna_mm.ops.luna_matmul_f32_kernel``), on
the CPU its plain version (``core.quant.luna_matmul_f32``, JAX's library
path).  Times are
microseconds a call on that device, synchronised on the card; on the card
the script first prints the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them.  Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core import luna  # noqa: E402
from repro_torch.core.luna import LunaMode  # noqa: E402
from repro_torch.core.quant import ste_luna_matmul  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def _time(fn, *args, device="cpu", iters=5):
    """Microseconds a call of ``fn(*args)`` after one warm-up call, the
    card synchronised before and after the timed calls."""
    on_card = torch.device(device).type == "cuda"
    fn(*args)
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    if on_card:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def table1(device=None) -> dict:
    """Paper Table I: conventional-LUT storage/mux growth 3b..8b."""
    rows = {}
    for bits in range(3, 9):
        c = cm.conventional_cost(bits)
        rows[bits] = (c.srams, c.muxes)
        print(f"table1_{bits}b,0,srams={c.srams};muxes={c.muxes}")
    expected = {3: (48, 42), 4: (128, 120), 5: (320, 310), 6: (768, 756),
                7: (1792, 1778), 8: (4096, 4080)}
    assert rows == expected, rows
    return rows


def table2(device=None) -> dict:
    """Paper Table II: traditional vs optimized D&C for 4/8/16 b."""
    rows = {}
    for bits in (4, 8, 16):
        t = cm.conventional_cost(bits)
        o = cm.opt_dc_cost(bits)
        rows[bits] = {"trad": (t.srams, t.muxes),
                      "opt": (o.srams, o.muxes, o.has, o.fas)}
        print(f"table2_{bits}b,0,trad_srams={t.srams};opt_srams={o.srams};"
              f"opt_muxes={o.muxes};opt_has={o.has};opt_fas={o.fas}")
    assert rows[16]["opt"] == (136, 432, 31, 105)
    return rows


def fig5(device=None) -> dict:
    """LSB-side product distribution; P(0) = 0.296."""
    vals, probs, _ = luna.lsb_product_distribution()
    us = _time(lambda: luna.lsb_product_distribution.__wrapped__())
    print(f"fig5,{us:.1f},p_zero={probs[0]:.4f}")
    return {"p_zero": float(probs[0]),
            "impossible": luna.impossible_lsb_products()}


def fig6(device=None) -> dict:
    """Hamming-distance-optimal Z_LSB approx: argmin 0, HD 0.275."""
    cands, hd = luna.hamming_distance_profile()
    us = _time(luna.hamming_distance_profile)
    print(f"fig6,{us:.1f},argmin={int(np.argmin(hd))};min_hd={hd.min():.4f}")
    return {"argmin": int(np.argmin(hd)), "min_hd": float(hd.min())}


def fig8(device=None) -> dict:
    """ApproxD&C error histogram: range [0, 45]."""
    err = luna.error_table(LunaMode.APPROX_DC)
    hist = np.bincount(err.ravel(), minlength=46)
    print(f"fig8,0,err_min={err.min()};err_max={err.max()};"
          f"mae={np.abs(err).mean():.3f}")
    return {"min": int(err.min()), "max": int(err.max()), "hist": hist}


def fig12(device=None) -> dict:
    """ApproxD&C2 error histogram: range [-15, 30], balanced."""
    err = luna.error_table(LunaMode.APPROX_DC2)
    print(f"fig12,0,err_min={err.min()};err_max={err.max()};"
          f"mean={err.mean():.3f};mae={np.abs(err).mean():.3f}")
    return {"min": int(err.min()), "max": int(err.max()),
            "mean": float(err.mean())}


def fig13(device=None) -> dict:
    """NN-level MAE per multiplier mode (paper's MATLAB experiment).

    One small MLP regressor (JAX's weights: the same numpy draws) whose
    forward pass is evaluated with each multiplier mode on ``device``;
    MAE is vs the IDEAL (f32) forward, averaged over 100 random input
    batches — matching the paper's protocol.  The row's time is one
    forward of the last mode on the device.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    d_in, d_h, d_out = 16, 32, 4
    w1 = torch.as_tensor(rng.normal(size=(d_in, d_h)) * 0.5,
                         dtype=torch.float32, device=dev)
    w2 = torch.as_tensor(rng.normal(size=(d_h, d_out)) * 0.5,
                         dtype=torch.float32, device=dev)

    def fwd(x, mode):
        if mode == "ideal":
            h = torch.relu(x @ w1)
            return h @ w2
        # without autograd the STE is the LUNA forward: the luna_mm
        # kernel's route on the card, the plain version on the CPU
        h = torch.relu(ste_luna_matmul(x, w1, mode, 4))
        return ste_luna_matmul(h, w2, mode, 4)

    maes = {}
    us = 0.0
    for mode in ("ideal", LunaMode.OPT_DC, LunaMode.APPROX_DC2,
                 LunaMode.APPROX_DC):
        tot = 0.0
        for it in range(100):          # paper: 100 iterations
            x = torch.as_tensor(rng.normal(size=(8, d_in)),
                                dtype=torch.float32, device=dev)
            ref = fwd(x, "ideal")
            out = fwd(x, mode)
            tot += float((out - ref).abs().mean())
        maes[str(mode)] = tot / 100
        print(f"fig13_{mode},0,mae={maes[str(mode)]:.4f}")
        us = _time(fwd, x, mode, device=dev)
    print(f"fig13_forward,{us:.1f},device={dev.type}")
    assert maes["ideal"] == 0.0
    # paper ordering: exact D&C < ApproxD&C2 < ApproxD&C (balanced error wins)
    assert maes[str(LunaMode.OPT_DC)] <= maes[str(LunaMode.APPROX_DC)]
    return maes


def fig14(device=None) -> dict:
    """Transient-sim re-enactment: W=0110 fixed, Y in {1010,1011,0011,1100}."""
    dev = resolve_device(device)
    w = 0b0110
    outs = {}
    for y in (0b1010, 0b1011, 0b0011, 0b1100):
        z = int(luna.luna_product(
            torch.tensor(w, dtype=torch.int32, device=dev),
            torch.tensor(y, dtype=torch.int32, device=dev), 4,
            LunaMode.OPT_DC))
        outs[f"{y:04b}"] = f"{z:08b}"
        assert z == w * y
    print(f"fig14,0,{';'.join(f'Y={k}->OUT={v}' for k, v in outs.items())}")
    return outs


def fig15(device=None) -> dict:
    """Energy: multiplier = 47.96 fJ = 0.0276 % of SRAM write energy."""
    rep = cm.energy_report()
    print(f"fig15,0,mult_share={rep['multiplier_share']*100:.4f}%")
    return rep


def fig16(device=None) -> dict:
    """Area comparison across variants (transistor model); opt D&C ~3.7x."""
    rep = cm.area_report(4)
    ratio = rep["opt_dc"]["area_vs_conventional"]
    print(f"fig16,0,opt_dc_vs_conventional={ratio:.2f}x;"
          f"approx_dc={rep['approx_dc']['area_vs_conventional']:.2f}x")
    return rep


def fig18(device=None) -> dict:
    """Array overhead: 4 LUNA units on 8x8 SRAM = 32 %."""
    rep = cm.array_overhead(4)
    print(f"fig18,0,overhead={rep['overhead_fraction']*100:.1f}%")
    return rep


ALL = [table1, table2, fig5, fig6, fig8, fig12, fig13, fig14, fig15, fig16,
       fig18]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(f"# {card_line()}")
    return {fn.__name__: fn(dev) for fn in ALL}


if __name__ == "__main__":
    main()
