"""Quickstart on the port: the LUNA-CIM technique end to end.

The counterpart of ``examples/quickstart.py``:

1. the paper's multiplier variants on raw 4-bit codes (incl. the Fig 14
   transient-sim re-enactment: W=0110 x Y sequence);
2. hardware cost/energy/area model (Tables I/II, Figs 15/16/18);
3. a real matmul through the LUNA GEMM: on the card the hand-written
   ``luna_mm`` kernel, on the CPU its plain version;
4. a LUNA-quantized transformer (model-level ``QuantConfig``: dynamic
   quantization of every projection), its loss;
5. the serving engine with ``EngineConfig(quant="lut4")`` — 4-bit decode
   weights through the paper's D&C sub-table LUT GEMM (``lut_gemm_dc``'s
   kernel on the card).

Run:  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
      python examples/quickstart_torch.py             # on the card
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core.layers import QuantConfig  # noqa: E402
from repro_torch.core.luna import LunaMode, luna_product  # noqa: E402
from repro_torch.core.quant import ste_luna_matmul  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}

    print("=" * 66)
    print("1. LUNA multiplier variants (paper Figs 1-10)")
    print("=" * 66)
    w, y = 0b0110, 0b1011            # 6 x 11
    for mode in LunaMode:
        z = int(luna_product(torch.tensor(w, device=dev),
                             torch.tensor(y, device=dev), 4, mode))
        tag = "exact" if LunaMode(mode).is_exact else f"err={w*y-z:+d}"
        print(f"  {mode.value:>14}: {w} x {y} = {z:3d}  ({tag})")

    print("\n  Fig 14 re-enactment: W=0110 fixed, Y applied sequentially")
    for y_seq in (0b1010, 0b1011, 0b0011, 0b1100):
        z = int(luna_product(torch.tensor(w, device=dev),
                             torch.tensor(y_seq, device=dev), 4,
                             LunaMode.OPT_DC))
        print(f"    Y={y_seq:04b} -> OUT={z:08b} ({z})")

    print()
    print("=" * 66)
    print("2. Hardware cost model (Tables I/II, Figs 15/16/18)")
    print("=" * 66)
    for bits in (4, 8, 16):
        conv = cm.conventional_cost(bits)
        opt = cm.opt_dc_cost(bits)
        print(f"  {bits:2d}b: conventional {conv.srams:>8} SRAMs -> "
              f"optimized D&C {opt.srams:>4} SRAMs "
              f"({conv.srams / opt.srams:.0f}x less storage)")
    area = cm.area_report(4)
    print(f"  area: optimized D&C is "
          f"{area['opt_dc']['area_vs_conventional']:.1f}x smaller "
          "(paper: ~3.7x)")
    en = cm.energy_report()
    print(f"  energy: multiplier = {en['mux_multiplier_J']*1e15:.2f} fJ "
          f"= {en['multiplier_share']*100:.4f}% of SRAM write "
          "(paper: 0.0276%)")
    print(f"  array overhead: "
          f"{cm.array_overhead(4)['overhead_fraction']*100:.0f}%"
          " (paper: 32%)")

    print()
    print("=" * 66)
    where = ("the luna_mm kernel" if dev.type == "cuda"
             else "the LUNA GEMM's plain version")
    print(f"3. Float matmul through {where} ({dev})")
    print("=" * 66)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(8, 64)), dtype=torch.float32,
                        device=dev)
    wm = torch.as_tensor(rng.normal(size=(64, 16)), dtype=torch.float32,
                         device=dev)
    ref = x @ wm
    out["rel_err"] = {}
    for mode in ("opt_dc", "approx_dc", "approx_dc2"):
        # without autograd the STE is the LUNA forward alone
        got = ste_luna_matmul(x, wm, mode)
        rel = float((got - ref).abs().mean() / ref.abs().mean())
        out["rel_err"][mode] = rel
        print(f"  {mode:>10}: mean rel err vs f32 = {rel:.4f}")

    print()
    print("=" * 66)
    print("4. A transformer under LUNA quantization (reduced yi-9b)")
    print("=" * 66)
    from repro_torch.models.registry import get_config, get_model

    out["loss"] = {}
    for mode in ("bf16", "luna_dc", "luna_approx"):
        cfg = get_config("yi-9b").reduced(quant=QuantConfig(mode=mode))
        model = get_model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(0))
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 32)),
                               device=dev)
        with torch.no_grad():
            loss, _ = model.loss({"tokens": toks, "labels": toks})
        out["loss"][mode] = float(loss)
        print(f"  quant={mode:>12}: loss {float(loss):.4f}")

    print()
    print("=" * 66)
    print('5. Serving with EngineConfig(quant="lut4"): 4-bit decode weights')
    print("=" * 66)
    from repro_torch.serve.config import EngineConfig
    from repro_torch.serve.engine import Engine, Request

    cfg = get_config("yi-9b").reduced(dtype="float32")
    model = get_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    out["outputs"] = {}
    for quant in (None, "lut4"):
        engine = Engine(cfg, model,
                        EngineConfig(max_batch=2, max_seq=48, quant=quant),
                        device=dev)
        reqs = [Request(rid=i,
                        prompt=rng.integers(1, cfg.vocab_size, 5).tolist(),
                        max_new=6)
                for i in range(2)]
        stats = engine.serve(reqs)
        assert stats["done"]
        out["outputs"][quant] = [r.out for r in reqs]
        print(f"  quant={str(quant):>5}: {stats['decode_tokens']} decode "
              f"tok, outputs {[r.out[:3] for r in reqs]}")
    print("\nDone.")
    return out


if __name__ == "__main__":
    main()
