"""Serve a small model with batched requests through the port's
LUNA-quantized path (the counterpart of ``examples/serve_luna.py``).

The paper's CiM setting is inference: weights stationary in SRAM, inputs
streamed through the LUT multipliers.  The serving engine is the system
analogue — weights resident, requests streamed through batched prefill and
mixed-depth continuous-batching decode with every projection in the chosen
LUNA mode.  This example also shows the request lifecycle: one request is
streamed token by token through its ``RequestHandle``, and the stream
must equal its output.

``--quant`` is the shared flag registered by ``EngineConfig.add_cli_args``:
``lut4``/``int4`` freeze 4-bit affine decode weights on the engine (on the
card the D&C sub-table LUT GEMM kernel), ``nf4``/``nf4p`` non-affine NF4
weights (D&C + full or pruned residual correction); any other spelling
(``luna_*``, ``int8``, ``lut_nf4``, ``bf16``) is a model-level
``QuantConfig`` mode applied dynamically to every projection.

Run:  PYTHONPATH=src python examples/serve_luna_torch.py --device cpu \\
          --quant luna_approx2 --sampling top_k --top-k 20
      PYTHONPATH=src python examples/serve_luna_torch.py --device cpu --quant nf4p \\
          --spec self_lut
      python examples/serve_luna_torch.py --quant lut4     # on the card
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402
from repro_torch.serve.config import EngineConfig, model_quant  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    EngineConfig.add_cli_args(ap)
    ap.set_defaults(max_batch=4, max_seq=96, quant="luna_approx")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("yi-9b").reduced()
    qcfg = model_quant(args.quant)
    if qcfg is not None:
        from dataclasses import replace
        cfg = replace(cfg, quant=qcfg)
    model = get_model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(0))
    engine = Engine(cfg, model, EngineConfig.from_args(args), device=device)

    rng = np.random.default_rng(0)
    # deliberately mixed prompt lengths: the engine buckets them for prefill
    # and decodes them at per-slot positions on one slab
    reqs = [Request(rid=i,
                    prompt=rng.integers(
                        1, cfg.vocab_size, int(rng.integers(3, 9))).tolist(),
                    max_new=args.max_new,
                    priority=1 if i == 0 else 0)
            for i in range(args.requests)]
    stats = engine.serve(reqs)
    print(f"served {len(reqs)} requests in {stats['ticks']} ticks "
          f"({stats['wall_s']:.1f}s wall on {device}, quant={args.quant}, "
          f"sampling={args.sampling})")
    print(f"  prefill {stats['prefill_tok_s']:.0f} tok/s over "
          f"{stats['prefill_calls']} bucket calls | decode "
          f"{stats['decode_tok_s']:.0f} tok/s | slot occupancy "
          f"{stats['occupancy']:.0%}")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt {r.prompt} -> {r.out}")
    assert stats["done"]

    # the request lifecycle: stream one more request off its handle
    handle = engine.submit(Request(
        rid=99, prompt=rng.integers(1, cfg.vocab_size, 5).tolist(),
        max_new=6, priority=1))
    streamed = list(handle.tokens())
    print(f"  streamed req 99: {streamed}")
    assert streamed == handle.out
    return {"outs": [r.out for r in reqs], "streamed": streamed,
            "stats": stats}


if __name__ == "__main__":
    main()
