"""Perf hillclimb driver over the port's dry run (mirrors
``repro.launch.hillclimb``): run a named variant of a cell and record its
roofline into ``results_torch/perf/<cell>__<variant>.json``.

Usage (the CPU, no card):
  python -m repro_torch.launch.hillclimb --arch yi-9b --shape decode_32k \\
      --variant sharded_decode
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import cell_tag, run_cell

RESULTS = Path(__file__).resolve().parents[3] / "results_torch" / "perf"

# variant name -> cfg overrides (JAX's, each a field of the port's
# ModelConfig)
VARIANTS = {
    "baseline": {},
    # decode: flash-decode over the model group
    "sharded_decode": {"decode_attn": "sharded"},
    # + TP-only param sharding (no FSDP weight all-gathers per token)
    "sharded_decode+tp": {"decode_attn": "sharded",
                          "serve_param_sharding": "tp"},
    # + grouped cache-dtype flash-decode operands
    "sharded_decode+tp+bf16": {"decode_attn": "sharded",
                               "serve_param_sharding": "tp",
                               "decode_attn_precision": "bf16_grouped"},
    # train/prefill: bf16 attention operands (halves attention HBM bytes)
    "bf16_attn": {"attn_f32": False},
    # remat policy: save matmul outputs instead of recomputing everything
    "save_dots": {"remat_policy": "dots"},
    # larger attention chunk (fewer chunk-loop iterations, bigger tiles)
    "chunk_1024": {"attn_chunk": 1024},
    "chunk_2048": {"attn_chunk": 2048},
    # combined winners
    "bf16_attn+save_dots": {"attn_f32": False, "remat_policy": "dots"},
    "bf16_attn+chunk_2048": {"attn_f32": False, "attn_chunk": 2048},
    # fused scale+mask (one where() vs mul + broadcast-bias add)
    "fused_mask": {"attn_fused_mask": True},
    # causal chunks attend only to keys <= the chunk's end
    "causal_skip": {"attn_fused_mask": True, "attn_causal_skip": True},
    "causal_skip+save_dots": {"attn_fused_mask": True,
                              "attn_causal_skip": True,
                              "remat_policy": "dots"},
    "causal_skip+bf16": {"attn_fused_mask": True, "attn_causal_skip": True,
                         "attn_f32": False},
    "sharded_decode+bf16_attn": {"decode_attn": "sharded", "attn_f32": False},
}


def run_variant(arch: str, shape: str, variant: str, multi_pod: bool = False,
                quant: str = "bf16", out_dir: Path = RESULTS) -> dict:
    rec = run_cell(arch, shape, multi_pod, quant=quant,
                   extra_cfg=dict(VARIANTS[variant]))
    rec["variant"] = variant
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{cell_tag(arch, shape, multi_pod, 'bf16')}__{variant}"
    if quant != "bf16":
        tag += f"__{quant}"
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True, choices=sorted(VARIANTS))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--quant", default="bf16")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)
    rec = run_variant(args.arch, args.shape, args.variant, args.multipod,
                      args.quant, Path(args.out))
    if rec["status"] != "ok":
        print(rec["status"].upper(), rec.get("reason", rec.get("error", ""))
              [:500])
        return 0 if rec["status"] == "skip" else 1
    print(json.dumps({k: rec[k] for k in
                      ("variant", "compute_s", "memory_s", "collective_s",
                       "dominant", "roofline_fraction")}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
