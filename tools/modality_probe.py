#!/usr/bin/env python3
"""The encdec and vlm families' card checks alone.

    python3 tools/modality_probe.py           # phase 4's part, phase 14
    python3 tools/modality_probe.py --no-4    # phase 14 alone

Runs ``chip_smoke.py``'s reduced f32 card-against-CPU checks of
whisper-base and llava-next-mistral-7b (phase 4's part: loss, every
gradient, one train step, prefill and decode logits), then phase 14 at
the published widths: whisper-base served in bf16 and under lut_nf4
(lut_gemm on its tensor-core and wgmma kernels) and trained (QAT on
luna_mm), llava-next-mistral-7b served at its 32 layers, its flash eval
(flash_attention's tensor-core kernel) and training at depth 8, each
with the checks and output lines of ``chip_smoke.py``.  A card is
needed; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path too)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--no-4", dest="phase_4", action="store_false",
                    help="leave out phase 4's reduced card-vs-CPU checks")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("modality_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    cs.emit({"nvidia_smi": smi.stdout.strip().splitlines()[0]})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    from repro_torch.kernels import _build
    _build.build_all()
    if args.phase_4:
        from repro_torch.train import card_vs_cpu as cc
        cs.emit({"small_reference": "reduced f32 whisper-base and llava, "
                                    "card vs cpu",
                 "max_err": {a: cc.modality_card_vs_cpu(dev, a)
                             for a in cc.MODALITY_ARCHS}})
    launches, tc = cs.modality_phase(dev)
    cs.emit({"phase14_launches": launches, "launches_tc": tc})
    return 0


if __name__ == "__main__":
    sys.exit(main())
