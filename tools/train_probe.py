#!/usr/bin/env python3
"""The training slice's card checks alone.

    python3 tools/train_probe.py             # phases 3f, 4 (training), 13
    python3 tools/train_probe.py --no-13     # without phase 13

Runs ``chip_smoke.py``'s SSD backward checks (phase 3f: ``ssd_scan_bwd``
against autograd of the plain scan at the training shape of mamba2-1.3b
and zamba2-1.2b and a ragged masked call, two calls bitwise equal, times
beside the bound), its reduced training card against CPU (phase 4's
training part: yi-9b, mamba2, zamba2, one Mamba2 layer), then phase 13 at
full width: mamba2-1.3b (the gradient check, 4 bf16 steps, 2 QAT steps),
zamba2-1.2b and deepseek-v2-lite-16b (depth 3) at B 2 x S 4096, each with
the checks and output lines of ``chip_smoke.py``.  A card is needed;
imports nothing of JAX.
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
    ap.add_argument("--no-13", dest="phase_13", action="store_false",
                    help="leave out phase 13's full-width training")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_probe: torch.cuda.is_available() is false",
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
    kernels = cs.ssd_bwd_kernel_phase(dev)
    cs.small_training_phase(dev)
    if args.phase_13:
        launches, luna_tc = cs.family_train_phase(dev)
        cs.emit({"phase13_launches": launches, "luna_mm_launches_tc":
                 luna_tc, "ssd_scan_bwd": {
                     k: v for k, v in kernels["ssd_scan_bwd"].items()
                     if k != "per_shape"}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
