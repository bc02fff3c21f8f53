#!/usr/bin/env python3
"""The hybrid family's card checks alone.

    python3 tools/hybrid_probe.py            # phases 3a, 3d, 4 (hybrid), 12
    python3 tools/hybrid_probe.py --no-3a    # without phase 3a's checks

Runs ``chip_smoke.py``'s D&C LUT kernel checks (phase 3a, zamba2-1.2b's
five projection shapes among them, at decode's M = 8 and verify's M =
40), its ``ssd_scan`` checks (phase 3d, zamba2's state dim 64 among
them), its reduced zamba2 card against CPU (phase 4's hybrid part: logits
and engines on the slab and the split substrate, self_lut), then phase 12
at full width: zamba2-1.2b on the slab under bf16, lut4 and nf4p with a
4-tick lut4 profile and the 8-prompt prefill's (12a), on the split
substrate and with the prefix cache (12b), under self_lut on both
substrates (12c); each with the checks and output lines of
``chip_smoke.py``.  A card is needed; imports nothing of JAX.
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
    ap.add_argument("--no-3a", dest="phase_3a", action="store_false",
                    help="leave out phase 3a's kernel checks")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("hybrid_probe: torch.cuda.is_available() is false",
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
    if args.phase_3a:
        cs.kernel_phase(dev)
    cs.ssd_kernel_phase(dev)
    cs.small_hybrid_phase(dev)
    launches, tc = cs.hybrid_phase(dev)
    cs.emit({"phase12_launches": launches, "launches_tc": tc})
    return 0


if __name__ == "__main__":
    sys.exit(main())
