#!/usr/bin/env python3
"""The moe family's and the rest of the dense family's card checks alone.

    python3 tools/moe_probe.py            # phases 3a, 4 (moe part) and 11
    python3 tools/moe_probe.py --no-3a    # without phase 3a's kernel checks

Runs ``chip_smoke.py``'s D&C LUT kernel checks (phase 3a, deepseek-v2-
lite-16b's and minitron-4b's projection shapes among them, at decode's
M = 8 and verify's M = 40), its reduced starcoder2-15b, minitron-4b,
deepseek-67b, deepseek-v2-lite-16b and deepseek-v2-236b models and
deepseek-v2-lite engines card against CPU (phase 4's part for them), then
phase 11 at full width: deepseek-v2-lite-16b on the slab under bf16,
lut4 and nf4p with a 4-tick lut4 profile (11a), on the paged pool and
with the prefix cache (11b), under self_lut (11c), and minitron-4b under
lut4 (11d); each with the checks and output lines of ``chip_smoke.py``.
A card is needed; imports nothing of JAX.
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
        print("moe_probe: torch.cuda.is_available() is false",
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
    cs.small_moe_phase(dev)
    launches, tc, _ = cs.moe_phase(dev)
    cs.emit({"phase11_launches": launches, "launches_tc": tc})
    return 0


if __name__ == "__main__":
    sys.exit(main())
