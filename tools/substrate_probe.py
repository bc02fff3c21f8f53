#!/usr/bin/env python3
"""The cache substrate's card checks alone, and paged against dense decode.

    python3 tools/substrate_probe.py            # phases 3d, 4 and 9
    python3 tools/substrate_probe.py --turns    # dense, paged, paged, dense

The first form runs ``chip_smoke.py``'s SSD scan checks (phase 3d, with
the resumed and warm-seeded pieces), its reduced card-against-CPU engines
on the cache substrate (phase 4) and phase 9 (yi-9b's phase 6a lut4 run,
the paged run and the shared-prefix run at full width, then mamba2's),
each with the checks and the output lines of ``chip_smoke.py``.  The
second serves phase 6's requests on yi-9b under lut4 at full width four
times on one card, on the dense slab and the paged pool in turns, each
run's decode tok/s and 4-tick profile on its own line, the paged tokens
held to the dense ones.  A card is needed; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path too)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", action="store_true",
                    help="only time dense and paged decode in turns")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("substrate_probe: torch.cuda.is_available() is false",
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
    if not args.turns:
        cs.ssd_kernel_phase(dev)
        cs.small_substrate_phase(dev)
    cfg, model, prompts = cs.build_model(dev, 48)
    if args.turns:
        dense = None
        for turn in ("dense", "paged", "paged", "dense"):
            if turn == "dense":
                _, outs, _ = cs.serve_once(dev, cfg, model, prompts, "lut4",
                                           "lut_gemm_dc")
                dense = outs
            else:
                _, outs, _, _ = cs.substrate_run(
                    dev, cfg, model, "lut4", "lut_gemm_dc",
                    dict(paged=True, block_size=16), [prompts],
                    "yi-9b paged")
                cs.check(outs == dense, "paged tokens differ from dense")
        return 0
    _, outs, _ = cs.serve_once(dev, cfg, model, prompts, "lut4",
                               "lut_gemm_dc")
    cs.substrate_phase(dev, cfg, model, prompts, outs)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, _ = cs.build_ssm_model(dev)
    cs.ssm_substrate_phase(dev, cfg, model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
