#!/usr/bin/env python3
"""Speculative decoding and the request lifecycle's card checks alone.

    python3 tools/spec_probe.py            # phases 3a, 3d, 4 (spec) and 10
    python3 tools/spec_probe.py --no-3a    # without phase 3a's kernel checks

Runs ``chip_smoke.py``'s D&C LUT kernel checks (phase 3a, verify's M = 40
among them), its SSD scan checks (phase 3d, with the speculation windows
of B = 8, S = 5, fully masked rows included), its reduced speculative
engines card against CPU (phase 4's spec part), then phase 10 at full
width: yi-9b's phase 6a lut4 run (10c's reference), 10a (its own plain
run on 24 layers, then self_lut and ngram), 10c (the background loop
with a cancel and a preempt), mamba2's phase 7 nf4p run (logits
recorded) and 10b (self_lut); each with the checks and output lines of
``chip_smoke.py``.  A card is needed; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
import os
import subprocess
import sys
import time

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
        print("spec_probe: torch.cuda.is_available() is false",
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
        cs.emit({"phase_3a": {k: v.get("verify_m40") for k, v in
                              cs.kernel_phase(dev).items()}})
    cs.ssd_kernel_phase(dev)
    cs.small_spec_phase(dev)
    t0 = time.perf_counter()
    cfg, model, prompts = cs.build_model(dev, 48)
    _, outs, _, _ = cs.serve_once(dev, cfg, model, prompts, "lut4",
                                  "lut_gemm_dc", profile=False)
    t1 = time.perf_counter()
    cs.spec_phase(dev, cfg, model, prompts)
    cs.loop_phase(dev, cfg, model, prompts, outs)
    t2 = time.perf_counter()
    del model, plain
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, prompts = cs.build_ssm_model(dev)
    _, outs, _, plain = cs.serve_once(dev, cfg, model, prompts, "nf4p",
                                      "lut_gemm_dc_res", record=True,
                                      profile=False)
    t3 = time.perf_counter()
    cs.ssm_spec_phase(dev, cfg, model, prompts, outs, plain)
    cs.emit({"phase10_s": (t2 - t1) + (time.perf_counter() - t3),
             "references_s": (t1 - t0) + (t3 - t2)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
