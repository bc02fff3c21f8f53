"""Train a small LM with the port's stack: the train step (remat, AdamW
with f32 moments), checkpoints and the restart-safe ``Trainer`` loop
(the counterpart of ``examples/train_lm.py``), optionally quantized:
``--quant`` takes every model-level mode — ``luna_*`` makes every
projection run the paper's integer D&C path in the forward (the STE
backward), ``int8``, ``int4_dequant`` and ``lut_nf4`` train with
``jax.grad``'s gradients of JAX's modes (on the card ``lut_nf4``'s
backward is the LUT GEMM kernel over the transposed codes).

``--grad-compression`` sends every gradient through the int8 round trip
before AdamW, as JAX's example does.  ``--host-devices N`` trains on N
local gloo ranks on the CPU over a ("data", "model") mesh with
``--model-parallel`` ranks on its model axis (JAX's example forces 4 host
devices and a model axis of 2: ``--host-devices 4 --model-parallel 2``),
through the train CLI's ``launch.train.in_world`` and ``fit``; the
default trains on one device.

Run:  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20
      PYTHONPATH=src python examples/train_lm_torch.py --device cpu \\
          --steps 10 --quant lut_nf4
      PYTHONPATH=src python examples/train_lm_torch.py --device cpu \\
          --steps 20 --host-devices 4 --model-parallel 2
      python examples/train_lm_torch.py --steps 200       # on the card
(kill it mid-run and re-run: it resumes from the last checkpoint.)
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.layers import QuantConfig  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.launch.train import fit, in_world  # noqa: E402
from repro_torch.train.trainer import TrainerConfig  # noqa: E402


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--quant", default="bf16")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--host-devices", type=int, default=0,
                    help="train on N local gloo ranks on the CPU")
    ap.add_argument("--grad-compression", action="store_true")
    args = ap.parse_args(argv)

    cfg = ModelConfig(
        name="demo-lm", family="dense", num_layers=args.layers,
        d_model=args.d_model, num_heads=8, num_kv_heads=4,
        d_ff=4 * args.d_model, vocab_size=2048, head_dim=args.d_model // 8,
        mlp_type="swiglu", dtype="float32",
        quant=QuantConfig(mode=args.quant), attn_impl="full")
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=25,
                         ckpt_dir=args.ckpt_dir, log_every=10, lr=1e-3,
                         warmup=min(20, max(1, args.steps // 2)),
                         microbatch=args.microbatch,
                         grad_compression=args.grad_compression)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0)
    hist, events, where = in_world(
        fit, cfg, tcfg, data, args.model_parallel, args.device,
        host_devices=args.host_devices, device=args.device)
    print(f"first-10 mean loss {sum(hist[:10])/max(len(hist[:10]),1):.4f} -> "
          f"last-10 mean loss {sum(hist[-10:])/max(len(hist[-10:]),1):.4f}"
          f"  ({args.quant}, {where})")
    if events:
        print(f"straggler events at steps: {events}")
    return hist


if __name__ == "__main__":
    main()
