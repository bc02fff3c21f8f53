"""Training CLI of the port (mirrors ``repro.launch.train``).

  # reduced yi-9b (the default), on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 5

  # the paper's QAT path: every projection through ste_luna_matmul
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 5 --quant luna_approx     # or int8, int4_dequant, lut_nf4

  # the ssm, hybrid and moe families (reduced widths), on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 5 --arch mamba2-1.3b     # or zamba2-1.2b, deepseek-v2-lite-16b

  # on the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.train --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
      --no-reduced --seq 4096 --batch 2 --steps 4

``--reduced`` (the default) trains the smoke-test widths; ``--no-reduced``
the published ones.  ``--arch`` is any config of the dense (``yi-9b``,
``starcoder2-15b``, ``minitron-4b``, ``deepseek-67b``), moe
(``deepseek-v2-lite-16b``, ``deepseek-v2-236b``), ssm (``mamba2-1.3b``)
or hybrid (``zamba2-1.2b``) family, or ``luna-mlp`` (the paper's Fig 13
network); on the card the Mamba2 layers' SSD scan runs forward and
backward on the hand-written kernels.  The encdec (``whisper-base``) and
vlm (``llava-next-mistral-7b``) archs fail here with ``KeyError``, as
JAX's CLI does: ``SyntheticLM``'s batches carry no frames or patches
(the ``Trainer`` trains them on a stream that does).  ``--quant`` takes
every model-level mode (``core.layers.QUANT_MODES``: ``bf16``, ``int8``,
``int4_dequant``, ``lut_nf4`` and the four ``luna_*``), as JAX's CLI
does; each trains with ``jax.grad``'s gradients (the ``luna_*`` modes
through the STE; on the card ``lut_nf4``'s backward runs the LUT GEMM
kernel over the transposed codes).  ``remat_policy="dots"`` is a config
field, not a flag.  Checkpoints go to ``--ckpt-dir`` and a rerun
resumes from the latest.  ``--grad-compression`` sends every gradient
through the int8 round trip before AdamW (``parallel.collectives.
compress_grads_int8``), as JAX's CLI does.  The mesh flags of the JAX CLI
(``--model-parallel``, ``--host-devices``, ``--distributed``) raise:
training on a mesh is ROADMAP queue 1 item 9b.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True, help="smoke-test widths (--no-reduced: "
                                       "the published widths)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--quant", default="bf16")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: TrainerConfig's, $TMPDIR/repro_torch_ckpt")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--host-devices", type=int, default=0)
    ap.add_argument("--distributed", action="store_true")
    args = ap.parse_args(argv)

    if args.model_parallel > 1 or args.host_devices or args.distributed:
        raise NotImplementedError(
            "training on a mesh and multi-host runs are not ported yet: "
            "ROADMAP queue 1 item 9b")

    from dataclasses import replace

    from repro_torch.core.layers import QuantConfig
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.device import resolve_device
    from repro_torch.models.registry import get_config
    from repro_torch.train.trainer import Trainer, TrainerConfig

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.quant != "bf16":
        cfg = replace(cfg, quant=QuantConfig(mode=args.quant))
    tcfg = TrainerConfig(total_steps=args.steps, microbatch=args.microbatch,
                         grad_compression=args.grad_compression)
    if args.ckpt_dir:
        tcfg.ckpt_dir = args.ckpt_dir
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch)
    _, history = Trainer(cfg, tcfg, device=device).run(data)
    if history:
        print(f"{cfg.name} x{cfg.num_layers} layers on {device}, quant "
              f"{args.quant}: {len(history)} steps, loss {history[0]:.4f} "
              f"-> {history[-1]:.4f}")
    return history


if __name__ == "__main__":
    main()
