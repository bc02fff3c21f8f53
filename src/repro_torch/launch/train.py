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
compress_grads_int8``), as JAX's CLI does.

The mesh flags (JAX's):

  # 4 local gloo ranks on the CPU, a (2, 2) ("data", "model") mesh:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --host-devices 4 --model-parallel 2 --steps 5

  # one process per card, started by a launcher that sets MASTER_ADDR,
  # MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK:
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --distributed --model-parallel 2 --steps 100

``--host-devices N`` (CPU only) spawns N local gloo ranks over a file
store (JAX's N forced host devices); ``--distributed`` joins the world
from the environment (``init_method="env://"``; NCCL on the card, gloo
with ``--device cpu``), JAX's ``jax.distributed.initialize()``; in an
initialised world (either, or a caller's) ``--model-parallel M`` builds
``make_host_mesh(model=M)`` and the ``Trainer`` trains on it (sharded
params, gradients and moments; data-parallel rows).  ``--model-parallel``
above 1 with no world fails (``make_host_mesh`` needs one): nothing trains
unsharded when a mesh was asked for.
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
    ap.add_argument("--host-devices", type=int, default=0,
                    help="spawn N local gloo ranks on the CPU")
    ap.add_argument("--distributed", action="store_true",
                    help="join the world from the environment (env://)")
    args = ap.parse_args(argv)
    return in_world(train, args, host_devices=args.host_devices,
                    distributed=args.distributed, device=args.device)


def in_world(fn, *args, host_devices: int = 0, distributed: bool = False,
             device=None):
    """``fn(*args)`` in the world the mesh flags ask for:
    ``host_devices`` N spawns N local gloo ranks on the CPU and returns
    rank 0's result (``fn`` and ``args`` must pickle); ``distributed``
    joins the world from the environment (NCCL on the card, gloo on the
    CPU) for the call; else this process alone."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import spawn_host_ranks

    cpu = device is not None and torch.device(device).type == "cpu"
    if host_devices:
        if not cpu:
            raise ValueError("--host-devices runs local gloo ranks on the "
                             "CPU: add --device cpu (on cards, launch one "
                             "process per card with --distributed)")
        return spawn_host_ranks(host_devices, fn, *args)[0]
    if distributed:
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("gloo" if cpu else "nccl",
                                init_method="env://")
        try:
            return fn(*args)
        finally:
            dist.destroy_process_group()
    return fn(*args)


def train(args):
    """Train as ``args`` say (the parsed flags of :func:`main`), on the
    mesh of the initialised world when there is one or
    ``--model-parallel`` asks for one; returns the loss history."""
    from dataclasses import replace

    from repro_torch.core.layers import QuantConfig
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.registry import get_config
    from repro_torch.train.trainer import TrainerConfig

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
    history, _, where = fit(cfg, tcfg, data, args.model_parallel,
                            args.device)
    if history and where is not None:
        print(f"{cfg.name} x{cfg.num_layers} layers on {where}, quant "
              f"{args.quant}: {len(history)} steps, loss {history[0]:.4f} "
              f"-> {history[-1]:.4f}")
    return history


def fit(cfg, tcfg, data, model_parallel: int = 1, device=None):
    """The ``Trainer`` of ``cfg``/``tcfg`` on ``data``, on
    ``make_host_mesh(model=model_parallel)`` when the world is initialised
    or ``model_parallel`` > 1 (with no world that raises: nothing trains
    unsharded when a mesh was asked for), else on ``device``.  Returns
    (the loss history, the straggler steps, where it trained: None on
    ranks other than 0)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.trainer import Trainer

    mesh = None
    if dist.is_initialized() or model_parallel > 1:
        mesh = make_host_mesh(model=model_parallel)
    trainer = Trainer(cfg, tcfg, mesh, device=device)
    _, history = trainer.run(data)
    where = (f"{trainer.device}" if mesh is None else
             f"a {tuple(mesh.shape.values())} {tuple(mesh.axis_names)} "
             f"mesh of {trainer.device}")
    return history, trainer.straggler_events, where if trainer.main else None


if __name__ == "__main__":
    main()
