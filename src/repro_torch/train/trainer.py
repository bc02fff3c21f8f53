"""Fault-tolerant training loop (mirrors ``repro.train.trainer``):
checkpoint/restart, preemption handling, straggler detection.

* resume from the latest complete checkpoint on (re)start, printing
  ``[trainer] resumed from step N``;
* SIGTERM/SIGINT -> finish the step, checkpoint synchronously, exit the
  loop (the previous handlers come back when ``run`` returns);
* a per-step wall-time watchdog with an EMA outlier test (the straggler
  signal; here it logs and counts events);
* a deterministic data stream keyed by step, so a restart replays nothing.

Every family trains (``TRAINED_FAMILIES``; the ssm and hybrid families'
SSD scan differentiates through ``kernels.ssd_scan.ops.SSDScanFn``, on
the card the kernels ``ssd_scan_tc.cu`` forward and ``ssd_scan_bwd.cu``
backward).  The encdec and vlm families train as JAX's Trainer trains
them: on a data stream whose ``batch(step, device)`` carries ``frames``
or ``patches`` (shapes from ``models.registry.input_specs``);
``SyntheticLM`` carries neither, so their ``loss`` raises ``KeyError`` on
its batches, as JAX's does.
``Trainer(cfg, tcfg, mesh=None, device=None)``: JAX's third argument is
the mesh (:class:`~repro_torch.launch.mesh.Mesh`).  Without one the
trainer runs on one device, the card unless ``device="cpu"``; with one,
on the mesh's device of this rank (``device`` may name it), and every
rank of the world must run it.  Weights start random from
``torch.Generator(device).manual_seed(tcfg.seed)`` (the full leaves,
drawn alike on every rank); JAX's PRNG stream is not reproduced (parity
with JAX goes through ``repro_torch.bridge``).

On a mesh (elastic, as JAX's): the model is sharded after ``init``
(:func:`~repro_torch.parallel.fsdp.shard_model`: each rank keeps its
shards, gathered at use), the AdamW moments are the shards' (ZeRO-1),
each step gets the global ``data.batch(step, device)`` and keeps this
rank's rows (``train_step.local_rows``), checkpoints hold whole leaves
and a run resumes onto any mesh or none.  The ``[trainer]`` and
``[watchdog]`` lines are printed by rank 0 only, and the ranks agree on a
preemption signal before acting on it (one all-reduce a step).
"""
from __future__ import annotations

import os
import signal
import tempfile
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.parallel.fsdp import flat_specs, local_tree, shard_model
from repro_torch.train.train_step import make_train_step, train_specs


def default_ckpt_dir() -> str:
    """``$TMPDIR/repro_torch_ckpt`` (``/tmp`` without ``$TMPDIR``): the
    port's own, so that it never resumes from a JAX run's checkpoints."""
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = field(default_factory=default_ckpt_dir)
    log_every: int = 10
    lr: float = 3e-4
    warmup: int = 10
    straggler_factor: float = 3.0   # step > factor * EMA -> straggler event
    microbatch: int = 0
    grad_compression: bool = False
    seed: int = 0


#: the families the port trains: all six of the JAX registry
TRAINED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


class Trainer:
    def __init__(self, cfg, tcfg: TrainerConfig, mesh=None, device=None):
        if cfg.family not in TRAINED_FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is none of the six the trainer "
                f"trains {TRAINED_FAMILIES}: ROADMAP queue 1 item 8 ported "
                "their training")
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        self.main = mesh is None or dist.get_rank() == 0
        self.opt = AdamW(lr=tcfg.lr,
                         schedule=cosine_schedule(tcfg.warmup,
                                                  tcfg.total_steps))
        self.ckpt = Checkpointer(tcfg.ckpt_dir)
        self._stop = False
        self.straggler_events: list[int] = []

    def _install_signals(self) -> dict:
        def handler(signum, frame):
            self._stop = True      # finish current step, checkpoint, exit
        return {sig: signal.signal(sig, handler)
                for sig in (signal.SIGTERM, signal.SIGINT)}

    def run(self, data, *, install_signals: bool = True):
        """Train to ``tcfg.total_steps`` on ``data``'s ``batch(step,
        device)`` (a :class:`~repro_torch.data.synthetic.SyntheticLM`, or
        a stream that also carries ``frames`` or ``patches``); returns
        (model, loss history of the steps this run took)."""
        previous = self._install_signals() if install_signals else {}
        try:
            return self._run(data)
        finally:
            for sig, h in previous.items():
                signal.signal(sig, h)

    def _log(self, line: str):
        if self.main:
            print(line, flush=True)

    def _stopping(self) -> bool:
        """The preemption flag, agreed by every rank on a mesh (a signal
        reaches one process; all must checkpoint and stop together)."""
        if self.mesh is None:
            return self._stop
        flag = torch.tensor([int(self._stop)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def _run(self, data):
        tcfg, mesh = self.tcfg, self.mesh
        step_fn = make_train_step(self.cfg, self.opt, mesh,
                                  microbatch=tcfg.microbatch,
                                  grad_compression=tcfg.grad_compression)
        model = get_model(self.cfg, device=self.device)
        model.requires_grad_(True)
        start = self.ckpt.latest_step()
        if start is None:
            model.init(torch.Generator(device=self.device)
                       .manual_seed(tcfg.seed))
        state_specs = None
        if mesh is not None:
            shard_model(model, mesh)
            p, o, _ = train_specs(model, mesh, {})
            state_specs = flat_specs({"params": p, "opt": o})
        params = local_tree(model)
        opt_state = self.opt.init(params)
        if start is None:
            start = 0
        else:
            self.ckpt.restore(start, {"params": params, "opt": opt_state},
                              mesh=mesh, specs=state_specs)
            self._log(f"[trainer] resumed from step {start}")

        ema = None
        history = []
        for step in range(start, tcfg.total_steps):
            t0 = time.time()
            batch = data.batch(step, self.device)
            metrics = step_fn(model, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if ema is not None and dt > tcfg.straggler_factor * ema:
                self.straggler_events.append(step)
                self._log(f"[watchdog] step {step} took {dt:.2f}s "
                          f"(EMA {ema:.2f}s) — straggler/retry signal")
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            history.append(loss)
            if step % tcfg.log_every == 0:
                self._log(f"[trainer] step {step} loss {loss:.4f} "
                          f"({dt*1e3:.0f} ms)")
            done = step + 1
            stop = self._stopping()
            if (done % tcfg.ckpt_every == 0 or stop
                    or done == tcfg.total_steps):
                self.ckpt.save(done, {"params": params, "opt": opt_state},
                               blocking=stop, mesh=mesh, specs=state_specs)
            if stop:
                self._log(f"[trainer] preemption: checkpointed at {done}")
                break
        self.ckpt.wait()
        return model, history
