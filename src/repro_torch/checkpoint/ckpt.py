"""Async, atomic checkpointing to numpy ``.npz`` (mirrors
``repro.checkpoint.ckpt``).

* async: the device -> host copy is the only synchronous part; a
  background thread writes the host copies while training continues;
* atomic: writes ``step_N.tmp/`` then ``os.rename`` -- a crash never
  leaves a half checkpoint visible, and a restart picks the latest
  complete one (a directory without ``meta.json`` is ignored);
* arrays are keyed by tree path (``params/blocks/0/attn/wq``); bf16
  leaves are stored as f32 (exact) and cast back on restore;
* elastic (JAX's): a checkpoint holds whole leaves whatever wrote it.  On
  a mesh :meth:`Checkpointer.save` gathers each leaf whole on the calling
  thread (collectives may not run in the writer thread), rank 0 writes
  the same ``.npz`` a one-device run writes and the other ranks wait at a
  barrier (in :meth:`Checkpointer.wait`); :meth:`Checkpointer.restore`
  cuts each leaf to the CURRENT mesh's spec, so 4 ranks restore onto 2,
  onto 1 or onto no mesh, and back.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.fsdp import block, gather_leaf
from repro_torch.tree import leaves_with_path, path_key


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy that later in-place updates of ``t`` cannot reach."""
    dt = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to("cpu", dt, copy=True).numpy()


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._barrier = False             # a mesh save awaits its barrier

    # ---------------- save ----------------
    def save(self, step: int, tree: Any, *, blocking: bool = False,
             mesh=None, specs: list | None = None):
        """Device -> host copy now; disk write in the background.
        ``mesh``/``specs``: ``tree``'s leaves are this rank's shards under
        ``specs`` (in leaf order); every rank must call ``save`` (each
        leaf is all-gathered) and only rank 0 writes."""
        self.wait()                       # one in-flight checkpoint max
        items = leaves_with_path(tree)
        if mesh is None:
            host = {path_key(p): _host(t) for p, t in items}
        else:
            # one whole leaf on the device at a time; rank 0 keeps a host
            # copy of each
            host = {}
            for (p, t), spec in zip(items, specs):
                whole = gather_leaf(t.detach(), spec, mesh)
                if dist.get_rank() == 0:
                    host[path_key(p)] = _host(whole)
            self._barrier = True
            if dist.get_rank() != 0:
                return self.wait() if blocking else None

        def _write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
            np.savez(tmp / "arrays.npz", **host)
            (tmp / "meta.json").write_text(json.dumps({"step": step}))
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)         # atomic publish
            self._gc()

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        """Until the last checkpoint is on disk (on a mesh: on every
        rank, through a barrier)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()

    def _gc(self):
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---------------- restore ----------------
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "meta.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    @torch.no_grad()
    def restore(self, step: int, target: Any, *, mesh=None,
                specs: list | None = None) -> Any:
        """Fill ``target``'s tensors in place (each keeps its device and
        dtype) from checkpoint ``step``; returns ``target``.  ``mesh``/
        ``specs``: ``target``'s leaves are this rank's shards under
        ``specs`` (in leaf order), each cut from the whole leaf (the
        elastic restore: any mesh, whatever mesh wrote it)."""
        items = leaves_with_path(target)
        specs = specs if mesh is not None else [None] * len(items)
        with np.load(self.dir / f"step_{step}" / "arrays.npz") as data:
            for (path, leaf), spec in zip(items, specs):
                arr = torch.from_numpy(data[path_key(path)])
                if spec is not None:
                    arr = block(arr, spec, mesh)
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"{path_key(path)}: checkpoint shape "
                                     f"{tuple(arr.shape)} != "
                                     f"{tuple(leaf.shape)}")
                leaf.copy_(arr)
        return target
