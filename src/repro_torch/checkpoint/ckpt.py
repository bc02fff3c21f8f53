"""Async, atomic checkpointing to numpy ``.npz`` (mirrors
``repro.checkpoint.ckpt``).

* async: the device -> host copy is the only synchronous part; a
  background thread writes the host copies while training continues;
* atomic: writes ``step_N.tmp/`` then ``os.rename`` -- a crash never
  leaves a half checkpoint visible, and a restart picks the latest
  complete one (a directory without ``meta.json`` is ignored);
* arrays are keyed by tree path (``params/blocks/0/attn/wq``); bf16
  leaves are stored as f32 (exact) and cast back on restore.

Elastic restore onto another mesh is the mesh's concern (ROADMAP queue 1
item 9b): the port restores onto one device.
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

    # ---------------- save ----------------
    def save(self, step: int, tree: Any, *, blocking: bool = False):
        """Device -> host copy now; disk write in the background."""
        self.wait()                       # one in-flight checkpoint max
        host = {path_key(p): _host(t) for p, t in leaves_with_path(tree)}

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
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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
    def restore(self, step: int, target: Any) -> Any:
        """Fill ``target``'s tensors in place (each keeps its device and
        dtype) from checkpoint ``step``; returns ``target``."""
        with np.load(self.dir / f"step_{step}" / "arrays.npz") as data:
            for path, leaf in leaves_with_path(target):
                arr = data[path_key(path)]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"{path_key(path)}: checkpoint shape "
                                     f"{arr.shape} != {tuple(leaf.shape)}")
                leaf.copy_(torch.from_numpy(arr))
        return target
