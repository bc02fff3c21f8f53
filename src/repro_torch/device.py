"""Device resolution: the one rule every entry point follows.

An entry point (``Engine``, ``TransformerLM``, ``launch.serve``, the
bridge) runs on ``cuda`` unless its caller passes ``device="cpu"``.  With
no GPU and no explicit CPU request it raises: nothing quietly carries on
on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card; ``"cpu"`` must be asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the "
                "CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def takes_kernels(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's route through the models: a CUDA
    tensor, or a ``meta`` one (the dry run's stand-in for the card, on
    which each kernel wrapper records its cost and computes nothing).  A
    CPU tensor takes the plain versions."""
    return t.device.type in ("cuda", "meta")
