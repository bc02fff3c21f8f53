"""Architecture registry of the port: ``--arch <id>`` -> config, model.

Ported: the dense GQA family (``starcoder2-15b``, ``minitron-4b``,
``yi-9b``, ``deepseek-67b``), the moe family (``deepseek-v2-lite-16b``,
``deepseek-v2-236b``: capacity-routed MoE + MLA), ``zamba2-1.2b``
(hybrid: Mamba2 with one shared attention block), ``mamba2-1.3b`` (ssm)
and ``luna-mlp`` (the paper's Fig 13 network, dense; trained, not served,
and left out of ``ARCH_IDS`` as in JAX).  Every other arch of the JAX
registry raises ``NotImplementedError`` naming the ROADMAP item that
ports it.
"""
from __future__ import annotations

import importlib
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

ARCH_MODULES = {
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1p3b",
    "luna-mlp": "repro_torch.configs.luna_mlp",
}

#: archs of the JAX registry still to be ported -> the ROADMAP item (the
#: JAX engine serves neither: both are reached through training only)
UNPORTED_ARCHS = {
    "whisper-base": "queue 1 item 7 (encdec, trained under item 8)",
    "llava-next-mistral-7b": "queue 1 item 7 (vlm, trained under item 8)",
}

ARCH_IDS = [a for a in ARCH_MODULES if a != "luna-mlp"]


def get_config(arch: str, **overrides) -> ModelConfig:
    if arch in UNPORTED_ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: ROADMAP {UNPORTED_ARCHS[arch]}")
    if arch not in ARCH_MODULES:
        raise ValueError(f"unknown arch {arch!r}")
    cfg = importlib.import_module(ARCH_MODULES[arch]).CONFIG
    return replace(cfg, **overrides) if overrides else cfg


def model_class(cfg: ModelConfig):
    """The port's LM class for ``cfg.family``."""
    if cfg.family in ("dense", "moe"):
        from repro_torch.models.transformer import TransformerLM
        return TransformerLM
    if cfg.family == "ssm":
        from repro_torch.models.ssm_lm import SSMLM
        return SSMLM
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import HybridLM
        return HybridLM
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet: ROADMAP queue 1 item 7")


def get_model(cfg: ModelConfig, device=None):
    """An uninitialised LM of ``cfg``'s family (:class:`TransformerLM`,
    :class:`SSMLM` or :class:`HybridLM`) on ``device`` (the card unless ``device="cpu"``); call
    ``.init(generator)`` or load weights through
    :mod:`repro_torch.bridge`."""
    return model_class(cfg)(cfg, device=device)
