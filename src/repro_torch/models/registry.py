"""Architecture registry of the port: ``--arch <id>`` -> (config, model,
input specs).

Every arch of the JAX registry is ported: the dense GQA family
(``starcoder2-15b``, ``minitron-4b``, ``yi-9b``, ``deepseek-67b``), the
moe family (``deepseek-v2-lite-16b``, ``deepseek-v2-236b``: capacity-
routed MoE + MLA), ``whisper-base`` (encdec), ``zamba2-1.2b`` (hybrid:
Mamba2 with one shared attention block), ``mamba2-1.3b`` (ssm),
``llava-next-mistral-7b`` (vlm) and ``luna-mlp`` (the paper's Fig 13
network, dense; trained, not served, and left out of ``ARCH_IDS`` as in
JAX).
"""
from __future__ import annotations

import importlib
from dataclasses import replace

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.common import dtype_of

ARCH_MODULES = {
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1p3b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "luna-mlp": "repro_torch.configs.luna_mlp",
}

#: archs of the JAX registry still to be ported -> the ROADMAP item (none:
#: the encdec and vlm families came last, queue 1 item 8a)
UNPORTED_ARCHS: dict[str, str] = {}

ARCH_IDS = [a for a in ARCH_MODULES if a != "luna-mlp"]

#: archs with sub-quadratic sequence mixing (they run the long_500k cell)
SUBQUADRATIC = {"zamba2-1.2b", "mamba2-1.3b"}


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
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM
    if cfg.family == "vlm":
        from repro_torch.models.vlm import VLM
        return VLM
    raise NotImplementedError(
        f"family {cfg.family!r} is none of the JAX registry's six (dense, "
        "moe, ssm, hybrid, encdec, vlm), which ROADMAP queue 1 item 7 "
        "ported")


def get_model(cfg: ModelConfig, device=None):
    """An uninitialised LM of ``cfg``'s family (:class:`TransformerLM`,
    :class:`SSMLM`, :class:`HybridLM`, :class:`EncDecLM` or :class:`VLM`)
    on ``device`` (the card unless ``device="cpu"``); call
    ``.init(generator)`` or load weights through
    :mod:`repro_torch.bridge`."""
    return model_class(cfg)(cfg, device=device)


def cell_supported(arch: str, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether this (arch x shape) cell runs, and why not if skipped
    (JAX's rule, word for word)."""
    if shape.name == "long_500k" and arch not in SUBQUADRATIC:
        return False, ("SKIP: pure full-attention arch; 500k decode needs "
                       "sub-quadratic attention (DESIGN.md section 5)")
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                batch: int | None = None) -> dict:
    """``(shape, dtype)`` of every model input of this cell (JAX's
    ``input_specs`` without its ``ShapeDtypeStruct``): tokens and labels,
    whisper's frames (B, enc_seq, D) and llava's patches (B, P, D) in the
    model's dtype, llava's text S - P tokens long.  ``batch`` overrides
    the global batch."""
    b = batch or shape.global_batch
    s = shape.seq_len
    dt = dtype_of(cfg)
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        labels = {"labels": ((b, s), i32)} if shape.kind == "train" else {}
        if cfg.family == "encdec":
            return {"frames": ((b, cfg.encdec.enc_seq, cfg.d_model), dt),
                    "tokens": ((b, s), i32), **labels}
        if cfg.family == "vlm":
            p = cfg.vlm.num_patches
            return {"patches": ((b, p, cfg.d_model), dt),
                    "tokens": ((b, s - p), i32), **labels}
        return {"tokens": ((b, s), i32), **labels}
    # decode: one new token against an s-long cache
    return {"token": ((b, 1), i32), "index": ((), i32)}
