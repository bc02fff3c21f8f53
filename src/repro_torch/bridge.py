"""Weight bridge: the JAX package's parameter tree, already converted to
numpy by the caller, into the port's modules.  Imports no jax.

* Stacked ``(L, ...)`` block leaves are split per layer; the moe
  family's ``"dense_blocks"`` (a list of unstacked blocks) and its
  ``"blocks"`` stack of ``num_layers - first_dense`` layers both cross,
  and so do the hybrid's unstacked ``"shared"`` block and its
  ``"mamba"`` stack of ``num_layers`` layers, and whisper's
  ``"enc_blocks"`` (``enc_layers``) and ``"dec_blocks"`` (``num_layers``)
  stacks; llava's tree is the dense one.
* A ``QuantizedWeight`` arrives as a dict of its numpy children plus its
  ``kernel`` string and becomes the port's ``QuantizedWeight``.
* Every config of the six families crosses, ``luna-mlp`` (GELU, MHA
  4/4) included;
  trained (grad-requiring) parameters go back through
  :func:`params_to_numpy`.
* Float leaves cross with their dtype unchanged; a bfloat16 array
  (numpy's ``ml_dtypes`` bfloat16) crosses through float32, which is
  exact.

:func:`params_to_numpy` is the way back, for round-trip checks.

Configs do not cross: the caller builds the port's ``ModelConfig``.  Its
``QuantConfig`` has no ``use_pallas`` (the port picks the kernel by the
tensor's device), so a JAX config's ``use_pallas`` has nothing to map to.
"""
from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from repro_torch.core.quant import QuantizedWeight
from repro_torch.device import resolve_device

_QW_FIELDS = tuple(f.name for f in fields(QuantizedWeight))


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)     # a writable copy


def _leaf(node, device):
    if isinstance(node, dict) and "kernel" in node:
        return QuantizedWeight(**{
            k: (node[k] if k == "kernel" or node.get(k) is None
                else _tensor(node[k], device))
            for k in _QW_FIELDS if k in node})
    if isinstance(node, dict):
        return {k: _leaf(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_leaf(v, device) for v in node]
    return _tensor(node, device)


def _split_layers(node, n: int) -> list:
    """A stacked block subtree -> a list of ``n`` per-layer subtrees."""
    if isinstance(node, QuantizedWeight):
        return [node[i] for i in range(n)]
    if isinstance(node, dict):
        per = {k: _split_layers(v, n) for k, v in node.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(node.unbind(0))


#: the JAX trees' layer stacks: ``"blocks"`` (dense, moe, ssm, vlm), the
#: hybrid's ``"mamba"`` and whisper's ``"enc_blocks"`` / ``"dec_blocks"``
_STACKS = ("blocks", "mamba", "enc_blocks", "dec_blocks")


def _stack_depth(cfg, key: str, n_dense: int) -> int:
    """Layers on a stack's leading axis: whisper's encoder has
    ``enc_layers``; every other stack ``num_layers`` less the moe
    family's leading dense blocks."""
    if key == "enc_blocks":
        return cfg.encdec.enc_layers
    return cfg.num_layers - n_dense


def params_from_numpy(tree: dict, cfg, device=None):
    """Build the port's LM of ``cfg``'s family (``TransformerLM`` for
    dense and moe, ``SSMLM`` for ssm, ``HybridLM`` for hybrid,
    ``EncDecLM`` for encdec, ``VLM`` for vlm) over a numpy copy of the
    JAX tree (``model.init`` output or its frozen decode tree).  Its
    float leaves are frozen; ``.requires_grad_()`` makes them
    trainable."""
    from repro_torch.models.registry import model_class
    device = resolve_device(device)
    params = {k: _leaf(v, device) for k, v in tree.items()
              if k not in _STACKS}
    n_dense = len(tree.get("dense_blocks", []))
    for key in _STACKS:
        if key in tree:
            params[key] = _split_layers(_leaf(tree[key], device),
                                        _stack_depth(cfg, key, n_dense))
    return model_class(cfg).from_params(cfg, params, device=device)


def params_to_numpy(model) -> dict:
    """The model's tree in the JAX layout (the :data:`_STACKS` stacked on
    a leading axis, ``"dense_blocks"`` a list), bfloat16 leaves as
    float32 numpy arrays."""
    def arr(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def conv(node):
        if isinstance(node, QuantizedWeight):
            return {k: (getattr(node, k) if k == "kernel"
                        or getattr(node, k) is None else arr(getattr(node, k)))
                    for k in _QW_FIELDS}
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        return arr(node)

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        if isinstance(nodes[0], str) or nodes[0] is None:
            return nodes[0]
        return np.stack(nodes)

    tree = model.params_tree()
    return {k: stack([conv(b) for b in v]) if k in _STACKS else conv(v)
            for k, v in tree.items()}
