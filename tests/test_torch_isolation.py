"""The port stands alone and runs on the card unless told otherwise.

* With ``jax`` blocked, every ``repro_torch`` module (and ``chip_smoke``)
  imports, and no module of the JAX package ``repro`` gets loaded.
* Without a GPU, every entry point raises unless given ``device="cpu"``
  (the training ones too: ``Trainer``, ``launch.train``, the data
  stream's ``batch``).
* What the slice does not port raises ``NotImplementedError`` naming the
  ROADMAP item that ports it.
"""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.models.attention import sdpa
from repro_torch.models.common import CacheSpec
from repro_torch.models.registry import get_config, get_model
from repro_torch.models.ssm_lm import SSMLM
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.engine import Engine
from repro_torch.train.trainer import Trainer, TrainerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_every_module_imports_without_jax_or_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any `import jax` now fails
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        leaked = sorted(m for m in sys.modules
                        if m == "repro" or m.startswith("repro."))
        assert not leaked, leaked
        print(" ".join(names))
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 20                   # the whole package walked
    assert {f"repro_torch.{m}" for m in (
        "tree", "optim.adamw", "data.synthetic", "checkpoint.ckpt",
        "train.train_step", "train.trainer", "train.card_vs_cpu",
        "launch.train",
        "configs.luna_mlp", "kernels.flash_attention.ref",
        "kernels.flash_attention.flash_attention",
        "kernels.flash_attention.ops", "obs", "obs.registry", "obs.trace",
        "obs.exporters", "serve.spec", "serve.engine")} <= names


def _small_cfg():
    return get_config("yi-9b").reduced(dtype="float32", attn_impl="full")


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = _small_cfg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({}, cfg)
    model = get_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, model, EngineConfig(max_batch=1, max_seq=16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, model, EngineConfig(max_batch=1, max_seq=16),
               device="cuda")
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--requests", "1"])


def test_training_entry_points_refuse_the_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.train import main
    cfg = get_config("luna-mlp")
    tcfg = TrainerConfig(total_steps=1, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticLM(cfg.vocab_size, 8, 2).batch(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, tcfg, device="cuda")
    Trainer(cfg, tcfg, device="cpu")


def test_ssm_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = get_config("mamba2-1.3b").reduced(dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SSMLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(cfg)
    model = get_model(cfg, device="cpu")
    assert isinstance(model, SSMLM)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, model, EngineConfig(max_batch=1, max_seq=16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from repro_torch.launch.serve import main
        main(["--arch", "mamba2-1.3b", "--requests", "1"])
    Engine(cfg, model, EngineConfig(max_batch=1, max_seq=16), device="cpu")


def test_ssm_unported_parts_name_their_roadmap_item():
    """Speculation's decode windows are ported (logits of (B, W, V); a
    fully masked row keeps its caches); the prefix cache's snapshot hooks
    are ported (a copy, seeded by copying), and ``paged`` is refused as
    JAX refuses it (nothing to page)."""
    model = get_model(get_config("mamba2-1.3b").reduced(dtype="float32"),
                      device="cpu").init(torch.Generator().manual_seed(0))
    caches = model.init_cache(2, 8)
    for c in caches:
        c.state.normal_()
        c.conv.normal_()
    with torch.inference_mode():
        logits, new = model.decode_window(
            torch.ones(2, 3, dtype=torch.long), caches, torch.zeros(2),
            last_pos=torch.tensor([-1, 2]))
    assert logits.shape == (2, 3, model.cfg.vocab_size)
    assert all(torch.equal(n.state[0], c.state[0])
               and torch.equal(n.conv[0], c.conv[0])
               and not torch.equal(n.state[1], c.state[1])
               for n, c in zip(new, caches))
    snap = model.state_snapshot(caches, 1)
    assert all(torch.equal(s.state[0], c.state[1])
               and s.state.data_ptr() != c.state.data_ptr()
               for s, c in zip(snap, caches))
    staging = model.seed_from_snapshot(model.init_cache(1, 8), snap)
    assert all(torch.equal(s.state, t.state)
               and s.state.data_ptr() != t.state.data_ptr()
               for s, t in zip(snap, staging))
    with pytest.raises(ValueError, match="paged"):
        Engine(model.cfg, model, EngineConfig(max_batch=1, max_seq=16,
                                              paged=True), device="cpu")


def test_unported_parts_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        get_config("starcoder2-15b")
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        get_config("zamba2-1.2b")
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        Trainer(get_config("mamba2-1.3b").reduced(), TrainerConfig(),
                device="cpu")
    assert CacheSpec(block_size=16, num_blocks=8).paged   # ported
    EngineConfig(spec="ngram").validate("dense")          # ported, as JAX
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        EngineConfig(spec="ngram").validate("hybrid")
    q = torch.zeros(1, 4, 2, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        sdpa(q, q, q, impl="flash")
    from repro_torch.launch.train import main as train_main
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        train_main(["--device", "cpu", "--model-parallel", "2"])
    from dataclasses import replace
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        TransformerLM(replace(_small_cfg(), family="moe"), device="cpu")
