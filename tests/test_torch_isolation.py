"""The port stands alone and runs on the card unless told otherwise.

* With ``jax`` blocked, every ``repro_torch`` module (and ``chip_smoke``)
  imports, and no module of the JAX package ``repro`` gets loaded.
* Without a GPU, every entry point raises unless given ``device="cpu"``
  (the training ones too: ``Trainer``, ``launch.train``, the data
  stream's ``batch``).
* What the port leaves out raises ``NotImplementedError`` naming the
  ROADMAP item that ports it; what it ports (every arch of the JAX
  registry, the encdec and vlm families last) loads, serves and trains.
"""
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.models.attention import sdpa
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.common import CacheSpec
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.registry import UNPORTED_ARCHS, get_config, get_model
from repro_torch.models.ssm_lm import SSMLM
from repro_torch.models.vlm import VLM
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
        "obs.exporters", "serve.spec", "serve.engine", "models.moe",
        "models.attention", "configs.starcoder2_15b", "configs.minitron_4b",
        "configs.deepseek_67b", "configs.deepseek_v2_lite_16b",
        "configs.deepseek_v2_236b", "models.hybrid",
        "configs.zamba2_1p2b", "models.encdec", "models.vlm",
        "configs.whisper_base", "configs.llava_next_mistral_7b")} <= names


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


def test_unported_parts_name_their_roadmap_item(tmp_path):
    # starcoder2 (queue 1 item 4) is ported: it loads as JAX's config
    assert get_config("starcoder2-15b").mlp_type == "gelu"
    # zamba2 (the hybrid, queue 1 item 7) is ported: it loads and builds
    zamba = get_config("zamba2-1.2b")
    assert zamba.family == "hybrid" and zamba.hybrid.period == 6
    assert isinstance(get_model(zamba.reduced(dtype="float32"),
                                device="cpu"), HybridLM)
    # whisper-base and llava-next are ported (queue 1 item 8a; the JAX
    # engine serves neither): they load and build; no arch is left
    for arch, cls in (("whisper-base", EncDecLM),
                      ("llava-next-mistral-7b", VLM)):
        assert isinstance(get_model(get_config(arch).reduced(
            dtype="float32"), device="cpu"), cls)
    assert UNPORTED_ARCHS == {}
    # the trainer builds for the ssm, hybrid and moe families (queue 1
    # item 8's first part) and for encdec and vlm (item 8a); a family
    # outside the six still names the item
    for arch in ("mamba2-1.3b", "zamba2-1.2b", "deepseek-v2-lite-16b",
                 "whisper-base", "llava-next-mistral-7b"):
        Trainer(get_config(arch).reduced(), TrainerConfig(), device="cpu")
    from dataclasses import replace
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        Trainer(replace(get_config("mamba2-1.3b").reduced(), family="audio"),
                TrainerConfig(), device="cpu")
    assert CacheSpec(block_size=16, num_blocks=8).paged   # ported
    EngineConfig(spec="ngram").validate("dense")          # ported, as JAX
    EngineConfig(spec="ngram").validate("hybrid")         # ported, as JAX
    q = torch.zeros(1, 4, 2, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        sdpa(q, q, q, impl="flash")
    # training on a mesh (queue 1 item 9b) is ported: the CLI's mesh
    # flags train on 4 local gloo ranks, a (2, 2) mesh
    from repro_torch.launch.train import main as train_main
    hist = train_main(["--device", "cpu", "--host-devices", "4",
                       "--model-parallel", "2", "--steps", "2", "--seq",
                       "16", "--batch", "4", "--ckpt-dir",
                       str(tmp_path / "mesh")])
    assert len(hist) == 2 and all(map(math.isfinite, hist))
    with pytest.raises(ValueError, match="--device cpu"):
        train_main(["--host-devices", "4", "--device", "cuda"])
    # the moe family is ported (queue 1 item 7's first part), and the vlm
    # family's backbone is a TransformerLM (item 8a); a transformer of a
    # family it does not serve, and a family outside the six, still name
    # the item
    moe = get_config("deepseek-v2-lite-16b").reduced(dtype="float32")
    assert isinstance(TransformerLM(moe, device="cpu"), TransformerLM)
    assert isinstance(TransformerLM(replace(_small_cfg(), family="vlm"),
                                    device="cpu"), TransformerLM)
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        TransformerLM(replace(_small_cfg(), family="encdec"), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        get_model(replace(_small_cfg(), family="audio"), device="cpu")
