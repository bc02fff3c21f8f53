"""The port's engine against the JAX engine, and the JAX engine's pins.

* Greedy tokens equal the JAX ``Engine``'s on the same prompts and bridged
  weights, for ``quant=None``, ``lut4``, ``nf4`` and ``nf4p`` (engine
  level) and the model-level ``luna_approx2``, ``luna_dc`` and ``lut_nf4``.
* The launcher routes a model-level ``--quant`` into ``cfg.quant``; the
  engine refuses engine- and model-level quantization together.
* The JAX pins hold in the port: mixed-length batch == sequential,
  lut4 == int4 tokens, nf4 == the direct NF4 dequant oracle.
* Sampled modes: a request's tokens depend on (seed, rid) only — the same
  in a mixed batch and alone, reproducible, and changed by the seed.
* mamba2 (the ssm family, on the dense slab of ``SSMCache`` rows): greedy
  tokens equal the JAX engine's under ``quant=None``, ``lut4``, ``nf4``,
  ``nf4p`` and the model-level ``luna_dc``; a mixed-length batch equals
  the sequential reference; bucketed prefill equals ``prefill_bucket=1``.
"""
import argparse
from dataclasses import replace

import jax
import numpy as np
import pytest

from repro.core.layers import QuantConfig as JaxQuantConfig
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.serve.config import EngineConfig as JaxEngineConfig
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.core.layers import QuantConfig
from repro_torch.core.quant import quantize_decode_params
from repro_torch.models.registry import get_config
from repro_torch.models.ssm import SSMCache
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve.config import ENGINE_QUANT_MODES, EngineConfig, model_quant
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.sampling import SamplingConfig

MIXED_LENS = (3, 9, 5)


@pytest.fixture(scope="module")
def ssm_setup():
    jcfg = jax_config("mamba2-1.3b").reduced(dtype="float32")
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(1))
    cfg = get_config("mamba2-1.3b").reduced(dtype="float32")
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config("yi-9b").reduced(dtype="float32", attn_impl="full")
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(1))
    cfg = get_config("yi-9b").reduced(dtype="float32", attn_impl="full")
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, model


def _prompts(cfg, lens=MIXED_LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]


def _serve(cfg, model, prompts, max_new=8, max_batch=None, rids=None,
           **conf):
    eng = Engine(cfg, model, EngineConfig(
        max_batch=max_batch or len(prompts), max_seq=48, **conf),
        device="cpu")
    reqs = [Request(rid=rids[i] if rids else i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    assert eng.serve(reqs)["done"]
    return [r.out for r in reqs], eng


@pytest.mark.parametrize("quant", [None, "lut4", "nf4", "nf4p",
                                   "luna_approx2", "luna_dc", "lut_nf4"])
def test_greedy_tokens_equal_jax_engine(setup, quant):
    """Engine-level modes go to ``EngineConfig.quant``, model-level ones to
    ``cfg.quant`` (per-tensor activation calibration then spans padded
    bucket rows and idle decode slots: both engines feed the same ones)."""
    jcfg, jparams, cfg, model = setup
    engine_quant = quant if quant in ENGINE_QUANT_MODES else None
    if quant is not None and engine_quant is None:
        jcfg = replace(jcfg, quant=JaxQuantConfig(mode=quant))
        cfg = replace(cfg, quant=QuantConfig(mode=quant))
        model = TransformerLM.from_params(cfg, model.params_tree(),
                                          device="cpu")
    prompts = _prompts(cfg)
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(
        max_batch=len(prompts), max_seq=48, quant=engine_quant))
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=8)
             for i, p in enumerate(prompts)]
    assert jeng.serve(jreqs)["done"]
    port, _ = _serve(cfg, model, prompts, quant=engine_quant)
    assert port == [r.out for r in jreqs]


def test_mixed_length_batch_matches_sequential(setup):
    """5 mixed-length requests on a 3-slot slab (slot reuse, mixed depths)
    == each request served alone."""
    _, _, cfg, model = setup
    prompts = _prompts(cfg, lens=(3, 9, 5, 17, 2))
    batched, _ = _serve(cfg, model, prompts, max_new=6, max_batch=3)
    for i, p in enumerate(prompts):
        alone, _ = _serve(cfg, model, [p], max_new=6)
        assert batched[i] == alone[0], (i, len(p))


def test_quant_none_aliases_params(setup):
    _, _, cfg, model = setup
    _, eng = _serve(cfg, model, _prompts(cfg), max_new=2)
    assert eng.decode_params is eng.params is model


def test_lut4_and_int4_tokens_identical(setup):
    """Two evaluations of one affine grid emit identical tokens."""
    _, _, cfg, model = setup
    prompts = _prompts(cfg)
    lut, eng = _serve(cfg, model, prompts, quant="lut4")
    i4, _ = _serve(cfg, model, prompts, quant="int4")
    assert lut == i4
    # the decode model shares every unquantized tensor with the float one
    assert eng.decode_params.embed.data_ptr() == model.embed.data_ptr()
    assert eng.decode_params.blocks[0].attn.wq.kernel == "lut_dc"


def test_nf4_tokens_identical_to_direct_dequant_oracle(setup):
    """nf4 (6-select D&C + residual) == the direct 16-entry NF4 lookup,
    and the first (full-precision prefill) token equals bf16 decode's."""
    _, _, cfg, model = setup
    prompts = _prompts(cfg)
    base, _ = _serve(cfg, model, prompts)
    nf4, _ = _serve(cfg, model, prompts, quant="nf4")
    eng = Engine(cfg, model, EngineConfig(max_batch=len(prompts), max_seq=48,
                                          quant="nf4"), device="cpu")
    eng.decode_params = TransformerLM.from_params(
        cfg, quantize_decode_params(model.params_tree(), "nf4_direct"),
        device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=8)
            for i, p in enumerate(prompts)]
    assert eng.serve(reqs)["done"]
    assert nf4 == [r.out for r in reqs]
    assert [o[0] for o in nf4] == [o[0] for o in base]


@pytest.mark.parametrize("sampling", [
    SamplingConfig("temperature", temperature=0.8),
    SamplingConfig("top_k", temperature=1.0, top_k=5)])
def test_sampled_streams_depend_on_seed_and_rid_only(setup, sampling):
    _, _, cfg, model = setup
    prompts = _prompts(cfg, lens=(3, 9, 5, 6))
    rids = [7, 3, 11, 5]
    kw = dict(max_new=6, rids=rids, sampling=sampling, seed=3)
    batched, _ = _serve(cfg, model, prompts, max_batch=2, **kw)
    again, _ = _serve(cfg, model, prompts, max_batch=4, **kw)
    assert batched == again                     # slot/co-tenant independent
    for i, p in enumerate(prompts):
        alone, _ = _serve(cfg, model, [p], max_new=6, rids=[rids[i]],
                          sampling=sampling, seed=3)
        assert alone[0] == batched[i], i
    reseeded, _ = _serve(cfg, model, prompts, max_batch=4, max_new=6,
                         rids=rids, sampling=sampling, seed=4)
    assert reseeded != batched


def test_scheduler_admits_higher_priority_first(setup):
    _, _, cfg, model = setup
    eng = Engine(cfg, model, EngineConfig(max_batch=1, max_seq=48),
                 device="cpu")
    low = Request(rid=0, prompt=[5, 6, 7], max_new=2, priority=0)
    high = Request(rid=1, prompt=[8, 9], max_new=2, priority=1)
    assert eng.serve([low, high])["done"]
    assert high.token_ts[-1] <= low.token_ts[0]


def test_engine_validation(setup):
    _, _, cfg, model = setup
    eng = Engine(cfg, model, EngineConfig(max_batch=1, max_seq=8),
                 device="cpu")
    with pytest.raises(ValueError, match="prompt length"):
        eng.serve([Request(rid=0, prompt=list(range(1, 9)))])
    with pytest.raises(ValueError, match="max_new"):
        eng.serve([Request(rid=0, prompt=[1], max_new=0)])
    with pytest.raises(ValueError, match="quant"):
        EngineConfig(quant="fp3")
    for knob in (dict(spec="ngram"), dict(trace=True)):
        with pytest.raises(NotImplementedError, match="queue 1 item 6"):
            Engine(cfg, model, EngineConfig(**knob), device="cpu")
    # the cache substrate's switches serve (tests/test_torch_chunked.py);
    # a dense prefix cache is refused as JAX refuses it
    with pytest.raises(ValueError, match="prefix_cache"):
        Engine(cfg, model, EngineConfig(prefix_cache=True), device="cpu")
    for knob in (dict(paged=True), dict(prefill_chunk=8),
                 dict(paged=True, prefix_cache=True)):
        Engine(cfg, model, EngineConfig(max_batch=1, max_seq=16, **knob),
               device="cpu")


def test_from_args_routes_quant_flag():
    ap = argparse.ArgumentParser()
    EngineConfig.add_cli_args(ap)
    for mode in ("lut4", "int4", "nf4", "nf4p"):
        assert EngineConfig.from_args(
            ap.parse_args(["--quant", mode])).quant == mode
    assert EngineConfig.from_args(ap.parse_args(["--quant", "bf16"])).quant \
        is None
    assert model_quant("bf16") is model_quant(None) is model_quant("lut4") \
        is None
    for mode in ("int8", "int4_dequant", "lut_nf4", "luna_conventional",
                 "luna_dc", "luna_approx", "luna_approx2"):
        args = ap.parse_args(["--quant", mode])
        assert EngineConfig.from_args(args).quant is None
        assert model_quant(args.quant) == QuantConfig(mode=mode)
    with pytest.raises(ValueError, match="unknown quant mode"):
        model_quant("fp3")
    conf = EngineConfig.from_args(ap.parse_args(
        ["--max-batch", "3", "--sampling", "top_k", "--top-k", "7"]))
    assert conf.max_batch == 3 and conf.sampling.top_k == 7


def test_engine_refuses_double_quantization(setup):
    _, _, cfg, model = setup
    qcfg = replace(cfg, quant=QuantConfig(mode="luna_approx2"))
    with pytest.raises(ValueError, match="would quantize twice"):
        Engine(qcfg, model, EngineConfig(max_batch=1, max_seq=16,
                                         quant="lut4"), device="cpu")
    # each alone is fine
    Engine(qcfg, model, EngineConfig(max_batch=1, max_seq=16), device="cpu")
    Engine(replace(cfg, quant=QuantConfig(mode="bf16")), model,
           EngineConfig(max_batch=1, max_seq=16, quant="lut4"), device="cpu")


def _cli_tokens(out: str) -> list[list[int]]:
    return [eval(line.split(":", 1)[1]) for line in out.splitlines()
            if line.startswith("rid ")]


def test_cli_routes_model_quant_to_the_luna_path(capsys):
    """``--quant luna_approx2`` reaches ``cfg.quant`` (it once served in
    full precision): the CLI's tokens equal an engine built directly with
    that ``QuantConfig`` and differ from bf16's."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import main
    argv = ["--device", "cpu", "--requests", "2", "--max-new", "6"]
    main(argv + ["--quant", "luna_approx2"])
    luna = _cli_tokens(capsys.readouterr().out)
    main(argv)
    bf16 = _cli_tokens(capsys.readouterr().out)
    cfg = get_config("yi-9b").reduced(quant=QuantConfig(mode="luna_approx2"))
    model = TransformerLM(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, 6).tolist() for _ in range(2)]
    eng = Engine(cfg, model, EngineConfig(max_batch=4, max_seq=128),
                 device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=6)
            for i, p in enumerate(prompts)]
    assert eng.serve(reqs)["done"]
    assert luna == [r.out for r in reqs]
    assert luna != bf16


def test_cli_serves_on_cpu(capsys):
    from repro_torch.launch.serve import main
    stats = main(["--device", "cpu", "--quant", "nf4p", "--requests", "2",
                  "--max-new", "3"])
    assert stats["done"] and stats["decode_tokens"] == 4
    assert "rid 1:" in capsys.readouterr().out


@pytest.mark.parametrize("quant", [None, "lut4", "nf4", "nf4p", "luna_dc"])
def test_ssm_greedy_tokens_equal_jax_engine(ssm_setup, quant):
    """mamba2: bucketed right-padded prefill (masked SSD scan), the O(1)
    decode recurrence with frozen ``w_in``/``w_out`` (engine-level) or
    every projection on the LUNA path (``luna_dc``)."""
    jcfg, jparams, cfg, model = ssm_setup
    engine_quant = quant if quant in ENGINE_QUANT_MODES else None
    if quant is not None and engine_quant is None:
        jcfg = replace(jcfg, quant=JaxQuantConfig(mode=quant))
        cfg = replace(cfg, quant=QuantConfig(mode=quant))
        model = type(model).from_params(cfg, model.params_tree(),
                                        device="cpu")
    prompts = _prompts(cfg, lens=(3, 9, 20))
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(
        max_batch=len(prompts), max_seq=48, quant=engine_quant))
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=8)
             for i, p in enumerate(prompts)]
    assert jeng.serve(jreqs)["done"]
    port, eng = _serve(cfg, model, prompts, quant=engine_quant)
    assert all(isinstance(c, SSMCache) for c in eng.backend.caches)
    assert port == [r.out for r in jreqs]


def test_ssm_mixed_length_batch_matches_sequential(ssm_setup):
    """The port of ``test_engine.test_mixed_length_batch_recurrent_families``
    for mamba2, with slot reuse: 5 requests on a 2-slot slab == each
    served alone."""
    _, _, cfg, model = ssm_setup
    prompts = _prompts(cfg, lens=(4, 7, 4, 17, 2))
    batched, _ = _serve(cfg, model, prompts, max_new=4, max_batch=2)
    for i, p in enumerate(prompts):
        alone, _ = _serve(cfg, model, [p], max_new=4)
        assert batched[i] == alone[0], (i, len(p))


def test_ssm_bucketed_prefill_matches_exact_length(ssm_setup):
    """From ``test_engine.test_recurrent_chunked_prefill_matches_whole_
    prompt``: padded 16-token buckets (pad columns masked out of the
    recurrent state) == exact-length prefill (``prefill_bucket=1``)."""
    _, _, cfg, model = ssm_setup
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (31, 4, 12)]
    exact, _ = _serve(cfg, model, prompts, max_new=5, max_batch=2,
                      prefill_bucket=1)
    bucketed, _ = _serve(cfg, model, prompts, max_new=5, max_batch=2)
    assert bucketed == exact


def test_cli_serves_mamba2_on_cpu(capsys):
    from repro_torch.launch.serve import main
    stats = main(["--arch", "mamba2-1.3b", "--device", "cpu", "--quant",
                  "lut4", "--requests", "3", "--max-new", "3"])
    assert stats["done"] and stats["decode_tokens"] == 6
    assert "mamba2-1.3b x2 layers on cpu" in capsys.readouterr().out
