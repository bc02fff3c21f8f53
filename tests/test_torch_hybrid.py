"""The port's hybrid family (zamba2: Mamba2 with one weight-shared
attention block) against the JAX package, on bridged weights.

Reduced zamba2-1.2b in f32 with ``attn_impl="full"`` (4 Mamba2 layers in
2 groups, d_model 128, the shared block's 4 heads / 2 KV heads of 32,
state 16), JAX params from ``PRNGKey(1)`` crossing through numpy.

* The bridge round-trips the tree bit-exactly; the frozen decode trees
  (lut4, nf4p) freeze JAX's leaves (the shared block's seven projections,
  each layer's ``w_in``/``w_out``) with codes, tables, scales and zero
  points bitwise.
* Logits at 1e-4 and caches equal at 1e-4: right-padded prefill and
  per-row decode on the slab (None/lut4/nf4p), a chunked continuation
  (``cache_index > 0``), decode steps and a verify window on the engine's
  slab and split substrate (a fully masked window row's SSM state passes
  through bitwise); the training loss at 1e-5.
* Engine tokens equal the JAX engine's under None/lut4/nf4p: mixed
  lengths on the slab and the split substrate; whole-exact == bucketed ==
  chunked == paged-chunked; the prefix cache warm == cold with JAX's hit
  counts; ``ngram``/``self_lut`` speculation == plain greedy == JAX's; the
  background loop's streams == sync on the split substrate.
* Copy-on-write, one case each: verify leaves ``pre``'s SSM tensors
  untouched, a self_lut draft leaves the live SSM state untouched,
  ``HybridComposite.rollback`` keeps the pool accounting, a snapshot is a
  clone, and seeding copies.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.core.quant import QuantizedWeight as JQW
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.serve.config import EngineConfig as JaxEngineConfig
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.core import quant as tq
from repro_torch.models.attention import KVCache
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.registry import get_config
from repro_torch.models.ssm import SSMCache
from repro_torch.serve.backend import (PAGED_FAMILIES, RECURRENT_FAMILIES,
                                       SERVED_FAMILIES, HybridComposite,
                                       RecurrentState)
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.paged import GARBAGE_BLOCK

ARCH = "zamba2-1.2b"
TOL = dict(rtol=1e-4, atol=1e-4)
QW_FIELDS = ("codes", "scale", "zero_point", "hi_tab", "lo_tab", "residual")
QUANTS = [None, "lut4", "nf4p"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny shapes: the default (one
    a core) only contends with the other test workers; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_quant_once():
    """JAX's ``quantize_decode_params`` run once per (tree, mode) for this
    module: every JAX engine here freezes the same bridged weights, and
    JAX's eager quantization is most of a small engine's construction.
    The results are JAX's own (a memo of a pure function); restored
    after."""
    base = jq.quantize_decode_params
    memo = {}

    def once(params, quant):
        key = (id(params), quant)
        if key not in memo:
            memo[key] = (params, base(params, quant))
        return memo[key][1]
    jq.quantize_decode_params = once
    yield
    jq.quantize_decode_params = base


def _to_numpy(tree):
    """A JAX param tree as numpy; QuantizedWeights as dicts + kernel."""
    if isinstance(tree, JQW):
        d = {f: (None if getattr(tree, f) is None
                 else np.asarray(getattr(tree, f))) for f in QW_FIELDS}
        d["kernel"] = tree.kernel
        return d
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


class _Jitted:
    """The JAX model with prefill/decode_step jitted."""

    def __init__(self, model):
        self.model = model
        self.init_cache = model.init_cache
        self.prefill = jax.jit(model.prefill)
        self.decode_step = jax.jit(model.decode_step)


@pytest.fixture(scope="module")
def zamba():
    jcfg = jax_config(ARCH).reduced(dtype="float32", attn_impl="full")
    jmodel = jax_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(1))
    cfg = get_config(ARCH).reduced(dtype="float32", attn_impl="full")
    model = params_from_numpy(_to_numpy(jparams), cfg, "cpu")
    return _Jitted(jmodel), jparams, cfg, model


def _decode_trees(setup, quant):
    _, jparams, cfg, model = setup
    if quant is None:
        return jparams, model
    jtree = jq.quantize_decode_params(jparams, quant)
    return jtree, params_from_numpy(_to_numpy(jtree), cfg, "cpu")


def _check_caches(got, want, groups, *, pool=False, tol=TOL):
    """The port's flat cache list against JAX's (attn list, stacked SSM
    pair); a pool's garbage block (written by parked rows) is left out."""
    jattn, jssm = want
    assert len(got) == groups + jssm.conv.shape[0]
    for g in range(groups):
        assert isinstance(got[g], KVCache)
        for a, b in zip(got[g], jattn[g]):
            a, b = a.numpy(), np.asarray(b)
            if pool:
                a, b = a[GARBAGE_BLOCK + 1:], b[GARBAGE_BLOCK + 1:]
            np.testing.assert_allclose(a, b, **tol)
    for i, c in enumerate(got[groups:]):
        assert isinstance(c, SSMCache)
        np.testing.assert_allclose(c.conv.numpy(), np.asarray(jssm.conv[i]),
                                   **tol)
        np.testing.assert_allclose(c.state.numpy(),
                                   np.asarray(jssm.state[i]), **tol)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_bridge_round_trips_bit_exactly(zamba):
    _, jparams, cfg, model = zamba
    assert isinstance(model, HybridLM)
    assert len(model.mamba) == cfg.num_layers == 4 and model.num_groups == 2
    assert model.shared.attn.heads == (4, 2, 32)
    want = _to_numpy(jparams)
    got = params_to_numpy(model)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _paths(node, path=()):
    if isinstance(node, (JQW, tq.QuantizedWeight)):
        return {path}
    if isinstance(node, dict):
        return set().union(*(_paths(v, path + (k,)) for k, v in node.items()))
    if isinstance(node, list):
        return set().union(*(_paths(v, path + (i,))
                             for i, v in enumerate(node)))
    return set()


@pytest.mark.parametrize("quant", ["lut4", "nf4p"])
def test_frozen_tree_quantizes_jax_leaves(zamba, quant):
    _, jparams, cfg, model = zamba
    jtree = jq.quantize_decode_params(jparams, quant)
    ttree = tq.quantize_decode_params(model.params_tree(), quant)
    jpaths, tpaths = _paths(jtree), _paths(ttree)
    # JAX stacks "mamba" (one path for every layer); the port lists them
    want = {p for p in jpaths if p[0] == "shared"} | {
        ("mamba", i) + p[1:] for p in jpaths if p[0] == "mamba"
        for i in range(cfg.num_layers)}
    assert tpaths == want
    assert {p[1:] for p in tpaths if p[0] == "shared"} == {
        ("attn", n) for n in ("wq", "wk", "wv", "wo")} | {
        ("mlp", n) for n in ("w_gate", "w_up", "w_down")}
    assert {p[2:] for p in tpaths if p[0] == "mamba"} == {
        ("m", "w_in"), ("m", "w_out")}
    for path in tpaths:
        got, want_qw = ttree, jtree
        for i, key in enumerate(path):
            got = got[key]
            if path[0] == "mamba" and i == 1:
                continue                    # the stacked axis, below
            want_qw = want_qw[key]
        if path[0] == "mamba":
            want_qw = jax.tree.map(lambda a, i=path[1]: a[i], want_qw)
        assert got.kernel == want_qw.kernel
        for f in QW_FIELDS:
            a, b = getattr(want_qw, f), getattr(got, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the bridge carries the frozen tree both ways, bit-exactly
    frozen = params_from_numpy(_to_numpy(jtree), cfg, "cpu")
    for a, b in zip(jax.tree.leaves(_to_numpy(jtree)),
                    jax.tree.leaves(params_to_numpy(frozen))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quant", QUANTS)
def test_bucketed_prefill_and_decode_match_jax(zamba, quant):
    """Right-padded prompts of lengths 3 and 7 in one 8-wide bucket, logits
    at each row's ``last_pos``, then 6 per-row decode steps through the
    (frozen) decode tree: logits and both halves of the slab."""
    jmodel, jparams, cfg, model = zamba
    jdec, tdec = _decode_trees(zamba, quant)
    rng = np.random.default_rng(1)
    lens = np.array([3, 7])
    toks = np.zeros((2, 8), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    jl, jc = jmodel.prefill(jparams, jnp.asarray(toks),
                            jmodel.init_cache(2, 16),
                            last_pos=jnp.asarray(lens - 1))
    with torch.inference_mode():
        tl, tc = model.prefill(torch.from_numpy(toks), model.init_cache(2, 16),
                               last_pos=torch.from_numpy(lens - 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    follow = rng.integers(1, cfg.vocab_size, (2, 6))
    for t in range(6):
        tok = follow[:, t:t + 1]
        jl, jc = jmodel.decode_step(jdec, jnp.asarray(tok), jc,
                                    jnp.asarray(lens + t, jnp.int32))
        with torch.inference_mode():
            tl, tc = tdec.decode_step(torch.from_numpy(tok), tc,
                                      torch.from_numpy(lens + t))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {t}")
    _check_caches(tc, jc, model.num_groups)


def test_chunked_continuation_matches_jax(zamba):
    """A 1-row staging cache fed in pieces (9 tokens, then 5 more at
    ``cache_index`` 9, right-padded to 8 with ``last_pos``): the shared
    block writes at the offset, the scan resumes from the carried state."""
    jmodel, jparams, cfg, model = zamba
    toks = np.random.default_rng(2).integers(1, cfg.vocab_size, (1, 14))
    tail = np.zeros((1, 8), np.int64)
    tail[0, :5] = toks[0, 9:]
    jc = jmodel.init_cache(1, 32)
    tc = model.init_cache(1, 32)
    jprefill = jax.jit(jmodel.model.prefill, static_argnames="cache_index")
    jl, jc = jprefill(jparams, jnp.asarray(toks[:, :9]), jc)
    with torch.inference_mode():
        tl, tc = model.prefill(torch.from_numpy(toks[:, :9]), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jl, jc = jprefill(jparams, jnp.asarray(tail), jc,
                      last_pos=jnp.asarray([4]), cache_index=9)
    with torch.inference_mode():
        tl, tc = model.prefill(torch.from_numpy(tail), tc,
                               last_pos=torch.tensor([4]), cache_index=9)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_caches(tc, jc, model.num_groups)
    # the pieces equal the whole prompt at once
    with torch.inference_mode():
        whole, _ = model.prefill(torch.from_numpy(toks),
                                 model.init_cache(1, 32))
    np.testing.assert_allclose(tl.numpy(), whole.numpy(), **TOL)


def test_loss_matches_jax(zamba):
    jmodel, jparams, cfg, model = zamba
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 16))
    labels = rng.integers(0, cfg.vocab_size, (2, 16))
    jloss, _ = jax.jit(jmodel.model.loss)(
        jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    loss, aux = model.loss({"tokens": torch.from_numpy(toks),
                            "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    assert set(aux) == {"xent"}


SUBSTRATES = {"dense": {}, "split": dict(paged=True, block_size=8)}


@pytest.fixture(scope="module")
def jax_admitted(zamba):
    """JAX engines (lut4) after the admission and first decode tick of
    :func:`_admitted`'s prompts, one per substrate; read, never stepped
    (JAX's caches are immutable)."""
    return {}


def _admitted(setup, jax_engines, substrate):
    """A port and a JAX engine (lut4) after the same admission and one
    decode tick of three prompts (lengths 5, 11, 3) on 3 slots."""
    jmodel, jparams, cfg, model = setup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 11, 3)]
    conf = dict(max_batch=3, max_seq=48, quant="lut4",
                **SUBSTRATES[substrate])
    eng = Engine(cfg, model, EngineConfig(**conf), device="cpu")
    eng.serve([Request(rid=i, prompt=list(p), max_new=8)
               for i, p in enumerate(prompts)], max_ticks=1)
    if substrate not in jax_engines:
        jeng = JaxEngine(jmodel.model.cfg, jparams, JaxEngineConfig(**conf))
        jeng.serve([JaxRequest(rid=i, prompt=list(p), max_new=8)
                    for i, p in enumerate(prompts)], max_ticks=1)
        jax_engines[substrate] = jeng
    jeng = jax_engines[substrate]
    np.testing.assert_array_equal(eng.positions, jeng.positions)
    return eng, jeng


@pytest.mark.parametrize("substrate", list(SUBSTRATES))
def test_engine_decode_steps_match_jax(zamba, jax_admitted, substrate):
    """After the same admission (the staged rows scattered into the slab,
    or split between the pool and the dense state), three decode steps
    through the lut4 tree at per-row positions: logits and both halves of
    the substrate equal JAX's."""
    eng, jeng = _admitted(zamba, jax_admitted, substrate)
    groups = zamba[3].num_groups
    assert isinstance(eng.backend, HybridComposite) == (substrate == "split")
    _check_caches(eng.caches, jeng.caches, groups, pool=eng.paged)
    rng = np.random.default_rng(6)
    caches, jcaches = eng.caches, jeng.caches
    pos = eng.positions.copy()
    jstep = jax.jit(jeng.model.decode_step)
    for t in range(3):
        tok = rng.integers(1, zamba[2].vocab_size, (3, 1))
        with torch.inference_mode():
            tl, caches = eng.decode_params.decode_step(
                torch.as_tensor(tok), caches, torch.as_tensor(pos),
                tables=eng.backend.decode_tables([]))
        jl, jcaches = jstep(
            jeng.decode_params, jnp.asarray(tok, jnp.int32), jcaches,
            jnp.asarray(pos, jnp.int32),
            tables=jeng.backend.decode_tables([]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {t}")
        pos += 1
    _check_caches(caches, jcaches, groups, pool=eng.paged)


@pytest.mark.parametrize("substrate", list(SUBSTRATES))
def test_decode_window_matches_jax(zamba, jax_admitted, substrate):
    """One verify window after the same admission: n_valid (5, 2, 0) with
    ``last_pos = n_valid - 1`` (the last row fully masked): logits within
    1e-4 of JAX's, both halves of the caches JAX's, the masked row's SSM
    state and conv window passed through bitwise, and the caller's SSM
    leaves only read."""
    eng, jeng = _admitted(zamba, jax_admitted, substrate)
    groups = zamba[3].num_groups
    toks = np.random.default_rng(3).integers(1, zamba[2].vocab_size, (3, 5))
    n_valid = np.array([5, 2, 0])
    before = [[t.clone() for t in layer] for layer in eng.caches[groups:]]
    with torch.inference_mode():
        logits, caches = eng.decode_params.decode_window(
            torch.as_tensor(toks), eng.caches,
            torch.as_tensor(eng.positions),
            tables=eng.backend.decode_tables([]),
            n_valid=torch.as_tensor(n_valid),
            last_pos=torch.as_tensor(n_valid - 1))
    jlogits, jcaches = jax.jit(jeng.model.decode_window)(
        jeng.decode_params, jnp.asarray(toks, jnp.int32), jeng.caches,
        jnp.asarray(jeng.positions),
        tables=jeng.backend.decode_tables([]),
        n_valid=jnp.asarray(n_valid, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    _check_caches(caches, jcaches, groups, pool=eng.paged)
    for i, c in enumerate(caches[groups:]):
        assert torch.equal(c.state[2], before[i][1][2])      # last_pos -1
        assert torch.equal(c.conv[2], before[i][0][2])
        live = eng.caches[groups + i]
        assert torch.equal(live.state, before[i][1])         # only read
        assert torch.equal(live.conv, before[i][0])


# ---------------------------------------------------------------------------
# the engine, against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's runs, one per (mix, config), shared by the tests."""
    return {}


def _jax_serve(setup, runs, key, prompts, max_new, knobs):
    if key not in runs:
        jmodel, jparams, _, _ = setup
        eng = JaxEngine(jmodel.model.cfg, jparams, JaxEngineConfig(**knobs))
        reqs = [JaxRequest(rid=i, prompt=list(p), max_new=max_new)
                for i, p in enumerate(prompts)]
        stats = eng.serve(reqs)
        assert stats["done"]
        runs[key] = ([r.out for r in reqs], stats, eng.metrics)
    return runs[key]


def _serve(setup, prompts, max_new, **knobs):
    _, _, cfg, model = setup
    eng = Engine(cfg, model, EngineConfig(**knobs), device="cpu")
    reqs = [Request(rid=i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    stats = eng.serve(reqs)
    assert stats["done"]
    return [r.out for r in reqs], stats, eng


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]


MIXED_LENS = (3, 9, 5, 17, 2)


@pytest.mark.parametrize("quant", QUANTS)
def test_mixed_lengths_slab_and_split_equal_jax(zamba, jax_runs, quant):
    """5 mixed-length requests on 3 slots (slot reuse, a mixed-depth
    slab): the slab's tokens and the split substrate's (block 8) equal
    the JAX engine's slab run (JAX pins its split substrate to its slab:
    ``tests/test_engine.py``)."""
    prompts = _prompts(zamba[2], MIXED_LENS)
    knobs = dict(max_batch=3, max_seq=48, quant=quant)
    want, _, _ = _jax_serve(zamba, jax_runs, ("mixed", quant), prompts, 6,
                            knobs)
    dense, _, eng = _serve(zamba, prompts, 6, **knobs)
    assert isinstance(eng.backend, RecurrentState)
    split, _, eng = _serve(zamba, prompts, 6, paged=True, block_size=8,
                           **knobs)
    assert isinstance(eng.backend, HybridComposite)
    assert dense == want
    assert split == want
    assert eng.allocator.used_blocks == 0


@pytest.mark.parametrize("quant", QUANTS)
def test_chunked_prefill_modes_equal_whole_and_jax(zamba, jax_runs, quant):
    """``tests/test_engine.py``'s recurrent pin for the hybrid: bucketed,
    chunked (8-token pieces resuming the scan) and paged-chunked (the
    split substrate) are token-identical to the whole-prompt exact-length
    run.  Prefill is full precision under every quant mode, so JAX's run
    anchors the full-precision case (the frozen decode trees are held to
    JAX's by the mixed-length test)."""
    prompts = _prompts(zamba[2], (31, 4, 12), seed=3)   # 31 == max_seq - 1
    base = dict(max_batch=2, max_seq=32, quant=quant)
    modes = {"whole_exact": {"prefill_bucket": 1}, "bucketed": {},
             "chunked": {"prefill_chunk": 8},
             "paged_chunked": {"prefill_chunk": 8, "paged": True,
                               "block_size": 8}}
    outs = {}
    for mode, kw in modes.items():
        outs[mode], stats, _ = _serve(zamba, prompts, 5, **base, **kw)
        if "chunk" in mode:
            assert stats["prefill_chunks"] >= 4
    for mode in modes:
        assert outs[mode] == outs["whole_exact"], mode
    if quant is None:
        # JAX's bucketed run (JAX pins it to its whole-prompt oracle)
        want, _, _ = _jax_serve(zamba, jax_runs, ("chunk",), prompts, 5,
                                base)
        assert outs["whole_exact"] == want


def _serve_each(setup, prompts, max_new, **knobs):
    _, _, cfg, model = setup
    eng = Engine(cfg, model, EngineConfig(**knobs), device="cpu")
    reqs = [Request(rid=i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.serve([r])["done"]
    return [r.out for r in reqs], eng


@pytest.mark.parametrize("kw", [{}, {"prefill_chunk": 8}],
                         ids=["bucketed", "chunked"])
def test_warm_equals_cold_and_jax(zamba, kw):
    """``tests/test_prefix_cache.py``'s zamba2 pin: a shared 18-token head
    with divergent tails, one request at a time on the split substrate:
    warm == cold, and the hits and reused tokens are JAX's (both halves
    warm at one block-aligned boundary)."""
    jmodel, jparams, cfg, _ = zamba
    rng = np.random.default_rng(0)
    head = rng.integers(1, cfg.vocab_size, 18).tolist()
    prompts = [head + rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (6, 5, 7)]
    knobs = dict(max_batch=2, max_seq=48, paged=True, block_size=8, **kw)
    cold, _ = _serve_each(zamba, prompts, 4, **knobs)
    warm, eng = _serve_each(zamba, prompts, 4, prefix_cache=True, **knobs)
    assert warm == cold
    jeng = JaxEngine(jmodel.model.cfg, jparams,
                     JaxEngineConfig(prefix_cache=True, **knobs))
    jreqs = [JaxRequest(rid=i, prompt=list(p), max_new=4)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        assert jeng.serve([r])["done"]
    assert warm == [r.out for r in jreqs]
    m, jm = eng.metrics, jeng.metrics
    assert m.prefix_hits >= 1 and m.prefix_tokens_reused >= 16
    assert (m.prefix_hits, m.prefix_tokens_reused, m.prefill_tokens) == \
        (jm.prefix_hits, jm.prefix_tokens_reused, jm.prefill_tokens)
    # every block is free or held by the prefix cache alone
    owners = eng.prefix_cache._block_owners
    assert all(eng.allocator.refcount(b) == n for b, n in owners.items())
    assert eng.allocator.free_blocks + len(owners) == \
        eng.backend.num_blocks - 1


SPEC_KEYS = ("spec_ticks", "spec_drafted", "spec_accepted", "spec_rejected",
             "decode_tokens", "ticks")


@pytest.mark.parametrize("mode", ["ngram", "self_lut"])
@pytest.mark.parametrize("substrate", list(SUBSTRATES))
def test_spec_tokens_equal_plain_and_jax(zamba, jax_runs, substrate, mode):
    """``tests/test_spec.py``'s zamba2 cases (dense and paged): spec
    tokens == plain greedy == JAX's, and drafted == accepted + rejected.
    One JAX run anchors all four: its dense self_lut run (JAX pins its
    spec tokens to its plain greedy and its split substrate to its slab);
    self_lut's counts equal that run's on both substrates (the drafts are
    the nf4p model's, whatever the substrate).  ngram's counts follow from
    the tokens alone (its proposer is held to JAX's in
    ``tests/test_torch_spec.py``)."""
    prompts = _prompts(zamba[2], (5, 11, 3))
    knobs = dict(max_batch=3, max_seq=48, **SUBSTRATES[substrate])
    base, _, _ = _serve(zamba, prompts, 8, **knobs)
    out, _, eng = _serve(zamba, prompts, 8, spec=mode, **knobs)
    assert out == base
    want, _, jm = _jax_serve(zamba, jax_runs, ("spec",), prompts, 8,
                             dict(max_batch=3, max_seq=48, spec="self_lut"))
    assert out == want
    m = eng.metrics
    assert m.spec_accepted + m.spec_rejected == m.spec_drafted
    if mode == "self_lut":
        assert m.spec_drafted > 0 and m.spec_ticks > 0
        assert {k: getattr(m, k) for k in SPEC_KEYS} == \
            {k: getattr(jm, k) for k in SPEC_KEYS}


def test_loop_stream_equals_sync_on_split(zamba):
    """``tests/test_serve_loop.py``'s hybrid case: the background loop's
    token streams equal the synchronous ``serve()`` run's on the split
    substrate (whose tokens the tests above hold to JAX's)."""
    prompts = _prompts(zamba[2], (3, 9, 5, 12))
    knobs = dict(max_batch=2, max_seq=48, paged=True, block_size=8)
    ref, _, _ = _serve(zamba, prompts, 5, **knobs)
    _, _, cfg, model = zamba
    loop = Engine(cfg, model, EngineConfig(**knobs), device="cpu").start()
    outs = [None] * len(prompts)
    try:
        reqs = [Request(rid=i, prompt=list(p), max_new=5)
                for i, p in enumerate(prompts)]
        handles = [loop.submit(r) for r in reqs]

        def consume(i):
            outs[i] = list(handles[i].tokens())
        threads = [threading.Thread(target=consume, args=(i,), daemon=True)
                   for i in range(len(handles))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert all(not t.is_alive() for t in threads), "stream hung"
    finally:
        assert loop.stop(timeout=120)
    assert outs == [r.out for r in reqs] == ref
    assert loop.allocator.used_blocks == 0


def test_families_map_to_substrates_as_jax(zamba):
    assert "hybrid" in SERVED_FAMILIES and "hybrid" in PAGED_FAMILIES
    assert "hybrid" in RECURRENT_FAMILIES
    EngineConfig(paged=True, prefix_cache=True).validate("hybrid")
    with pytest.raises(ValueError, match="prefix_cache"):
        EngineConfig(prefix_cache=True).validate("hybrid")
    _, _, cfg, model = zamba
    eng = Engine(cfg, model, EngineConfig(max_batch=2, max_seq=16,
                                          paged=True, block_size=4),
                 device="cpu")
    assert isinstance(eng.backend, HybridComposite)
    assert eng.backend.needs_state and eng.backend.stage_len == 16
    # the split substrate: KV leaves are pools, SSM leaves dense per slot
    kv, ssm = eng.caches[0], eng.caches[model.num_groups]
    assert kv.k.shape == (eng.backend.num_blocks, 4, 2, 32)
    assert ssm.state.shape[0] == 2


def test_entry_points_refuse_the_cpu_unless_asked(zamba):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = zamba[2]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HybridLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, zamba[3], EngineConfig(max_batch=1, max_seq=16))


# ---------------------------------------------------------------------------
# copy-on-write: the port writes caches in place, JAX's arrays are immutable
# ---------------------------------------------------------------------------

def _spec_engine(setup, prompts, **knobs):
    """A self_lut engine with its requests admitted and one tick run."""
    _, _, cfg, model = setup
    eng = Engine(cfg, model, EngineConfig(max_batch=3, max_seq=48,
                                          spec="self_lut", quant="lut4",
                                          **knobs), device="cpu")
    eng.serve([Request(rid=i, prompt=list(p), max_new=10)
               for i, p in enumerate(prompts)], max_ticks=1)
    return eng


def _ssm_copies(eng, groups):
    return [[t.clone() for t in layer] for layer in eng.caches[groups:]]


@pytest.mark.parametrize("substrate", list(SUBSTRATES))
def test_verify_leaves_pre_ssm_untouched(zamba, substrate):
    """The verify pass returns the SSM half as new tensors: the caches
    the engine keeps as ``pre`` (and re-commits a partial accept from)
    still hold the pre-verify state, value for value."""
    groups = zamba[3].num_groups
    eng = _spec_engine(zamba, _prompts(zamba[2], (5, 11, 3)),
                       **SUBSTRATES[substrate])
    pre = list(eng.caches)
    saved = _ssm_copies(eng, groups)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        1, zamba[2].vocab_size, (3, 5)))
    n_valid = torch.tensor([5, 3, 1])
    with torch.inference_mode():
        _, post = eng._verify(eng.decode_params, toks, pre,
                              torch.as_tensor(eng.positions),
                              eng.backend.decode_tables([]), n_valid,
                              n_valid - 1)
    for i, (p, q, s) in enumerate(zip(pre[groups:], post[groups:], saved)):
        assert p.state.data_ptr() != q.state.data_ptr(), i
        assert p.conv.data_ptr() != q.conv.data_ptr(), i
        assert torch.equal(p.state, s[1]) and torch.equal(p.conv, s[0])
        assert not torch.equal(q.state, p.state)     # the window moved it
    assert all(a is b for a, b in zip(post[:groups], pre[:groups]))


def test_self_lut_draft_leaves_live_ssm_untouched(zamba):
    """self_lut's draft steps run on the live caches: their KV writes land
    at the rows' future positions, their SSM state is discarded, so the
    live state is unchanged, value for value and object for object."""
    groups = zamba[3].num_groups
    eng = _spec_engine(zamba, _prompts(zamba[2], (5, 11, 3)))
    live = list(eng.caches)
    saved = _ssm_copies(eng, groups)
    with torch.inference_mode():
        drafts = eng._spec.propose(eng.slots, [4, 4, 4])
    assert [len(d) for d in drafts] == [4, 4, 4]
    assert all(a is b for a, b in zip(eng.caches, live))
    for layer, s in zip(eng.caches[groups:], saved):
        assert torch.equal(layer.state, s[1]) and torch.equal(layer.conv, s[0])


def test_rollback_keeps_pool_accounting(zamba):
    eng = _spec_engine(zamba, _prompts(zamba[2], (5, 11, 3)),
                       paged=True, block_size=8)
    backend = eng.backend
    assert isinstance(backend, HybridComposite)
    free = backend.free_blocks
    blocks = [list(backend.slot_blocks(s)) for s in range(3)]
    tables = backend.block_tables.copy()
    with eng._lock:
        for s in range(3):
            backend.rollback(s, 3)
    assert backend.free_blocks == free
    assert [backend.slot_blocks(s) for s in range(3)] == blocks
    np.testing.assert_array_equal(backend.block_tables, tables)
    eng.serve([])                                   # drain: slots freed
    with eng._lock, pytest.raises(AssertionError, match="no reservation"):
        backend.rollback(0, 1)
    assert backend.free_blocks == backend.num_blocks - 1


def test_snapshot_is_a_clone(zamba):
    """A prefix-cache snapshot is a copy of the slot's SSM row that later
    decode ticks cannot change."""
    groups = zamba[3].num_groups
    eng = _spec_engine(zamba, _prompts(zamba[2], (5, 11, 3)),
                       paged=True, block_size=8)
    snap = eng.backend.snapshot(eng.caches, 1)
    assert len(snap) == zamba[2].num_layers
    for sn, layer in zip(snap, eng.caches[groups:]):
        assert sn.state.shape[0] == 1
        assert torch.equal(sn.state[0], layer.state[1])
        assert sn.state.data_ptr() != layer.state[1:2].data_ptr()
    kept = [s.state.clone() for s in snap]
    eng.step()                                      # the live row moves on
    assert all(torch.equal(s.state, k) for s, k in zip(snap, kept))
    assert not all(torch.equal(s.state[0], layer.state[1])
                   for s, layer in zip(snap, eng.caches[groups:]))


def test_seeding_copies(zamba):
    """Seeding a staging row copies the snapshot in: the staging KV leaves
    are kept (they hold the gathered shared blocks), the SSM leaves take
    the snapshot's values in their own storage."""
    groups = zamba[3].num_groups
    eng = _spec_engine(zamba, _prompts(zamba[2], (5, 11, 3)),
                       paged=True, block_size=8)
    backend = eng.backend
    snap = backend.snapshot(eng.caches, 0)
    tbl = torch.as_tensor(backend.staging_table(backend.slot_blocks(0)[:1]))
    staging = backend.gather_staging(eng.caches, tbl)
    kv = [layer.k for layer in staging[:groups]]
    seeded = backend.seed_snapshot(staging, snap)
    assert all(a.k is b for a, b in zip(seeded[:groups], kv))
    for st, sn in zip(seeded[groups:], snap):
        assert torch.equal(st.state, sn.state) and torch.equal(st.conv,
                                                               sn.conv)
        assert st.state.data_ptr() != sn.state.data_ptr()
    before = [s.state.clone() for s in snap]
    for st in seeded[groups:]:
        st.state.add_(1.0)                          # the tail prefill writes
    assert all(torch.equal(s.state, b) for s, b in zip(snap, before))
    # the gathered KV is the slot's prefix, read from the pool as a copy
    b0 = backend.slot_blocks(0)[0]
    for layer, pool in zip(staging[:groups], eng.caches[:groups]):
        assert torch.equal(layer.k[0, :8], pool.k[b0])
        assert layer.k.data_ptr() != pool.k.data_ptr()
