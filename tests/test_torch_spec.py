"""The port's speculative decoding against the JAX package
(``tests/test_spec.py``), on bridged reduced f32 weights.

* ``accept_length``, ``_prompt_lookup`` and ``NGramProposer`` equal JAX's
  on seeded random contexts; the config surface raises as JAX's does.
* ``quantize_draft_params`` gives JAX's nf4p codes and tables bitwise,
  and ``SelfLutProposer`` drafts JAX's tokens.
* ``decode_window`` logits within 1e-4 of JAX's (``WINDOW_TOL``) on the
  dense slab, the paged pool and mamba2 (``last_pos`` -1 included), with
  a mixed ``n_valid``.
* Spec tokens == plain greedy tokens == JAX's spec tokens for (yi-9b
  dense, yi-9b paged, mamba2) x (ngram, self_lut), with JAX's spec
  metrics; the cancel, preempt, warm-prefix and ``max_new=1`` cases of
  ``tests/test_spec.py:147-277``.
* The port writes caches in place where JAX's speculation relies on
  immutable arrays; one test per hazard: draft writes never touch a
  shared prefix block, invalid window columns never write outside the
  garbage block or past ``max_seq - 1``, the live cache below each row's
  pointer after a spec run equals a plain run's (``CACHE_TOL``), and
  mamba2's partial-accept commit leaves the plain run's state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import quantize_draft_params as jax_draft_params
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.serve.config import EngineConfig as JaxEngineConfig
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.sampling import SamplingConfig as JaxSamplingConfig
from repro.serve.spec import NGramProposer as JaxNGram
from repro.serve.spec import _prompt_lookup as jax_lookup
from repro.serve.spec import accept_length as jax_accept
from repro_torch.bridge import params_from_numpy
from repro_torch.core.quant import (SPEC_DRAFT_QUANT, QuantizedWeight,
                                    quantize_draft_params)
from repro_torch.models.registry import get_config
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.paged import GARBAGE_BLOCK
from repro_torch.serve.sampling import SamplingConfig
from repro_torch.serve.spec import NGramProposer, _prompt_lookup, accept_length

#: decode_window logits, port against JAX (f32, the same as the port's
#: other logits parity: summation order differs, nothing else)
WINDOW_TOL = 1e-4
#: a spec run's live caches against a plain run's (f32; verify computes
#: the same K/V in a wider GEMM)
CACHE_TOL = 1e-5


def _bridged(arch, **over):
    jcfg = jax_config(arch).reduced(dtype="float32", **over)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(1))
    cfg = get_config(arch).reduced(dtype="float32", **over)
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module")
def yi():
    return _bridged("yi-9b", attn_impl="full")


@pytest.fixture(scope="module")
def mamba():
    return _bridged("mamba2-1.3b")


def _prompts(cfg, lens=(5, 11, 3), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]


def _serve(setup, prompts, max_new=8, **knobs):
    _, _, cfg, model = setup
    eng = Engine(cfg, model, EngineConfig(max_batch=3, max_seq=48, **knobs),
                 device="cpu")
    reqs = [Request(rid=i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    assert eng.serve(reqs)["done"]
    return [r.out for r in reqs], eng


# --- host-side helpers, against JAX ---------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_accept_length_and_prompt_lookup_as_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        vocab = int(rng.integers(2, 6))     # small vocab: repeats happen
        ctx = rng.integers(0, vocab, int(rng.integers(1, 30))).tolist()
        k = int(rng.integers(1, 6))
        max_n = int(rng.integers(1, 4))
        min_n = int(rng.integers(1, max_n + 1))
        assert _prompt_lookup(ctx, k, max_n, min_n) == \
            jax_lookup(ctx, k, max_n, min_n)
        drafts = rng.integers(0, vocab, int(rng.integers(0, 5))).tolist()
        targets = rng.integers(0, vocab, len(drafts) + 1).tolist()
        assert accept_length(drafts, targets) == jax_accept(drafts, targets)
    assert _prompt_lookup([5, 1, 2, 5, 9, 1, 2], 2, 3, 1) == [5, 9]
    assert accept_length([9, 5], [4, 5, 6]) == 0


def test_ngram_proposer_as_jax():
    rng = np.random.default_rng(7)
    for _ in range(50):
        prompt = rng.integers(0, 4, int(rng.integers(1, 12))).tolist()
        out = rng.integers(0, 4, int(rng.integers(1, 6))).tolist()
        k = [int(rng.integers(0, 5)), int(rng.integers(0, 5))]
        port = Request(rid=0, prompt=prompt, out=list(out))
        ref = JaxRequest(rid=0, prompt=prompt, out=list(out))
        assert NGramProposer().propose([port, None], k) == \
            JaxNGram().propose([ref, None], k)


@pytest.mark.parametrize("kw,match", [
    (dict(spec="medusa"), "spec must be one of"),
    (dict(spec="ngram", spec_k=0), "spec_k"),
    (dict(spec="ngram", sampling="temperature"), "greedy-only"),
    (dict(trace_buffer=0), "trace_buffer"),
    (dict(idle_backoff_s=-1.0), "idle_backoff_s")])
def test_spec_config_validation_as_jax(kw, match):
    for conf, samp in ((EngineConfig, SamplingConfig),
                       (JaxEngineConfig, JaxSamplingConfig)):
        args = dict(kw)
        if args.get("sampling"):
            args["sampling"] = samp(mode="temperature", temperature=0.7)
        with pytest.raises(ValueError, match=match):
            conf(**args)
        conf(spec="ngram", sampling=samp(mode="greedy"))
        conf(spec="self_lut", spec_k=2)


# --- the draft model --------------------------------------------------------
def test_quantize_draft_params_bitwise_as_jax(yi):
    _, jparams, cfg, model = yi
    assert SPEC_DRAFT_QUANT == "nf4p"
    jtree = jax_draft_params(jparams)
    ttree = quantize_draft_params(model.params_tree())
    n = 0
    for i, blk in enumerate(ttree["blocks"]):
        for g in ("attn", "mlp"):
            for name, qw in blk[g].items():
                assert isinstance(qw, QuantizedWeight)
                ref = jax.tree.map(lambda a: a[i], jtree["blocks"][g][name])
                assert qw.kernel == ref.kernel == "nf4_dc"
                for f in ("codes", "scale", "zero_point", "hi_tab", "lo_tab",
                          "residual"):
                    np.testing.assert_array_equal(
                        getattr(qw, f).numpy(), np.asarray(getattr(ref, f)),
                        err_msg=f"{i} {g} {name} {f}")
                n += 1
    assert n == 7 * cfg.num_layers


@pytest.mark.parametrize("arch", ["yi", "mamba"])
def test_self_lut_drafts_as_jax(request, arch):
    """After the same admission, the port's drafter proposes JAX's
    tokens for every row."""
    setup = request.getfixturevalue(arch)
    jcfg, jparams, cfg, model = setup
    prompts = _prompts(cfg)
    knobs = dict(max_batch=3, max_seq=48, spec="self_lut")
    eng = Engine(cfg, model, EngineConfig(**knobs), device="cpu")
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**knobs))
    reqs = [Request(rid=i, prompt=list(p), max_new=8)
            for i, p in enumerate(prompts)]
    jreqs = [JaxRequest(rid=i, prompt=list(p), max_new=8)
             for i, p in enumerate(prompts)]
    eng.serve(reqs, max_ticks=0)
    jeng.serve(jreqs, max_ticks=0)
    with eng._lock:
        eng._admit_pending()
    jeng._admit_pending()
    k_eff = [4, 2, 3]
    with torch.inference_mode():
        drafts = eng._spec.propose(eng.slots, k_eff)
    assert drafts == jeng._spec.propose(jeng.slots, k_eff)
    assert [len(d) for d in drafts] == k_eff


# --- decode_window, against JAX -------------------------------------------
WINDOW_CASES = [("yi", {}), ("yi", dict(paged=True, block_size=8)),
                ("mamba", {})]


@pytest.mark.parametrize("arch,knobs", WINDOW_CASES,
                         ids=["dense", "paged", "mamba2"])
def test_decode_window_logits_as_jax(request, arch, knobs):
    """After the same admission and one decode tick, one verify window
    (n_valid 5, 2, 0: the last row writes nothing; mamba2's last_pos -1)
    gives JAX's logits within WINDOW_TOL and JAX's caches."""
    setup = request.getfixturevalue(arch)
    jcfg, jparams, cfg, model = setup
    prompts = _prompts(cfg)
    conf = dict(max_batch=3, max_seq=48, quant="lut4", **knobs)
    eng = Engine(cfg, model, EngineConfig(**conf), device="cpu")
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**conf))
    eng.serve([Request(rid=i, prompt=list(p), max_new=8)
               for i, p in enumerate(prompts)], max_ticks=1)
    jeng.serve([JaxRequest(rid=i, prompt=list(p), max_new=8)
                for i, p in enumerate(prompts)], max_ticks=1)
    np.testing.assert_array_equal(eng.positions, jeng.positions)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab_size, (3, 5))
    n_valid = np.array([5, 2, 0])
    tables = eng.backend.decode_tables([])
    before = [[t.clone() for t in layer] for layer in eng.caches]
    with torch.inference_mode():
        logits, caches = eng.decode_params.decode_window(
            torch.as_tensor(toks), eng.caches,
            torch.as_tensor(eng.positions), tables=tables,
            n_valid=torch.as_tensor(n_valid))
    jlogits, jcaches = jeng.model.decode_window(
        jeng.decode_params, jnp.asarray(toks, jnp.int32), jeng.caches,
        jnp.asarray(jeng.positions), tables=jeng.backend.decode_tables([]),
        n_valid=jnp.asarray(n_valid, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=WINDOW_TOL, atol=WINDOW_TOL)
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jcaches)]
    if arch == "mamba":
        # per layer (conv, state); JAX stacks the layers on a leading axis
        jconv, jstate = jleaves
        for i, c in enumerate(caches):
            np.testing.assert_allclose(c.conv.numpy(), jconv[i],
                                       rtol=WINDOW_TOL, atol=WINDOW_TOL)
            np.testing.assert_allclose(c.state.numpy(), jstate[i],
                                       rtol=WINDOW_TOL, atol=WINDOW_TOL)
            assert torch.equal(c.state[2], before[i][1][2])   # last_pos -1
            assert torch.equal(c.conv[2], before[i][0][2])
    else:
        jk, jv = jleaves
        for i, layer in enumerate(caches):
            for got, want in ((layer.k, jk[i]), (layer.v, jv[i])):
                got = got.numpy()
                if eng.paged:
                    got = got[GARBAGE_BLOCK + 1:]
                    want = want[GARBAGE_BLOCK + 1:]
                np.testing.assert_allclose(got, want, rtol=WINDOW_TOL,
                                           atol=WINDOW_TOL)


# --- token identity, against plain greedy and JAX ---------------------------
SPEC_CASES = [("yi", False), ("yi", True), ("mamba", False)]
SPEC_KEYS = ("spec_ticks", "spec_drafted", "spec_accepted", "spec_rejected",
             "decode_tokens", "ticks")


@pytest.mark.parametrize("mode", ["ngram", "self_lut"])
@pytest.mark.parametrize("arch,paged", SPEC_CASES,
                         ids=["yi-dense", "yi-paged", "mamba2"])
def test_spec_tokens_equal_plain_and_jax(request, arch, paged, mode):
    setup = request.getfixturevalue(arch)
    jcfg, jparams, cfg, _ = setup
    prompts = _prompts(cfg)
    base, _ = _serve(setup, prompts, paged=paged)
    out, eng = _serve(setup, prompts, paged=paged, spec=mode)
    assert out == base
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(
        max_batch=3, max_seq=48, paged=paged, spec=mode))
    jreqs = [JaxRequest(rid=i, prompt=list(p), max_new=8)
             for i, p in enumerate(prompts)]
    assert jeng.serve(jreqs)["done"]
    assert out == [r.out for r in jreqs]
    m = eng.metrics
    assert {k: getattr(m, k) for k in SPEC_KEYS} == \
        {k: getattr(jeng.metrics, k) for k in SPEC_KEYS}
    assert m.spec_accepted + m.spec_rejected == m.spec_drafted
    if mode == "self_lut":
        assert m.spec_drafted > 0 and m.spec_ticks > 0
    assert m.decode_tokens == sum(len(o) - 1 for o in out)


def test_spec_metrics_and_obs(yi):
    prompts = _prompts(yi[2])
    _, eng = _serve(yi, prompts, spec="self_lut", trace=True)
    m = eng.metrics
    s = m.summary(3)
    assert s["spec_ticks"] == m.spec_ticks > 0
    assert s["spec_acceptance"] == m.spec_accepted / m.spec_drafted
    dump = eng.registry.dump()
    assert dump["engine_spec_accepted_per_window"]["series"]
    (key, _), = dump["engine_info"]["series"].items()
    assert "self_lut" in key
    series = dump["engine_spec_tokens_per_request"]["series"]
    assert all(v["count"] == len(prompts) for v in series.values())
    assert {"draft", "verify", "emit"} <= {e.name
                                          for e in eng.tracer.events()}


# --- lifecycle edges under speculation --------------------------------------
def _engine(setup, **knobs):
    _, _, cfg, model = setup
    return Engine(cfg, model, EngineConfig(**knobs), device="cpu")


def test_spec_cancel_from_callback_mid_window(yi):
    prompts = _prompts(yi[2], lens=(5, 7))
    base, _ = _serve(yi, prompts[:1], spec="self_lut")
    eng = _engine(yi, max_batch=2, max_seq=48, spec="self_lut")
    r0 = Request(rid=0, prompt=list(prompts[0]), max_new=8)
    r1 = Request(rid=1, prompt=list(prompts[1]), max_new=8)
    fired = []

    def kill_r1(tok):
        if len(r0.out) == 3 and not fired:
            fired.append(True)
            assert eng.cancel(r1)

    assert eng.submit(r0, on_token=kill_r1) and eng.submit(r1)
    for _ in range(64):
        if r0.done and r1.done:
            break
        eng.step()
    assert r0.done and r1.done and r1.cancelled
    assert r0.out == base[0] and eng.metrics.cancelled == 1


@pytest.mark.parametrize("arch", ["yi", "mamba"])
def test_spec_preempt_racing_mid_verify(request, arch):
    setup = request.getfixturevalue(arch)
    prompts = _prompts(setup[2], lens=(5, 7))
    base, _ = _serve(setup, prompts, spec="self_lut")
    eng = _engine(setup, max_batch=3, max_seq=48, spec="self_lut")
    r0 = Request(rid=0, prompt=list(prompts[0]), max_new=8)
    r1 = Request(rid=1, prompt=list(prompts[1]), max_new=8)
    fired = []

    def kick_r1(tok):
        if len(r0.out) == 3 and not fired:
            fired.append(True)
            eng.preempt(r1)

    assert eng.submit(r0, on_token=kick_r1) and eng.submit(r1)
    for _ in range(64):
        if r0.done and r1.done:
            break
        eng.step()
    assert fired and eng.metrics.preemptions == 1
    assert [r0.out, r1.out] == base


def test_spec_cancel_during_draft_window(yi):
    prompts = _prompts(yi[2], lens=(5, 7))
    eng = _engine(yi, max_batch=2, max_seq=48, spec="self_lut")
    r0 = Request(rid=0, prompt=list(prompts[0]), max_new=8)
    r1 = Request(rid=1, prompt=list(prompts[1]), max_new=8)
    assert eng.submit(r0) and eng.submit(r1)
    assert eng.cancel(r1)
    for _ in range(32):
        if r0.done:
            break
        eng.step()
    base, _ = _serve(yi, prompts[:1], spec="self_lut")
    assert r0.done and r0.out == base[0]


def test_spec_prefix_cache_warm_equals_cold(yi):
    rng = np.random.default_rng(3)
    shared = rng.integers(1, yi[2].vocab_size, 24).tolist()
    p_a = shared + rng.integers(1, yi[2].vocab_size, 4).tolist()
    p_b = shared + rng.integers(1, yi[2].vocab_size, 6).tolist()

    def run(prompts):
        eng = _engine(yi, max_batch=2, max_seq=64, paged=True,
                      prefix_cache=True, spec="self_lut")
        outs = []
        for i, p in enumerate(prompts):
            req = Request(rid=i, prompt=list(p), max_new=6)
            assert eng.serve([req])["done"]
            outs.append(req.out)
        return outs, eng

    warm, eng = run([p_a, p_b])
    assert warm == [run([p_a])[0][0], run([p_b])[0][0]]
    assert eng.metrics.prefix_hits >= 1


def test_spec_max_new_one_never_spec_ticks(yi):
    prompts = _prompts(yi[2])
    base, _ = _serve(yi, prompts, max_new=1)
    out, eng = _serve(yi, prompts, max_new=1, spec="self_lut")
    assert out == base and all(len(o) == 1 for o in out)
    assert eng.metrics.spec_ticks == 0


# --- the in-place hazards ------------------------------------------------
def test_draft_writes_never_touch_a_shared_prefix_block(yi):
    """A warm admission shares cached prefix blocks (refcount > 1); a spec
    run's draft and verify writes leave every such block bitwise as it
    was, and only the garbage block and the rows' private blocks change."""
    rng = np.random.default_rng(4)
    head = rng.integers(1, yi[2].vocab_size, 24).tolist()
    eng = _engine(yi, max_batch=2, max_seq=64, paged=True, block_size=8,
                  prefix_cache=True, spec="self_lut")
    assert eng.serve([Request(rid=0, prompt=head + [5, 6],
                              max_new=3)])["done"]
    warm = Request(rid=1, prompt=head + [7, 8, 9], max_new=12)
    eng.serve([warm], max_ticks=1)
    assert eng.metrics.prefix_hits == 1 and not warm.done
    held = eng.backend.slot_blocks(0) + eng.backend.slot_blocks(1)
    shared = [b for b in held if eng.allocator.refcount(b) > 1]
    assert len(shared) == 3
    snap = [(layer.k[shared].clone(), layer.v[shared].clone())
            for layer in eng.caches]
    drafts = []
    draft = eng._draft

    def counting(*a, **kw):
        drafts.append(1)
        return draft(*a, **kw)

    eng._draft = counting
    while not warm.done:
        eng.step()
    assert drafts and eng.metrics.spec_ticks > 0
    for layer, (k, v) in zip(eng.caches, snap):
        assert torch.equal(layer.k[shared], k)
        assert torch.equal(layer.v[shared], v)


@pytest.mark.parametrize("paged", [False, True])
def test_window_writes_equal_jax(paged):
    """``dense_write_window`` / ``paged_write_window`` on random caches and
    a mixed ``n_valid`` (rows past the slab's end and the table's width
    among them): the port's in-place writes leave JAX's result, where JAX
    drops the invalid entries."""
    from repro.models import common as jcommon
    from repro_torch.models import common as tcommon
    rng = np.random.default_rng(5)
    index = np.array([0, 3, 13, 14])
    n_valid = np.array([5, 0, 2, 1])
    new = rng.normal(size=(4, 5, 2, 3)).astype(np.float32)
    if paged:
        pool = rng.normal(size=(9, 4, 2, 3)).astype(np.float32)
        table = np.array([[1, 2, 0, 0], [3, 4, 0, 0], [5, 6, 7, 8],
                          [0, 0, 0, 0]])
        want = jcommon.paged_write_window(
            jnp.asarray(pool), jnp.asarray(new), jnp.asarray(table),
            jnp.asarray(index), jnp.asarray(n_valid))
        got = tcommon.paged_write_window(
            torch.as_tensor(pool), torch.as_tensor(new),
            torch.as_tensor(table), torch.as_tensor(index),
            torch.as_tensor(n_valid))
        # JAX drops what the port parks on the garbage block
        got, want = got[GARBAGE_BLOCK + 1:], np.asarray(want)[1:]
    else:
        slab = rng.normal(size=(4, 16, 2, 3)).astype(np.float32)
        want = jcommon.dense_write_window(
            jnp.asarray(slab), jnp.asarray(new), jnp.asarray(index),
            jnp.asarray(n_valid))
        got = tcommon.dense_write_window(
            torch.as_tensor(slab), torch.as_tensor(new),
            torch.as_tensor(index), torch.as_tensor(n_valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("paged", [False, True])
def test_invalid_window_columns_write_nowhere(yi, paged):
    """A window whose invalid columns run past ``max_seq - 1`` (and past
    the block table): the cache changes only at the real columns' targets
    (and, paged, on the garbage block)."""
    _, _, cfg, model = yi
    knobs = dict(paged=True, block_size=8) if paged else {}
    eng = _engine(yi, max_batch=3, max_seq=16, **knobs)
    reqs = [Request(rid=i, prompt=[3 + i] * (12 + i), max_new=2)
            for i in range(3)]
    eng.serve(reqs, max_ticks=0)
    with eng._lock:
        eng._admit_pending()
    pos = torch.as_tensor(eng.positions)            # 12, 13, 14
    n_valid = torch.tensor([2, 1, 0])
    before = [[t.clone() for t in layer] for layer in eng.caches]
    with torch.inference_mode():
        eng.decode_params.decode_window(
            torch.ones(3, 5, dtype=torch.long), eng.caches, pos,
            tables=eng.backend.decode_tables([]), n_valid=n_valid)
    for layer, old in zip(eng.caches, before):
        for new, prev in zip(layer, old):
            changed = (new != prev).flatten(2).any(-1)       # (rows, cols)
            if paged:
                targets = {(int(eng.block_tables[b, p // 8]), p % 8)
                           for b in range(3)
                           for p in range(int(pos[b]),
                                          int(pos[b] + n_valid[b]))}
                got = {(int(i), int(j)) for i, j in changed.nonzero()
                       if int(i) != GARBAGE_BLOCK}
            else:
                targets = {(b, p) for b in range(3)
                           for p in range(int(pos[b]),
                                          int(pos[b] + n_valid[b]))}
                got = {(int(i), int(j)) for i, j in changed.nonzero()}
            assert got == targets


@pytest.mark.parametrize("paged", [False, True])
def test_spec_live_cache_equals_plain_run(yi, paged):
    """After the same requests run to the same depth, the spec run's live
    K/V below each row's pointer equals the plain run's (CACHE_TOL): the
    drafts' nf4p writes never survive below the pointer."""
    prompts = _prompts(yi[2])
    knobs = dict(paged=True, block_size=8) if paged else {}

    def run(**kw):
        eng = _engine(yi, max_batch=3, max_seq=48, **knobs, **kw)
        reqs = [Request(rid=i, prompt=list(p), max_new=40)
                for i, p in enumerate(prompts)]
        eng.serve(reqs, max_ticks=0)
        while min(len(r.out) for r in reqs) < 12:
            eng.step()
        return eng, reqs

    plain, preqs = run()
    spec, sreqs = run(spec="self_lut")
    assert spec.metrics.spec_ticks > 0
    for s in range(3):
        depth = int(min(plain.positions[s], spec.positions[s]))
        assert depth >= len(prompts[s]) + 11
        assert sreqs[s].out[:depth - len(prompts[s]) + 1] == \
            preqs[s].out[:depth - len(prompts[s]) + 1]
        for lp, ls in zip(plain.caches, spec.caches):
            for a, b in zip(lp, ls):
                if paged:
                    rows = ((a, plain.block_tables[s]),
                            (b, spec.block_tables[s]))
                    a, b = (t[torch.as_tensor(tb)].flatten(0, 1)
                            for t, tb in rows)
                else:
                    a, b = a[s], b[s]
                torch.testing.assert_close(b[:depth], a[:depth],
                                           rtol=CACHE_TOL, atol=CACHE_TOL)


def test_mamba2_partial_accept_commit_equals_plain_state(mamba):
    """mamba2 under self_lut on lut4 weights (drafts on nf4p disagree, so
    commits run): after the same tokens, each row's recurrent state
    equals the plain run's (CACHE_TOL), and the commit ran."""
    prompts = _prompts(mamba[2])

    def run(**kw):
        eng = _engine(mamba, max_batch=3, max_seq=48, quant="lut4", **kw)
        reqs = [Request(rid=i, prompt=list(p), max_new=40)
                for i, p in enumerate(prompts)]
        eng.serve(reqs, max_ticks=0)
        return eng, reqs

    spec, sreqs = run(spec="self_lut")
    commits = []
    commit = spec._spec_commit

    def counting(*a, **kw):
        commits.append(1)
        return commit(*a, **kw)

    spec._spec_commit = counting
    while not commits or spec.metrics.spec_ticks < 3:
        spec.step()
    # the plain run emits one token a row a tick, all rows in step: each
    # spec row is held to the plain state at its own token count
    plain, preqs = run()
    want = {s: len(r.out) for s, r in enumerate(sreqs)}
    checked = set()
    while len(checked) < 3:
        plain.step()
        for s, n in want.items():
            if len(preqs[s].out) != n or s in checked:
                continue
            checked.add(s)
            assert preqs[s].out == sreqs[s].out
            for lp, ls in zip(plain.caches, spec.caches):
                torch.testing.assert_close(ls.state[s], lp.state[s],
                                           rtol=CACHE_TOL, atol=CACHE_TOL)
                torch.testing.assert_close(ls.conv[s], lp.conv[s],
                                           rtol=CACHE_TOL, atol=CACHE_TOL)
