"""The port's capacity-routed MoE and the moe family in the engine,
against the JAX package.

* ``moe_ffn`` against JAX's on the same f32 inputs (reduced
  deepseek-v2-lite: 8 experts, top-2, 2 shared): the output at 1e-5 and
  the aux loss, in each grouping (decode folds the batch into one group,
  a verify window groups by column, prefill by row); a decode group of
  duplicated tokens that overflows capacity (exact ties in both top-k's:
  ``jax.lax.top_k`` takes the lower index first, and so does the port);
  the dense-expert-sum identity at a capacity that drops nothing (JAX's
  ``tests/test_moe.py``); gradients reach the router and the experts.
* Engine tokens equal the JAX engine's for reduced f32 deepseek-v2-lite
  under quant None, lut4 and nf4p:
  - at ``max_batch = 8`` (capacity 4 of a decode tick's 8 rows) on mixed
    lengths whose rows retire at different ticks, on the dense slab and
    the paged pool (block 8): capacity drops routed tokens in the decode
    ticks (counted), and the port's tokens equal one JAX dense run's (JAX's
    paged equals its dense: ``tests/test_engine.py``).  Idle and staged
    rows decode token 0 at position 0 and attend only to what they just
    wrote, on either substrate, so their routing is the same everywhere;
  - paged with ``prefill_chunk`` and ``prefix_cache`` on a shared-head
    mix, against JAX under the same config (for moe a chunked piece is a
    smaller routing group than the whole prompt, so it is never held to
    the port's own whole-prompt run), hit and chunk counts equal;
  - ``spec="self_lut"`` and ``"ngram"`` on the slab and the pool equal
    plain greedy (JAX's ``tests/test_spec.py`` deepseek case), on 3 slots
    where capacity never binds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.models.moe as tmoe
from repro.models import moe as jmoe
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.serve.config import EngineConfig as JaxEngineConfig
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import get_config
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.engine import Engine, Request

LITE = "deepseek-v2-lite-16b"
TOL5 = dict(rtol=1e-5, atol=1e-5)



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny shapes: the default (one
    a core) only contends with the other test workers; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _dropped(router, x, cfg, window=False) -> int:
    """Routed (token, expert) assignments that capacity drops in one
    ``moe_ffn`` call on ``x``."""
    _, top_e, sel_gate, _ = tmoe.route(router, tmoe.groups(x, window), cfg)
    return top_e.numel() - int((sel_gate > 0).sum())


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

def _moe_setup(**moe_over):
    from dataclasses import replace
    jcfg = jax_config(LITE).reduced(dtype="float32")
    cfg = get_config(LITE).reduced(dtype="float32")
    if moe_over:
        jcfg = replace(jcfg, moe=replace(jcfg.moe, **moe_over))
        cfg = replace(cfg, moe=replace(cfg.moe, **moe_over))
    jp = jmoe.init_moe(jax.random.PRNGKey(7), jcfg)
    tp = jax.tree.map(lambda a: _t(np.asarray(a)), jp)
    return jcfg, jp, cfg, tp


def _compare(x, window=False, **moe_over):
    jcfg, jp, cfg, tp = _moe_setup(**moe_over)
    jout, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, window=window)
    out, aux = tmoe.moe_ffn(tp, _t(x), cfg, window=window)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **TOL5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-9)
    return cfg, tp


@pytest.mark.parametrize("grouping,shape", [
    ("decode", (8, 1)), ("window", (4, 3)), ("row", (2, 16))])
def test_moe_ffn_matches_jax(grouping, shape):
    x = np.random.default_rng(0).normal(
        size=shape + (128,)).astype(np.float32)
    cfg, tp = _compare(x, window=grouping == "window")
    groups = tmoe.groups(_t(x), grouping == "window")
    assert groups.shape[:2] == {"decode": (1, 8), "window": (3, 4),
                                "row": (2, 16)}[grouping]


def test_moe_ffn_ties_and_overflow_match_jax():
    """A decode group of 12 rows: three distinct tokens, each 4 times,
    and a zero row (an idle slot's twin).  Duplicates tie exactly in the
    expert choice, and the experts they pick overflow capacity 4."""
    rng = np.random.default_rng(1)
    base = rng.normal(size=(3, 128)).astype(np.float32)
    x = np.concatenate([np.repeat(base, 4, 0)[:11],
                        np.zeros((1, 128), np.float32)])[:, None]
    cfg, tp = _compare(x)
    assert tmoe.capacity(12, cfg) == 4
    assert _dropped(tp["router"], _t(x), cfg) > 0
    # the choice itself: the same picks, in the same order, as JAX's
    _, top_e, sel_gate, sel_idx = tmoe.route(tp["router"],
                                             tmoe.groups(_t(x)), cfg)
    jx = jnp.asarray(x).reshape(1, 12, 128)
    probs = jax.nn.softmax(jx @ jnp.asarray(tp["router"].numpy()), -1)
    jp, je = jax.lax.top_k(probs, 2)
    gates = jnp.zeros((1, 12, 8)).at[0, jnp.arange(12)[:, None], je[0]].set(
        jp[0])
    jg, ji = jax.lax.top_k(gates.transpose(0, 2, 1), 4)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(sel_idx.numpy(), np.asarray(ji))
    assert (np.diff(sel_gate.numpy(), axis=-1) == 0).any()     # real ties


def test_top_k_breaks_ties_as_jax():
    x = np.random.default_rng(2).integers(0, 3, (64, 16)).astype(np.float32)
    vals, idx = tmoe.top_k(_t(x), 5)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_moe_matches_dense_expert_sum():
    """With capacity high enough to route everything, the grouped dispatch
    equals every token through its top-k experts (and the shared ones)."""
    _, _, cfg, tp = _moe_setup(capacity_factor=8.0)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 8, 128)).astype(np.float32))
    assert _dropped(tp["router"], x, cfg) == 0
    out, aux = tmoe.moe_ffn(tp, x, cfg)
    xt = x.reshape(-1, 128)
    probs = torch.softmax(xt @ tp["router"], -1)
    top_p, top_e = torch.topk(probs, cfg.moe.top_k)
    ref = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(cfg.moe.top_k):
            e = int(top_e[t, j])
            h = (torch.nn.functional.silu(xt[t] @ tp["w_gate"][e])
                 * (xt[t] @ tp["w_up"][e]))
            ref[t] += top_p[t, j] * (h @ tp["w_down"][e])
    sp = tp["shared"]
    ref += (torch.nn.functional.silu(xt @ sp["w_gate"]) * (xt @ sp["w_up"])
            ) @ sp["w_down"]
    np.testing.assert_allclose(out.reshape(-1, 128).numpy(), ref.numpy(),
                               rtol=2e-4, atol=2e-4)
    assert float(aux) >= 0


def test_moe_gradients_flow_to_router_and_experts():
    _, _, cfg, tp = _moe_setup()
    tp = jax.tree.map(lambda a: a.requires_grad_(), tp)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 16, 128)).astype(np.float32))
    out, aux = tmoe.moe_ffn(tp, x, cfg)
    (torch.sum(out ** 2) + aux).backward()
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert float(tp[name].grad.abs().sum()) > 0, name
    assert float(tp["shared"]["w_down"].grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lite():
    jcfg = jax_config(LITE).reduced(dtype="float32", attn_impl="full")
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(1))
    cfg = get_config(LITE).reduced(dtype="float32", attn_impl="full")
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's runs, one per (mix, quant), shared by the tests."""
    return {}


def _jax_serve(setup, runs, key, reqs, knobs):
    if key not in runs:
        jcfg, jparams, _, _ = setup
        eng = JaxEngine(jcfg, jparams, JaxEngineConfig(**knobs))
        jreqs = [JaxRequest(rid=i, prompt=p, max_new=m)
                 for i, (p, m) in enumerate(reqs)]
        stats = eng.serve(jreqs)
        assert stats["done"]
        runs[key] = ([r.out for r in jreqs], stats)
    return runs[key]


def _serve(setup, reqs, **knobs):
    _, _, cfg, model = setup
    eng = Engine(cfg, model, EngineConfig(**knobs), device="cpu")
    preqs = [Request(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(reqs)]
    stats = eng.serve(preqs)
    assert stats["done"]
    return [r.out for r in preqs], stats, eng


def _mixed(cfg):
    """10 requests of mixed prompt lengths and budgets on 8 slots: rows
    retire at different ticks and idle rows decode beside active ones."""
    rng = np.random.default_rng(4)
    lens = (3, 9, 5, 17, 2, 12, 7, 4, 6, 10)
    news = (4, 9, 6, 3, 8, 5, 7, 2, 6, 5)
    return [(rng.integers(1, cfg.vocab_size, n).tolist(), m)
            for n, m in zip(lens, news)]


def _shared_mix(cfg):
    """A shared 24-token head with divergent tails, plus an unrelated
    prompt: cold, warm, strict-extension and chunked admissions."""
    rng = np.random.default_rng(2)
    head = rng.integers(1, cfg.vocab_size, 24).tolist()
    mix = [head + rng.integers(1, cfg.vocab_size, n).tolist()
           for n in (6, 13, 2, 9, 20)]
    mix.insert(3, rng.integers(1, cfg.vocab_size, 11).tolist())
    return [(p, 5) for p in mix]


QUANTS = [None, "lut4", "nf4p"]
BIG = dict(max_batch=8, max_seq=48)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_capacity_drops_tokens_equal_jax(lite, jax_runs, monkeypatch, quant,
                                         paged):
    """8 slots, capacity 4 a decode tick: the port's tokens equal the JAX
    engine's dense run on the slab and on the pool, and capacity dropped
    routed tokens in the decode ticks."""
    reqs = _mixed(lite[2])
    want, _ = _jax_serve(lite, jax_runs, ("mixed", quant), reqs,
                         dict(BIG, quant=quant))
    drops = []
    plain = tmoe.moe_ffn

    def counted(params, x, cfg, *, window=False):
        if x.shape[1] == 1:
            drops.append(_dropped(params["router"], x, cfg, window))
        return plain(params, x, cfg, window=window)

    monkeypatch.setattr(tmoe, "moe_ffn", counted)
    knobs = dict(BIG, quant=quant)
    if paged:
        knobs.update(paged=True, block_size=8)
    got, _, _ = _serve(lite, reqs, **knobs)
    assert got == want
    assert tmoe.capacity(8, lite[2]) == 4 and sum(drops) > 0


STAT_KEYS = ("prefix_hits", "prefix_tokens_reused", "prefill_chunks",
             "prefill_calls", "prefill_tokens", "decode_tokens", "ticks")


@pytest.mark.parametrize("quant", QUANTS)
def test_chunked_prefix_cache_tokens_equal_jax(lite, jax_runs, quant):
    """Paged (block 8), 8-token prefill pieces and the prefix cache on 3
    slots: tokens and counts equal the JAX engine's under the same
    config."""
    knobs = dict(max_batch=3, max_seq=64, quant=quant, paged=True,
                 block_size=8, prefill_chunk=8, prefix_cache=True)
    reqs = _shared_mix(lite[2])
    want, jstats = _jax_serve(lite, jax_runs, ("shared", quant), reqs, knobs)
    got, stats, eng = _serve(lite, reqs, **knobs)
    assert got == want
    assert {k: stats[k] for k in STAT_KEYS} == \
        {k: jstats[k] for k in STAT_KEYS}
    assert stats["prefix_hits"] >= 2 and stats["prefill_chunks"] > 0
    # every block is free or held by the prefix cache alone
    owners = eng.prefix_cache._block_owners
    assert owners and all(eng.allocator.refcount(b) == n
                          for b, n in owners.items())
    assert eng.allocator.free_blocks + len(owners) == \
        eng.backend.num_blocks - 1


@pytest.fixture(scope="module")
def plain_runs():
    """The port's plain greedy runs of the spec tests' prompts, one per
    substrate, shared by both proposers."""
    return {}


#: spec tests' substrates: the slab in full precision, the pool frozen
SPEC_SUBSTRATES = {"dense": dict(quant=None),
                   "paged-lut4": dict(quant="lut4", paged=True, block_size=8)}


@pytest.mark.parametrize("mode", ["self_lut", "ngram"])
@pytest.mark.parametrize("substrate", list(SPEC_SUBSTRATES))
def test_spec_tokens_equal_plain(lite, plain_runs, substrate, mode):
    """3 slots (capacity never binds): speculative tokens equal plain
    greedy's, as JAX's deepseek case of ``tests/test_spec.py``."""
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, lite[2].vocab_size, n).tolist(), 8)
            for n in (5, 11, 3)]
    knobs = dict(max_batch=3, max_seq=48, **SPEC_SUBSTRATES[substrate])
    if substrate not in plain_runs:
        plain_runs[substrate] = _serve(lite, reqs, **knobs)[0]
    out, _, eng = _serve(lite, reqs, spec=mode, **knobs)
    assert out == plain_runs[substrate]
    m = eng.metrics
    assert m.spec_accepted + m.spec_rejected == m.spec_drafted
    if mode == "self_lut":
        assert m.spec_drafted > 0 and m.spec_ticks > 0
