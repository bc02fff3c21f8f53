"""The port's MLA attention, ``sdpa``'s three knobs and the models of the
moe family and the rest of the dense family, against the JAX package.

* ``MLAAttention`` against ``mla_attention`` at 1e-5 (f32, reduced
  deepseek-v2-lite widths, ``attn_chunk`` 8): a chunked prefill (S = 16 >
  chunk) with and without a cache, a scalar-index decode, per-row decode,
  paged decode through a block table and verify windows with ``n_valid``
  on the slab and the pool, each with ``q_lora_rank`` 0 and 16 (the
  reduced config hides the q-LoRA path: 0); the caches the port writes in
  place equal JAX's functional ones.
* ``sdpa`` under each knob against JAX's: ``f32_operands=False`` on bf16
  inputs within one bf16 ulp of the output (P is rounded to bf16 before
  P@V: a score one f32 ulp apart may round P the other way), and
  ``fused_mask`` / ``causal_skip`` at 1e-6.
* Whole-model logits (prefill and one decode step) at 1e-4 and ``loss``
  at 1e-5 for reduced deepseek-v2-lite-16b, deepseek-v2-236b
  (``q_lora_rank=16``), starcoder2-15b, minitron-4b and deepseek-67b.
* bf16 parity (reduced yi-9b and deepseek-v2-lite in bf16): the port's
  prefill logits lie within ``BF16_FACTOR`` (2) times the bf16 model's own
  distance from an f32 copy of its weights of JAX's, and where JAX's
  top-two margin exceeds that distance the tokens are equal.
* The moe tree crosses the bridge and back bit for bit; the frozen
  decode tree quantizes exactly JAX's leaves (the attention projections,
  the shared experts and the dense block's MLP; never the routed experts,
  the router, ``w_uk`` or ``w_uv``), each bitwise.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.core.quant import QuantizedWeight as JQW
from repro.models import attention as jattn
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.core import quant as tq
from repro_torch.models import attention as tattn
from repro_torch.models.attention import KVCache, MLAAttention
from repro_torch.models.common import dense_window, paged_rows, paged_window
from repro_torch.models.registry import get_config

LITE = "deepseek-v2-lite-16b"
TOL5 = dict(rtol=1e-5, atol=1e-5)
#: the bf16 parity bound: the port's bf16 logits against JAX's at most
#: this many times the bf16 model's own distance from an f32 copy of its
#: weights (two bf16 roundings of one function, each about as far from
#: exact arithmetic as the other: ``chip_smoke.WARM_FACTOR``'s argument)
BF16_FACTOR = 2.0
QW_FIELDS = ("codes", "scale", "zero_point", "hi_tab", "lo_tab", "residual")


def _np(tree):
    """A JAX tree as numpy; QuantizedWeights as dicts + kernel."""
    if isinstance(tree, JQW):
        d = {f: (None if getattr(tree, f) is None
                 else np.asarray(getattr(tree, f))) for f in QW_FIELDS}
        d["kernel"] = tree.kernel
        return d
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return np.asarray(tree)



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


def _with_q_lora(cfg, rank):
    return replace(cfg, mla=replace(cfg.mla, q_lora_rank=rank))


# ---------------------------------------------------------------------------
# MLA attention
# ---------------------------------------------------------------------------

MLA_CASES = ["prefill", "nocache", "scalar", "per_row", "paged",
             "window_dense", "window_paged"]


def _mla_setup(q_lora):
    over = dict(dtype="float32", attn_chunk=8)
    jcfg = _with_q_lora(jax_config(LITE).reduced(**over), q_lora)
    cfg = _with_q_lora(get_config(LITE).reduced(**over), q_lora)
    jp = jattn.init_mla(jax.random.PRNGKey(3), jcfg)
    return jcfg, jp, cfg, MLAAttention(cfg, {k: _t(v) for k, v in
                                             jp.items()})


@pytest.mark.parametrize("q_lora", [0, 16])
@pytest.mark.parametrize("case", MLA_CASES)
def test_mla_attention_matches_jax(case, q_lora):
    jcfg, jp, cfg, mod = _mla_setup(q_lora)
    m = cfg.mla
    rng = np.random.default_rng(MLA_CASES.index(case))
    b, s_max, bs, nblk = 2, 24, 4, 7
    s = {"prefill": 16, "nocache": 16, "window_dense": 3,
         "window_paged": 3}.get(case, 1)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    paged = case in ("paged", "window_paged")
    lead = (nblk, bs) if paged else (b, s_max)
    ck = rng.normal(size=lead + (m.kv_lora_rank,)).astype(np.float32)
    cr = rng.normal(size=lead + (m.qk_rope_dim,)).astype(np.float32)
    table = np.array([[3, 1, 5, 0, 0, 0], [2, 6, 4, 0, 0, 0]])
    index, n_valid = {"prefill": (0, None), "scalar": (5, None),
                      "per_row": (np.array([3, 7]), None),
                      "paged": (np.array([5, 9]), None),
                      "window_dense": (np.array([2, 6]), np.array([3, 1])),
                      "window_paged": (np.array([2, 8]), np.array([1, 3]))
                      }.get(case, (None, None))
    pos = (np.arange(s)[None] + index if np.ndim(index) == 0 and
           index is not None else
           (index[:, None] + np.arange(s)[None] if index is not None
            else np.arange(s)[None]))

    jkw = dict(positions=jnp.asarray(pos))
    tkw = dict(positions=_t(pos))
    if case != "nocache":
        jkw.update(cache=jattn.KVCache(jnp.asarray(ck), jnp.asarray(cr)),
                   cache_index=(index if np.ndim(index) == 0
                                else jnp.asarray(index, jnp.int32)))
        tkw.update(cache=KVCache(_t(ck), _t(cr)),
                   cache_index=index if np.ndim(index) == 0 else _t(index))
    if paged:
        jkw["block_table"] = jnp.asarray(table, jnp.int32)
    if n_valid is not None:
        jkw["n_valid"] = jnp.asarray(n_valid, jnp.int32)
        tkw["n_valid"] = _t(n_valid)
    if case == "paged":
        tkw["paged"] = paged_rows(_t(table), _t(index), bs)
    elif case == "window_paged":
        tkw["window"] = paged_window(_t(table), _t(index), s, bs,
                                     _t(n_valid))
    elif case == "window_dense":
        tkw["window"] = dense_window(_t(index), s, s_max, _t(n_valid))

    # under jax.jit (the inputs as constants): one compile in place of
    # op-by-op dispatch
    jout, jcache = jax.jit(lambda: jattn.mla_attention(
        jp, jnp.asarray(x), jcfg, **jkw))()
    with torch.inference_mode():
        out, cache = mod(_t(x), **tkw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL5)
    if case == "nocache":
        assert cache is None and jcache is None
        return
    for got, want in zip(cache, jcache):
        got, want = got.numpy(), np.asarray(want)
        if paged:
            # JAX drops an invalid window entry (an out-of-range id); the
            # port writes it on the garbage block 0, never read unmasked
            got, want = got[1:], want[1:]
        np.testing.assert_allclose(got, want, **TOL5)


# ---------------------------------------------------------------------------
# sdpa's knobs
# ---------------------------------------------------------------------------

def _qkv(dtype, sq=16, sk=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, sq, 4, 32)).astype(np.float32)
    k = rng.normal(size=(2, sk, 2, 32)).astype(np.float32)
    v = rng.normal(size=(2, sk, 2, 32)).astype(np.float32)
    j = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    t = [torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
        for a in j]
    return j, t


SDPA_CASES = {
    # (knobs, call kwargs)
    "bf16_operands": (dict(f32_operands=False),
                      dict(impl="full", q_offset=0, kv_len=None)),
    "bf16_operands_chunked": (dict(f32_operands=False),
                              dict(impl="chunked", chunk=4, q_offset=0,
                                   kv_len=None)),
    "fused_mask": (dict(fused_mask=True),
                   dict(impl="full", q_offset=3, kv_len=12, sq=8)),
    "fused_mask_per_row": (dict(fused_mask=True),
                           dict(impl="full", q_offset="rows", kv_len="rows",
                                sq=2)),
    "causal_skip": (dict(causal_skip=True),
                    dict(impl="chunked", chunk=4, q_offset=0, kv_len=None)),
}


@pytest.mark.parametrize("case", list(SDPA_CASES))
def test_sdpa_knobs_match_jax(case):
    knobs, kw = SDPA_CASES[case]
    kw = dict(kw)
    bf16 = not knobs.get("f32_operands", True)
    (jqv, tqv) = _qkv(jnp.bfloat16 if bf16 else jnp.float32,
                      sq=kw.pop("sq", 16))
    if kw["q_offset"] == "rows":
        kw["q_offset"] = np.array([5, 9])
        kw["kv_len"] = np.array([7, 11])
    jkw, tkw = dict(kw), dict(kw)
    for name in ("q_offset", "kv_len"):
        if isinstance(kw[name], np.ndarray):
            jkw[name] = jnp.asarray(kw[name])
            tkw[name] = _t(kw[name])
    # JAX skips causal chunks only on its unrolled path
    want = jax.jit(lambda: jattn.sdpa(*jqv, unroll=True, **knobs, **jkw))()
    got = tattn.sdpa(*tqv, **knobs, **tkw)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if bf16:
        # one bf16 ulp of the output's magnitude (2^-7 relative)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        assert np.all(np.abs(got - want) <= ulp), \
            np.max(np.abs(got - want) / ulp)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the knob leaves the function as the default path computes it
    plain = tattn.sdpa(*(a.float() for a in tqv), **tkw).numpy()
    np.testing.assert_allclose(got, plain, rtol=2e-2 if bf16 else 1e-6,
                               atol=2e-2 if bf16 else 1e-6)


# ---------------------------------------------------------------------------
# whole models: the moe family and the rest of the dense family
# ---------------------------------------------------------------------------

ARCHS = {"deepseek-v2-lite-16b": 0, "deepseek-v2-236b": 16,
         "starcoder2-15b": None, "minitron-4b": None, "deepseek-67b": None}


def _bridged(arch, q_lora=None, **over):
    jcfg = jax_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    if q_lora:
        jcfg, cfg = _with_q_lora(jcfg, q_lora), _with_q_lora(cfg, q_lora)
    jmodel = jax_model(jcfg)
    jp = jmodel.init(jax.random.PRNGKey(1))
    return jmodel, jp, cfg, params_from_numpy(_np(jp), cfg, "cpu")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_logits_and_loss_match_jax(arch):
    """Prefill 6 tokens, one decode step at index 6, logits at 1e-4; the
    training loss (xent + the MoE blocks' aux) at 1e-5."""
    jmodel, jp, cfg, model = _bridged(arch, ARCHS[arch], dtype="float32")
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 8))
    jc = jmodel.init_cache(2, 12)
    # under jax.jit: one compile per function instead of op-by-op dispatch
    jl, jc = jax.jit(jmodel.prefill)(jp, jnp.asarray(toks[:, :6]), jc)
    jd, _ = jax.jit(jmodel.decode_step)(jp, jnp.asarray(toks[:, 6:7]), jc,
                                        jnp.int32(6))
    batch = {"tokens": toks[:, :7], "labels": toks[:, 1:8]}
    jloss, jaux = jax.jit(jmodel.loss)(jp, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    with torch.inference_mode():
        tc = model.init_cache(2, 12)
        tl, tc = model.prefill(_t(toks[:, :6]), tc)
        td, _ = model.decode_step(_t(toks[:, 6:7]), tc, 6)
        tloss, taux = model.loss({k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux["aux"]), float(jaux["aux"]),
                               rtol=1e-5, atol=1e-8)
    if cfg.moe:
        assert float(taux["aux"]) > 0


def _f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree)


@pytest.mark.parametrize("arch", ["yi-9b", LITE])
def test_bf16_logits_within_factor_of_jax(arch):
    """bf16 weights and activations: max |port - JAX| over the prefill
    logits <= BF16_FACTOR x max |JAX - JAX on an f32 copy of the same
    weights|; the argmax equal wherever JAX's top-two margin exceeds that
    distance."""
    jmodel, jp, cfg, model = _bridged(arch)
    assert cfg.dtype == "bfloat16" and model.embed.dtype == torch.bfloat16
    toks = np.random.default_rng(5).integers(1, cfg.vocab_size, (2, 16))

    def jax_logits(m, params):
        hidden, _, _ = m.forward(params, jnp.asarray(toks))
        return np.asarray(m.logits(params, hidden).astype(jnp.float32))

    want = jax_logits(jmodel, jp)
    exact = jax_logits(jax_model(replace(jmodel.cfg, dtype="float32")),
                       _f32(jp))
    with torch.inference_mode():
        hidden, _ = model(_t(toks))
        got = model.logits(hidden).float().numpy()
    dist = np.abs(want - exact).max()
    assert dist > 0
    assert np.abs(got - want).max() <= BF16_FACTOR * dist, \
        (np.abs(got - want).max(), dist)
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > dist
    assert sure.any()
    np.testing.assert_array_equal(got.argmax(-1)[sure], want.argmax(-1)[sure])


# ---------------------------------------------------------------------------
# the bridge and the frozen decode tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lite():
    return _bridged(LITE, dtype="float32")


def test_bridge_round_trips_moe_tree(lite):
    _, jp, _, model = lite
    want = _np(jp)
    got = params_to_numpy(model)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert len(model.blocks) == model.cfg.num_layers
    assert model.blocks[0].mlp.w_up.shape[1] == model.cfg.moe.dense_ff
    assert model.blocks[1].moe.router.dtype == torch.float32


def _paths(node, path=()):
    if isinstance(node, (JQW, tq.QuantizedWeight)):
        return {path}
    if isinstance(node, dict):
        return set().union(*(_paths(v, path + (k,)) for k, v in node.items()))
    if isinstance(node, list):
        return set().union(*(_paths(v, path + (i,))
                             for i, v in enumerate(node)))
    return set()


def test_frozen_tree_quantizes_jax_leaves(lite):
    """lut4's frozen tree (the leaf set is the same under every mode)."""
    _, jp, cfg, model = lite
    quant = "lut4"
    jtree = jq.quantize_decode_params(jp, quant)
    ttree = tq.quantize_decode_params(model.params_tree(), quant)
    jpaths, tpaths = _paths(jtree), _paths(ttree)
    n_moe = cfg.num_layers - cfg.moe.first_dense
    # JAX stacks "blocks" (one path for every layer); the port lists them
    want = {p for p in jpaths if p[0] == "dense_blocks"} | {
        ("blocks", i) + p[1:] for p in jpaths if p[0] == "blocks"
        for i in range(n_moe)}
    assert tpaths == want
    assert {p[-2:] for p in tpaths if p[0] == "blocks"} == {
        ("attn", "wq"), ("attn", "w_dkv"), ("attn", "wo"),
        ("shared", "w_gate"), ("shared", "w_up"), ("shared", "w_down")}
    assert {p[2:] for p in tpaths if p[0] == "dense_blocks"} == {
        ("attn", "wq"), ("attn", "w_dkv"), ("attn", "wo"),
        ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down")}
    for path in tpaths:
        got, want_qw = ttree, jtree
        for i, key in enumerate(path):
            got = got[key]
            if path[0] == "blocks" and i == 1:
                continue                    # the stacked axis, below
            want_qw = want_qw[key]
        if path[0] == "blocks":
            want_qw = jax.tree.map(lambda a, i=path[1]: a[i], want_qw)
        assert got.kernel == want_qw.kernel
        for f in QW_FIELDS:
            a, b = getattr(want_qw, f), getattr(got, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
    moe = ttree["blocks"][0]["moe"]
    attn = ttree["blocks"][0]["attn"]
    assert moe["w_up"] is model.blocks[1].moe.w_up
    assert moe["router"] is model.blocks[1].moe.router
    assert attn["w_uk"] is model.blocks[1].attn.w_uk
    assert attn["w_uv"] is model.blocks[1].attn.w_uv
