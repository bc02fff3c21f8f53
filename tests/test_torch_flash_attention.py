"""The port's flash attention (``kernels/flash_attention``) and the
cacheless forward under ``attn_impl="flash"`` against the JAX package.

* ``mha(use_flash=True)`` (on the CPU: ``attention_ref``, as JAX runs its
  Pallas kernel in interpret mode there) and ``mha(use_flash=False)``
  against JAX's ``mha(use_flash=True, interpret=True)`` and JAX's
  ``attention_ref`` at the shapes of JAX's ``test_flash_vs_ref``,
  rtol = atol = 2e-5, and its bf16 case against the f32 reference at
  2e-2 (the tolerances of ``kernels/flash_attention/flash_attention.py``);
  the stated bf16 kernel-vs-plain tolerance passes an output rounded to
  nearest and fails one whose store truncates.
* Reduced f32 yi-9b on bridged weights at S = 256: the cacheless
  ``forward`` hidden states at 1e-4 and ``loss`` at 1e-5 under
  ``attn_impl="flash"``, against JAX's under the same impl.
* The port refuses what JAX refuses: S off JAX's tiling (JAX asserts;
  the port raises ValueError) and the flash route under autograd (JAX's
  kernel has no backward; the port raises NotImplementedError).
"""
import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import mha as jax_mha
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention as fk
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.attention import sdpa
from repro_torch.models.registry import get_config

CASES = [(1, 128, 2, 2, 16), (2, 256, 4, 2, 32), (1, 512, 8, 1, 64)]


def _qkv(b, s, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,hkv,d", CASES)
def test_mha_matches_jax(b, s, h, hkv, d, causal):
    q, k, v = _qkv(b, s, h, hkv, d, hash((b, s, h, hkv, d, causal)) % 2**32)
    sm = 1.0 / np.sqrt(d)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    want_flash = np.asarray(jax_mha(jq, jk, jv, sm_scale=sm, causal=causal,
                                    use_flash=True, interpret=True))
    want_ref = np.asarray(jax_mha(jq, jk, jv, sm_scale=sm, causal=causal,
                                  use_flash=False))
    got_flash = mha(tq, tk, tv, sm_scale=sm, causal=causal, use_flash=True)
    got_ref = mha(tq, tk, tv, sm_scale=sm, causal=causal, use_flash=False)
    tol = dict(rtol=fk.F32_TOL, atol=fk.F32_TOL)
    np.testing.assert_allclose(got_flash.numpy(), want_flash, **tol)
    np.testing.assert_allclose(got_ref.numpy(), want_ref, **tol)


def test_attention_ref_matches_jax_flat_layout():
    """The (B*H, S, D) oracle itself, GQA group 4, causal."""
    b, s, h, hkv, d = 2, 64, 8, 2, 16
    rng = np.random.default_rng(3)
    q = rng.normal(size=(b * h, s, d)).astype(np.float32)
    k = rng.normal(size=(b * hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b * hkv, s, d)).astype(np.float32)
    kw = dict(sm_scale=0.25, causal=True, num_q_heads=h, num_kv_heads=hkv)
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), **kw))
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=fk.F32_TOL,
                               atol=fk.F32_TOL)


def test_mha_bf16_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(1, 256, 2, 32)).astype(np.float32)
               for _ in range(3))
    jb = [jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)]
    want = np.asarray(jax_mha(*jb, sm_scale=0.17, use_flash=True,
                              interpret=True), dtype=np.float32)
    tb = [torch.from_numpy(t).bfloat16() for t in (q, k, v)]
    got = mha(*tb, sm_scale=0.17, use_flash=True)
    assert got.dtype == torch.bfloat16
    ref = mha(*(t.float() for t in tb), sm_scale=0.17, use_flash=False)
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(),
                               **fk.tolerance(torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=fk.BF16_TOL,
                               atol=fk.BF16_TOL)


def test_bf16_tolerance_catches_a_truncating_store():
    """The bf16 tolerance against the plain version is half a bf16 ulp
    past the f32 one: the f32 output rounded to nearest passes, the same
    output truncated to bf16 (a faulty store) does not."""
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(shape, generator=gen).bfloat16()
               for shape in ((8, 512, 64), (2, 512, 64), (2, 512, 64)))
    want = attention_ref(q.float(), k.float(), v.float(), sm_scale=0.125,
                         num_q_heads=8, num_kv_heads=2)
    tol = fk.tolerance(torch.bfloat16)
    torch.testing.assert_close(want.bfloat16().float(), want, **tol)
    truncated = (want.view(torch.int32) & ~0xFFFF).view(torch.float32)
    assert torch.equal(truncated.bfloat16().float(), truncated)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(truncated, want, **tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,hkv,d", CASES)
def test_rounded_p_variant_within_bound_of_jax(b, s, h, hkv, d, causal):
    """The tensor-core kernel's plain version (p rounded to nearest bf16
    against the running max of 128-key tiles, l from the f32 p) against
    JAX's ``attention_ref`` at JAX's ``test_flash_vs_ref`` shapes: rounding
    moves each term p v by at most 2^-8 of |p v|, so |delta o| <= 2^-8 *
    attention_ref(q, k, |v|) + F32_TOL."""
    rng = np.random.default_rng(hash((b, s, h, hkv, d, causal)) % 2**32)
    q, k, v = (rng.normal(size=(b * n, s, d)).astype(np.float32)
               for n in (h, hkv, hkv))
    kw = dict(sm_scale=d ** -0.5, causal=causal, num_q_heads=h,
              num_kv_heads=hkv)
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), **kw))
    scale = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(np.abs(v)), **kw))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = attention_ref(tq, tk, tv, p_dtype=torch.bfloat16,
                        block_k=fk.BLOCK_K, **kw).numpy()
    assert np.all(np.abs(got - want) <= 2.0 ** -8 * scale + fk.F32_TOL)
    # the bound is not loose by orders: rounding p does move the output
    assert np.abs(got - want).max() > 0.05 * (2.0 ** -8 * scale).max()


LOG2E = 1.4426950408889634


def _emulate_tc_kernel(q, k, v, *, sm_scale, num_q_heads, num_kv_heads,
                       fault=None):
    """The tensor-core kernel's arithmetic on the CPU, causal, written as
    the kernel computes it, not as the plain version does: raw f32 scores
    (the bf16 products summed in f64, then rounded: another order than
    the plain version's), the mask at -1e30 / sm_scale, the running max
    over 128-key tiles, p = exp2(s c - m c) with c = sm_scale log2(e),
    l from the f32 p, p rounded to nearest bf16 for P V, o = acc /
    max(l, 1e-30) stored to nearest bf16.  ``fault``: "truncating store",
    "p truncated" (toward zero, not to nearest) or "last KV tile dropped"
    (for the last 64 query rows)."""
    group = num_q_heads // num_kv_heads
    kk = k.float().repeat_interleave(group, 0)
    vv = v.float().repeat_interleave(group, 0)
    qf = q.float()
    bh, s, d = q.shape
    raw = (qf.double() @ kk.double().transpose(1, 2)).float()
    rows = torch.arange(s)[:, None]
    c = torch.tensor(sm_scale * LOG2E, dtype=torch.float32)
    m = torch.full((bh, s, 1), -math.inf)
    l = torch.zeros(bh, s, 1)
    acc = torch.zeros(bh, s, d)
    last = (s - 1) // fk.BLOCK_K * fk.BLOCK_K
    for k0 in range(0, s, fk.BLOCK_K):
        cols = torch.arange(k0, min(s, k0 + fk.BLOCK_K))
        st = torch.where(cols[None, :] <= rows, raw[:, :, cols],
                         torch.tensor(-1e30 / sm_scale))
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        mc = m_new * c
        corr = torch.exp2(m * c - mc)
        p = torch.exp2(torch.addcmul(-mc, st, c))
        if fault == "last KV tile dropped" and k0 == last:
            late = rows >= s - 64
            p = torch.where(late, 0.0, p)
            corr = torch.where(late, 1.0, corr)
            m_new = torch.where(late, m, m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        if fault == "p truncated":
            pr = (p.view(torch.int32) & ~0xFFFF).view(torch.float32)
        else:
            pr = p.bfloat16().float()
        acc = acc * corr + pr @ vv[:, cols]
        m = m_new
    o = acc / l.clamp_min(1e-30)
    if fault == "truncating store":
        return (o.view(torch.int32) & ~0xFFFF).view(torch.float32)
    return o.bfloat16().float()


@pytest.mark.parametrize("fault", [None, "truncating store",
                                   "last KV tile dropped", "p truncated"])
def test_tc_tolerance_tells_faults(fault):
    """The tensor-core kernel's stated tolerance against its plain version
    (``flash_attention.reference``) passes an emulation of the kernel's
    sound arithmetic and fails each faulty one, at yi-9b's head width, a
    GQA group of 4 and S = 512 (four KV tiles), causal."""
    gen = torch.Generator().manual_seed(13)
    h, hkv, s, d = 8, 2, 512, 128
    q, k, v = (torch.randn((n, s, d), generator=gen).bfloat16()
               for n in (h, hkv, hkv))
    kw = dict(sm_scale=d ** -0.5, num_q_heads=h, num_kv_heads=hkv)
    got = _emulate_tc_kernel(q, k, v, fault=fault, **kw)
    plain, bound = fk.reference(q, k, v, causal=True, **kw)
    share = fk.tolerance_share(got, plain, bound)
    if fault is None:
        assert share <= 1.0
    else:
        assert share > 1.0, f"{fault}: {share}"


@pytest.fixture(scope="module")
def flash_models():
    jcfg = jax_config("yi-9b").reduced(dtype="float32", attn_impl="flash")
    jmodel = jax_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    cfg = get_config("yi-9b").reduced(dtype="float32", attn_impl="flash")
    model = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, model


def _batch(vocab, b=2, s=256, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def test_cacheless_forward_under_flash_matches_jax(flash_models):
    jmodel, jparams, model = flash_models
    toks, _ = _batch(model.cfg.vocab_size)
    want, _, _ = jax.jit(jmodel.forward)(jparams, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = model.forward(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_loss_under_flash_matches_jax_and_chunked(flash_models):
    jmodel, jparams, model = flash_models
    toks, labels = _batch(model.cfg.vocab_size)
    want, _ = jax.jit(jmodel.loss)(
        jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    with torch.no_grad():
        got, parts = model.loss(batch)
        chunked = type(model).from_params(
            replace(model.cfg, attn_impl="chunked", attn_chunk=128),
            model.params_tree(), device="cpu")
        other, _ = chunked.loss(batch)
    assert float(parts["aux"]) == 0.0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(other), float(got), rtol=1e-5)


def test_flash_refuses_jax_tiling():
    """S = 384: bq = 256 does not divide it; JAX's wrapper asserts."""
    q, k, v = _qkv(1, 384, 2, 1, 16, 0)
    with pytest.raises(AssertionError):
        jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                sm_scale=0.25, use_flash=True, interpret=True)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    with pytest.raises(ValueError, match="JAX's tiling"):
        mha(tq, tk, tv, sm_scale=0.25, use_flash=True)
    with pytest.raises(ValueError, match="JAX's tiling"):
        sdpa(tq, tk, tv, impl="flash")
    # the plain route takes any S, as JAX's does
    assert mha(tq, tk, tv, sm_scale=0.25).shape == tq.shape


def test_flash_refuses_autograd():
    """JAX's kernel has no backward: jax.grad fails, the port raises."""
    q, k, v = _qkv(1, 128, 2, 2, 16, 1)

    def f(q):
        return jax_mha(q, jnp.asarray(k), jnp.asarray(v), sm_scale=0.25,
                       use_flash=True, interpret=True).sum()

    with pytest.raises(Exception):
        jax.grad(f)(jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_()
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    with pytest.raises(NotImplementedError, match="no backward"):
        mha(tq, tk, tv, sm_scale=0.25, use_flash=True)
    # the same call without autograd, or on the plain route, runs
    with torch.no_grad():
        mha(tq, tk, tv, sm_scale=0.25, use_flash=True)
    mha(tq, tk, tv, sm_scale=0.25, use_flash=False).sum().backward()
    assert tq.grad is not None


def test_decode_under_flash_takes_the_full_path(flash_models):
    """With a cache, impl="flash" falls through to the full path, as in
    JAX: prefill and one decode step equal the full impl's."""
    _, _, model = flash_models
    full = type(model).from_params(replace(model.cfg, attn_impl="full"),
                                   model.params_tree(), device="cpu")
    toks = torch.from_numpy(_batch(model.cfg.vocab_size, s=8)[0]).long()
    with torch.no_grad():
        outs = []
        for m in (model, full):
            caches = m.init_cache(2, 16)
            _, caches = m.prefill(toks, caches)
            lg, _ = m.decode_step(toks[:, -1:], caches, 8)
            outs.append(lg)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_wrapper_checks_arguments():
    q = torch.zeros(4, 64, 16)
    kv = torch.zeros(2, 64, 16)
    kw = dict(sm_scale=0.25, num_q_heads=2, num_kv_heads=1)
    assert fk.flash_attention(q, kv, kv, **kw).shape == q.shape
    with pytest.raises(ValueError, match="k/v must be"):
        fk.flash_attention(q, q, q, **kw)
    with pytest.raises(ValueError, match="must divide"):
        fk.flash_attention(q, kv, kv, sm_scale=0.25, num_q_heads=3,
                           num_kv_heads=2)
    with pytest.raises(ValueError, match="share one of"):
        fk.flash_attention(q.double(), kv.double(), kv.double(), **kw)
    with pytest.raises(ValueError, match="shapes"):
        fk.flash_attention(q[0], kv, kv, **kw)
