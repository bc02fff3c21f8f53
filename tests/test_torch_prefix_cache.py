"""The port's prefix cache against the JAX package's, and its engine pins.

* The radix tree (``repro_torch.serve.prefix_cache``) against JAX's
  ``PrefixCache`` on the same hypothesis-generated insert / match /
  evict / trim sequences, each over its own allocator: the same hits
  (length, blocks, state), node counts, evictions and refcounts after
  every op; and JAX's four mechanics pins (``test_prefix_cache.py:60-131``).
* Warm admission is token-identical to cold prefill: yi-9b on the paged
  pool and mamba2 on state snapshots, each bucketed and with
  ``prefill_chunk=8`` (``:135``, ``:155``), and two prefix families in
  turn (``:192``); with JAX's hit and reuse counts.
* Copy-on-write: the cache's shared pool blocks are bit-identical before
  and after a warm admission prefills and decodes (``:217``), also while
  it sits staged through a co-tenant's decode ticks (its row parked on
  the garbage block); a cached mamba2 snapshot is a copy that later ticks
  leave unchanged, and seeding leaves it unchanged too (the port writes
  its caches in place).
* A pool too small for every cached prefix evicts and keeps serving
  (``:243``); the engine refuses a dense prefix cache (``:265``); the
  reused head is accounted apart from re-prefilled tokens (``:276``).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serve.paged import BlockAllocator as JaxAllocator
from repro.serve.prefix_cache import PrefixCache as JaxPrefixCache
from repro_torch.models.registry import get_config, get_model
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.paged import BlockAllocator
from repro_torch.serve.prefix_cache import PrefixCache


# ---------------------------------------------------------------------------
# radix-tree mechanics (host-side, no model)
# ---------------------------------------------------------------------------

def _hit(h):
    return None if h is None else (h.length, list(h.blocks), h.state)


@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_radix_tree_matches_jax_on_random_sequences(data):
    """Paged (blocks) and recurrent (states) trees, driven op for op with
    JAX's: every match returns the same hit, and node counts, evictions,
    lookups, hits and every block's refcount agree after every op."""
    paged = data.draw(st.booleans(), label="paged")
    bs = 4
    nb = data.draw(st.integers(6, 20), label="num_blocks")
    max_nodes = data.draw(st.integers(1, 8), label="max_nodes")
    a, ja = BlockAllocator(nb, bs), JaxAllocator(nb, bs)
    kw = dict(block_size=bs, max_nodes=max_nodes) if paged else \
        dict(max_nodes=max_nodes)
    pc = PrefixCache(backend=a if paged else None, **kw)
    jpc = JaxPrefixCache(backend=ja if paged else None, **kw)
    token = st.integers(0, 2)                 # tiny alphabet: forces sharing
    for i in range(data.draw(st.integers(1, 30), label="n_ops")):
        op = data.draw(st.sampled_from(["insert", "insert", "match",
                                        "evict", "trim"]), label="op")
        if op == "insert":
            toks = data.draw(st.lists(token, min_size=1, max_size=14),
                             label="tokens")
            if paged:
                n = len(toks) // bs
                if n > a.free_blocks:
                    continue
                blocks, jblocks = a.alloc(n), ja.alloc(n)
                assert blocks == jblocks
                pc.insert(toks, blocks=blocks)
                jpc.insert(toks, blocks=jblocks)
                # the inserting "request" finishes: cache-only refs remain
                if blocks:
                    a.release(blocks)
                    ja.release(jblocks)
            else:
                pc.insert(toks, state=f"s{i}")
                jpc.insert(toks, state=f"s{i}")
        elif op == "match":
            toks = data.draw(st.lists(token, min_size=1, max_size=16),
                             label="query")
            max_len = data.draw(st.integers(0, len(toks)), label="max_len")
            assert _hit(pc.match(toks, max_len=max_len,
                                 need_state=not paged)) == \
                _hit(jpc.match(toks, max_len=max_len, need_state=not paged))
        elif op == "evict":
            n = data.draw(st.integers(0, nb), label="need")
            assert pc.evict_for(n) == jpc.evict_for(n)
        else:
            assert pc.trim() == jpc.trim()
        assert (pc.node_count, pc.evictions, pc.lookups, pc.hits) == \
            (jpc.node_count, jpc.evictions, jpc.lookups, jpc.hits)
        assert [a.refcount(b) for b in range(nb)] == \
            [ja.refcount(b) for b in range(nb)]
        assert a.free_blocks == ja.free_blocks


def test_radix_insert_match_split_blocks():
    a = BlockAllocator(20, 4)
    pc = PrefixCache(block_size=4, backend=a, max_nodes=32)
    p1 = list(range(1, 13))                   # 12 tokens = 3 whole blocks
    b1 = a.alloc(3)
    pc.insert(p1, blocks=b1)
    assert all(a.refcount(b) == 2 for b in b1)    # request + cache
    h = pc.match(p1, max_len=11)              # same prompt, tail reserved
    assert h.length == 8 and h.blocks == b1[:2]
    h = pc.match(p1 + [77], max_len=12)       # strict extension: all blocks
    assert h.length == 12 and h.blocks == b1
    p2 = p1[:10] + [99, 98]                   # partial-edge hit: the head
    h = pc.match(p2, max_len=11)
    assert h.length == 8 and h.blocks == b1[:2]
    b2 = a.alloc(3)                           # split: the internal node
    pc.insert(p2, blocks=b2)                  # co-owns the head's blocks
    assert a.refcount(b1[0]) == 3
    h = pc.match(p1[:10] + [55, 56], max_len=11)
    assert h.length == 8 and h.blocks == b1[:2]


def test_radix_state_snapshots_match_exact_boundary_only():
    pc = PrefixCache(max_nodes=8)
    pc.insert([1, 2, 3], state="s3")
    pc.insert([1, 2, 3, 4, 5], state="s5")
    h = pc.match([1, 2, 3, 4, 5, 6], max_len=5, need_state=True)
    assert h.length == 5 and h.state == "s5"
    h = pc.match([1, 2, 3, 4, 5], max_len=4, need_state=True)
    assert h.length == 3 and h.state == "s3"
    assert pc.match([1, 2, 9], max_len=2, need_state=True) is None
    assert pc.match([9, 9], max_len=1, need_state=True) is None


def test_lru_eviction_on_node_budget():
    pc = PrefixCache(max_nodes=2)
    pc.insert([1, 1], state="a")
    pc.insert([2, 2], state="b")
    assert pc.match([1, 1, 5], max_len=2, need_state=True).state == "a"
    pc.insert([3, 3], state="c")              # over budget: LRU leaf "b" goes
    assert pc.evictions == 1 and pc.node_count == 2
    assert pc.match([2, 2, 5], max_len=2, need_state=True) is None
    assert pc.match([1, 1, 5], max_len=2, need_state=True).state == "a"


def test_pool_shortage_evicts_only_unreferenced_nodes():
    a = BlockAllocator(6, 4)                  # 5 usable blocks
    pc = PrefixCache(block_size=4, backend=a, max_nodes=32)
    b1 = a.alloc(2)
    pc.insert([1] * 8, blocks=b1)
    a.release(b1)                             # request done: cache-only refs
    b2 = a.alloc(2)
    pc.insert([2] * 8, blocks=b2)             # this "request" stays live
    assert a.free_blocks == 1
    assert pc.evict_for(3) == 1               # only the unreferenced node
    assert a.free_blocks == 3
    assert pc.match([1] * 8 + [9], max_len=8) is None
    assert pc.match([2] * 8 + [9], max_len=8).blocks == b2
    assert all(a.refcount(b) == 2 for b in b2)


# ---------------------------------------------------------------------------
# warm admission == cold prefill, per family
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def yi():
    cfg = get_config("yi-9b").reduced(dtype="float32", attn_impl="full")
    return cfg, get_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(1))


@pytest.fixture(scope="module")
def mamba():
    cfg = get_config("mamba2-1.3b").reduced(dtype="float32")
    return cfg, get_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(1))


def _engine(setup, **knobs):
    cfg, model = setup
    return Engine(cfg, model, EngineConfig(**knobs), device="cpu")


def _shared_head_prompts(cfg, head_len=18, tails=(6, 5, 7), seed=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(1, cfg.vocab_size, head_len).tolist()
    return [head + rng.integers(1, cfg.vocab_size, n).tolist()
            for n in tails]


def _serve_each(eng, prompts, max_new=5):
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.serve([r])["done"]
    return [r.out for r in reqs]


CHUNKING = pytest.mark.parametrize("kw", [{}, {"prefill_chunk": 8}],
                                   ids=["bucketed", "chunked"])


@CHUNKING
def test_warm_transformer_paged_matches_cold(yi, kw):
    prompts = _shared_head_prompts(yi[0])
    paged = dict(max_batch=2, max_seq=48, paged=True, block_size=8, **kw)
    ref = _serve_each(_engine(yi, **paged), prompts)
    warm = _engine(yi, prefix_cache=True, **paged)
    assert _serve_each(warm, prompts) == ref
    # prompts 2 and 3 share the 18-token head: 2 whole blocks reused each
    assert warm.metrics.prefix_hits == 2
    assert warm.metrics.prefix_tokens_reused == 32


@CHUNKING
def test_warm_mamba2_matches_cold(mamba, kw):
    prompts = _shared_head_prompts(mamba[0])
    prompts.append(prompts[0] + [7, 8, 9])    # strict prefix extension
    ref = _serve_each(_engine(mamba, max_batch=2, max_seq=48, **kw), prompts,
                      max_new=4)
    warm = _engine(mamba, max_batch=2, max_seq=48, prefix_cache=True, **kw)
    assert _serve_each(warm, prompts, max_new=4) == ref
    assert warm.metrics.prefix_hits >= 2
    assert warm.metrics.prefix_tokens_reused >= 32


@CHUNKING
def test_warm_two_prefix_families_sequential(yi, kw):
    """cold A, warm A, cold B, warm B: the warm-B gather reads pool blocks
    written after the first warm admission."""
    cfg = yi[0]
    rng = np.random.default_rng(11)
    head_a = rng.integers(1, cfg.vocab_size, 18).tolist()
    head_b = rng.integers(1, cfg.vocab_size, 18).tolist()
    prompts = [head_a + rng.integers(1, cfg.vocab_size, 6).tolist(),
               head_a + rng.integers(1, cfg.vocab_size, 5).tolist(),
               head_b + rng.integers(1, cfg.vocab_size, 6).tolist(),
               head_b + rng.integers(1, cfg.vocab_size, 5).tolist()]
    paged = dict(max_batch=2, max_seq=48, paged=True, block_size=8, **kw)
    ref = _serve_each(_engine(yi, **paged), prompts)
    warm = _engine(yi, prefix_cache=True, **paged)
    assert _serve_each(warm, prompts) == ref
    assert warm.metrics.prefix_hits == 2
    assert warm.metrics.prefix_tokens_reused == 32


def test_warm_concurrent_admissions_match_cold(yi, mamba):
    """A shared-head mix served concurrently (warm admissions staged
    between decode ticks, slot contention) equals the cold run."""
    for setup, kw in ((yi, dict(paged=True, block_size=8)), (mamba, {})):
        prompts = _shared_head_prompts(setup[0], head_len=24,
                                       tails=(6, 5, 7, 9, 4, 8))
        outs = []
        for warm in (False, True):
            eng = _engine(setup, max_batch=3, max_seq=64, prefix_cache=warm,
                          prefill_chunk=8, **kw)
            reqs = [Request(rid=i, prompt=p, max_new=5)
                    for i, p in enumerate(prompts)]
            assert eng.serve(reqs)["done"]
            outs.append([r.out for r in reqs])
        assert outs[0] == outs[1]
        assert eng.metrics.prefix_hits >= 1


def test_shared_blocks_never_written_in_place(yi):
    """COW pin: the pool content of every cache-shared block is
    bit-identical before and after a warm admission prefills + decodes."""
    prompts = _shared_head_prompts(yi[0], tails=(6, 5))
    eng = _engine(yi, max_batch=2, max_seq=48, paged=True, block_size=8,
                  prefix_cache=True)
    _serve_each(eng, prompts[:1])
    hit = eng.prefix_cache.match(prompts[1], max_len=len(prompts[1]) - 1)
    assert hit is not None and len(hit.blocks) == 2
    ids = torch.as_tensor(hit.blocks)

    def pool_snapshot():
        return [leaf[ids].clone() for layer in eng.caches for leaf in layer]

    before = pool_snapshot()
    _serve_each(eng, prompts[1:])             # warm admission + decode
    assert eng.metrics.prefix_hits == 1
    for a, b in zip(before, pool_snapshot()):
        assert torch.equal(a, b)


def test_shared_blocks_never_written_while_staged(yi):
    """A warm admission whose tail takes several chunks sits staged through
    decode ticks of a co-tenant: its row decodes parked on the garbage
    block (its table starts with shared blocks), and the final scatter
    redirects the shared range there too.  The shared blocks stay
    bit-identical, and the tokens equal the cold run's."""
    cfg = yi[0]
    rng = np.random.default_rng(5)
    head = rng.integers(1, cfg.vocab_size, 16).tolist()
    first = head + rng.integers(1, cfg.vocab_size, 4).tolist()
    other = rng.integers(1, cfg.vocab_size, 5).tolist()
    warm_p = head + rng.integers(1, cfg.vocab_size, 20).tolist()
    outs = []
    for cache in (False, True):
        eng = _engine(yi, max_batch=2, max_seq=64, paged=True, block_size=8,
                      prefill_chunk=8, prefix_cache=cache)
        _serve_each(eng, [first])
        if cache:
            hit = eng.prefix_cache.match(warm_p, max_len=len(warm_p) - 1)
            ids = torch.as_tensor(hit.blocks)
            before = [leaf[ids].clone() for layer in eng.caches
                      for leaf in layer]
        reqs = [Request(rid=1, prompt=other, max_new=8),
                Request(rid=2, prompt=warm_p, max_new=4)]
        stats = eng.serve(reqs)
        assert stats["done"]
        outs.append([r.out for r in reqs])
    assert stats["prefix_hits"] == 1 and stats["prefill_chunks"] >= 3
    for a, b in zip(before, [leaf[ids] for layer in eng.caches
                             for leaf in layer]):
        assert torch.equal(a, b)
    assert outs[0] == outs[1]


def test_cached_snapshot_is_a_copy(mamba):
    """The slab is written in place by every decode tick: a snapshot must
    not be a view into it, and a warm admission seeded from it must leave
    it as it was."""
    prompts = _shared_head_prompts(mamba[0], tails=(6, 5))
    eng = _engine(mamba, max_batch=2, max_seq=48, prefix_cache=True)
    _serve_each(eng, prompts[:1], max_new=6)
    hit = eng.prefix_cache.match(prompts[0] + [1], max_len=len(prompts[0]),
                                 need_state=True)
    assert hit is not None and hit.length == len(prompts[0])
    snap = [(c.conv.clone(), c.state.clone()) for c in hit.state]
    slab = {t.data_ptr() for layer in eng.caches for t in layer}
    assert not {t.data_ptr() for c in hit.state for t in c} & slab
    warm = Request(rid=7, prompt=prompts[0] + [3, 1, 4], max_new=6)
    assert eng.serve([warm])["done"] and eng.metrics.prefix_hits == 1
    for (conv, state), c in zip(snap, hit.state):
        assert torch.equal(conv, c.conv) and torch.equal(state, c.state)


def test_eviction_under_pool_pressure_keeps_serving(yi):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, yi[0].vocab_size, 24).tolist()
               for _ in range(3)]             # disjoint: each caches 3 blocks
    paged = dict(max_batch=1, max_seq=48, paged=True, block_size=8,
                 num_blocks=8)
    ref = _serve_each(_engine(yi, **paged), prompts, max_new=4)
    warm = _engine(yi, prefix_cache=True, **paged)
    assert _serve_each(warm, prompts, max_new=4) == ref
    assert warm.metrics.cache_evictions >= 1
    assert warm.allocator.used_blocks > 0
    warm.prefix_cache.evict_for(warm.backend.num_blocks)
    assert warm.allocator.used_blocks == 0


def test_prefix_cache_construction_contract(yi, mamba):
    with pytest.raises(ValueError, match="prefix_cache"):
        _engine(yi, max_batch=1, max_seq=32, prefix_cache=True)
    _engine(mamba, max_batch=1, max_seq=32, prefix_cache=True)
    eng = _engine(yi, max_batch=1, max_seq=32, paged=True, block_size=8,
                  prefix_cache=True, prefix_cache_nodes=3)
    assert eng.prefix_cache.max_nodes == 3
    assert eng.prefix_cache.block_size == 8


def test_warm_metrics_accounting(mamba):
    """prefill_tokens counts only re-prefilled tokens; the reused head is
    accounted apart (their sum is the full prompt)."""
    p1 = _shared_head_prompts(mamba[0], tails=(6,))[0]
    eng = _engine(mamba, max_batch=1, max_seq=48, prefix_cache=True)
    _serve_each(eng, [p1], max_new=3)
    base = eng.metrics.prefill_tokens
    r = Request(rid=9, prompt=p1 + [3, 1, 4], max_new=3)
    stats = eng.serve([r])
    assert stats["done"] and stats["prefix_hits"] == 1
    reused = eng.metrics.prefix_tokens_reused
    assert reused == len(p1) == stats["prefix_tokens_reused"]
    assert eng.metrics.prefill_tokens - base == len(r.prompt) - reused
