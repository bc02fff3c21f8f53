"""The port's paged KV substrate against the JAX package's.

* ``BlockAllocator`` and ``blocks_needed`` (``repro_torch.serve.paged``)
  against JAX's on the same hypothesis-generated op sequences: the same
  block ids, refcounts and free counts after every op (the invariants of
  ``test_paged_alloc.py`` hold on the port's side too).
* ``paged_gather`` / ``paged_write`` (through ``paged_rows``) bitwise
  against JAX's on the same seeded pools, tables and positions (rows
  share no block: duplicate writes have no specified winner in either).
* ``CacheSpec``, ``init_cache`` under a paged spec and the
  ``EngineConfig`` cross-rules raise where JAX's do, with the same error
  types (``test_engine.py:310``, ``test_serve_api.py:59``).
* ``PagedPool``: reservation, backpressure without side effects, the
  copy-on-write redirect and the decode tables parking staged slots.
"""
import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.models.common import CacheSpec as JaxCacheSpec
from repro.models.common import paged_gather as jax_paged_gather
from repro.models.common import paged_write as jax_paged_write
from repro.serve.config import EngineConfig as JaxEngineConfig
from repro.serve.paged import BlockAllocator as JaxAllocator
from repro.serve.paged import blocks_needed as jax_blocks_needed
from repro_torch.models.common import (CacheSpec, paged_gather, paged_rows,
                                       paged_write)
from repro_torch.models.registry import get_config, get_model
from repro_torch.serve.backend import PagedPool
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.paged import GARBAGE_BLOCK, BlockAllocator, blocks_needed


def _same_state(a: BlockAllocator, j: JaxAllocator):
    assert a.free_blocks == j.free_blocks
    assert a.used_blocks == j.used_blocks
    assert [a.refcount(b) for b in range(a.num_blocks)] == \
        [j.refcount(b) for b in range(j.num_blocks)]


@settings(max_examples=60, deadline=None)
@given(num_blocks=st.integers(2, 24), data=st.data())
def test_allocator_matches_jax_on_random_ops(num_blocks, data):
    """alloc / ref / release / writable: the same ids handed out, the same
    refcounts and free counts after every op, and a failed alloc changes
    nothing on either side."""
    a, j = BlockAllocator(num_blocks, 4), JaxAllocator(num_blocks, 4)
    held: list[list[int]] = []
    for _ in range(data.draw(st.integers(0, 40), label="n_ops")):
        op = data.draw(st.sampled_from(["alloc", "alloc", "ref", "release"]),
                       label="op")
        if op == "alloc":
            n = data.draw(st.integers(0, 8), label="n")
            got, want = a.alloc(n), j.alloc(n)
            assert got == want
            if got:
                held.append(got)
        elif op == "ref" and held:
            blocks = held[data.draw(st.integers(0, len(held) - 1))]
            a.ref(blocks)
            j.ref(blocks)
            held.append(list(blocks))
        elif op == "release" and held:
            blocks = held.pop(data.draw(st.integers(0, len(held) - 1)))
            a.release(blocks)
            j.release(blocks)
        _same_state(a, j)
        assert all(a.writable(b) == j.writable(b)
                   for b in range(1, num_blocks))
        outstanding = {b for blocks in held for b in blocks}
        assert GARBAGE_BLOCK not in outstanding
        assert a.free_blocks + len(outstanding) == num_blocks - 1
    for blocks in held:
        a.release(blocks)
        j.release(blocks)
    _same_state(a, j)
    assert a.free_blocks == num_blocks - 1


@settings(max_examples=80, deadline=None)
@given(prompt_len=st.integers(1, 300), max_new=st.integers(1, 300),
       max_seq=st.integers(2, 512), block_size=st.integers(1, 64))
def test_blocks_needed_matches_jax(prompt_len, max_new, max_seq, block_size):
    assert blocks_needed(prompt_len, max_new, max_seq, block_size) == \
        jax_blocks_needed(prompt_len, max_new, max_seq, block_size)


def test_allocator_refuses_as_jax_does():
    for args in ((1, 4), (4, 0)):
        with pytest.raises(ValueError):
            JaxAllocator(*args)
        with pytest.raises(ValueError):
            BlockAllocator(*args)
    a = BlockAllocator(5, 4)
    got = a.alloc(2)
    a.release(got)
    with pytest.raises(AssertionError, match="double free"):
        a.release(got[:1])
    with pytest.raises(AssertionError, match="unheld"):
        a.ref(got[:1])


@pytest.mark.parametrize("num_blocks,bs,b,nblk", [(13, 4, 3, 4),
                                                   (17, 8, 2, 8)])
def test_paged_gather_and_write_bitwise_equal_jax(num_blocks, bs, b, nblk):
    rng = np.random.default_rng(num_blocks)
    pool = rng.standard_normal((num_blocks, bs, 2, 8)).astype(np.float32)
    # distinct physical blocks per row (rows share none), garbage beyond
    ids = rng.permutation(np.arange(1, num_blocks))[:b * (nblk - 1)]
    table = np.zeros((b, nblk), np.int32)
    table[:, :nblk - 1] = ids.reshape(b, nblk - 1)
    got = paged_gather(torch.from_numpy(pool), torch.from_numpy(table))
    want = jax_paged_gather(jnp.asarray(pool), jnp.asarray(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    new = rng.standard_normal((b, 1, 2, 8)).astype(np.float32)
    index = rng.integers(0, (nblk - 1) * bs, b)
    t_pool = torch.from_numpy(pool.copy())
    rows = paged_rows(torch.from_numpy(table), torch.from_numpy(index), bs)
    out = paged_write(t_pool, torch.from_numpy(new), rows)
    assert out is t_pool                      # written in place
    want = jax_paged_write(jnp.asarray(pool), jnp.asarray(new),
                           jnp.asarray(table), jnp.asarray(index))
    np.testing.assert_array_equal(t_pool.numpy(), np.asarray(want))
    # and the gathered view reads each row's new token back at its depth
    view = paged_gather(t_pool, torch.from_numpy(table))
    for r in range(b):
        np.testing.assert_array_equal(view[r, index[r]].numpy(), new[r, 0])


def test_cache_spec_rules_match_jax():
    for kw in (dict(block_size=16), dict(num_blocks=8)):
        with pytest.raises(ValueError, match="BOTH"):
            JaxCacheSpec(**kw)
        with pytest.raises(ValueError, match="BOTH"):
            CacheSpec(**kw)
    assert CacheSpec(16, 8).paged and not CacheSpec().paged
    cfg = get_config("yi-9b").reduced(dtype="float32")
    caches = get_model(cfg, device="cpu").init_cache(
        3, 40, spec=CacheSpec(8, 11))
    assert len(caches) == cfg.num_layers
    assert caches[0].k.shape == (11, 8, cfg.num_kv_heads,
                                 cfg.resolved_head_dim)
    ssm = get_model(get_config("mamba2-1.3b").reduced(dtype="float32"),
                    device="cpu")
    with pytest.raises(ValueError, match="rejects a paged CacheSpec"):
        ssm.init_cache(1, 8, spec=CacheSpec(8, 4))


CROSS_RULES = [
    (dict(paged=True), "ssm", "paged"),
    (dict(prefix_cache=True), "dense", "prefix_cache"),
]


@pytest.mark.parametrize("kw,family,match", CROSS_RULES)
def test_config_cross_rules_raise_as_jax(kw, family, match):
    with pytest.raises(ValueError, match=match):
        JaxEngineConfig(**kw).validate(family)
    with pytest.raises(ValueError, match=match):
        EngineConfig(**kw).validate(family)


@pytest.mark.parametrize("kw,match", [
    (dict(prefill_chunk=0), "prefill_chunk"),
    (dict(paged=True, block_size=0), "block_size"),
    (dict(prefix_cache=True, prefix_cache_nodes=0), "prefix_cache_nodes"),
    (dict(max_batch=0), "max_batch"), (dict(prefill_bucket=0),
                                       "prefill_bucket")])
def test_config_field_checks_raise_as_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        JaxEngineConfig(**kw)
    with pytest.raises(ValueError, match=match):
        EngineConfig(**kw)


def test_config_accepts_what_jax_accepts():
    for conf in (EngineConfig, JaxEngineConfig):
        conf(prefix_cache=True).validate("ssm")
        conf(prefill_chunk=8).validate("ssm")
        conf(paged=True, prefix_cache=True, prefill_chunk=4).validate(
            "dense")
    for conf in (EngineConfig, JaxEngineConfig):
        conf(spec="ngram").validate("dense")
        conf(spec="self_lut", spec_k=2, trace=True).validate("ssm")
    # the moe and hybrid families are served (queue 1 item 7), paged too,
    # as JAX serves them; encdec and vlm are refused as JAX refuses them
    for conf in (EngineConfig, JaxEngineConfig):
        for family in ("moe", "hybrid"):
            conf(spec="ngram").validate(family)
            conf(paged=True, prefix_cache=True, prefill_chunk=4).validate(
                family)
        with pytest.raises(ValueError, match="prefix_cache"):
            conf(prefix_cache=True).validate("hybrid")
        for family in ("encdec", "vlm"):
            with pytest.raises(ValueError, match="modality"):
                conf(spec="ngram").validate(family)


def test_cli_flags_parse_as_jax():
    argv = ["--max-batch", "3", "--paged", "--block-size", "8",
            "--num-blocks", "40", "--prefill-chunk", "4", "--prefix-cache",
            "--prefix-cache-nodes", "7", "--spec", "self_lut", "--spec-k",
            "3", "--trace-out", "t.json", "--trace-buffer", "99",
            "--idle-backoff-s", "0.5", "--metrics-dump", "m.txt",
            "--metrics-port", "0"]
    confs, args = [], []
    for conf in (EngineConfig, JaxEngineConfig):
        ap = argparse.ArgumentParser()
        conf.add_cli_args(ap)
        args.append(ap.parse_args(argv))
        confs.append(conf.from_args(args[-1], max_seq=64))
    names = ("max_batch", "max_seq", "paged", "block_size", "num_blocks",
             "prefill_chunk", "prefix_cache", "prefix_cache_nodes", "spec",
             "spec_k", "trace", "trace_buffer", "idle_backoff_s")
    assert [getattr(confs[0], n) for n in names] == \
        [getattr(confs[1], n) for n in names] == \
        [3, 64, True, 8, 40, 4, True, 7, "self_lut", 3, True, 99, 0.5]
    assert vars(args[0]) == vars(args[1])
    ap = argparse.ArgumentParser()
    EngineConfig.add_cli_args(ap)
    c = EngineConfig.from_args(ap.parse_args([]))
    assert not c.paged and c.block_size == 16 and c.prefill_chunk is None


@pytest.fixture
def pool():
    cfg = get_config("yi-9b").reduced(dtype="float32")
    return PagedPool(get_model(cfg, device="cpu"), max_batch=3, max_seq=40,
                     block_size=8, num_blocks=8)


def test_paged_pool_reserve_free_and_backpressure(pool):
    assert pool.blocks_per_row == 5 and pool.stage_len == 40
    assert pool.free_capacity == 7            # 8 blocks, one the garbage
    assert pool.reserve(0, prompt_len=10, max_new=10)     # 3 blocks
    assert pool.block_tables[0, :3].tolist() == pool.slot_blocks(0)
    assert pool.block_tables[0, 3:].tolist() == [GARBAGE_BLOCK] * 2
    before = pool.free_capacity
    assert not pool.reserve(1, prompt_len=30, max_new=10)  # 5 > 4 free
    assert pool.free_capacity == before and pool.slot_blocks(1) == []
    # a shared prefix is ref'd, not allocated; only the tail is new
    shared = pool.slot_blocks(0)[:2]
    assert pool.reserve(1, prompt_len=20, max_new=4, shared=shared)
    assert pool.slot_blocks(1)[:2] == shared
    assert all(pool.refcount(b) == 2 and not pool.writable(b)
               for b in shared)
    assert pool.free_capacity == before - 1    # 3 blocks, 2 of them shared
    cow = pool.cow_table(1, len(shared))
    assert cow[:2].tolist() == [GARBAGE_BLOCK] * 2
    assert cow[2:3].tolist() == pool.slot_blocks(1)[2:3]
    tables = pool.decode_tables([1])          # slot 1 still staged
    assert tables[1].tolist() == [GARBAGE_BLOCK] * 5
    assert tables[0].tolist() == pool.block_tables[0].tolist()
    pool.free_slot(0)
    pool.free_slot(1)
    assert pool.free_capacity == 7
    assert (pool.block_tables == GARBAGE_BLOCK).all()


def test_paged_pool_validate_request(pool):
    pool.validate_request(0, 30, 9)           # 5 blocks of 7: servable
    with pytest.raises(ValueError, match="needs 10 blocks"):
        PagedPool(pool.model, 1, 80, 8, 8).validate_request(0, 70, 9)
