"""The port's paged pool, chunked prefill and prefix cache in the engine,
against the JAX engine and against the port's own dense, whole-prompt,
cold run.

* The port's greedy tokens equal the JAX engine's on the same bridged
  weights and requests under ``paged`` / ``prefill_chunk`` /
  ``prefix_cache`` (yi-9b) and ``prefill_chunk`` / ``prefix_cache``
  (mamba2), with engine-level quant ``None``, ``lut4`` and ``nf4p``, and
  so do the hit, reuse, chunk and call counts; the tokens also equal the
  port's dense, whole-prompt, cold run.
* JAX's pins in the port: paged == dense on mixed lengths with slot reuse
  (``test_engine.py:158``); chunked == whole prompt, dense and paged
  (``:176``) and for mamba2 (``:104``); a chunked admission interleaves
  decode, one piece a tick (``:202``); ``max_new=1``, a prompt of
  ``max_seq - 1`` and slot reuse on the pool; paged backpressure on a full
  pool (``:285``) and the scheduler's stall state, which skips the
  radix-tree walk while capacity has not grown (``test_serve_api.py:537``);
  ssm refuses ``paged`` and the pool refuses requests it can never hold
  (``:310``).
"""
import jax
import numpy as np
import pytest

from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.serve.config import EngineConfig as JaxEngineConfig
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import get_config
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.engine import Engine, Request


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


def _serve(setup, prompts, max_new=6, **knobs):
    _, _, cfg, model = setup
    eng = Engine(cfg, model, EngineConfig(**knobs), device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    stats = eng.serve(reqs)
    assert stats["done"]
    return [r.out for r in reqs], stats, eng


def _prompts(cfg, lens=(3, 9, 5, 17, 2), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]


def _shared_mix(cfg, seed=2):
    """A shared 24-token head with divergent tails, plus an unrelated
    prompt: cold, warm, strict-extension and chunked admissions."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1, cfg.vocab_size, 24).tolist()
    mix = [head + rng.integers(1, cfg.vocab_size, n).tolist()
           for n in (6, 13, 2, 9, 20)]
    mix.insert(3, rng.integers(1, cfg.vocab_size, 11).tolist())
    return mix


STAT_KEYS = ("prefix_hits", "prefix_tokens_reused", "prefill_chunks",
             "prefill_calls", "prefill_tokens", "decode_tokens", "ticks")

PARITY = [
    ("yi", dict(paged=True, block_size=8)),
    ("yi", dict(paged=True, block_size=8, prefill_chunk=8)),
    ("yi", dict(paged=True, block_size=8, prefill_chunk=8,
                prefix_cache=True)),
    ("mamba", dict(prefill_chunk=8)),
    ("mamba", dict(prefill_chunk=8, prefix_cache=True)),
]


PARITY_IDS = ["-".join([a] + [k for k in kw if k != "block_size"])
              for a, kw in PARITY]


@pytest.mark.parametrize("quant", [None, "lut4", "nf4p"])
@pytest.mark.parametrize("arch,knobs", PARITY, ids=PARITY_IDS)
def test_engine_tokens_equal_jax_engine(request, arch, knobs, quant):
    """Served concurrently on 3 slots (slot reuse, staged admissions
    between decode ticks): tokens and counts equal the JAX engine's, and
    the tokens equal the port's dense, whole-prompt, cold run."""
    setup = request.getfixturevalue(arch)
    jcfg, jparams, cfg, _ = setup
    prompts = _shared_mix(cfg)
    base = dict(max_batch=3, max_seq=64, quant=quant)
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**base, **knobs))
    jreqs = [JaxRequest(rid=i, prompt=p, max_new=5)
             for i, p in enumerate(prompts)]
    jstats = jeng.serve(jreqs)
    assert jstats["done"]
    port, stats, _ = _serve(setup, prompts, max_new=5, **base, **knobs)
    assert port == [r.out for r in jreqs]
    assert {k: stats[k] for k in STAT_KEYS} == \
        {k: jstats[k] for k in STAT_KEYS}
    if knobs.get("prefix_cache"):
        assert stats["prefix_hits"] >= 2
    cold, _, _ = _serve(setup, prompts, max_new=5, **base)
    assert port == cold


def test_paged_matches_dense_mixed_lengths(yi):
    prompts = _prompts(yi[2])
    outs = [_serve(yi, prompts, max_batch=3, max_seq=48, paged=paged,
                   block_size=8)[0] for paged in (False, True)]
    assert outs[0] == outs[1]


def test_chunked_prefill_matches_whole_prompt(yi):
    """A max_seq-1 prompt admitted in 8-token pieces (dense and paged) ==
    the same prompt prefilled whole."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, yi[2].vocab_size, n).tolist()
               for n in (31, 4, 12)]
    outs = {}
    for mode, kw in {"whole": {}, "chunked": {"prefill_chunk": 8},
                     "paged_chunked": {"prefill_chunk": 8, "paged": True,
                                       "block_size": 8}}.items():
        outs[mode], stats, _ = _serve(yi, prompts, max_new=5, max_batch=2,
                                      max_seq=32, **kw)
        if mode != "whole":
            assert stats["prefill_chunks"] >= 4
    assert outs["chunked"] == outs["whole"] == outs["paged_chunked"]


def test_recurrent_chunked_prefill_matches_whole_prompt(mamba):
    """mamba2: bucketed and chunked prefill (the state-continuing masked
    scan) == the exact-length whole-prompt oracle."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, mamba[2].vocab_size, n).tolist()
               for n in (31, 4, 12)]
    outs = {}
    for mode, kw in {"whole_exact": {"prefill_bucket": 1}, "bucketed": {},
                     "chunked": {"prefill_chunk": 8}}.items():
        outs[mode], stats, _ = _serve(mamba, prompts, max_new=5,
                                      max_batch=2, max_seq=32, **kw)
        if mode == "chunked":
            assert stats["prefill_chunks"] >= 4
    assert outs["bucketed"] == outs["whole_exact"] == outs["chunked"]


def test_chunked_prefill_interleaves_decode(yi):
    """While a long admission is mid-flight every tick still advances the
    active decode: one piece of prefill a tick, never more."""
    _, _, cfg, model = yi
    rng = np.random.default_rng(4)
    eng = Engine(cfg, model, EngineConfig(max_batch=2, max_seq=48,
                                          prefill_chunk=8), device="cpu")
    short = Request(rid=0, prompt=[5, 6, 7], max_new=30)
    eng.serve([short], max_ticks=1)           # admitted, one decode tick
    long = Request(rid=1, prompt=rng.integers(1, cfg.vocab_size, 20).tolist(),
                   max_new=4)
    eng.serve([long], max_ticks=0)            # queued, no tick run
    assert long.out == []
    ticks = 0
    while not long.out:                       # 20 tokens / 8 -> 3 pieces
        emitted = len(short.out)
        eng.step()
        ticks += 1
        assert len(short.out) == emitted + 1, ticks
    assert ticks == 3 and eng.metrics.prefill_chunks == 3
    eng.serve([])
    alone, _, _ = _serve(yi, [long.prompt], max_new=4, max_batch=1,
                         max_seq=48)
    assert long.out == alone[0]


def test_max_new_one_and_max_seq_boundary_on_the_pool(yi):
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, yi[2].vocab_size, 31).tolist()
    for kw in ({}, {"paged": True, "block_size": 8}):
        outs, _, eng = _serve(yi, [[3, 1, 4]], max_new=1, max_batch=1,
                              max_seq=48, **kw)
        assert len(outs[0]) == 1 and eng.slots == [None] and not eng.active
        if eng.paged:
            assert eng.allocator.used_blocks == 0
        outs, _, _ = _serve(yi, [prompt], max_new=8, max_batch=1, max_seq=32,
                            **kw)
        assert len(outs[0]) == 2              # prefill token + 1 decode step


def test_slot_reuse_no_stale_state_on_the_pool(yi):
    """A 1-slot pool: a long request, then a short one, equals the short
    one served on a fresh engine."""
    rng = np.random.default_rng(6)
    long_p = rng.integers(1, yi[2].vocab_size, 20).tolist()
    short_p = rng.integers(1, yi[2].vocab_size, 4).tolist()
    both, _, _ = _serve(yi, [long_p, short_p], max_batch=1, max_seq=48,
                        paged=True, block_size=8)
    alone, _, _ = _serve(yi, [short_p], max_batch=1, max_seq=48)
    assert both[1] == alone[0]


def test_paged_backpressure_full_pool(yi):
    """A pool that fits one request at a time: the others wait for blocks
    with slots free, and all finish equal to the dense run."""
    prompts = _prompts(yi[2], lens=(5, 4, 6))
    outs, stats, eng = _serve(yi, prompts, max_batch=3, max_seq=48,
                              paged=True, block_size=8, num_blocks=3)
    dense, _, _ = _serve(yi, prompts, max_batch=3, max_seq=48)
    assert outs == dense
    assert eng.allocator.used_blocks == 0
    assert stats["occupancy"] <= 1 / 3 + 1e-9   # one request at a time


def test_stall_state_lives_in_scheduler_and_skips_rematch(yi):
    """A backpressured head of line records its stall in the scheduler;
    while capacity has not grown, later ticks skip the radix-tree walk;
    once the hog frees its blocks the same request admits."""
    _, _, cfg, model = yi
    eng = Engine(cfg, model, EngineConfig(
        max_batch=2, max_seq=32, paged=True, block_size=8, num_blocks=4,
        prefix_cache=True), device="cpu")
    hog = Request(rid=0, prompt=[1, 2, 3, 4, 5], max_new=18)
    eng.serve([hog], max_ticks=1)             # 3 blocks: the pool is empty
    assert eng.allocator.free_blocks == 0
    calls = []
    real_match = eng.prefix_cache.match

    def counting_match(*a, **kw):
        calls.append(1)
        return real_match(*a, **kw)

    eng.prefix_cache.match = counting_match
    blocked = Request(rid=1, prompt=[6, 7, 8], max_new=8)
    need = eng.backend.reservation_need(3, 8)
    eng.serve([blocked], max_ticks=1)
    assert len(calls) == 1 and blocked.out == []
    assert eng.scheduler.stalled(1, eng.backend.free_capacity, need)
    for _ in range(5):                        # capacity unchanged:
        eng.step()                            # no re-walk, no churn
    assert len(calls) == 1 and blocked.out == []
    # a smaller demand under a stalled rid is not gated by the record
    assert not eng.scheduler.stalled(1, eng.backend.free_capacity,
                                     eng.backend.reservation_need(1, 1))
    assert eng.serve([])["done"]
    assert hog.done and blocked.done and len(blocked.out) == 8
    assert len(calls) == 2
    assert not eng.scheduler.stalled(1, eng.backend.free_capacity, need)


def test_paged_rejects_ssm_and_oversized(yi, mamba):
    _, _, cfg, model = mamba
    with pytest.raises(ValueError, match="paged"):
        Engine(cfg, model, EngineConfig(max_batch=1, max_seq=32, paged=True),
               device="cpu")
    Engine(cfg, model, EngineConfig(max_batch=1, max_seq=32,
                                    prefill_chunk=8), device="cpu")
    _, _, cfg, model = yi
    eng = Engine(cfg, model, EngineConfig(max_batch=1, max_seq=64,
                                          paged=True, block_size=8,
                                          num_blocks=4), device="cpu")
    with pytest.raises(ValueError, match="blocks"):
        eng.serve([Request(rid=0, prompt=list(range(1, 40)), max_new=16)])
    assert eng.scheduler.pending == 0         # nothing was queued


def _cli_tokens(out: str) -> list[list[int]]:
    return [eval(line.split(":", 1)[1]) for line in out.splitlines()
            if line.startswith("rid ")]


@pytest.mark.parametrize("arch,flags", [
    ("yi-9b", ["--paged", "--block-size", "8", "--prefill-chunk", "16",
               "--prefix-cache", "--quant", "lut4"]),
    ("mamba2-1.3b", ["--prefill-chunk", "16", "--prefix-cache", "--quant",
                     "nf4p"])])
def test_cli_serves_the_cache_substrate(capsys, arch, flags):
    """The launcher takes the substrate's flags through
    ``EngineConfig.add_cli_args``; on shared-prefix prompts it reports
    hits and chunks, and its tokens equal the dense, whole-prompt, cold
    run's."""
    from repro_torch.launch.serve import main
    argv = ["--arch", arch, "--device", "cpu", "--requests", "6",
            "--max-new", "4", "--shared-prefix", "32"]
    stats = main(argv + flags)
    warm = _cli_tokens(capsys.readouterr().out)
    assert stats["done"] and stats["prefix_hits"] >= 2
    assert stats["prefill_chunks"] > 0
    main(argv + [f for f in flags[-2:]])      # the same --quant only
    assert warm == _cli_tokens(capsys.readouterr().out)
