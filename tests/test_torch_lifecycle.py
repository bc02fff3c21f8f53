"""The port's request lifecycle and background serve loop, against the JAX
engine (``tests/test_serve_api.py:142-723``, ``tests/test_serve_loop.py:
80-288``) on bridged reduced f32 weights.

* Streams (generator and ``on_token``) equal ``req.out`` and the JAX
  engine's tokens for the same requests; loop-mode streams equal the
  synchronous ``serve()`` path and JAX's, for yi-9b on the paged pool and
  for mamba2.
* ``cancel()`` at every lifecycle stage and ``preempt()`` keep pool
  accounting exact; the numbers equal the JAX engine's on the same
  script (cancel mid-chunked-prefill).
* The scheduler pops in JAX's order and ages as JAX's does (seeded random
  op sequences through both ``Scheduler`` classes); priority admission
  under contention equals JAX's.
* The injected clock is the single time base: a virtual clock gives
  JAX's deadline hit/miss counts.
* Threaded tests wait on engine state and join with timeouts; none
  asserts on a sleep.  Greedy token identity is exact (argmax, f32).
"""
import random
import threading

import jax
import numpy as np
import pytest

from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.serve.config import EngineConfig as JaxEngineConfig
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import Scheduler as JaxScheduler
from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import get_config
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.engine import Engine, Request, Scheduler


class VirtualClock:
    """Hand-advanced monotonic clock (``tests/test_serve_loop.py:30``)."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


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


def _engine(setup, clock=None, **knobs):
    _, _, cfg, model = setup
    return Engine(cfg, model, EngineConfig(**knobs), device="cpu",
                  clock=clock)


def _jax_engine(setup, clock=None, **knobs):
    jcfg, jparams, _, _ = setup
    return JaxEngine(jcfg, jparams, JaxEngineConfig(**knobs), clock=clock)


def _prompts(cfg, lens=(3, 9, 5, 12), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]


def _drain(eng, max_ticks=256):
    ticks = 0
    while not eng.idle and ticks < max_ticks:
        eng.step()
        ticks += 1
    assert ticks < max_ticks, "engine failed to drain"


def _solo(setup, prompt, max_new, **knobs):
    """A fresh port engine serving one request alone: its tokens."""
    eng = _engine(setup, **{"max_batch": 1, "max_seq": 48, **knobs})
    req = Request(rid=0, prompt=list(prompt), max_new=max_new)
    assert eng.serve([req])["done"]
    return req.out


def _consume_threaded(handles, timeout=120):
    """Drain every handle's stream on its own client thread."""
    outs = [None] * len(handles)

    def consume(i):
        outs[i] = list(handles[i].tokens())

    threads = [threading.Thread(target=consume, args=(i,), daemon=True)
               for i in range(len(handles))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert all(not t.is_alive() for t in threads), "stream consumer hung"
    return outs


# --- streaming ------------------------------------------------------------
def test_streaming_tokens_match_final_output_and_jax(yi):
    eng = _engine(yi, max_batch=2, max_seq=48)
    seen = []
    req = Request(rid=7, prompt=[5, 6, 7, 8], max_new=6)
    handle = eng.submit(req, on_token=seen.append)
    assert handle
    streamed = list(handle.tokens())
    assert handle.done and not handle.cancelled
    assert streamed == handle.out == req.out == seen
    jeng = _jax_engine(yi, max_batch=1, max_seq=48)
    jreq = JaxRequest(rid=7, prompt=[5, 6, 7, 8], max_new=6)
    assert jeng.serve([jreq])["done"]
    assert streamed == jreq.out


def test_streaming_unadmitted_handle_waits_for_capacity(yi):
    eng = _engine(yi, max_batch=1, max_seq=48)
    first = Request(rid=0, prompt=[1, 2, 3], max_new=4)
    assert eng.submit(first)
    second = Request(rid=1, prompt=[4, 5], max_new=3)
    handle = eng.submit(second)
    assert not handle
    streamed = list(handle.tokens())
    assert first.done and second.done
    assert streamed == second.out == _solo(yi, [4, 5], 3)


def test_streaming_interleaves_with_chunked_admission(yi):
    rng = np.random.default_rng(2)
    eng = _engine(yi, max_batch=2, max_seq=48, prefill_chunk=8)
    short = Request(rid=0, prompt=[3, 1, 4], max_new=8)
    h_short = eng.submit(short)
    long = Request(rid=1, prompt=rng.integers(1, yi[2].vocab_size,
                                              20).tolist(), max_new=3)
    assert eng.submit(long)
    assert list(h_short.tokens()) == short.out and short.done
    _drain(eng)
    assert long.done and len(long.out) == 3


# --- cancellation ---------------------------------------------------------
def _cancel_mid_chunk_script(eng, req_cls, vocab):
    """JAX's cancel-mid-chunked-prefill script; returns what it saw."""
    rng = np.random.default_rng(4)
    short = req_cls(rid=0, prompt=[1, 2, 3], max_new=12)
    assert eng.submit(short)
    used0, free0 = eng.allocator.used_blocks, eng.allocator.free_blocks
    long = req_cls(rid=1, prompt=rng.integers(1, vocab, 30).tolist(),
                   max_new=4)
    handle = eng.submit(long)
    assert handle and long.out == []
    eng.step()
    staged_used = eng.allocator.used_blocks
    assert eng._chunked and long.out == [] and staged_used > used0
    assert handle.cancel() and not handle.cancel()
    seen = (used0, free0, staged_used, eng.allocator.used_blocks,
            eng.allocator.free_blocks, long.cancelled, long.out,
            eng.metrics.cancelled)
    _drain(eng)
    return seen + (short.out, eng.allocator.used_blocks)


def test_cancel_mid_chunked_prefill_releases_blocks_as_jax(yi):
    knobs = dict(max_batch=2, max_seq=64, paged=True, block_size=8,
                 prefill_chunk=8)
    port = _cancel_mid_chunk_script(_engine(yi, **knobs), Request,
                                    yi[2].vocab_size)
    ref = _cancel_mid_chunk_script(_jax_engine(yi, **knobs), JaxRequest,
                                   yi[2].vocab_size)
    assert port == ref
    used0, free0, _, used, free, cancelled, out, n, _, used_end = port
    assert (used, free, cancelled, out, n, used_end) == \
        (used0, free0, True, [], 1, 0)


def test_cancel_warm_prefix_admission_restores_refcounts(yi):
    rng = np.random.default_rng(5)
    head = rng.integers(1, yi[2].vocab_size, 16).tolist()
    eng = _engine(yi, max_batch=2, max_seq=64, paged=True, block_size=8,
                  prefix_cache=True, prefill_chunk=8)
    assert eng.serve([Request(rid=0, prompt=head + [7, 8],
                              max_new=2)])["done"]
    warm_prompt = head + rng.integers(1, yi[2].vocab_size, 6).tolist()
    hit = eng.prefix_cache.match(warm_prompt, max_len=len(warm_prompt) - 1)
    assert hit is not None and len(hit.blocks) == 2
    refs0 = [eng.allocator.refcount(b) for b in hit.blocks]
    free0 = eng.allocator.free_blocks
    warm = Request(rid=1, prompt=warm_prompt, max_new=3)
    handle = eng.submit(warm)
    assert handle and eng._chunked
    assert [eng.allocator.refcount(b) for b in hit.blocks] == \
        [r + 1 for r in refs0]
    assert eng.allocator.free_blocks < free0
    assert handle.cancel()
    assert [eng.allocator.refcount(b) for b in hit.blocks] == refs0
    assert eng.allocator.free_blocks == free0
    assert warm.cancelled and warm.out == []
    redo = Request(rid=2, prompt=warm_prompt, max_new=3)
    assert eng.serve([redo])["done"]
    assert redo.out == _solo(yi, warm_prompt, 3, max_seq=64, paged=True,
                             block_size=8)


def test_cancel_active_and_queued_requests(yi):
    eng = _engine(yi, max_batch=1, max_seq=48)
    active = Request(rid=0, prompt=[1, 2], max_new=30)
    h_active = eng.submit(active)
    assert h_active
    eng.step()
    emitted = len(active.out)
    assert h_active.cancel()
    assert active.cancelled and len(active.out) == emitted
    assert eng.slots == [None] and not eng.active
    queued = Request(rid=1, prompt=[3, 4], max_new=2)
    eng.scheduler.push(queued)
    assert eng.cancel(queued)
    assert queued.cancelled and queued.out == []
    assert eng.scheduler.pending == 0
    blocked = _engine(yi, max_batch=1, max_seq=48)
    assert blocked.submit(Request(rid=2, prompt=[1], max_new=9))
    h = blocked.submit(Request(rid=3, prompt=[2], max_new=1))
    assert not h and h.cancel() and h.cancelled


@pytest.mark.parametrize("paged", [False, True])
def test_cancel_from_on_token_callback_is_reentrancy_safe(yi, paged):
    knobs = dict(paged=True, block_size=8) if paged else {}
    eng = _engine(yi, max_batch=2, max_seq=48, **knobs)
    req = Request(rid=0, prompt=[5, 6, 7], max_new=10)
    handle = eng.submit(req)

    def cb(tok):
        if len(req.out) >= 3:
            handle.cancel()

    eng._callbacks.setdefault(req, []).append(cb)
    assert handle
    for _ in range(12):
        if req.done:
            break
        eng.step()
    assert req.cancelled and len(req.out) == 3
    assert eng.slots == [None, None] and not eng.active
    req2 = Request(rid=1, prompt=[1, 2], max_new=5)
    eng.submit(req2, on_token=lambda tok: eng.cancel(req2))
    assert req2.cancelled and len(req2.out) == 1
    assert eng.slots == [None, None] and not eng.active
    if eng.allocator is not None:
        assert eng.allocator.used_blocks == 0
    ok = Request(rid=2, prompt=[3, 4], max_new=3)
    assert eng.serve([ok])["done"] and len(ok.out) == 3


def test_invalid_request_does_not_poison_the_scheduler(yi):
    eng = _engine(yi, max_batch=1, max_seq=16)
    bad = Request(rid=0, prompt=list(range(1, 40)), max_new=2)
    with pytest.raises(ValueError):
        eng.serve([bad])
    assert eng.scheduler.pending == 0
    good = Request(rid=1, prompt=[1, 2, 3], max_new=2)
    assert eng.serve([good])["done"] and len(good.out) == 2
    eng.scheduler.push(bad)
    with pytest.raises(ValueError):
        eng.step()
    assert eng.scheduler.pending == 0
    assert eng.serve([Request(rid=2, prompt=[4, 5], max_new=2)])["done"]


def test_on_token_callback_registration_is_idempotent(yi):
    eng = _engine(yi, max_batch=1, max_seq=48)
    assert eng.submit(Request(rid=0, prompt=[1], max_new=6))
    seen = []
    retry = Request(rid=1, prompt=[2, 3], max_new=3)
    assert not eng.submit(retry, on_token=seen.append)
    h = eng.submit(retry, on_token=seen.append)
    streamed = list(h.tokens()) if h else list(
        eng.submit(retry, on_token=seen.append).tokens())
    assert retry.done and seen == retry.out == streamed
    eng2 = _engine(yi, max_batch=1, max_seq=48)
    assert eng2.submit(Request(rid=0, prompt=[1], max_new=4))
    ghost_tokens = []
    ghost = eng2.submit(Request(rid=7, prompt=[2], max_new=2),
                        on_token=ghost_tokens.append)
    assert not ghost and not eng2._callbacks
    assert ghost.cancel()
    _drain(eng2)
    assert eng2.serve([Request(rid=7, prompt=[3, 4], max_new=2)])["done"]
    assert ghost_tokens == []


# --- scheduler ------------------------------------------------------------
def _req(cls, rid, pri=0, dl=None):
    return cls(rid=rid, prompt=[1], max_new=1, priority=pri, deadline=dl)


def _sched_trace(sched_cls, req_cls, ops, bound):
    """Drive a scheduler through (push pri dl | pop) ops; the pop order
    with each popped entry's ``passed`` and effective priority."""
    s = sched_cls(starvation_bound=bound, clock=lambda: 0.0)
    pushes, popped = 0, []
    for op in ops:
        if op[0] == "push":
            s.push(_req(req_cls, pushes, pri=op[1], dl=op[2]))
            pushes += 1
        else:
            e = s.select()
            if e is None:
                continue
            for other in s._queue:          # inversion within one bucket
                if other is not e:
                    assert other.req.priority - e.req.priority <= 1
            popped.append((e.req.rid, e.passed, s.effective_priority(e)))
            s.commit(e)
    assert s.pending == 0
    return popped


@pytest.mark.parametrize("seeds", [range(0, 10), range(10, 20),
                                   range(20, 30)])
def test_scheduler_orders_as_jax_seeded_random(seeds):
    for seed in seeds:
        rng = random.Random(seed)
        bound = rng.choice([1, 2, 4, 8])
        ops = []
        for _ in range(rng.randint(1, 60)):
            if rng.random() < 0.6:
                ops.append(("push", rng.choice([0, 1]),
                            rng.choice([None, rng.random()])))
            else:
                ops.append(("pop",))
        ops.extend([("pop",)] * 60)
        assert _sched_trace(Scheduler, Request, ops, bound) == \
            _sched_trace(JaxScheduler, JaxRequest, ops, bound)


def test_scheduler_priority_deadline_and_aging():
    s = Scheduler(starvation_bound=8)
    for r in (_req(Request, 0, 0, 5.0), _req(Request, 1, 0, 1.0),
              _req(Request, 2, 1)):
        s.push(r)
    order = []
    while s.pending:
        e = s.select()
        s.commit(e)
        order.append(e.req.rid)
    assert order == [2, 1, 0]
    s = Scheduler(starvation_bound=2)
    s.push(_req(Request, 0, pri=0))
    for rid in (1, 2):
        s.push(_req(Request, rid, pri=1))
        e = s.select()
        assert e.req.rid == rid
        s.commit(e)
    s.push(_req(Request, 3, pri=1))
    e = s.select()
    assert e.req.rid == 0 and s.effective_priority(e) == 1
    assert s.queued(e.req) and s.remove(e.req) and not s.queued(e.req)
    s.note_stall(5, 1, 2)
    s.clear_stall()
    assert not s.stalled(5, 1, 2)


def test_stall_state_lives_in_scheduler_and_skips_rematch(yi):
    eng = _engine(yi, max_batch=2, max_seq=32, paged=True, block_size=8,
                  num_blocks=4, prefix_cache=True)
    hog = Request(rid=0, prompt=[1, 2, 3, 4, 5], max_new=18)
    assert eng.submit(hog)
    calls = []
    real_match = eng.prefix_cache.match

    def counting_match(*a, **kw):
        calls.append(1)
        return real_match(*a, **kw)

    eng.prefix_cache.match = counting_match

    def is_stalled(req):
        return eng.scheduler.stalled(
            req.rid, eng.backend.free_capacity,
            eng.backend.reservation_need(len(req.prompt), req.max_new))

    blocked = Request(rid=1, prompt=[6, 7, 8], max_new=8)
    blocked2 = Request(rid=2, prompt=[6, 7, 9], max_new=8)
    assert not eng.submit(blocked) and len(calls) == 1
    assert is_stalled(blocked)
    assert not eng.submit(blocked2) and len(calls) == 2
    assert not eng.submit(blocked) and not eng.submit(blocked2)
    assert len(calls) == 2
    _drain(eng)
    assert eng.submit(blocked) and len(calls) == 3
    assert not is_stalled(blocked)
    _drain(eng)
    assert blocked.done and len(blocked.out) == 8


def test_rid_collision_and_done_resubmission_are_explicit(yi):
    eng = _engine(yi, max_batch=2, max_seq=48)
    a = Request(rid=0, prompt=[1, 2], max_new=8)
    assert eng.submit(a)
    with pytest.raises(ValueError, match="in flight"):
        eng.submit(Request(rid=0, prompt=[3], max_new=2))
    assert eng.submit(a) and eng.scheduler.pending == 0
    _drain(eng)
    assert len(a.out) == 8
    done_req = Request(rid=5, prompt=[4], max_new=1)
    assert eng.serve([done_req])["done"]
    assert not eng.submit(done_req, on_token=lambda t: None)
    assert not eng._callbacks


def test_reentrant_submit_from_on_token_cannot_steal_slot(yi):
    eng = _engine(yi, max_batch=2, max_seq=48)
    inner = Request(rid=1, prompt=[9, 8], max_new=2)
    results = []

    def cb(tok):
        if not results:
            results.append(eng.submit(inner))

    a = Request(rid=0, prompt=[1, 2, 3], max_new=4)
    assert eng.submit(a, on_token=cb) and not results[0]
    assert eng.slots[0] is a and inner.out == []
    assert eng.submit(inner)
    _drain(eng)
    assert len(a.out) == 4 and len(inner.out) == 2
    assert a.out == _solo(yi, [1, 2, 3], 4)


def test_serve_path_rejects_live_rid_collision_and_poison(yi):
    eng = _engine(yi, max_batch=2, max_seq=48)
    a = Request(rid=0, prompt=[1, 2], max_new=20)
    assert eng.submit(a)
    with pytest.raises(ValueError, match="in flight"):
        eng.serve([Request(rid=0, prompt=[3, 4], max_new=2)])
    assert eng.scheduler.pending == 0
    _drain(eng)
    assert a.done and len(a.out) == 20
    paged = _engine(yi, max_batch=2, max_seq=32, paged=True, block_size=8)
    good = Request(rid=0, prompt=[1, 2, 3], max_new=3)
    paged.scheduler.push(good)
    paged.scheduler.push(Request(rid=1, prompt=list(range(1, 40)),
                                 max_new=2))
    with pytest.raises(ValueError):
        paged.step()
    assert paged.scheduler.pending == 0 and good.out
    _drain(paged)
    assert len(good.out) == 3 and paged.allocator.used_blocks == 0


def test_no_double_admission_and_no_leapfrog(yi):
    eng = _engine(yi, max_batch=2, max_seq=48)
    req = Request(rid=0, prompt=[1, 2, 3], max_new=4)
    eng.scheduler.push(req)
    assert eng.submit(req) and eng.scheduler.pending == 0
    _drain(eng)
    assert len(req.out) == 4 and eng.slots == [None, None]
    hog = Request(rid=0, prompt=[1, 2], max_new=30)
    assert eng.submit(hog)
    queued_hi = Request(rid=1, prompt=[3, 4], max_new=2, priority=1)
    eng.scheduler.push(queued_hi)
    assert not eng.submit(Request(rid=2, prompt=[5, 6], max_new=2))
    hi2 = Request(rid=3, prompt=[7, 8], max_new=2, priority=2)
    assert eng.submit(hi2)
    entry = eng.scheduler.select()
    assert entry.req.rid == 1 and entry.passed == 1
    _drain(eng, max_ticks=64)
    assert queued_hi.done and hi2.done


def test_priority_admission_order_under_contention_as_jax(yi):
    """One slot, queued mixed priorities: the high class is admitted
    first, in JAX's order, with JAX's tokens."""
    def run(eng, cls):
        reqs = [cls(rid=i, prompt=[i + 1, i + 2], max_new=2,
                    priority=(1 if i % 2 else 0)) for i in range(6)]
        assert eng.serve(reqs)["done"]
        order = sorted(reqs, key=lambda r: r.token_ts[0])
        return [r.rid for r in order], [r.out for r in reqs]

    port = run(_engine(yi, max_batch=1, max_seq=48), Request)
    assert port == run(_jax_engine(yi, max_batch=1, max_seq=48), JaxRequest)
    assert port[0] == [1, 3, 5, 0, 2, 4]


def test_virtual_clock_deadline_accounting_as_jax(yi):
    def run(eng, cls):
        vc = eng.clock
        prompts = _prompts(yi[2])
        hit = cls(rid=0, prompt=prompts[0], max_new=2, deadline=1e9)
        miss = cls(rid=1, prompt=prompts[1], max_new=2, deadline=0.5)
        vc.advance(1.0)
        assert eng.serve([hit, miss])["done"]
        assert hit.token_ts[0] == hit.submit_ts == 1.0
        m = eng.metrics
        return m.deadline_hits, m.deadline_misses, hit.out, miss.out

    port = run(_engine(yi, clock=VirtualClock(), max_batch=2, max_seq=48),
               Request)
    assert port == run(_jax_engine(yi, clock=VirtualClock(), max_batch=2,
                                   max_seq=48), JaxRequest)
    assert port[:2] == (1, 1)


# --- the background loop ----------------------------------------------------
LOOP_FAMILIES = {"yi": dict(paged=True, block_size=8), "mamba": {}}


@pytest.mark.parametrize("arch", sorted(LOOP_FAMILIES))
def test_loop_stream_identical_to_sync_and_jax(request, arch):
    setup = request.getfixturevalue(arch)
    prompts = _prompts(setup[2])
    knobs = dict(max_batch=2, max_seq=48, **LOOP_FAMILIES[arch])
    jeng = _jax_engine(setup, **knobs)
    jreqs = [JaxRequest(rid=i, prompt=list(p), max_new=5)
             for i, p in enumerate(prompts)]
    assert jeng.serve(jreqs)["done"]
    ref = [list(r.out) for r in jreqs]
    sync = _engine(setup, **knobs)
    sreqs = [Request(rid=i, prompt=list(p), max_new=5)
             for i, p in enumerate(prompts)]
    assert sync.serve(sreqs)["done"]
    assert [r.out for r in sreqs] == ref
    loop = _engine(setup, **knobs).start()
    try:
        reqs = [Request(rid=i, prompt=list(p), max_new=5)
                for i, p in enumerate(prompts)]
        outs = _consume_threaded([loop.submit(r) for r in reqs])
    finally:
        assert loop.stop(timeout=120)
    assert outs == [r.out for r in reqs] == ref
    if loop.allocator is not None:
        assert loop.allocator.used_blocks == 0


def test_concurrent_submit_from_many_threads(yi):
    prompts = _prompts(yi[2], lens=(3, 9, 5, 12, 4, 7, 6, 10))
    refs = [_solo(yi, p, 4) for p in prompts]
    loop = _engine(yi, max_batch=2, max_seq=48).start()
    reqs = [Request(rid=i, prompt=list(p), max_new=4)
            for i, p in enumerate(prompts)]
    outs = [None] * len(reqs)
    try:
        def client(idx):
            for i in range(idx, len(reqs), 4):
                outs[i] = list(loop.submit(reqs[i]).tokens())

        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        assert all(not t.is_alive() for t in threads), "client thread hung"
    finally:
        assert loop.stop(timeout=120)
    assert outs == refs


def test_tokens_blocks_on_queue_while_loop_runs(yi):
    loop = _engine(yi, max_batch=2, max_seq=48).start()
    try:
        req = Request(rid=0, prompt=_prompts(yi[2])[1], max_new=6)
        with loop._lock:                  # admitted before any tick runs
            handle = loop.submit(req)
            ticks_before = loop.metrics.ticks
        stream = list(handle.tokens())    # this thread never calls step()
        assert loop.metrics.ticks > ticks_before
        assert stream == req.out and len(stream) == 6 and req.done
    finally:
        assert loop.stop(timeout=120)


def test_cancel_races_final_token(yi):
    loop = _engine(yi, max_batch=2, max_seq=48).start()
    try:
        for attempt, cancel_after in enumerate((1, 2, 3)):
            req = Request(rid=attempt, prompt=_prompts(yi[2])[3], max_new=8)
            handle = loop.submit(req)
            got, canceller = [], None
            for tok in handle.tokens():
                got.append(tok)
                if len(got) == cancel_after:
                    canceller = threading.Thread(target=handle.cancel,
                                                 daemon=True)
                    canceller.start()
            canceller.join(60)
            assert not canceller.is_alive()
            assert req.done and cancel_after <= len(got) <= 8
            assert got == req.out[:len(got)]
    finally:
        assert loop.stop(timeout=120)


def test_stop_drains_and_stop_without_drain_resumes(yi):
    prompts = _prompts(yi[2])
    loop = _engine(yi, max_batch=2, max_seq=48).start()
    reqs = [Request(rid=i, prompt=list(p), max_new=4)
            for i, p in enumerate(prompts)]
    handles = [loop.submit(r) for r in reqs]
    assert loop.stop(drain=True, timeout=180)
    assert not loop.running and loop.idle
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert [list(h.tokens()) for h in handles] == [r.out for r in reqs]
    eng = _engine(yi, max_batch=1, max_seq=48)
    req = Request(rid=3, prompt=list(prompts[3]), max_new=6)
    eng.serve([req], max_ticks=0)
    eng.start()
    assert eng.stop(drain=False, timeout=120)
    eng.serve([])
    assert req.done and req.out == _solo(yi, prompts[3], 6)


@pytest.mark.parametrize("arch", ["yi", "mamba"])
def test_preempt_requeue_is_greedy_identical(request, arch):
    setup = request.getfixturevalue(arch)
    prompts = _prompts(setup[2])
    knobs = dict(max_batch=2, max_seq=48, **LOOP_FAMILIES[arch])
    ref = _solo(setup, prompts[1], 8, **knobs)
    eng = _engine(setup, **knobs)
    req = Request(rid=7, prompt=list(prompts[1]), max_new=8)
    eng.serve([req], max_ticks=0)
    for _ in range(4):
        eng.step()
    assert 0 < len(req.out) < 8 and not req.done
    free_before = eng.backend.free_capacity
    assert eng.preempt(req)
    if eng.paged:
        assert eng.backend.free_capacity > free_before
    assert eng.metrics.preemptions == 1
    while not req.done:
        eng.step()
    assert req.out == ref
    assert not eng.preempt(req)


def test_submit_backpressure_queues_under_loop(yi):
    """Loop mode: a backpressured submit() returns a falsy handle but the
    request is queued and still streams.  The three submits run under the
    engine lock, so no tick can free the slot between them (JAX's test
    leaves that to timing)."""
    loop = _engine(yi, max_batch=1, max_seq=48).start()
    try:
        reqs = [Request(rid=i, prompt=list(p), max_new=4)
                for i, p in enumerate(_prompts(yi[2], lens=(6, 6, 6)))]
        with loop._lock:
            handles = [loop.submit(r) for r in reqs]
            assert [bool(h) for h in handles] == [True, False, False]
            assert loop.scheduler.pending == 2
        outs = _consume_threaded(handles)
        assert all(len(o) == 4 for o in outs)
        assert outs == [r.out for r in reqs]
    finally:
        assert loop.stop(timeout=120)
