"""The port's copy of ``repro.obs`` and its wiring in the engine, against
the JAX package (``tests/test_obs.py``).

* Driven with the same operations, ``repro_torch.obs`` and ``repro.obs``
  give byte-equal ``dump_json``, ``prometheus_text`` and ``perfetto_json``
  and raise the same errors.
* Under a virtual clock the port's engine and JAX's, serving the same
  requests on bridged reduced f32 weights (yi-9b dense and paged with
  chunked prefill, mamba2), leave byte-equal registry dumps and Perfetto
  traces: every counter, histogram and lifecycle event of the port is
  JAX's.
* ``EngineMetricsView`` keeps JAX's contract; the threaded loop's trace
  is schema-valid; tracing off records nothing while the metrics stay
  live.
"""
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest

import repro.obs as jobs
from repro.models.registry import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.obs.trace import request_events as jax_request_events
from repro.serve.config import EngineConfig as JaxEngineConfig
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch import obs
from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import get_config
from repro_torch.obs.trace import request_events
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.engine import (Engine, EngineMetrics,
                                      EngineMetricsView, Request)


class VirtualClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


# --- the copy, op for op ----------------------------------------------------
def _registry_ops(mod, seed):
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    c = reg.counter("reqs_total", "requests", ("priority",))
    g = reg.gauge("depth", "queue depth")
    h = reg.histogram("lat_seconds", "latency", ("phase",),
                      buckets=mod.TTFT_BUCKETS)
    h2 = reg.histogram("win", "accepted", buckets=mod.SPEC_WINDOW_BUCKETS)
    for _ in range(60):
        op = int(rng.integers(0, 4))
        if op == 0:
            c.add(int(rng.integers(1, 4)), priority=str(rng.integers(0, 2)))
        elif op == 1:
            g.set(float(rng.normal()))
        elif op == 2:
            h.observe(float(rng.exponential(0.3)),
                      phase=("decode", "prefill")[int(rng.integers(0, 2))])
        else:
            h2.observe(float(rng.integers(0, 5)))
    reg.counter("zero_total", "never touched")
    return reg


@pytest.mark.parametrize("seed", range(3))
def test_registry_byte_equal_to_jax(seed):
    port, ref = _registry_ops(obs, seed), _registry_ops(jobs, seed)
    assert port.dump_json() == ref.dump_json()
    assert port.prometheus_text() == ref.prometheus_text()
    assert port.dump() == ref.dump()


def _tracer_ops(mod, capacity):
    clk = iter(float(i) / 7 for i in range(1000)).__next__
    tr = mod.Tracer(clock=clk, capacity=capacity, enabled=True)
    for rid in range(4):
        tr.event("submit", rid=rid, priority=rid % 2)
        with tr.span("decode", batch=rid):
            pass
        tr.event("first_token", rid=rid)
        tr.event("token", rid=rid, ts=0.125 * rid)
        tr.event("finish", rid=rid, tokens=3, cancelled=False)
    return tr


@pytest.mark.parametrize("capacity", [8, 65536])
def test_tracer_perfetto_byte_equal_to_jax(capacity):
    port, ref = _tracer_ops(obs, capacity), _tracer_ops(jobs, capacity)
    assert port.perfetto() == ref.perfetto()
    assert obs.perfetto_json(port.events()) == \
        jobs.perfetto_json(ref.events())
    assert port.dropped == ref.dropped
    assert {k: [e.name for e in v]
            for k, v in request_events(port.events()).items()} == \
        {k: [e.name for e in v]
         for k, v in jax_request_events(ref.events()).items()}
    json.loads(port.perfetto())


def test_schema_errors_and_disabled_tracer_as_jax():
    for mod in (obs, jobs):
        reg = mod.MetricsRegistry()
        c = reg.counter("a_total", "a", ("mode",))
        with pytest.raises(ValueError):
            c.add(wrong="x")
        with pytest.raises(ValueError):
            reg.gauge("a_total", "a", ("mode",))
        with pytest.raises(ValueError):
            reg.counter("a_total", "a", ("other",))
        assert reg.counter("a_total", "a", ("mode",)) is c
        with pytest.raises(ValueError):
            mod.Tracer(capacity=0)
        tr = mod.Tracer(clock=lambda: 0.0, capacity=4)
        tr.event("submit", rid=1)
        assert tr.events() == [] and tr.dropped == 0


def test_http_exporter_and_dumps(tmp_path):
    reg = obs.MetricsRegistry()
    reg.counter("hits_total", "hits").add(5)
    server = obs.start_metrics_server(reg, port=0)
    try:
        port = server.server_address[1]
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        assert "hits_total 5" in body
        js = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics.json", timeout=10).read()
        assert json.loads(js)["hits_total"]["series"][""] == 5
    finally:
        server.shutdown()
    mp = tmp_path / "m.prom"
    assert obs.dump_metrics(reg, str(mp)) == mp.read_text()
    tr = obs.Tracer(clock=iter([0.0]).__next__, enabled=True)
    tr.event("submit", rid=0)
    tp = tmp_path / "t.json"
    assert obs.dump_trace(tr, str(tp)) == tp.read_text()


def test_metrics_view_contract():
    view = EngineMetricsView(obs.MetricsRegistry())
    view.ticks += 3
    view.decode_tokens = 7
    view.prefill_s += 0.5
    snap = view.snapshot()
    assert isinstance(snap, EngineMetrics) and snap.ticks == 3
    view.ticks += 1
    assert view.since(snap).ticks == 1
    view.decode_tokens = 0
    view.decode_s = 0.0
    assert view.summary(4)["decode_tok_s"] == 0.0
    assert EngineMetrics().summary(4)["prefill_tok_s"] == 0.0
    with pytest.raises(AttributeError):
        view.not_a_metric = 1
    with pytest.raises(AttributeError):
        _ = view.not_a_metric


# --- the engine's instruments, against JAX's --------------------------------
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


def _virtual_run(eng, req_cls, vocab):
    """A deterministic script on a virtual clock: requests arrive, with
    priorities and deadlines, between ticks of 10 ms; one is cancelled
    while queued and one preempted while decoding."""
    vc = eng.clock
    rng = np.random.default_rng(0)
    reqs = [req_cls(rid=i, prompt=rng.integers(1, vocab, n).tolist(),
                    max_new=6, priority=i % 2, deadline=0.05 * i + 0.02)
            for i, n in enumerate((4, 12, 20, 6, 9))]
    eng.serve(reqs[:3], max_ticks=0)
    for t in range(64):
        if t == 1:
            eng.serve(reqs[3:], max_ticks=0)
        if t == 2:
            eng.cancel(reqs[4])
        if t == 3:
            assert eng.preempt(eng.active[min(eng.active)])
        eng.step()
        vc.advance(0.01)
        if eng.idle and t > 3:
            break
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


OBS_CASES = [("yi", dict(max_batch=2, max_seq=48)),
             ("yi", dict(max_batch=2, max_seq=48, paged=True, block_size=8,
                         prefill_chunk=8)),
             ("mamba", dict(max_batch=2, max_seq=48, prefill_chunk=8))]


@pytest.mark.parametrize("arch,knobs", OBS_CASES,
                         ids=["yi-dense", "yi-paged-chunked",
                              "mamba2-chunked"])
def test_virtual_run_registry_and_trace_equal_jax(request, arch, knobs):
    setup = request.getfixturevalue(arch)
    jcfg, jparams, cfg, model = setup
    eng = Engine(cfg, model, EngineConfig(trace=True, **knobs),
                 device="cpu", clock=VirtualClock())
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(trace=True, **knobs),
                     clock=VirtualClock())
    outs = _virtual_run(eng, Request, cfg.vocab_size)
    assert outs == _virtual_run(jeng, JaxRequest, cfg.vocab_size)
    assert eng.registry.dump_json() == jeng.registry.dump_json()
    assert eng.registry.prometheus_text() == jeng.registry.prometheus_text()
    assert eng.tracer.perfetto() == jeng.tracer.perfetto()
    m = eng.metrics
    assert m.cancelled == 1 and m.preemptions == 1
    evs = eng.tracer.events()
    per_req = request_events(evs)
    assert len(per_req) == 5
    for res in per_req.values():
        names = [e.name for e in res]
        assert names.count("submit") == names.count("finish") == 1
    assert sum(e.name in ("first_token", "token") for e in evs) == \
        sum(len(o) for o in outs)


def test_threaded_trace_schema_valid(yi):
    eng = Engine(yi[2], yi[3], EngineConfig(max_batch=2, max_seq=48,
                                            trace=True), device="cpu")
    eng.start()
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(1, yi[2].vocab_size,
                                               5).tolist(), max_new=3)
            for i in range(5)]
    try:
        outs = [None] * len(reqs)

        def client(i):
            outs[i] = list(eng.submit(reqs[i]).tokens())

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert all(not t.is_alive() for t in threads)
    finally:
        assert eng.stop(timeout=120)
    assert outs == [r.out for r in reqs]
    doc = json.loads(eng.tracer.perfetto())
    assert doc["traceEvents"]
    per_req = request_events(eng.tracer.events())
    assert len(per_req) == 5
    for res in per_req.values():
        names = [e.name for e in res]
        assert names.count("submit") == names.count("finish") == 1
        assert "first_token" in names and "admit" in names
        ts = [e.ts for e in res]
        assert ts == sorted(ts)
    dump = eng.registry.dump()
    assert dump["engine_ttft_seconds"]["series"]['priority="0"']["count"] == 5


def test_tracing_off_records_nothing_but_metrics_live(yi):
    eng = Engine(yi[2], yi[3], EngineConfig(max_batch=2, max_seq=48),
                 device="cpu", clock=VirtualClock())
    reqs = [Request(rid=i, prompt=[i + 1, i + 2], max_new=3)
            for i in range(4)]
    assert eng.serve(reqs)["done"]
    assert eng.tracer.events() == [] and not eng.tracer.enabled
    assert eng.metrics.decode_tokens == 8
    dump = eng.registry.dump()
    assert dump["engine_requests_finished_total"]["series"][""] == 4
    assert eng.registry.gauge("engine_queue_depth").value() == 0
    assert eng.registry.gauge("engine_active_slots").value() == 0
