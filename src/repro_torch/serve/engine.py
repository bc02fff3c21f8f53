"""Continuous-batching serving engine (mirrors ``repro.serve.engine``).

A fixed set of ``max_batch`` slots.  New requests are bucketed by padded
prompt length and prefilled in one call per bucket, their rows copied into
the cache substrate; every decode tick then advances ALL ``max_batch``
rows one token at their own positions (a ``(max_batch,)`` position
tensor).  Under ``EngineConfig(quant=...)`` prefill runs full precision
and the decode model carries frozen 4-bit projections evaluated by the LUT
GEMM kernels; a model-level ``cfg.quant`` mode (``luna_*``, ``lut_nf4``,
...) instead quantizes every projection of prefill and decode on each
call.  The two do not combine.  Free rows sit at position 0 with token 0
and compute garbage that is ignored, exactly as in JAX.

The cache substrate is owned by :mod:`repro_torch.serve.backend`: a dense
slab, a paged block pool (``paged=True``: admission reserves only the
blocks a request needs and backpressures when the pool is short) or dense
recurrent state (ssm); the engine never branches on which.

**Chunked prefill** (``prefill_chunk=N``): prompts longer than N tokens are
admitted in N-token pieces, at most ONE piece a tick before the decode
step; mamba2 resumes the SSD scan from the carried (conv, state).
**Prefix cache** (``prefix_cache=True``): a radix tree over prompt tokens
(:mod:`repro_torch.serve.prefix_cache`); warm admissions prefill only the
tail, on the staged path (shared KV blocks are never written:
copy-on-write).

**Request lifecycle.**  ``submit()`` returns a :class:`RequestHandle`:
streaming (``tokens()`` and an ``on_token`` callback), ``cancel()`` from
any lifecycle stage with exact pool accounting, and ``preempt()`` back to
the scheduler.  **Background loop**: ``start()`` runs the tick on a daemon
thread and ``stop()`` drains it.  ONE re-entrant lock guards scheduler,
slot and backend state: every public mutator takes it and the whole tick
runs under it, so there is one writer at a time and the kernels are only
ever launched from one thread at a time.  The synchronous ``serve()`` is a
thin wrapper over the same ``_tick()``, so loop output equals sync
output.  Every time stamp and metric interval comes from the injected
``clock`` (default ``time.perf_counter``).

**Observability**: the engine's counters live in a
:class:`~repro_torch.obs.MetricsRegistry` (``Engine.metrics`` is a live
:class:`EngineMetricsView` over it; :class:`EngineMetrics` is the snapshot
type), and ``EngineConfig(trace=True)`` records lifecycle and phase events
in a :class:`~repro_torch.obs.Tracer` on the same clock.

**Speculative decoding** (``EngineConfig(spec=...)``, greedy-only): each
tick drafts up to ``spec_k`` tokens a row (:mod:`repro_torch.serve.spec`),
scores the (max_batch, spec_k + 1) window in one ``decode_window`` call at
the decode precision, emits the accepted prefix plus the verifier's
correction, and on recurrent state re-commits a partial accept from the
pre-verify caches (:meth:`Engine._spec_tick`).
"""
from __future__ import annotations

import math
import queue
import threading
import time
from dataclasses import dataclass, field, fields

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import (ITL_BUCKETS, PHASE_BUCKETS, SPEC_REQUEST_BUCKETS,
                             SPEC_WINDOW_BUCKETS, TTFT_BUCKETS,
                             MetricsRegistry, Tracer)
from repro_torch.serve.backend import make_backend
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.paged import ceil_div
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.sampling import SamplingConfig, sample
from repro_torch.serve.spec import accept_length


@dataclass(eq=False)
class Request:
    """One generation request.  ``priority``: higher admits first;
    ``deadline``: a stamp on the ENGINE CLOCK (``engine.clock() +
    budget``), the within-class tie-break (earlier first) and the
    first-token deadline accounting.  ``submit_ts``/``token_ts`` are
    stamped on the same clock (TTFT = ``token_ts[0] - submit_ts``).
    ``eq=False``: a request is an identity (streams and callbacks are
    keyed on the object)."""
    rid: int
    prompt: list[int]
    max_new: int = 16
    priority: int = 0
    deadline: float | None = None
    out: list[int] = field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    submit_ts: float | None = field(default=None, repr=False)
    token_ts: list[float] = field(default_factory=list, repr=False)
    # engine-internal: the submit counter and trace event fired (a
    # backpressured submit() retry must not count twice)
    _submit_seen: bool = field(default=False, repr=False)
    # engine-internal speculative tallies, observed at retirement
    _spec_accepted: int = field(default=0, repr=False)
    _spec_rejected: int = field(default=0, repr=False)


#: end-of-stream sentinel pushed onto every subscribed token queue at
#: retirement (completion or cancellation)
_STREAM_DONE = object()


class RequestHandle:
    """Live view of one submitted request.

    * ``bool(handle)``: True iff the request was admitted at once.  False
      is backpressure: with the background loop running the request IS
      queued on the scheduler; without it, it is not (retry, or hand it to
      ``serve()``).
    * :meth:`tokens` yields the tokens in emission order.  While the loop
      runs it blocks on a per-handle queue fed under the engine lock;
      without the loop it drives the engine one tick at a time.  The
      streamed sequence is exactly ``req.out``.
    * :meth:`cancel` releases the request's slot, blocks and staged state
      wherever it is in its lifecycle; safe from any thread.
    """

    def __init__(self, engine: "Engine", req: Request, on_token=None):
        self._engine = engine
        self.req = req
        self._on_token = on_token
        self._admitted = False

    def __bool__(self) -> bool:
        return self._admitted

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def out(self) -> list[int]:
        return self.req.out

    @property
    def done(self) -> bool:
        return self.req.done

    @property
    def cancelled(self) -> bool:
        return self.req.cancelled

    def cancel(self) -> bool:
        """Stop the request and release its resources; True unless it had
        already finished."""
        return self._engine.cancel(self.req)

    def tokens(self):
        """Generator of this request's tokens, ending when it completes or
        is cancelled.  With the loop running it blocks on the handle's
        queue (re-checking ``engine.running`` every 0.1 s, so a loop
        stopped mid-stream falls back to driving the engine here);
        without it, it ticks the engine between yields and re-attempts
        the admission of an un-admitted handle."""
        eng = self._engine
        q = eng._subscribe(self.req)
        while True:
            try:
                tok = q.get_nowait()
            except queue.Empty:
                tok = None
            if tok is _STREAM_DONE:
                return
            if tok is not None:
                yield tok
                continue
            if eng.running:
                try:
                    tok = q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if tok is _STREAM_DONE:
                    return
                yield tok
                continue
            if self.req.done:
                continue        # the sentinel is already in the queue
            if not self._admitted:
                self._admitted = eng._admit_handle(self)
                if not self._admitted and eng.idle:
                    raise RuntimeError(
                        f"request {self.req.rid} cannot be admitted on an "
                        "idle engine (capacity permanently short?)")
            if not self.req.done:
                eng.step()


@dataclass(eq=False)
class _QueueEntry:
    """Scheduler bookkeeping for one queued request: ``passed`` counts the
    admissions that went to others while it waited; ``enqueue_ts`` is on
    the engine's clock."""
    req: Request
    arrival: int
    passed: int = 0
    enqueue_ts: float = 0.0


class Scheduler:
    """Priority-class admission queue: highest effective priority first;
    within a class aged entries first (by arrival), then earliest
    deadline, then arrival (FIFO).  An entry passed over
    ``starvation_bound`` times gains one priority bucket, never more
    (priority inversion stays within one bucket).

    It also holds the head-of-line stall state: per rid, the free
    capacity at its last failed reservation and what it asked for, so a
    backpressured request retries only after capacity grew, instead of
    re-walking the radix tree (and churning shared-block refcounts) every
    tick."""

    _MAX_STALLS = 128          # bound on abandoned-rid stall records

    def __init__(self, starvation_bound: int = 8, clock=None):
        self.starvation_bound = starvation_bound
        self.clock = clock if clock is not None else time.perf_counter
        self._queue: list[_QueueEntry] = []
        self._arrivals = 0
        self._stalls: dict[int, tuple[int, int]] = {}

    @property
    def pending(self) -> int:
        return len(self._queue)

    def push(self, req: Request) -> None:
        self._queue.append(_QueueEntry(req, self._arrivals,
                                       enqueue_ts=self.clock()))
        self._arrivals += 1

    def queued(self, req: Request) -> bool:
        """True if ``req`` (by object identity) is queued."""
        return any(e.req is req for e in self._queue)

    def aged(self, e: _QueueEntry) -> bool:
        return e.passed >= self.starvation_bound

    def effective_priority(self, e: _QueueEntry) -> int:
        return e.req.priority + (1 if self.aged(e) else 0)

    def _key(self, e: _QueueEntry):
        if self.aged(e):
            return (-self.effective_priority(e), 0, float(e.arrival),
                    e.arrival)
        dl = e.req.deadline if e.req.deadline is not None else math.inf
        return (-self.effective_priority(e), 1, dl, e.arrival)

    def select(self) -> _QueueEntry | None:
        """The entry the next admission should take (queue unchanged)."""
        return min(self._queue, key=self._key) if self._queue else None

    def commit(self, entry: _QueueEntry) -> None:
        """``entry`` was admitted: remove it and age everyone it passed."""
        self._queue.remove(entry)
        self.age_all()

    def age_all(self) -> None:
        """An admission went to someone not in the queue: every waiting
        entry was passed over once (direct ``submit()`` admissions call
        this too, so the starvation bound holds engine-wide)."""
        for e in self._queue:
            e.passed += 1

    def remove(self, req: Request) -> bool:
        """Drop a queued request by object identity (cancellation, or a
        direct admission claiming its own stale entry)."""
        for e in self._queue:
            if e.req is req:
                self._queue.remove(e)
                return True
        return False

    def drop(self, entry: _QueueEntry) -> None:
        """Evict one entry without aging anyone (no admission happened)."""
        self._queue.remove(entry)

    # --- head-of-line stall bookkeeping ---------------------------------
    def stalled(self, rid: int, capacity: int, need: int) -> bool:
        """True while ``rid``'s last reservation failure still stands: the
        retry wants at least as much as the failed attempt and capacity
        has not grown past what it failed at."""
        rec = self._stalls.get(rid)
        return rec is not None and need >= rec[1] and capacity <= rec[0]

    def note_stall(self, rid: int, capacity: int, need: int) -> None:
        self._stalls[rid] = (capacity, need)
        while len(self._stalls) > self._MAX_STALLS:
            self._stalls.pop(next(iter(self._stalls)))

    def clear_stall(self, rid: int | None = None) -> None:
        if rid is None:
            self._stalls.clear()
        else:
            self._stalls.pop(rid, None)


@dataclass(eq=False)
class _ChunkedPrefill:
    """A staged admission in flight: its reserved slot and staged 1-row
    cache (long chunked prompts, warm prefix-cache hits, and lone cold
    recurrent admissions that capture a mid-prompt state snapshot)."""
    req: Request
    slot: int
    staging: list           # dense (1, stage_len) cache tree
    consumed: int = 0       # prompt tokens already prefilled (or reused)
    capture_at: int | None = None   # grid boundary to snapshot state at
    captured: object | None = None  # the snapshot, once captured
    scatter_table: object | None = None  # COW redirect for the final scatter


@dataclass
class EngineMetrics:
    """Wall-clock and token accounting split by phase: the value type
    (``Engine.metrics`` is an :class:`EngineMetricsView` over the
    engine's registry; ``snapshot()``/``since()`` return this)."""
    prefill_s: float = 0.0
    decode_s: float = 0.0
    prefill_tokens: int = 0      # prompt tokens pushed through prefill
    decode_tokens: int = 0       # tokens emitted by decode ticks
    prefill_calls: int = 0       # prefill calls (bucket or chunk)
    prefill_chunks: int = 0      # chunked-admission pieces among those
    ticks: int = 0               # decode ticks (plain or speculative)
    occupancy_sum: int = 0       # sum over ticks of active slots
    prefix_hits: int = 0         # admissions seeded from the prefix cache
    prefix_tokens_reused: int = 0   # prompt tokens NOT re-prefilled
    cache_evictions: int = 0     # prefix-cache nodes evicted (LRU)
    cancelled: int = 0           # requests cancelled mid-lifecycle
    preemptions: int = 0         # active requests kicked back to the queue
    deadline_hits: int = 0       # first token on or before req.deadline
    deadline_misses: int = 0     # first token after req.deadline
    spec_ticks: int = 0          # speculative draft->verify ticks run
    spec_drafted: int = 0        # draft tokens proposed across spec ticks
    spec_accepted: int = 0       # draft tokens the verifier accepted
    spec_rejected: int = 0       # draft tokens the verifier rejected

    def since(self, start: "EngineMetrics") -> "EngineMetrics":
        return EngineMetrics(**{
            f.name: getattr(self, f.name) - getattr(start, f.name)
            for f in fields(self)})

    def snapshot(self) -> "EngineMetrics":
        return EngineMetrics(**{f.name: getattr(self, f.name)
                                for f in fields(self)})

    def summary(self, max_batch: int) -> dict:
        return {
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "prefill_calls": self.prefill_calls,
            "prefill_chunks": self.prefill_chunks,
            "ticks": self.ticks,
            # 0.0 when no tokens moved (0 / near-zero wall is no rate)
            "prefill_tok_s": (self.prefill_tokens / max(self.prefill_s, 1e-9)
                              if self.prefill_tokens else 0.0),
            "decode_tok_s": (self.decode_tokens / max(self.decode_s, 1e-9)
                             if self.decode_tokens else 0.0),
            "occupancy": (self.occupancy_sum / (self.ticks * max_batch)
                          if self.ticks else 0.0),
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "cache_evictions": self.cache_evictions,
            "cancelled": self.cancelled,
            "preemptions": self.preemptions,
            "deadline_hits": self.deadline_hits,
            "deadline_misses": self.deadline_misses,
            "spec_ticks": self.spec_ticks,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_rejected": self.spec_rejected,
            "spec_acceptance": (self.spec_accepted / self.spec_drafted
                                if self.spec_drafted else 0.0),
        }


#: EngineMetrics field -> (registry metric name, help), as in JAX
_ENGINE_COUNTERS = {
    "prefill_s": ("engine_prefill_seconds_total",
                  "wall seconds inside prefill jit calls"),
    "decode_s": ("engine_decode_seconds_total",
                 "wall seconds inside decode jit calls"),
    "prefill_tokens": ("engine_prefill_tokens_total",
                       "prompt tokens pushed through prefill"),
    "decode_tokens": ("engine_decode_tokens_total",
                      "tokens emitted by decode ticks"),
    "prefill_calls": ("engine_prefill_calls_total",
                      "jit prefill invocations (bucket or chunk)"),
    "prefill_chunks": ("engine_prefill_chunks_total",
                       "chunked-admission prefill pieces"),
    "ticks": ("engine_ticks_total", "engine ticks run"),
    "occupancy_sum": ("engine_occupancy_slots_total",
                      "sum over ticks of active slots"),
    "prefix_hits": ("engine_prefix_hits_total",
                    "admissions seeded from the prefix cache"),
    "prefix_tokens_reused": ("engine_prefix_tokens_reused_total",
                             "prompt tokens not re-prefilled"),
    "cache_evictions": ("engine_prefix_cache_evictions_total",
                        "prefix-cache nodes evicted (LRU)"),
    "cancelled": ("engine_requests_cancelled_total",
                  "requests cancelled mid-lifecycle"),
    "preemptions": ("engine_preemptions_total",
                    "active requests kicked back to the queue"),
    "deadline_hits": ("engine_deadline_hits_total",
                      "first token on or before the request deadline"),
    "deadline_misses": ("engine_deadline_misses_total",
                        "first token after the request deadline"),
    "spec_ticks": ("engine_spec_ticks_total",
                   "speculative draft->verify ticks run"),
    "spec_drafted": ("engine_spec_drafted_tokens_total",
                     "draft tokens proposed across speculative ticks"),
    "spec_accepted": ("engine_spec_accepted_tokens_total",
                      "draft tokens the verifier accepted"),
    "spec_rejected": ("engine_spec_rejected_tokens_total",
                      "draft tokens the verifier rejected"),
}


class EngineMetricsView:
    """Live :class:`EngineMetrics` facade over a metrics registry:
    attribute reads return the registry counter's value and writes set it
    (``engine.metrics.ticks += 1`` works), so the registry is the single
    source of truth.  ``snapshot()`` materializes an
    :class:`EngineMetrics`; ``since()``/``summary()`` delegate to it."""

    __slots__ = ("_counters",)

    def __init__(self, registry):
        object.__setattr__(self, "_counters", {
            f: registry.counter(name, help)
            for f, (name, help) in _ENGINE_COUNTERS.items()})

    def __getattr__(self, name):
        try:
            c = object.__getattribute__(self, "_counters")[name]
        except KeyError:
            raise AttributeError(name) from None
        return c.value()

    def __setattr__(self, name, value):
        counters = object.__getattribute__(self, "_counters")
        if name not in counters:
            raise AttributeError(
                f"EngineMetricsView has no metric field {name!r}")
        counters[name].set(value)

    def snapshot(self) -> EngineMetrics:
        return EngineMetrics(**{f.name: getattr(self, f.name)
                                for f in fields(EngineMetrics)})

    def since(self, start: EngineMetrics) -> EngineMetrics:
        return self.snapshot().since(start)

    def summary(self, max_batch: int) -> dict:
        return self.snapshot().summary(max_batch)


class Engine:
    def __init__(self, cfg, params, config: EngineConfig | None = None, *,
                 device=None, clock=None):
        """``params``: the model (``TransformerLM``, ``SSMLM`` or
        ``HybridLM``) holding the full-precision weights.  ``device``:
        the card unless ``"cpu"``
        (the model must already live there).  ``clock``: the engine's
        single time base, a zero-argument callable returning monotonic
        seconds (default ``time.perf_counter``); a virtual clock makes
        latency and deadline accounting deterministic."""
        if config is None:
            config = EngineConfig()
        config.validate(cfg.family)
        if config.quant is not None and cfg.quant.mode != "bf16":
            raise ValueError(
                f"EngineConfig(quant={config.quant!r}) freezes decode "
                f"weights to 4-bit; combining it with model-level "
                f"quant mode {cfg.quant.mode!r} would quantize twice — "
                "pick one")
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"model lives on {params.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.config = config
        self.max_batch = config.max_batch
        self.max_seq = config.max_seq
        self.sampling = config.sampling or SamplingConfig()
        self.prefill_bucket = config.prefill_bucket
        self.prefill_chunk = config.prefill_chunk
        self.backend = make_backend(params, cfg.family, config)
        self.caches = self.backend.caches
        # the full-precision model itself under quant=None; a model over
        # frozen 4-bit projections otherwise.  Prefill uses self.params.
        with torch.inference_mode():
            self.decode_params = self.backend.prepare_decode_params(
                params, config.quant)
        self.prefix_cache = None
        if config.prefix_cache:
            self.prefix_cache = PrefixCache(
                max_nodes=config.prefix_cache_nodes,
                **self.backend.prefix_cache_kwargs())
            # recurrent snapshots are captured on this boundary grid;
            # paged payloads must land on whole blocks
            self._capture_grid = self.backend.capture_grid(
                config.prefill_bucket)
        self._evictions_seen = 0
        self.positions = np.zeros(config.max_batch, np.int64)
        self.active: dict[int, Request] = {}
        self.slots: list[Request | None] = [None] * config.max_batch
        self._chunked: list[_ChunkedPrefill] = []
        self._admitting = False        # _admit in flight (emit window)
        self._callbacks: dict[Request, list] = {}
        self._streams: dict[Request, list[queue.SimpleQueue]] = {}
        self.clock = clock if clock is not None else time.perf_counter
        # ONE re-entrant lock guards scheduler + slot + backend state:
        # every public mutator and the whole tick run under it
        self._lock = threading.RLock()
        self.backend.bind_lock(self._lock)
        self._loop_thread: threading.Thread | None = None
        self._loop_stop = threading.Event()
        self._loop_wake = threading.Event()
        self._drain_on_stop = True
        self.scheduler = Scheduler(config.starvation_bound, clock=self.clock)
        # observability: one registry per engine is the source of truth
        # for every counter (self.metrics is a live view over it); the
        # tracer shares self.clock
        self.registry = MetricsRegistry()
        self.metrics = EngineMetricsView(self.registry)
        self.tracer = Tracer(clock=self.clock, capacity=config.trace_buffer,
                             enabled=config.trace)
        self._obs_init(cfg.family, config)
        # speculative decoding: the proposer drafts, _verify scores the
        # whole (B, spec_k + 1) window at the decode precision in one
        # call, _spec_commit re-runs a partial-accept window on recurrent
        # state, _draft is self-speculation's step over the nf4p model
        self._spec = None
        if config.spec is not None:
            from repro_torch.core.quant import (SPEC_DRAFT_QUANT,
                                                quantize_draft_params)
            from repro_torch.serve.spec import make_proposer
            if config.spec == "self_lut":
                if config.quant == SPEC_DRAFT_QUANT:
                    self.draft_params = self.decode_params
                else:
                    with torch.inference_mode():
                        self.draft_params = type(params).from_params(
                            cfg, quantize_draft_params(params.params_tree()),
                            device=self.device)
            self._spec = make_proposer(config.spec, self)

    # --- observability ---------------------------------------------------
    def _obs_init(self, family: str, config: EngineConfig):
        """Register the latency histograms, lifecycle counters, level
        gauges and the static ``engine_info`` series (JAX's set)."""
        reg = self.registry
        self._h_ttft = reg.histogram(
            "engine_ttft_seconds",
            "time from submit to first emitted token",
            ("priority",), buckets=TTFT_BUCKETS)
        self._h_itl = reg.histogram(
            "engine_itl_seconds",
            "latency between consecutive emitted tokens",
            ("priority",), buckets=ITL_BUCKETS)
        self._h_phase = reg.histogram(
            "engine_tick_phase_seconds",
            "wall seconds per engine phase per tick",
            ("phase",), buckets=PHASE_BUCKETS)
        self._h_spec_window = reg.histogram(
            "engine_spec_accepted_per_window",
            "accepted draft tokens per speculative verify window",
            ("proposer",), buckets=SPEC_WINDOW_BUCKETS)
        self._h_spec_request = reg.histogram(
            "engine_spec_tokens_per_request",
            "accepted/rejected draft tokens per retired request",
            ("kind",), buckets=SPEC_REQUEST_BUCKETS)
        self._c_submitted = reg.counter(
            "engine_requests_submitted_total",
            "requests submitted (first submission only)", ("priority",))
        self._c_finished = reg.counter(
            "engine_requests_finished_total",
            "requests retired (completed or cancelled)")
        self._c_prefix_lookups = reg.counter(
            "engine_prefix_lookups_total",
            "prefix-cache lookups by result", ("result",))
        self._g_queue = reg.gauge(
            "engine_queue_depth", "requests queued on the scheduler")
        self._g_active = reg.gauge(
            "engine_active_slots", "slots actively decoding")
        self._g_staged = reg.gauge(
            "engine_staged_admissions",
            "staged (chunked / warm-prefix) admissions in flight")
        self._g_free = reg.gauge(
            "engine_pool_free_capacity",
            "backend free capacity (dense: slots; paged: blocks)")
        reg.gauge(
            "engine_info",
            "static engine identity (value is always 1)",
            ("family", "quant", "paged", "spec"),
        ).set(1, family=family, quant=config.quant or "bf16",
              paged=str(bool(config.paged)).lower(),
              spec=config.spec or "off")
        self._update_gauges()

    def _update_gauges(self):
        """Refresh the level gauges (at every queue/slot/pool transition,
        under the engine lock)."""
        self._g_queue.set(self.scheduler.pending)
        self._g_active.set(len(self.active))
        self._g_staged.set(len(self._chunked))
        self._g_free.set(self.backend.free_capacity)

    def _note_submit(self, req: Request):
        """Once-only submit accounting, stamped at ``req.submit_ts``."""
        if not req._submit_seen:
            req._submit_seen = True
            self._c_submitted.add(priority=str(req.priority))
            self.tracer.event("submit", rid=req.rid, ts=req.submit_ts,
                              priority=req.priority)

    # --- substrate views ------------------------------------------------
    @property
    def paged(self) -> bool:
        return self.backend.paged

    @property
    def allocator(self):
        return getattr(self.backend, "allocator", None)

    @property
    def block_tables(self):
        return getattr(self.backend, "block_tables", None)

    @property
    def idle(self) -> bool:
        """Nothing queued, staged or decoding."""
        return not (self.active or self._chunked or self.scheduler.pending)

    def _sync(self):
        """Wait for the card (honest wall-clock intervals)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- speculative decoding's device bodies ---------------------------
    def _verify(self, params, tokens, caches, positions, tables, n_valid,
                last_pos):
        """Speculative verify: score the whole (B, W) window in one call;
        ``argmax(logits[:, i])`` is the greedy token after column ``i``
        (the same reduction the plain tick applies to its 1-wide logits).
        Returns (tokens (B, W) on the host, caches)."""
        logits, caches = params.decode_window(
            tokens, caches, positions, tables=tables, n_valid=n_valid,
            last_pos=last_pos)
        return torch.argmax(logits, dim=-1).cpu().numpy(), caches

    def _spec_commit(self, params, tokens, caches, positions, tables,
                     n_valid, last_pos):
        """Partial-accept commit on recurrent state: re-run the same
        window from the pre-verify caches with the scan masked at the
        accept boundary (``last_pos`` = accepted count, -1 for inactive
        rows).  Logits are discarded."""
        _, caches = params.decode_window(
            tokens, caches, positions, tables=tables, n_valid=n_valid,
            last_pos=last_pos)
        return caches

    def _draft(self, params, tokens, caches, positions, tables):
        """One greedy self-speculation step over the draft model."""
        logits, caches = params.decode_step(tokens, caches, positions,
                                            tables=tables)
        return torch.argmax(logits[:, 0], dim=-1), caches

    # --- admission ------------------------------------------------------
    def _validate(self, req: Request):
        if req.max_new < 1:
            raise ValueError(
                f"request {req.rid}: max_new must be >= 1 (prefill always "
                f"samples one token), got {req.max_new}")
        if not (0 < len(req.prompt) <= self.max_seq - 1):
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} not in "
                f"[1, max_seq-1={self.max_seq - 1}]")
        self.backend.validate_request(req.rid, len(req.prompt), req.max_new)

    def _check_rid_free(self, req: Request):
        """Rids must be unique among live requests (the active dict, the
        sampling streams and the metrics key on them)."""
        if req.rid in self.active or \
                any(cp.req.rid == req.rid for cp in self._chunked):
            raise ValueError(
                f"rid {req.rid} is already in flight for a different "
                "request — rids must be unique among live requests")

    def _reserve(self, req: Request, slot: int, hit=None) -> bool:
        """Claim the request's lifetime substrate capacity up front (paged:
        its block budget; a prefix hit's shared blocks are ref'd
        copy-on-write and only the tail is allocated).  False =
        backpressure; dense substrates always succeed."""
        shared = list(hit.blocks) if hit is not None else None
        return self.backend.reserve(slot, len(req.prompt), req.max_new,
                                    shared, on_short=self._on_pool_short)

    def _on_pool_short(self, need: int):
        """Pool pressure: let the prefix cache evict LRU unreferenced nodes
        before the reservation backpressures."""
        if self.prefix_cache is not None:
            self.prefix_cache.evict_for(need)
            self._note_evictions()

    def _note_evictions(self):
        """Fold the prefix cache's lifetime eviction count into the
        engine's metrics."""
        if self.prefix_cache is not None:
            d = self.prefix_cache.evictions - self._evictions_seen
            self._evictions_seen = self.prefix_cache.evictions
            self.metrics.cache_evictions += d

    def _free_slot(self, slot: int):
        self.slots[slot] = None
        self.positions[slot] = 0
        self.backend.free_slot(slot)

    def _chunkable(self, prompt_len: int) -> bool:
        return (self.prefill_chunk is not None
                and prompt_len > self.prefill_chunk)

    def _bucket_len(self, n: int) -> int:
        return min(ceil_div(n, self.prefill_bucket) * self.prefill_bucket,
                   self.max_seq)

    # --- token emission / retirement ------------------------------------
    def _emit(self, req: Request, tok: int):
        """Append one generated token: output list, latency stamp,
        deadline accounting, stream queues and callbacks all fan out from
        here."""
        req.out.append(tok)
        ts = self.clock()
        req.token_ts.append(ts)
        if len(req.out) == 1:
            if req.submit_ts is not None:
                self._h_ttft.observe(ts - req.submit_ts,
                                     priority=str(req.priority))
            self.tracer.event("first_token", rid=req.rid, ts=ts)
            if req.deadline is not None:
                if ts > req.deadline:
                    self.metrics.deadline_misses += 1
                else:
                    self.metrics.deadline_hits += 1
        else:
            self._h_itl.observe(ts - req.token_ts[-2],
                                priority=str(req.priority))
            self.tracer.event("token", rid=req.rid, ts=ts)
        for q in self._streams.get(req, ()):
            q.put(tok)
        for cb in tuple(self._callbacks.get(req, ())):
            cb(tok)

    def _retire(self, req: Request):
        if not req.done:
            # a request cancelled mid-admission is retired by cancel() and
            # again by the admission path: finish accounting runs once
            self.tracer.event("finish", rid=req.rid, tokens=len(req.out),
                              cancelled=req.cancelled)
            self._c_finished.add()
            if self._spec is not None:
                self._h_spec_request.observe(float(req._spec_accepted),
                                             kind="accepted")
                self._h_spec_request.observe(float(req._spec_rejected),
                                             kind="rejected")
        req.done = True
        self._callbacks.pop(req, None)
        for q in self._streams.pop(req, ()):
            q.put(_STREAM_DONE)

    def _subscribe(self, req: Request) -> queue.SimpleQueue:
        """A token stream over ``req``: a fresh queue preloaded (under the
        lock) with everything already emitted, then fed by ``_emit`` and
        closed by ``_retire``: no token is missed or duplicated."""
        with self._lock:
            q = queue.SimpleQueue()
            for tok in req.out:
                q.put(tok)
            if req.done:
                q.put(_STREAM_DONE)
            else:
                self._streams.setdefault(req, []).append(q)
            return q

    # --- public API -----------------------------------------------------
    def submit(self, req: Request, *, on_token=None) -> RequestHandle:
        """Submit one request; thread-safe.  The handle is truthy iff the
        request was admitted at once.  On backpressure: with the loop
        running the request is queued on the scheduler (the falsy handle
        still streams); without it, it is not queued.  ``on_token`` fires
        synchronously for every emitted token."""
        with self._lock:
            self._validate(req)
            if req.submit_ts is None:
                req.submit_ts = self.clock()
            self._note_submit(req)
            handle = RequestHandle(self, req, on_token=on_token)
            if self.running:
                # loop mode: the callback lives for the whole queued
                # lifetime, and backpressure queues instead of dropping
                if on_token is not None:
                    cbs = self._callbacks.setdefault(req, [])
                    if on_token not in cbs:
                        cbs.append(on_token)
                handle._admitted = self._try_admit(req)
                if not handle._admitted and not req.done \
                        and not self.scheduler.queued(req):
                    self.scheduler.push(req)
                    self.tracer.event("queue", rid=req.rid)
            else:
                handle._admitted = self._admit_handle(handle)
            self._update_gauges()
        self._loop_wake.set()
        return handle

    def _admit_handle(self, handle: RequestHandle) -> bool:
        """Admission attempt for a handle: its callback is registered
        before the attempt (the prefill emits the first token) and
        unregistered on failure, so an abandoned falsy handle leaks
        nothing."""
        with self._lock:
            req, cb = handle.req, handle._on_token
            if req.done:
                return False
            if cb is not None:
                cbs = self._callbacks.setdefault(req, [])
                if cb not in cbs:         # idempotent across retries
                    cbs.append(cb)
            admitted = self._try_admit(req)
            if not admitted and cb is not None:
                cbs = self._callbacks.get(req, [])
                if cb in cbs:
                    cbs.remove(cb)
                if not cbs:
                    self._callbacks.pop(req, None)
            return admitted

    @torch.inference_mode()
    def _try_admit(self, req: Request) -> bool:
        """One direct admission attempt, sharing the scheduler's state:
        the stall gate, no leapfrogging of queued work of equal or higher
        effective priority, aging the queue on success, and claiming the
        request's own stale queue entry."""
        if req.done:
            return False
        if self.active.get(req.rid) is req or \
                any(cp.req is req for cp in self._chunked):
            return True                       # already admitted
        self._check_rid_free(req)
        if self._admitting:
            # re-entrant submit from an on_token callback mid-admission:
            # the in-flight slot is not recorded yet and must not be stolen
            return False
        free = [s for s, r in enumerate(self.slots) if r is None]
        if not free:
            return False
        head = self.scheduler.select()
        if head is not None and head.req is not req and \
                self.scheduler.effective_priority(head) >= req.priority:
            return False
        need = self.backend.reservation_need(len(req.prompt), req.max_new)
        if self.scheduler.stalled(req.rid, self.backend.free_capacity,
                                  need):
            return False
        hit = self._match_prefix(req)
        if not self._reserve(req, free[0], hit):
            self.scheduler.note_stall(req.rid, self.backend.free_capacity,
                                      need)
            return False
        self.scheduler.clear_stall(req.rid)
        self.scheduler.remove(req)            # claim our own stale entry
        self.scheduler.age_all()
        if self._route_staged(req, hit):
            self._start_staged(req, free[0], hit)
        else:
            self._admit([req], free[:1])
        return True

    def cancel(self, req: Request) -> bool:
        """Cancel wherever the request is: drop it from the queue, abort a
        staged admission (staged rows dropped, reserved blocks, shared
        prefix refs included, released), or stop an active decode and
        free its slot.  A request found nowhere (mid-admission emit, or
        never admitted) is marked done and the admission path releases
        its slot.  False if it had already finished.  Safe from any
        thread."""
        with self._lock:
            if req.done:
                return False
            if self.scheduler.remove(req):
                self._finish_cancel(req)
                return True
            for cp in self._chunked:
                if cp.req is req:
                    self._chunked.remove(cp)
                    self._free_slot(cp.slot)
                    self._finish_cancel(req)
                    return True
            if self.active.get(req.rid) is req:
                del self.active[req.rid]
                for s, r in enumerate(self.slots):
                    if r is req:
                        self._free_slot(s)
                        break
                self._finish_cancel(req)
                return True
            self._finish_cancel(req)
            return True

    def preempt(self, req: Request) -> bool:
        """Kick an ACTIVE request off its slot and requeue it: the slot
        and its reservation are released as :meth:`cancel` releases them,
        the tokens emitted so far are folded into the prompt, and its
        re-admission re-prefills the extended prompt (greedy continues
        token for token, up to the rounding of prefill against decode).
        False if the request is not decoding or the extended prompt would
        not fit ``max_seq``."""
        with self._lock:
            if req.done or self.active.get(req.rid) is not req:
                return False
            if len(req.prompt) + len(req.out) > self.max_seq - 1:
                return False
            del self.active[req.rid]
            for s, r in enumerate(self.slots):
                if r is req:
                    self._free_slot(s)
                    break
            self.scheduler.clear_stall(req.rid)
            req.prompt = list(req.prompt) + list(req.out)
            self.scheduler.push(req)
            self.metrics.preemptions += 1
            self.tracer.event("preempt", rid=req.rid)
            self.tracer.event("queue", rid=req.rid)
            self._update_gauges()
        self._loop_wake.set()
        return True

    def _finish_cancel(self, req: Request):
        req.cancelled = True
        self.scheduler.clear_stall(req.rid)
        self.tracer.event("cancel", rid=req.rid)
        self._retire(req)
        self.metrics.cancelled += 1
        self._update_gauges()

    def _admit(self, reqs: list[Request], slots: list[int]):
        """Prefill ``reqs`` into ``slots`` (validated and reserved by the
        caller), with the emit window flagged."""
        assert len(reqs) == len(slots)
        for r, s in zip(reqs, slots):
            self.tracer.event("admit", rid=r.rid, slot=s, staged=False)
        prev_admitting = self._admitting
        self._admitting = True
        try:
            self._admit_buckets(reqs, slots)
        finally:
            self._admitting = prev_admitting

    def _admit_pending(self):
        """Admit queued requests into free slots, highest effective
        priority first.  Cold same-tick admissions share the bucketed
        prefill calls; a failed reservation stalls admission (head of
        line) until capacity grows."""
        free = [s for s, r in enumerate(self.slots) if r is None]
        batch: list[Request] = []
        batch_slots: list[int] = []
        while self.scheduler.pending and free:
            entry = self.scheduler.select()
            req = entry.req
            need = self.backend.reservation_need(len(req.prompt),
                                                 req.max_new)
            if self.scheduler.stalled(req.rid, self.backend.free_capacity,
                                      need):
                break
            try:
                self._validate(req)
                self._check_rid_free(req)
                if any(b.rid == req.rid for b in batch):
                    raise ValueError(
                        f"rid {req.rid} queued twice in one admission "
                        "tick — rids must be unique among live requests")
            except ValueError:
                # evict the poison entry, flush the requests already
                # committed this tick (their capacity is reserved), then
                # surface the error once
                self.scheduler.drop(entry)
                self._retire(req)
                if batch:
                    self._admit(batch, batch_slots)
                raise
            hit = self._match_prefix(req)
            if not self._reserve(req, free[0], hit):
                self.scheduler.note_stall(req.rid,
                                          self.backend.free_capacity, need)
                break          # head-of-line: wait for capacity to free
            self.scheduler.clear_stall(req.rid)
            self.scheduler.commit(entry)
            slot = free.pop(0)
            lone = not batch and not self.scheduler.pending
            if self._route_staged(req, hit, lone):
                self._start_staged(req, slot, hit)
            else:
                batch.append(req)
                batch_slots.append(slot)
        if batch:
            self._admit(batch, batch_slots)

    @torch.inference_mode()
    def _admit_buckets(self, reqs: list[Request], slots: list[int]):
        """One prefill per length bucket: prompts right-padded with 0 to
        the bucket length, logits read at each row's ``last_pos``, the
        rows scattered into the substrate (dense rows at their slots, pool
        blocks through the slots' tables)."""
        buckets: dict[int, list[int]] = {}
        for i, r in enumerate(reqs):
            buckets.setdefault(self._bucket_len(len(r.prompt)), []).append(i)
        for blen, idxs in buckets.items():
            k = len(idxs)
            toks = np.zeros((k, blen), np.int64)
            last = np.zeros(k, np.int64)
            for j, i in enumerate(idxs):
                p = reqs[i].prompt
                toks[j, :len(p)] = p
                last[j] = len(p) - 1
            bucket_slots = [slots[i] for i in idxs]
            slot_ids = torch.as_tensor(bucket_slots, device=self.device)
            tables = self.backend.admission_tables(bucket_slots)
            t0 = self.clock()
            logits, rows = self.params.prefill(
                torch.as_tensor(toks, device=self.device),
                self.backend.fresh(k),
                last_pos=torch.as_tensor(last, device=self.device))
            self.caches = self.backend.scatter(self.caches, rows, slot_ids,
                                               tables)
            nxt = sample(logits[:, 0], self.sampling, seed=self.config.seed,
                         rids=[reqs[i].rid for i in idxs], steps=[0] * k)
            nxt = nxt.cpu().numpy()       # sync for honest wall-clock
            dt = self.clock() - t0
            self.metrics.prefill_s += dt
            self.metrics.prefill_calls += 1
            self._h_phase.observe(dt, phase="prefill")
            self.tracer.event("prefill", ts=t0, dur=dt, batch=k)
            for j, i in enumerate(idxs):
                req, slot = reqs[i], slots[i]
                self._emit(req, int(nxt[j]))
                self.metrics.prefill_tokens += len(req.prompt)
                self._prefix_insert_from_slot(req, slot)
                if req.done or len(req.out) >= req.max_new:
                    # max_new=1 (done at admission), or an on_token
                    # callback cancelled the request mid-emit
                    self._retire(req)
                    self.backend.free_slot(slot)
                    continue
                self.positions[slot] = len(req.prompt)
                self.slots[slot] = req
                self.active[req.rid] = req

    # --- prefix cache ---------------------------------------------------
    def _match_prefix(self, req: Request):
        """Longest cached prefix usable for this admission (None = cold).
        At least one tail token must still run through prefill to produce
        the last-position logits, hence the ``len - 1`` cap."""
        if self.prefix_cache is None:
            return None
        hit = self.prefix_cache.match(req.prompt,
                                      max_len=len(req.prompt) - 1,
                                      need_state=self.backend.needs_state)
        self._c_prefix_lookups.add(
            result="hit" if hit is not None else "miss")
        return hit

    def _capture_boundary(self, prompt_len: int) -> int:
        """Grid boundary to snapshot recurrent state at (0 = none)."""
        return (prompt_len // self._capture_grid) * self._capture_grid

    def _route_staged(self, req: Request, hit, lone: bool = True) -> bool:
        """True when the admission must ride the staged path: chunked long
        prompts, every warm hit (the staging row is seeded from the
        cache), and LONE cold recurrent admissions that want a mid-prompt
        state snapshot (the prefill is split at the grid boundary to
        capture it).  ``lone=False`` (other cold requests are admitted
        this tick) keeps cold recurrent prompts on the batched bucket
        path."""
        if hit is not None or self._chunkable(len(req.prompt)):
            return True
        if not lone or self.prefix_cache is None \
                or not self.backend.needs_state:
            return False
        cap = self._capture_boundary(len(req.prompt))
        return 0 < cap < len(req.prompt)

    def _seed_staging(self, hit):
        """The warm admission's staging row: the shared blocks' KV gathered
        into the dense staging leaves, and the recurrent snapshot copied
        in.  The tail prefill then continues at ``hit.length`` as if the
        first chunks had just run."""
        if hit.blocks:
            tbl = torch.as_tensor(self.backend.staging_table(hit.blocks),
                                  device=self.device)
            staging = self.backend.gather_staging(self.caches, tbl)
        else:
            staging = self.backend.fresh(1)
        if hit.state is not None:
            staging = self.backend.seed_snapshot(staging, hit.state)
        return staging

    def _insert_boundary(self, prompt: list[int], slot: int, state):
        """Cache one finished-prefill boundary through the backend's
        storage policy (ssm: a state snapshot; attention: whole pool
        blocks)."""
        payload = self.backend.prefix_payload(prompt, slot, state)
        if payload is None:
            return
        tokens, blocks, state = payload
        self.prefix_cache.insert(tokens, blocks=blocks, state=state)

    def _prefix_insert_from_slot(self, req: Request, slot: int):
        """Cold batched admission: cache the freshly prefilled prefix (the
        state, where the substrate carries one, copied from the slot's
        row at the full prompt boundary)."""
        if self.prefix_cache is None:
            return
        state = self.backend.snapshot(self.caches, slot)
        self._insert_boundary(req.prompt, slot, state)
        self._note_evictions()

    def _finish_prefix_insert(self, cp: _ChunkedPrefill, staged_out):
        """Staged admission done: insert the mid-prompt capture (if one was
        taken) and the full-prompt boundary into the radix tree."""
        if self.prefix_cache is None:
            return
        req, slot = cp.req, cp.slot
        if cp.captured is not None:
            self._insert_boundary(req.prompt[:cp.capture_at], slot,
                                  cp.captured)
        state = self.backend.snapshot(staged_out, 0)
        self._insert_boundary(req.prompt, slot, state)
        self._note_evictions()

    # --- staged (chunked / warm-prefix) prefill -------------------------
    def _start_staged(self, req: Request, slot: int, hit=None):
        """Reserve ``slot`` for a staged admission.  The prompt is fed to a
        staged 1-row cache (one chunk a tick under ``prefill_chunk``,
        at once otherwise) and the request joins decode once the last
        piece lands.  A prefix ``hit`` seeds the staging row and skips the
        first ``hit.length`` prompt tokens; the final scatter of a warm
        paged admission redirects the shared-block range to the garbage
        block, so a shared block is never written (copy-on-write)."""
        self.slots[slot] = req
        self.positions[slot] = 0
        consumed, scatter_table = 0, None
        with torch.inference_mode():
            if hit is not None:
                staging = self._seed_staging(hit)
                consumed = hit.length
                scatter_table = self.backend.cow_table(slot, len(hit.blocks))
                self.metrics.prefix_hits += 1
                self.metrics.prefix_tokens_reused += consumed
            else:
                staging = self.backend.fresh(1)
        self.tracer.event("admit", rid=req.rid, slot=slot, staged=True,
                          reused=consumed)
        cap = None
        if self.prefix_cache is not None and self.backend.needs_state:
            c = self._capture_boundary(len(req.prompt))
            if consumed < c < len(req.prompt):
                cap = c
        cp = _ChunkedPrefill(req, slot, staging, consumed, capture_at=cap,
                             scatter_table=scatter_table)
        self._chunked.append(cp)
        if self.prefill_chunk is None:
            # no chunked scheduling: drive the staged admission to
            # completion now (cp is the only queue entry: earlier ones all
            # drained the same way)
            while self._chunked and self._chunked[0] is cp:
                self._advance_chunked()

    @torch.inference_mode()
    def _advance_chunked(self):
        """Run AT MOST one prefill piece (FIFO head): this bounds the
        prefill work any decode tick waits on to one chunk.  Pieces are
        cut at the state-capture boundary so the prefix cache can snapshot
        the staged recurrent state mid-prompt."""
        if not self._chunked:
            return
        cp = self._chunked[0]
        req = cp.req
        remaining = len(req.prompt) - cp.consumed
        c = self.prefill_chunk if self.prefill_chunk is not None \
            else remaining
        if cp.capture_at is not None and cp.consumed < cp.capture_at:
            c = min(c, cp.capture_at - cp.consumed)
        t0 = self.clock()
        if remaining > c:
            toks = torch.as_tensor(
                [req.prompt[cp.consumed:cp.consumed + c]], device=self.device)
            _, cp.staging = self.params.prefill(toks, cp.staging,
                                                cache_index=cp.consumed)
            self._sync()                  # honest wall-clock
            cp.consumed += c
            dt = self.clock() - t0
            self.metrics.prefill_s += dt
            self.metrics.prefill_tokens += c
            self.metrics.prefill_calls += 1
            self._h_phase.observe(dt, phase="prefill")
            self.tracer.event("prefill", ts=t0, dur=dt, batch=1)
            if self.prefill_chunk is not None:
                self.metrics.prefill_chunks += 1
                self.tracer.event("prefill_chunk", rid=req.rid, ts=t0,
                                  consumed=cp.consumed)
            if cp.capture_at == cp.consumed:
                cp.captured = self.backend.snapshot(cp.staging, 0)
            return
        # final piece: pad to the bucket grid, sample the request's first
        # token, scatter the staged row into the substrate
        self._chunked.pop(0)
        pl = min(self._bucket_len(remaining),
                 self.backend.stage_len - cp.consumed)
        toks = np.zeros((1, pl), np.int64)
        toks[0, :remaining] = req.prompt[cp.consumed:]
        slot_ids = torch.as_tensor([cp.slot], device=self.device)
        tables = self.backend.finish_tables(cp.slot, cp.scatter_table)
        logits, staged_out = self.params.prefill(
            torch.as_tensor(toks, device=self.device), cp.staging,
            last_pos=torch.as_tensor([remaining - 1], device=self.device),
            cache_index=cp.consumed)
        self.caches = self.backend.scatter(self.caches, staged_out, slot_ids,
                                           tables)
        nxt = sample(logits[:, 0], self.sampling, seed=self.config.seed,
                     rids=[req.rid], steps=[0]).cpu().numpy()
        dt = self.clock() - t0
        self.metrics.prefill_s += dt
        self.metrics.prefill_tokens += remaining
        self.metrics.prefill_calls += 1
        self._h_phase.observe(dt, phase="prefill")
        self.tracer.event("prefill", ts=t0, dur=dt, batch=1)
        if self.prefill_chunk is not None:
            self.metrics.prefill_chunks += 1
            self.tracer.event("prefill_chunk", rid=req.rid, ts=t0,
                              consumed=len(req.prompt))
        self._finish_prefix_insert(cp, staged_out)
        self._emit(req, int(nxt[0]))
        if req.done or len(req.out) >= req.max_new:
            # cap met, or an on_token callback cancelled mid-emit
            self._retire(req)
            self._free_slot(cp.slot)
            return
        self.positions[cp.slot] = len(req.prompt)
        self.active[req.rid] = req

    # --- the tick -------------------------------------------------------
    def step(self):
        """One engine tick under the engine lock: the thread-safe spelling
        of :meth:`_tick` (safe while the background loop runs: ticks
        serialize on the lock)."""
        with self._lock:
            self._tick()

    @torch.inference_mode()
    def _tick(self):
        """Admit queued work into free slots, run at most one chunk of
        staged prefill, then every active slot advances: one speculative
        window, or one token (free and mid-admission rows compute ignored
        garbage: a staged slot's writes are overwritten by its final
        scatter, or parked on the garbage block when paged).  Callers hold
        the engine lock; ``serve()``/``step()`` and the background loop
        drive exactly this body."""
        ta = self.clock()
        self._admit_pending()
        self._advance_chunked()
        dta = self.clock() - ta
        self._h_phase.observe(dta, phase="admit")
        self.tracer.event("admit", ts=ta, dur=dta)
        if not self.active:
            self._update_gauges()
            return
        if self._spec is None or not self._spec_tick():
            self._decode_tick()
        self._update_gauges()

    def _decode_tick(self):
        """All ``max_batch`` rows step one token at their own position;
        the block tables (paged) reach the card once a tick.  Also the
        speculative mode's tick when no row produced a draft."""
        toks = np.zeros((self.max_batch, 1), np.int64)
        rids = [-1] * self.max_batch
        steps = [0] * self.max_batch
        n_active = 0
        for s, req in enumerate(self.slots):
            if req is not None and req.rid in self.active:
                toks[s, 0] = req.out[-1]
                rids[s] = req.rid
                steps[s] = len(req.out)
                n_active += 1
        t0 = self.clock()
        tables = self.backend.decode_tables([cp.slot for cp in
                                             self._chunked])
        logits, self.caches = self.decode_params.decode_step(
            torch.as_tensor(toks, device=self.device), self.caches,
            torch.as_tensor(self.positions, device=self.device),
            tables=tables)
        nxt = sample(logits[:, 0], self.sampling, seed=self.config.seed,
                     rids=rids, steps=steps).cpu().numpy()
        dt = self.clock() - t0
        self.metrics.decode_s += dt
        self.metrics.ticks += 1
        self.metrics.occupancy_sum += n_active
        self.metrics.decode_tokens += n_active
        self._h_phase.observe(dt, phase="decode")
        self.tracer.event("decode", ts=t0, dur=dt, batch=n_active)
        t2 = self.clock()
        for s, req in enumerate(self.slots):
            if req is None or req.rid not in self.active:
                continue
            self._emit(req, int(nxt[s]))
            if req.done:
                # an on_token callback cancelled from inside the emit:
                # cancel() already freed the slot and the active entry
                continue
            self.positions[s] += 1
            if len(req.out) >= req.max_new or \
                    self.positions[s] >= self.max_seq - 1:
                self._retire(req)
                self.active.pop(req.rid, None)
                self._free_slot(s)
        dte = self.clock() - t2
        self._h_phase.observe(dte, phase="emit")
        self.tracer.event("emit", ts=t2, dur=dte)

    def _spec_tick(self) -> bool:
        """One speculative advance: draft -> batched verify -> accept
        prefix -> rollback (:mod:`repro_torch.serve.spec`).  False when no
        row produced a draft: the caller then runs the plain
        :meth:`_decode_tick`.

        ``k_eff`` caps each row's window so the emitted ``accepted + 1``
        tokens never overrun ``max_new`` or write past ``max_seq - 1``.
        Verify runs one ``decode_window`` call against the live caches:
        on attention substrates its in-place writes at the row's window
        are the committed K/V for the accepted prefix and dead weight
        beyond it; recurrent state is returned as new tensors, so the
        live caches stay the pre-verify state, and on a partial accept
        the window is re-run from them with the scan masked at each row's
        accept boundary (full acceptance keeps the verify pass's state)."""
        spec_k = self.config.spec_k
        reqs: list[Request | None] = [None] * self.max_batch
        k_eff = np.zeros(self.max_batch, np.int64)
        for s, req in enumerate(self.slots):
            if req is not None and req.rid in self.active:
                reqs[s] = req
                limit = min(len(req.prompt) + req.max_new, self.max_seq)
                k_eff[s] = max(0, min(
                    spec_k,
                    req.max_new - len(req.out) - 1,
                    limit - 2 - int(self.positions[s])))
        t0 = self.clock()
        drafts = self._spec.propose(reqs, k_eff.tolist())
        total = sum(len(d) for d in drafts)
        dt0 = self.clock() - t0
        self._h_phase.observe(dt0, phase="draft")
        self.tracer.event("draft", ts=t0, dur=dt0, drafted=total)
        if total == 0:
            return False
        self.metrics.spec_drafted += total
        toks = np.zeros((self.max_batch, spec_k + 1), np.int64)
        n_valid = np.zeros(self.max_batch, np.int64)
        n_active = 0
        for s, req in enumerate(reqs):
            if req is None:
                continue
            d = drafts[s]
            toks[s, 0] = req.out[-1]
            toks[s, 1:1 + len(d)] = d
            n_valid[s] = 1 + len(d)
            n_active += 1
        tables = self.backend.decode_tables([cp.slot for cp in
                                             self._chunked])
        dev = self.device
        toks_d = torch.as_tensor(toks, device=dev)
        pos_d = torch.as_tensor(self.positions, device=dev)
        n_valid_d = torch.as_tensor(n_valid, device=dev)
        pre = self.caches
        t1 = self.clock()
        tgt, post = self._verify(self.decode_params, toks_d, pre, pos_d,
                                 tables, n_valid_d, n_valid_d - 1)
        dt1 = self.clock() - t1
        self.metrics.decode_s += dt1
        self.metrics.ticks += 1
        self.metrics.spec_ticks += 1
        self.metrics.occupancy_sum += n_active
        self._h_phase.observe(dt1, phase="verify")
        self.tracer.event("verify", ts=t1, dur=dt1, batch=n_active)
        accepts = np.zeros(self.max_batch, np.int64)
        partial = False
        for s, req in enumerate(reqs):
            if req is not None:
                accepts[s] = accept_length(drafts[s], tgt[s])
                partial = partial or accepts[s] < len(drafts[s])
        if self.backend.needs_state and partial:
            commit_last = np.where(n_valid > 0, accepts, -1)
            t2 = self.clock()
            self.caches = self._spec_commit(
                self.decode_params, toks_d, pre, pos_d, tables, n_valid_d,
                torch.as_tensor(commit_last, device=dev))
            self._sync()
            dt2 = self.clock() - t2
            self.metrics.decode_s += dt2
            self._h_phase.observe(dt2, phase="verify")
            self.tracer.event("verify", ts=t2, dur=dt2, batch=n_active,
                              commit=True)
        else:
            self.caches = post
        t3 = self.clock()
        emitted_total = 0
        for s, req in enumerate(reqs):
            if req is None or req.done or self.slots[s] is not req or \
                    req.rid not in self.active:
                continue   # a callback on an earlier row tore this one down
            m = int(accepts[s])
            rejected = len(drafts[s]) - m
            req._spec_accepted += m
            req._spec_rejected += rejected
            self.metrics.spec_accepted += m
            self.metrics.spec_rejected += rejected
            self._h_spec_window.observe(float(m), proposer=self._spec.name)
            for i in range(m + 1):
                self._emit(req, int(tgt[s, i]))
                emitted_total += 1
                if req.done or self.slots[s] is not req:
                    # an on_token callback cancelled/preempted this row
                    # mid-window: its teardown already released the slot
                    break
            else:
                self.positions[s] += m + 1
                if rejected:
                    self.backend.rollback(s, rejected)
                if len(req.out) >= req.max_new or \
                        self.positions[s] >= self.max_seq - 1:
                    self._retire(req)
                    self.active.pop(req.rid, None)
                    self._free_slot(s)
        self.metrics.decode_tokens += emitted_total
        dt3 = self.clock() - t3
        self._h_phase.observe(dt3, phase="emit")
        self.tracer.event("emit", ts=t3, dur=dt3)
        return True

    def serve(self, requests: list[Request], max_ticks: int = 512) -> dict:
        """Queue ``requests`` and run to completion (or ``max_ticks``).
        Requests are validated before any is queued.  Returned stats cover
        this call only (``ticks`` counts engine steps, as in JAX);
        requests still queued or staged at ``max_ticks`` stay for the
        next call."""
        with self._lock:
            for r in requests:
                self._validate(r)
            now = self.clock()
            for r in requests:
                if r.submit_ts is None:
                    r.submit_ts = now
                self._note_submit(r)
                self.scheduler.push(r)
                self.tracer.event("queue", rid=r.rid)
            self._update_gauges()
            start = self.metrics.snapshot()
        t0 = self.clock()
        ticks = 0
        while (self.scheduler.pending or self.active or self._chunked) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        stats = self.metrics.since(start).summary(self.max_batch)
        stats.update({"wall_s": self.clock() - t0, "ticks": ticks,
                      "done": all(r.done for r in requests)})
        return stats

    # --- background serve loop ------------------------------------------
    @property
    def running(self) -> bool:
        """True while the background serve loop thread is alive."""
        t = self._loop_thread
        return t is not None and t.is_alive()

    def start(self) -> "Engine":
        """Run the tick on a background daemon thread until :meth:`stop`.
        While it runs, ``submit()`` is the only client surface needed.
        Idempotent; returns ``self``."""
        with self._lock:
            if self.running:
                return self
            self._loop_stop.clear()
            self._loop_wake.clear()
            self._drain_on_stop = True
            self._loop_thread = threading.Thread(
                target=self._serve_loop, name="engine-serve-loop",
                daemon=True)
            self._loop_thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float | None = None):
        """Stop the background loop.  ``drain=True`` ticks until every
        queued, staged and active request has finished; ``drain=False``
        exits at the next tick boundary and a later ``start()``,
        ``serve()`` or ``step()`` resumes where it stopped.  ``timeout``
        bounds the join; returns True if the thread exited in time."""
        t = self._loop_thread
        if t is None or not t.is_alive():
            self._loop_thread = None
            return True
        self._drain_on_stop = drain
        self._loop_stop.set()
        self._loop_wake.set()
        t.join(timeout)
        alive = t.is_alive()
        if not alive:
            self._loop_thread = None
        return not alive

    def _serve_loop(self):
        """Tick while there is work, sleep ``idle_backoff_s`` while there
        is none (``submit``/``cancel``/``preempt``/``stop`` wake it).  The
        lock is released, and the GIL yielded, between ticks so clients
        can submit and cancel."""
        backoff = max(self.config.idle_backoff_s, 1e-4)
        while True:
            with self._lock:
                worked = not self.idle
                if worked:
                    self._tick()
                drained = self.idle
            if self._loop_stop.is_set() and (drained
                                             or not self._drain_on_stop):
                return
            if not worked:
                self._loop_wake.wait(backoff)
                self._loop_wake.clear()
            else:
                # give the GIL up between ticks: a client blocked on the
                # lock (submit, cancel) would otherwise lose the race to
                # re-acquire it to this thread, tick after tick
                time.sleep(0)
