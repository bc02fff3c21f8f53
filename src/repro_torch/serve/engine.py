"""Continuous-batching serving engine, synchronous path (mirrors
``repro.serve.engine``).

A fixed set of ``max_batch`` slots.  New requests are bucketed by padded
prompt length and prefilled in one call per bucket, their rows copied into
the cache substrate; every decode tick then advances ALL ``max_batch``
rows one token at their own positions (a ``(max_batch,)`` position
tensor).  Under ``EngineConfig(quant=...)`` prefill runs full precision
and the decode model carries frozen 4-bit projections evaluated by the LUT
GEMM kernels; a model-level ``cfg.quant`` mode (``luna_*``, ``lut_nf4``,
...) instead quantizes every projection of prefill and decode on each
call.  The two do not combine.  Free rows sit at position 0 with token 0
and compute garbage that is ignored, exactly as in JAX; under a
model-level mode they also enter the per-tensor activation calibration,
as in JAX.

The cache substrate is owned by :mod:`repro_torch.serve.backend`: a dense
slab, a paged block pool (``paged=True``: admission reserves only the
blocks a request needs and backpressures when the pool is short) or dense
recurrent state (ssm); the engine never branches on which.

**Chunked prefill** (``prefill_chunk=N``): prompts longer than N tokens are
admitted in N-token pieces, at most ONE piece a tick before the decode
step.  Attention pieces continue the staged KV cache at the write offset;
mamba2 resumes the SSD scan from the carried (conv, state), so chunked
prefill is token-identical to whole-prompt prefill.

**Prefix cache** (``prefix_cache=True``): a radix tree over prompt tokens
(:mod:`repro_torch.serve.prefix_cache`) remembers what prefill computed.
Admission matches the longest cached prefix and prefills only the tail:
shared KV blocks are gathered into the staging row (and never written:
copy-on-write), or a state snapshot is copied in.  Warm admissions ride
the same staged path as chunked prefill.

Ported: ``serve()``/``step()``, the priority/FIFO :class:`Scheduler` with
its head-of-line stall state, bucketed and staged admission, the decode
tick, emit and retire, and a plain :class:`EngineMetrics`.  The background
loop, cancel/preempt, ``submit()`` and streaming handles, speculative
decoding and the ``repro.obs`` registry/tracer are ROADMAP queue 1 item 6.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, fields

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serve.backend import make_backend
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.paged import ceil_div
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.sampling import SamplingConfig, sample


@dataclass(eq=False)
class Request:
    """One generation request.  ``priority``: higher admits first;
    ``deadline``: a ``time.perf_counter()`` stamp, the within-class
    tie-break (earlier first).  ``eq=False``: a request is an identity."""
    rid: int
    prompt: list[int]
    max_new: int = 16
    priority: int = 0
    deadline: float | None = None
    out: list[int] = field(default_factory=list)
    done: bool = False
    token_ts: list[float] = field(default_factory=list, repr=False)


@dataclass(eq=False)
class _QueueEntry:
    req: Request
    arrival: int
    passed: int = 0


class Scheduler:
    """Priority-class admission queue: highest effective priority first;
    within a class aged entries first (by arrival), then earliest
    deadline, then arrival (FIFO).  An entry passed over
    ``starvation_bound`` times gains one priority bucket, never more.

    It also holds the head-of-line stall state: per rid, the free
    capacity at its last failed reservation and what it asked for, so a
    backpressured request retries only after capacity grew, instead of
    re-walking the radix tree (and churning shared-block refcounts) every
    tick."""

    _MAX_STALLS = 128          # bound on abandoned-rid stall records

    def __init__(self, starvation_bound: int = 8):
        self.starvation_bound = starvation_bound
        self._queue: list[_QueueEntry] = []
        self._arrivals = 0
        self._stalls: dict[int, tuple[int, int]] = {}

    @property
    def pending(self) -> int:
        return len(self._queue)

    def push(self, req: Request) -> None:
        self._queue.append(_QueueEntry(req, self._arrivals))
        self._arrivals += 1

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
        for e in self._queue:
            e.passed += 1

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

    def clear_stall(self, rid: int) -> None:
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
    """Wall-clock and token accounting split by phase."""
    prefill_s: float = 0.0
    decode_s: float = 0.0
    prefill_tokens: int = 0      # prompt tokens pushed through prefill
    decode_tokens: int = 0       # tokens emitted by decode ticks
    prefill_calls: int = 0       # prefill calls (bucket or chunk)
    prefill_chunks: int = 0      # chunked-admission pieces among those
    ticks: int = 0               # decode ticks
    occupancy_sum: int = 0       # sum over ticks of active slots
    prefix_hits: int = 0         # admissions seeded from the prefix cache
    prefix_tokens_reused: int = 0   # prompt tokens NOT re-prefilled
    cache_evictions: int = 0     # prefix-cache nodes evicted (LRU)

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
            "prefill_tok_s": (self.prefill_tokens / max(self.prefill_s, 1e-9)
                              if self.prefill_tokens else 0.0),
            "decode_tok_s": (self.decode_tokens / max(self.decode_s, 1e-9)
                             if self.decode_tokens else 0.0),
            "occupancy": (self.occupancy_sum / (self.ticks * max_batch)
                          if self.ticks else 0.0),
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "cache_evictions": self.cache_evictions,
        }


class Engine:
    def __init__(self, cfg, params, config: EngineConfig | None = None, *,
                 device=None):
        """``params``: the model (``TransformerLM`` or ``SSMLM``) holding
        the full-precision weights.  ``device``: the card unless ``"cpu"``
        (the model must already live there)."""
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
        self.clock = time.perf_counter
        self.scheduler = Scheduler(config.starvation_bound)
        self.metrics = EngineMetrics()

    # --- substrate views ------------------------------------------------
    @property
    def paged(self) -> bool:
        return self.backend.paged

    @property
    def allocator(self):
        return getattr(self.backend, "allocator", None)

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
        if req.rid in self.active or \
                any(cp.req.rid == req.rid for cp in self._chunked):
            raise ValueError(f"rid {req.rid} is already live; rids must be "
                             "unique among live requests")

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

    def _chunkable(self, prompt_len: int) -> bool:
        return (self.prefill_chunk is not None
                and prompt_len > self.prefill_chunk)

    def _bucket_len(self, n: int) -> int:
        return min(ceil_div(n, self.prefill_bucket) * self.prefill_bucket,
                   self.max_seq)

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
                    raise ValueError(f"rid {req.rid} queued twice in one "
                                     "admission tick")
            except ValueError:
                # evict the poison entry, flush the requests already
                # committed this tick (their capacity is reserved), then
                # surface the error once
                self.scheduler.drop(entry)
                self._retire(req)
                if batch:
                    self._admit_buckets(batch, batch_slots)
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
            self._admit_buckets(batch, batch_slots)

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
            for j, i in enumerate(idxs):
                req, slot = reqs[i], slots[i]
                self._emit(req, int(nxt[j]))
                self.metrics.prefill_tokens += len(req.prompt)
                self._prefix_insert_from_slot(req, slot)
                if len(req.out) >= req.max_new:
                    self._retire(req)     # max_new=1: done at admission
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
        return self.prefix_cache.match(req.prompt,
                                       max_len=len(req.prompt) - 1,
                                       need_state=self.backend.needs_state)

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
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # honest wall-clock
            cp.consumed += c
            self.metrics.prefill_s += self.clock() - t0
            self.metrics.prefill_tokens += c
            self.metrics.prefill_calls += 1
            if self.prefill_chunk is not None:
                self.metrics.prefill_chunks += 1
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
        self.metrics.prefill_s += self.clock() - t0
        self.metrics.prefill_tokens += remaining
        self.metrics.prefill_calls += 1
        if self.prefill_chunk is not None:
            self.metrics.prefill_chunks += 1
        self._finish_prefix_insert(cp, staged_out)
        self._emit(req, int(nxt[0]))
        if len(req.out) >= req.max_new:
            self._retire(req)
            self._free_slot(cp.slot)
            return
        self.positions[cp.slot] = len(req.prompt)
        self.active[req.rid] = req

    # --- token emission / retirement ------------------------------------
    def _emit(self, req: Request, tok: int):
        req.out.append(tok)
        req.token_ts.append(self.clock())

    def _retire(self, req: Request):
        req.done = True

    def _free_slot(self, slot: int):
        self.slots[slot] = None
        self.positions[slot] = 0
        self.backend.free_slot(slot)

    # --- decode ---------------------------------------------------------
    def step(self):
        """One engine tick: admit queued work into free slots, run at most
        one chunk of staged prefill, then every active slot advances one
        token (free and mid-admission rows compute ignored garbage: a
        staged slot's writes are overwritten by its final scatter, or
        parked on the garbage block when paged)."""
        self._admit_pending()
        self._advance_chunked()
        if self.active:
            self._decode_tick()

    @torch.inference_mode()
    def _decode_tick(self):
        """All ``max_batch`` rows step one token at their own position;
        the block tables (paged) reach the card once a tick."""
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
        for s, req in enumerate(self.slots):
            if req is None or req.rid not in self.active:
                continue
            self._emit(req, int(nxt[s]))
            self.positions[s] += 1
            if len(req.out) >= req.max_new or \
                    self.positions[s] >= self.max_seq - 1:
                self._retire(req)
                self.active.pop(req.rid, None)
                self._free_slot(s)

    def serve(self, requests: list[Request], max_ticks: int = 512) -> dict:
        """Queue ``requests`` and run to completion (or ``max_ticks``).
        Requests are validated before any is queued.  Returned stats cover
        this call only; ``ticks`` counts engine steps, as in JAX; requests
        still queued or staged at ``max_ticks`` stay for the next call."""
        for r in requests:
            self._validate(r)
        for r in requests:
            self.scheduler.push(r)
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
