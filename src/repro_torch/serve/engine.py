"""Continuous-batching serving engine, synchronous path (mirrors
``repro.serve.engine``).

A fixed set of ``max_batch`` slots over a dense slab: KV rows (dense
family) or recurrent state (ssm).  New requests are bucketed by padded
prompt length and prefilled in one call per bucket, their rows copied into
the slab; every decode tick then advances ALL
``max_batch`` rows one token at their own positions (a ``(max_batch,)``
position tensor).  Under ``EngineConfig(quant=...)`` prefill runs full
precision and the decode model carries frozen 4-bit projections evaluated
by the LUT GEMM kernels; a model-level ``cfg.quant`` mode (``luna_*``,
``lut_nf4``, ...) instead quantizes every projection of prefill and decode
on each call.  The two do not combine.  Free rows sit at position 0 with
token 0 and compute garbage that is ignored, exactly as in JAX (their KV
writes land in their own row and the next admission overwrites the whole
row); under a model-level mode they also enter the per-tensor activation
calibration, as in JAX.

Ported: ``serve()``/``step()``, the priority/FIFO :class:`Scheduler`,
bucketed admission, the decode tick, emit and retire, and a plain
:class:`EngineMetrics`.  The background loop, cancel/preempt, streaming
handles, chunked prefill, the prefix cache, speculative decoding and the
``repro.obs`` registry/tracer are ROADMAP queue 1 item 6.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, fields

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serve.backend import DenseSlab
from repro_torch.serve.config import EngineConfig
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
    ``starvation_bound`` times gains one priority bucket, never more."""

    def __init__(self, starvation_bound: int = 8):
        self.starvation_bound = starvation_bound
        self._queue: list[_QueueEntry] = []
        self._arrivals = 0

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


@dataclass
class EngineMetrics:
    """Wall-clock and token accounting split by phase."""
    prefill_s: float = 0.0
    decode_s: float = 0.0
    prefill_tokens: int = 0      # prompt tokens pushed through prefill
    decode_tokens: int = 0       # tokens emitted by decode ticks
    prefill_calls: int = 0       # prefill calls (one per bucket)
    ticks: int = 0               # decode ticks
    occupancy_sum: int = 0       # sum over ticks of active slots

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
            "ticks": self.ticks,
            "prefill_tok_s": (self.prefill_tokens / max(self.prefill_s, 1e-9)
                              if self.prefill_tokens else 0.0),
            "decode_tok_s": (self.decode_tokens / max(self.decode_s, 1e-9)
                             if self.decode_tokens else 0.0),
            "occupancy": (self.occupancy_sum / (self.ticks * max_batch)
                          if self.ticks else 0.0),
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
        self.backend = DenseSlab(params, config.max_batch, config.max_seq)
        self.caches = self.backend.caches
        # the full-precision model itself under quant=None; a model over
        # frozen 4-bit projections otherwise.  Prefill uses self.params.
        with torch.inference_mode():
            self.decode_params = self.backend.prepare_decode_params(
                params, config.quant)
        self.positions = np.zeros(config.max_batch, np.int64)
        self.active: dict[int, Request] = {}
        self.slots: list[Request | None] = [None] * config.max_batch
        self.clock = time.perf_counter
        self.scheduler = Scheduler(config.starvation_bound)
        self.metrics = EngineMetrics()

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

    def _check_rid_free(self, req: Request):
        if req.rid in self.active:
            raise ValueError(f"rid {req.rid} is already live; rids must be "
                             "unique among live requests")

    def _bucket_len(self, n: int) -> int:
        return min(-(-n // self.prefill_bucket) * self.prefill_bucket,
                   self.max_seq)

    def _admit_pending(self):
        """Admit queued requests into free slots in scheduler order; all
        of this tick's admissions share the bucketed prefill calls."""
        free = [s for s, r in enumerate(self.slots) if r is None]
        batch: list[Request] = []
        batch_slots: list[int] = []
        while self.scheduler.pending and free:
            entry = self.scheduler.select()
            req = entry.req
            self._check_rid_free(req)
            if any(b.rid == req.rid for b in batch):
                raise ValueError(f"rid {req.rid} queued twice in one "
                                 "admission tick")
            self.scheduler.commit(entry)
            batch.append(req)
            batch_slots.append(free.pop(0))
        if batch:
            self._admit_buckets(batch, batch_slots)

    @torch.inference_mode()
    def _admit_buckets(self, reqs: list[Request], slots: list[int]):
        """One prefill per length bucket: prompts right-padded with 0 to
        the bucket length, logits read at each row's ``last_pos``."""
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
            slot_ids = torch.as_tensor([slots[i] for i in idxs],
                                       device=self.device)
            t0 = self.clock()
            logits, rows = self.params.prefill(
                torch.as_tensor(toks, device=self.device),
                self.backend.fresh(k),
                last_pos=torch.as_tensor(last, device=self.device))
            self.caches = self.backend.scatter(self.caches, rows, slot_ids)
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
                if len(req.out) >= req.max_new:
                    self._retire(req)     # max_new=1: done at admission
                    continue
                self.positions[slot] = len(req.prompt)
                self.slots[slot] = req
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

    # --- decode ---------------------------------------------------------
    def step(self):
        """One engine tick: admit queued work into free slots, then every
        active slot advances one token."""
        self._admit_pending()
        if self.active:
            self._decode_tick()

    @torch.inference_mode()
    def _decode_tick(self):
        """All ``max_batch`` rows step one token at their own position;
        free rows (position 0, token 0) compute ignored garbage."""
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
        logits, self.caches = self.decode_params.decode_step(
            torch.as_tensor(toks, device=self.device), self.caches,
            torch.as_tensor(self.positions, device=self.device))
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
        this call only; ``ticks`` counts engine steps, as in JAX."""
        for r in requests:
            self._validate(r)
        for r in requests:
            self.scheduler.push(r)
        start = self.metrics.snapshot()
        t0 = self.clock()
        ticks = 0
        while (self.scheduler.pending or self.active) and ticks < max_ticks:
            self.step()
            ticks += 1
        stats = self.metrics.since(start).summary(self.max_batch)
        stats.update({"wall_s": self.clock() - t0, "ticks": ticks,
                      "done": all(r.done for r in requests)})
        return stats
