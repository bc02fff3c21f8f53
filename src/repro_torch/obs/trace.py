"""Request-lifecycle tracer: ring-buffered span events, Perfetto export.

The engine emits one structured event per lifecycle transition —
``submit -> queue -> admit -> prefill_chunk* -> first_token -> token* ->
preempt/cancel -> finish`` — plus complete-span events for the per-tick
engine phases (``admit``/``prefill``/``decode``/``emit``).  Every stamp
comes from the clock injected at construction (the engine's single time
base), which is what makes virtual-clock load-harness traces
byte-identical across repeated runs: no wall time ever leaks into an
event.

Recording is OFF by default (``enabled=False`` → :meth:`Tracer.event` is
a cheap early-return) and ring-buffered when on: a bounded
``collections.deque`` drops the oldest events under overflow and counts
the drops (``dropped``), so a long-running serve loop can trace forever
in fixed memory and the export is honest about truncation.

Export is the Chrome/Perfetto ``trace_event`` JSON format (open the file
at https://ui.perfetto.dev or ``chrome://tracing``): one track per
request (pid 1, tid = rid) carrying instant lifecycle events, one track
per engine phase lane (pid 0) carrying complete ``X`` spans.  The JSON
is rendered with sorted keys and stable separators — byte-identical for
identical event sequences (pinned in ``tests/test_obs.py`` and
``tests/test_torch_obs.py``).
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field

#: lifecycle event names a request track can carry, in canonical order
REQUEST_EVENTS = ("submit", "queue", "admit", "prefill_chunk",
                  "first_token", "token", "preempt", "cancel", "finish")

#: engine-track phase names (complete spans, one lane each)
PHASE_EVENTS = ("admit", "prefill", "decode", "draft", "verify", "emit")

_ENGINE_PID = 0
_REQUEST_PID = 1


@dataclass(frozen=True)
class TraceEvent:
    """One trace record.  ``rid`` is None for engine-phase spans;
    ``dur`` is None for instant events.  ``ts``/``dur`` are clock
    seconds (the export converts to microseconds)."""
    name: str
    ts: float
    rid: int | None = None
    dur: float | None = None
    args: dict = field(default_factory=dict)


class Tracer:
    """Bounded, clock-stamped event recorder.

    >>> clk = iter([0.0, 0.5, 0.75]).__next__
    >>> tr = Tracer(clock=clk, capacity=8, enabled=True)
    >>> tr.event("submit", rid=3, priority=1)
    >>> with tr.span("decode"):
    ...     pass
    >>> [(e.name, e.ts, e.rid) for e in tr.events()]
    [('submit', 0.0, 3), ('decode', 0.5, None)]
    >>> tr.events()[1].dur
    0.25
    """

    def __init__(self, clock=None, capacity: int = 65536,
                 enabled: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.clock = clock if clock is not None else time.perf_counter
        self.capacity = capacity
        self.enabled = enabled
        self._buf: deque[TraceEvent] = deque(maxlen=capacity)
        self._seen = 0            # lifetime appends (dropped = seen - len)
        self._lock = threading.Lock()

    @property
    def dropped(self) -> int:
        """Events lost to ring-buffer overflow."""
        with self._lock:
            return self._seen - len(self._buf)

    def event(self, name: str, *, rid: int | None = None, ts: float | None
              = None, dur: float | None = None, **args) -> None:
        """Record one event (no-op while disabled).  ``ts`` defaults to
        the injected clock's now; pass it explicitly to stamp a span you
        timed yourself (the engine reuses its metric timestamps so trace
        and registry never disagree)."""
        if not self.enabled:
            return
        e = TraceEvent(name, self.clock() if ts is None else ts,
                       rid=rid, dur=dur, args=args)
        with self._lock:
            self._buf.append(e)
            self._seen += 1

    def span(self, name: str, *, rid: int | None = None, **args):
        """Context manager recording ``name`` as a complete span over the
        enclosed block (clock-stamped entry/exit)."""
        return _Span(self, name, rid, args)

    def events(self) -> list[TraceEvent]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._seen = 0

    def perfetto(self) -> str:
        """The ring buffer as Chrome ``trace_event`` JSON text."""
        return perfetto_json(self.events())


class _Span:
    __slots__ = ("_tr", "_name", "_rid", "_args", "_t0")

    def __init__(self, tracer, name, rid, args):
        self._tr, self._name, self._rid, self._args = tracer, name, rid, args

    def __enter__(self):
        self._t0 = self._tr.clock() if self._tr.enabled else 0.0
        return self

    def __exit__(self, *exc):
        if self._tr.enabled:
            t1 = self._tr.clock()
            self._tr.event(self._name, rid=self._rid, ts=self._t0,
                           dur=t1 - self._t0, **self._args)
        return False


def request_events(events: list[TraceEvent]) -> dict[int, list[TraceEvent]]:
    """Group the request-track events by rid, preserving order."""
    out: dict[int, list[TraceEvent]] = {}
    for e in events:
        if e.rid is not None:
            out.setdefault(e.rid, []).append(e)
    return out


def perfetto_json(events: list[TraceEvent]) -> str:
    """Render events as Chrome/Perfetto ``trace_event`` JSON.

    Deterministic: sorted JSON keys, compact separators, metadata rows
    emitted in sorted track order — identical event lists produce
    byte-identical text.
    """
    rows = []
    rids = sorted({e.rid for e in events if e.rid is not None})
    rows.append({"ph": "M", "pid": _ENGINE_PID, "tid": 0,
                 "name": "process_name", "args": {"name": "engine"}})
    phase_tids = {p: i for i, p in enumerate(PHASE_EVENTS)}
    for p, tid in phase_tids.items():
        rows.append({"ph": "M", "pid": _ENGINE_PID, "tid": tid,
                     "name": "thread_name", "args": {"name": f"phase:{p}"}})
    rows.append({"ph": "M", "pid": _REQUEST_PID, "tid": 0,
                 "name": "process_name", "args": {"name": "requests"}})
    for rid in rids:
        rows.append({"ph": "M", "pid": _REQUEST_PID, "tid": rid,
                     "name": "thread_name",
                     "args": {"name": f"request {rid}"}})
    for e in events:
        us = e.ts * 1e6
        if e.rid is None:
            row = {"name": e.name, "pid": _ENGINE_PID,
                   "tid": phase_tids.get(e.name, len(PHASE_EVENTS)),
                   "ts": us}
            if e.dur is not None:
                row.update(ph="X", dur=e.dur * 1e6)
            else:
                row.update(ph="i", s="p")
        else:
            row = {"name": e.name, "pid": _REQUEST_PID, "tid": e.rid,
                   "ts": us}
            if e.dur is not None:
                row.update(ph="X", dur=e.dur * 1e6)
            else:
                row.update(ph="i", s="t")
        if e.args:
            row["args"] = e.args
        rows.append(row)
    return json.dumps({"displayTimeUnit": "ms", "traceEvents": rows},
                      sort_keys=True, separators=(",", ":"))
