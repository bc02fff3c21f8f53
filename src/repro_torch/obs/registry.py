"""Thread-safe metrics registry: counters, gauges, fixed-bucket histograms.

One :class:`MetricsRegistry` per engine.  Design constraints, in order:

* **Determinism** — a dump of the registry is a pure function of the
  observations it absorbed: no wall-clock stamps, no id()s, sorted keys
  everywhere.  Two virtual-clock engine runs over the same trace produce
  byte-identical ``dump_json()`` / ``prometheus_text()`` output (pinned
  in ``tests/test_obs.py`` and, for this copy,
  ``tests/test_torch_obs.py``).
* **Cheap on the hot path** — one shared lock, plain dict lookups, and a
  linear bucket scan per histogram observation (bucket lists are ~15
  entries).  The recording-overhead bound the bench gates (<3% decode
  tok/s) budgets for a handful of these per engine tick.
* **Prometheus-compatible** — ``prometheus_text()`` emits the text
  exposition format (``# HELP`` / ``# TYPE`` + samples; histograms as
  cumulative ``_bucket{le=...}`` series with ``_sum``/``_count``) so a
  stock Prometheus scraper can poll the ``/metrics`` endpoint that
  :func:`repro_torch.obs.exporters.start_metrics_server` serves.

Counters here allow ``set()`` as well as ``add()``: the engine's bench
harness resets phase counters mid-run, and ``EngineMetrics`` (a live
view over this registry) keeps its historical read/write field contract.
"""
from __future__ import annotations

import json
import math
import threading

#: fixed histogram bucket grids (seconds).  Fixed — not adaptive — so two
#: runs of the same workload land observations in the same buckets and
#: dumps stay byte-comparable across runs and machines.
TTFT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0, 30.0)
ITL_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
               0.5, 1.0)
PHASE_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3,
                 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.5, 1.0)
#: token-count grids for the speculative-decoding histograms: accepted
#: drafts per verify window (bounded by spec_k) and accepted/rejected
#: totals per retired request
SPEC_WINDOW_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0)
SPEC_REQUEST_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def _label_key(labels: dict) -> tuple:
    """Canonical (sorted) label tuple — the per-series dict key."""
    return tuple(sorted(labels.items()))


def _fmt_value(v) -> str:
    """Prometheus sample value: integers without a trailing ``.0`` (they
    compare cleanly in dumps), floats via ``repr`` (round-trip exact)."""
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()
                              and abs(v) < 1e15):
        return str(int(v))
    return repr(float(v))


def _fmt_le(b: float) -> str:
    return "+Inf" if math.isinf(b) else _fmt_value(b)


class _Metric:
    """Shared plumbing: name, help text, label schema, per-series store."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...],
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._series: dict[tuple, object] = {}

    def _check(self, labels: dict) -> tuple:
        if tuple(sorted(labels)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return _label_key(labels)

    def _series_items(self):
        """[(label_key, value)] sorted by label key — deterministic."""
        return sorted(self._series.items())


class Counter(_Metric):
    """Monotonic-by-convention numeric series (``add``); ``set`` exists
    for the EngineMetrics view's legacy reset contract."""

    kind = "counter"

    def add(self, value=1, **labels) -> None:
        key = self._check(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + value

    def set(self, value, **labels) -> None:
        key = self._check(labels)
        with self._lock:
            self._series[key] = value

    def value(self, **labels):
        with self._lock:
            return self._series.get(_label_key(labels), 0)


class Gauge(_Metric):
    """A point-in-time level (queue depth, pool occupancy)."""

    kind = "gauge"

    def set(self, value, **labels) -> None:
        key = self._check(labels)
        with self._lock:
            self._series[key] = value

    def add(self, value=1, **labels) -> None:
        key = self._check(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + value

    def value(self, **labels):
        with self._lock:
            return self._series.get(_label_key(labels), 0)


class Histogram(_Metric):
    """Fixed-bucket histogram: per-series cumulative counts + sum.

    Buckets are upper bounds (``le``); an implicit ``+Inf`` bucket always
    exists.  Percentile-free by design — the bench keeps exact latency
    percentiles, the registry keeps scrape-friendly distributions.
    """

    kind = "histogram"

    def __init__(self, name, help, labelnames, lock, buckets):
        super().__init__(name, help, labelnames, lock)
        b = tuple(float(x) for x in buckets)
        if not b or sorted(b) != list(b):
            raise ValueError(f"{name}: buckets must be sorted, got {b}")
        self.buckets = b

    def observe(self, value: float, **labels) -> None:
        key = self._check(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = {
                    "counts": [0] * (len(self.buckets) + 1), "sum": 0.0}
            i = 0
            for i, b in enumerate(self.buckets):
                if value <= b:
                    break
            else:
                i = len(self.buckets)
            s["counts"][i] += 1
            s["sum"] += float(value)

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return sum(s["counts"]) if s else 0


class MetricsRegistry:
    """Namespace of metrics sharing one lock.

    >>> reg = MetricsRegistry()
    >>> c = reg.counter("requests_total", "requests seen", ("priority",))
    >>> c.add(priority="0"); c.add(2, priority="1")
    >>> c.value(priority="1")
    2
    >>> print(reg.prometheus_text().strip())
    # HELP requests_total requests seen
    # TYPE requests_total counter
    requests_total{priority="0"} 1
    requests_total{priority="1"} 2
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _register(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        "type or label schema")
                return m
            m = cls(name, help, tuple(labelnames), self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: tuple[str, ...] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple[str, ...] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: tuple[str, ...] = (),
                  buckets=PHASE_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    # --- export ---------------------------------------------------------
    def dump(self) -> dict:
        """JSON-able snapshot: {metric: {kind, help, series}} with label
        keys flattened to ``k="v",...`` strings.  Deterministic (sorted)
        — two identical runs produce identical dumps."""
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            series = {}
            for key, val in m._series_items():
                lk = ",".join(f'{k}="{v}"' for k, v in key)
                if isinstance(m, Histogram):
                    series[lk] = {
                        "buckets": {_fmt_le(b): c for b, c in
                                    zip((*m.buckets, math.inf),
                                        _cum(val["counts"]))},
                        "sum": val["sum"],
                        "count": sum(val["counts"]),
                    }
                else:
                    series[lk] = val
            out[name] = {"kind": m.kind, "help": m.help, "series": series}
        return out

    def dump_json(self) -> str:
        return json.dumps(self.dump(), indent=2, sort_keys=True)

    def prometheus_text(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, val in m._series_items():
                base = ",".join(f'{k}="{v}"' for k, v in key)
                if isinstance(m, Histogram):
                    for b, c in zip((*m.buckets, math.inf),
                                    _cum(val["counts"])):
                        le = f'le="{_fmt_le(b)}"'
                        lbl = f"{base},{le}" if base else le
                        lines.append(f"{name}_bucket{{{lbl}}} {c}")
                    sfx = f"{{{base}}}" if base else ""
                    lines.append(f"{name}_sum{sfx} {_fmt_value(val['sum'])}")
                    lines.append(f"{name}_count{sfx} "
                                 f"{sum(val['counts'])}")
                else:
                    sfx = f"{{{base}}}" if base else ""
                    lines.append(f"{name}{sfx} {_fmt_value(val)}")
        return "\n".join(lines) + "\n"


def _cum(counts: list[int]):
    """Cumulative bucket counts (Prometheus ``le`` semantics)."""
    total = 0
    for c in counts:
        total += c
        yield total
