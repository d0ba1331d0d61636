"""Process-local metrics registry — counters, gauges, fixed-bucket histograms.

The numeric half of the observability plane (spans/events live in
``obs.trace``): a :class:`MetricsRegistry` of labeled series the
instrumented runtime increments on every admit/evict/step/flush, with two
exporters —

* :meth:`MetricsRegistry.to_prometheus` — the Prometheus text exposition
  format (``# HELP`` / ``# TYPE`` headers, cumulative ``_bucket{le=...}``
  histogram series, label-value escaping per the spec), scrapeable from a
  file or a trivial HTTP handler.
* :meth:`MetricsRegistry.snapshot` — a JSON-safe dict (histograms carry
  p50/p95/p99 from linear in-bucket interpolation).

:func:`us_per_tick` is defined here and nowhere else, so every µs/tick the
port reports is the same quantity. All metric names the runtime emits are
declared in :data:`DECLARED` (kind, help text, histogram buckets), the
reference's (``repro.obs.metrics``) name for name, so a dashboard reads
both packages alike; the exporters give the reference's text for the same
recorded series, string for string. The serving latencies time the host's
enqueue of a chunk: the runtime never synchronizes the device inside a
span, so on the card a chunk's latency is its dispatch, not its device
time.
"""
from __future__ import annotations

import bisect
import json
import math
import re
import threading
from typing import Any

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DECLARED",
    "LATENCY_MS_BUCKETS",
    "US_PER_TICK_BUCKETS",
    "escape_label_value",
    "us_per_tick",
]


def us_per_tick(wall_s: float, ticks: int) -> float:
    """Microseconds of wall clock per simulated tick — THE definition
    shared by bench cells and live serving metrics."""
    return wall_s / ticks * 1e6


# Chunk dispatch latency (ms): sub-ms solo sessions through multi-second
# 512-lane fleets on a loaded host.
LATENCY_MS_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0)
# µs/tick: the paper's real-time bar is 1000 µs/tick (1 ms model time per
# tick), so the buckets straddle it on both sides.
US_PER_TICK_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                       1000.0, 2500.0, 10000.0)

# name -> (kind, help, histogram buckets or None). The single source of
# truth for what the instrumented runtime emits; the registry uses it to
# attach help text / buckets on first touch.
DECLARED: dict[str, tuple[str, str, tuple | None]] = {
    "repro_serve_chunk_latency_ms": (
        "histogram",
        "Wall-clock per serving-chunk dispatch (scheduler fleet or solo "
        "session), milliseconds: the host's enqueue, the device not "
        "synchronized",
        LATENCY_MS_BUCKETS),
    "repro_serve_us_per_tick": (
        "histogram",
        "Wall-clock microseconds per simulated tick of a serving chunk "
        "(1000 = the paper's real-time bar): the host's enqueue, the "
        "device not synchronized",
        US_PER_TICK_BUCKETS),
    "repro_serve_ticks_total": (
        "counter", "Aggregate lane-ticks served (ticks x occupied lanes)",
        None),
    "repro_engine_ticks_total": (
        "counter", "Simulated ticks dispatched through Engine.run/run_batch",
        None),
    "repro_serve_admits_total": (
        "counter", "Sessions placed into a lane (restores included)", None),
    "repro_serve_evicts_total": (
        "counter", "Sessions evicted from a lane", None),
    "repro_serve_exports_total": (
        "counter", "Lanes exported raw (migration payloads)", None),
    "repro_serve_restores_total": (
        "counter", "Lane snapshots restored into a scheduler", None),
    "repro_serve_flushes_total": (
        "counter", "Telemetry flushes drained to the host", None),
    "repro_watch_trips_total": (
        "counter",
        "In-scan watchpoint verdicts tripped, by watch name and rung", None),
    "repro_quarantines_total": (
        "counter", "Tripped tenants quarantined off the serving fleet", None),
    "repro_flight_records_total": (
        "counter",
        "Flight-recorder chunk-boundary lane snapshots captured", None),
    "repro_quarantine_dump_bytes": (
        "gauge", "On-disk bytes of retained quarantine dumps per directory",
        None),
    "repro_serve_lane_occupancy": (
        "gauge", "Occupied lanes per scheduler rung", None),
    "repro_serve_lane_capacity": (
        "gauge", "Total lanes per scheduler rung", None),
    "repro_compiles_total": (
        "counter", "Dispatches that built or loaded kernels or launchers, "
        "by dispatch site", None),
    "repro_jit_cache_hits_total": (
        "counter", "Dispatches that reused what earlier ones built", None),
    "repro_rung_migrations_total": (
        "counter", "Whole-fleet capacity-rung migrations, by direction",
        None),
    "repro_pool_routes_total": (
        "counter", "ServePool admissions routed, by compile fingerprint",
        None),
    "repro_checkpoint_saves_total": (
        "counter", "Session/lane checkpoints written", None),
    "repro_checkpoint_restores_total": (
        "counter", "Session/lane checkpoint restores, by status", None),
    "repro_ledger_bytes": (
        "gauge", "Memory-ledger bytes by registration name", None),
    "repro_ledger_stage_bytes": (
        "gauge", "Memory-ledger bytes by paper ramp-up stage", None),
    "repro_ledger_total_bytes": (
        "gauge", "Total memory-ledger bytes per ledger", None),
    "repro_serve_rung_bytes": (
        "gauge", "Serve-lane bytes per capacity rung "
        "(MemoryLedger.serve_rung_bytes)", None),
    "repro_bench_us_per_tick": (
        "gauge", "Best-of-N bench-cell microseconds per tick", None),
}

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def escape_label_value(value: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _labels_key(labels: dict[str, Any]) -> tuple[tuple[str, str], ...]:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(key: tuple[tuple[str, str], ...],
                extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = key + extra
    if not pairs:
        return ""
    return ("{" + ",".join(f'{k}="{escape_label_value(v)}"'
                           for k, v in pairs) + "}")


def _fmt_num(x: float) -> str:
    if math.isinf(x):
        return "+Inf" if x > 0 else "-Inf"
    if float(x) == int(x):
        return str(int(x))
    return repr(float(x))


class _Metric:
    """Shared labeled-series plumbing."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def series(self) -> dict[tuple[tuple[str, str], ...], Any]:
        with self._lock:
            return dict(self._series_map())

    def _series_map(self) -> dict:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: dict[tuple, float] = {}

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        key = _labels_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels: Any) -> float:
        return self._values.get(_labels_key(labels), 0.0)

    def _series_map(self) -> dict:
        return self._values


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels: Any) -> None:
        with self._lock:
            self._values[_labels_key(labels)] = float(value)

    def value(self, **labels: Any) -> float | None:
        return self._values.get(_labels_key(labels))

    def remove(self, **labels: Any) -> None:
        with self._lock:
            self._values.pop(_labels_key(labels), None)

    def clear_where(self, **subset: Any) -> None:
        """Drop every series whose labels include the given subset — rung
        gauges are cleared this way when a scheduler closes."""
        want = set(_labels_key(subset))
        with self._lock:
            self._values = {k: v for k, v in self._values.items()
                            if not want <= set(k)}

    def _series_map(self) -> dict:
        return self._values


class Histogram(_Metric):
    """Fixed-bucket histogram with cumulative Prometheus export.

    Per-series storage is ``[per-bucket counts (+Inf last), sum, count]``;
    ``le`` semantics: a value lands in the first bucket whose upper edge
    is >= the value. Quantiles interpolate linearly within the landing
    bucket (the standard ``histogram_quantile`` estimate); values in the
    +Inf bucket report the last finite edge.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple | None = None):
        super().__init__(name, help)
        edges = tuple(sorted(float(b) for b in
                             (buckets or LATENCY_MS_BUCKETS)))
        if not edges:
            raise ValueError("need at least one bucket edge")
        self.buckets = edges
        self._series: dict[tuple, list] = {}

    def observe(self, value: float, **labels: Any) -> None:
        key = _labels_key(labels)
        v = float(value)
        if math.isfinite(v):
            i = bisect.bisect_left(self.buckets, v)
        else:
            # Non-finite samples (NaN from a poisoned timer, ±inf from an
            # upstream zero division) land in the overflow bucket and stay
            # out of the running sum — bisect on NaN would silently file
            # it under the SMALLEST bucket and one bad sample would turn
            # every future sum/mean export into NaN.
            i = len(self.buckets)
            v = 0.0
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = [[0] * (len(self.buckets) + 1),
                                         0.0, 0]
            s[0][i] += 1
            s[1] += v
            s[2] += 1

    def count(self, **labels: Any) -> int:
        s = self._series.get(_labels_key(labels))
        return s[2] if s else 0

    def sum(self, **labels: Any) -> float:
        s = self._series.get(_labels_key(labels))
        return s[1] if s else 0.0

    def quantile(self, q: float, labels: dict[str, Any] | None = None
                 ) -> float | None:
        """q in [0, 1]; with ``labels=None`` the quantile is over ALL
        series merged (the fleet-wide view). None when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            if labels is None:
                rows = list(self._series.values())
            else:
                s = self._series.get(_labels_key(labels))
                rows = [s] if s else []
            counts = [0] * (len(self.buckets) + 1)
            total = 0
            for s in rows:
                total += s[2]
                for i, c in enumerate(s[0]):
                    counts[i] += c
        if total == 0:
            return None
        target = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                if i >= len(self.buckets):  # +Inf bucket
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                return lo + (hi - lo) * max(0.0, target - cum) / c
            cum += c
        return self.buckets[-1]

    def _series_map(self) -> dict:
        return self._series


class MetricsRegistry:
    """Get-or-create registry of named metric families.

    ``counter(name)`` / ``gauge(name)`` / ``histogram(name)`` return the
    existing family or create one, pulling help text and buckets from
    :data:`DECLARED` when the name is declared. Asking for an existing
    name with a different kind raises — one name, one type, as Prometheus
    requires.
    """

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str | None,
                       **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"requested {cls.kind}")
                return m
            decl = DECLARED.get(name)
            if help is None:
                help = decl[1] if decl else ""
            if cls is Histogram and kw.get("buckets") is None and decl:
                kw["buckets"] = decl[2]
            m = self._metrics[name] = cls(name, help, **kw)
            return m

    def counter(self, name: str, help: str | None = None) -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str | None = None) -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str | None = None,
                  buckets: tuple | None = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- exporters --------------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition format, families sorted by name."""
        lines: list[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
            series = m.series()
            if isinstance(m, Histogram):
                for key in sorted(series):
                    counts, total_sum, total = series[key]
                    cum = 0
                    for edge, c in zip(m.buckets, counts):
                        cum += c
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels(key, (('le', _fmt_num(edge)),))}"
                            f" {cum}")
                    cum += counts[-1]
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(key, (('le', '+Inf'),))} {cum}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(key)} "
                        f"{_fmt_num(total_sum)}")
                    lines.append(f"{name}_count{_fmt_labels(key)} {total}")
            else:
                for key in sorted(series):
                    lines.append(
                        f"{name}{_fmt_labels(key)} "
                        f"{_fmt_num(series[key])}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict[str, Any]:
        """JSON-safe dump: counters/gauges as labeled values, histograms
        with count/sum/p50/p95/p99 and raw bucket counts."""
        out: dict[str, Any] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            entry: dict[str, Any] = {"kind": m.kind, "help": m.help,
                                     "series": []}
            if isinstance(m, Histogram):
                for key, (counts, total_sum, total) in sorted(
                        m.series().items()):
                    entry["series"].append({
                        "labels": dict(key),
                        "count": total,
                        "sum": total_sum,
                        "p50": m.quantile(0.50, dict(key)),
                        "p95": m.quantile(0.95, dict(key)),
                        "p99": m.quantile(0.99, dict(key)),
                        "buckets": {
                            **{_fmt_num(e): c
                               for e, c in zip(m.buckets, counts)},
                            "+Inf": counts[-1],
                        },
                    })
            else:
                for key, value in sorted(m.series().items()):
                    entry["series"].append({"labels": dict(key),
                                            "value": value})
            out[name] = entry
        return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=1)
