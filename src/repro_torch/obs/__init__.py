"""repro_torch.obs — the operational observability plane.

The reference's ``repro.obs`` on the port. ``repro_torch.telemetry``
measures the *simulation* (spike counts, rates, in-run monitor carries
that ride the device work); this package measures the *runtime*:
admit/evict latency, chunk dispatch wall time, kernel and launcher builds,
lane occupancy, ledger bytes against the paper's budgets. Submodules:

* :mod:`repro_torch.obs.trace`   — bounded ring-buffer spans/events, JSONL +
  Chrome-trace (Perfetto) exporters.
* :mod:`repro_torch.obs.metrics` — counters / gauges / fixed-bucket
  histograms with Prometheus text and JSON snapshot exporters.
* :mod:`repro_torch.obs.health`  — SLO snapshots: live metrics vs the
  paper's budgets (real-time factor on the M33 spec, per-rung bytes vs the
  8.477 MB MCU ceiling). Imported lazily: it pulls in
  ``repro_torch.memory`` and ``repro_torch.core.sizing``, which may import
  this package.
* :mod:`repro_torch.obs.watch`   — in-run watchpoints (NaN/Inf state, rate
  band, weight drift, silence) riding every run. Imported lazily (it
  imports torch).

This module is the facade the instrumented runtime calls: a process-wide
tracer + registry behind module functions (:func:`span`, :func:`event`,
:func:`inc`, :func:`gauge`, :func:`observe`) that collapse to near-free
no-ops when disabled. Observability is **default-on** (disable with
``obs.configure(enabled=False)`` or ``REPRO_OBS=0``) because it is
host-side only: spans wrap the host's enqueue of a run or a chunk and the
scheduler's bookkeeping, and never synchronize the device, so rasters,
weights and telemetry are bitwise identical with obs on or off
(``tests/test_torch_obs.py``).

Dispatch classification. The reference reads jit's compile cache; the port
has none. Its counterpart (:func:`build_count`, :func:`note_dispatch`):
a dispatch during which a kernel library was built or loaded into the
process, or a launcher set was built that later dispatches reuse (the
scheduler's propagation launchers, :func:`note_build`), is a ``compile``;
every other dispatch is a ``jit_cache_hit``. Per-run plans, rebuilt every
run, are not a compile. The event and counter names are the reference's.
"""
from __future__ import annotations

import os
from typing import Any

from repro_torch.obs.metrics import MetricsRegistry, us_per_tick
from repro_torch.obs.trace import Tracer

__all__ = [
    "build_count",
    "configure",
    "enabled",
    "event",
    "gauge",
    "inc",
    "note_build",
    "note_dispatch",
    "observe",
    "registry",
    "remove_gauge",
    "span",
    "tracer",
    "us_per_tick",
]


def _env_enabled() -> bool:
    return os.environ.get("REPRO_OBS", "1").strip().lower() not in (
        "0", "false", "off", "no")


_enabled: bool = _env_enabled()
_tracer = Tracer()
_registry = MetricsRegistry()
_launcher_builds = 0


def enabled() -> bool:
    """Whether instrumentation currently records anything."""
    return _enabled


def configure(*, enabled: bool | None = None,
              trace_capacity: int | None = None,
              reset: bool = False) -> None:
    """Reconfigure the process-global plane.

    ``enabled`` flips recording (the instrumentation hooks stay in place
    either way — disabled they cost one predicate per call site);
    ``trace_capacity`` rebuilds the tracer ring at a new size;
    ``reset=True`` drops all recorded events and metric series (tests start
    clean this way).
    """
    global _enabled, _tracer, _registry
    if reset:
        _tracer = Tracer(trace_capacity or _tracer.capacity)
        _registry = MetricsRegistry()
    elif trace_capacity is not None and trace_capacity != _tracer.capacity:
        _tracer = Tracer(trace_capacity)
    if enabled is not None:
        _enabled = bool(enabled)


def tracer() -> Tracer:
    return _tracer


def registry() -> MetricsRegistry:
    return _registry


class _NoopSpan:
    """`with obs.span(...) as sp:` yields None when disabled — call sites
    key their metric emission on that, so the disabled path allocates
    nothing beyond the argument dict."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


def span(name: str, **args: Any):
    """Record a span around the with-body; yields the live span (with
    ``dur_s`` set on exit) or None when disabled."""
    if not _enabled:
        return _NOOP_SPAN
    return _tracer.span(name, **args)


def event(name: str, **args: Any) -> None:
    if _enabled:
        _tracer.event(name, **args)


def inc(_metric: str, value: float = 1.0, **labels: Any) -> None:
    if _enabled:
        _registry.counter(_metric).inc(value, **labels)


def gauge(_metric: str, value: float, **labels: Any) -> None:
    # First param deliberately avoids the name "name": labels may carry a
    # ``name=...`` dimension (the ledger's per-registration gauge does).
    if _enabled:
        _registry.gauge(_metric).set(value, **labels)


def remove_gauge(_metric: str, **labels: Any) -> None:
    """Drop gauge series whose labels include the given subset (close /
    teardown hygiene — runs even when disabled so a close under
    ``enabled=False`` still clears series recorded while enabled)."""
    g = _registry.get(_metric)
    if g is not None and g.kind == "gauge":
        g.clear_where(**labels)


def observe(_metric: str, value: float, **labels: Any) -> None:
    if _enabled:
        _registry.histogram(_metric).observe(value, **labels)


# -- dispatch classification --------------------------------------------------
def note_build() -> None:
    """Count a launcher set built for later dispatches to reuse (a
    scheduler's propagation launchers): the dispatch that builds it is a
    ``compile``."""
    global _launcher_builds
    _launcher_builds += 1


def build_count() -> int | None:
    """Kernel libraries loaded into the process plus launcher sets built
    (:func:`note_build`), or None when disabled: the probe taken before a
    dispatch."""
    if not _enabled:
        return None
    from repro_torch.kernels import _build  # stdlib only: no cycle

    return len(_build._LIBS) + _launcher_builds


def note_dispatch(site: str, before: int | None) -> None:
    """Classify the dispatch that just ran: it built or loaded something
    (:func:`build_count` grew) → ``compile`` event + counter; otherwise a
    ``jit_cache_hit``. ``before`` is :func:`build_count` taken before the
    dispatch."""
    if not _enabled or before is None:
        return
    if build_count() > before:
        _tracer.event("compile", site=site)
        _registry.counter("repro_compiles_total").inc(site=site)
    else:
        _tracer.event("jit_cache_hit", site=site)
        _registry.counter("repro_jit_cache_hits_total").inc(site=site)


def __getattr__(name: str):
    if name == "health":  # lazy: health imports repro_torch.memory/core.sizing
        import repro_torch.obs.health as health
        return health
    if name == "watch":  # lazy: watch imports torch
        import repro_torch.obs.watch as watch
        return watch
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
