"""SLO health snapshots — live runtime metrics against the paper's budgets.

The reference's ``repro.obs.health`` on the port.

The paper's headline claims are operational: the 186-neuron configuration
runs *real time* (1 ms of model time per 1 ms of wall clock) on a 20 mW
Cortex-M33, inside an 8.477 MB memory ceiling. :func:`health_snapshot`
turns those claims into a structured pass/warn/fail report over whatever
is live right now:

* **Modeled real-time factor** (``realtime_vs_<hw>``): the same roofline
  as ``repro_torch.telemetry.metrics.device_tick_seconds`` (event-driven
  traversal, the MCU discipline), evaluated for a compiled network
  against a :class:`~repro_torch.core.sizing.HardwareSpec` — the paper's
  M33 by default. rtf >= 1 passes; the warn band flags configs within 20% of
  missing the deadline.
* **Ledger budget** (``ledger_budget``): total registered bytes vs the
  ledger's own budget (or the MCU ceiling when unbudgeted); warn at 90%.
* **Per-rung bytes** (``rung_bytes[...]``): every live serving rung's
  lane bytes vs the 8.477 MB MCU ceiling — a 512-lane HBM-scale rung
  correctly reports *fail* against the single-MCU budget, which is the
  point: the ceiling governs what fits ON one device, and the snapshot
  says which rungs do. Sourced from the ledger when a network is given,
  else from the live ``repro_serve_rung_bytes`` gauges.
* **Measured serve latency** (``serve_realtime_measured``): p95 of the
  live ``repro_serve_us_per_tick`` histogram vs the 1000 µs/tick
  real-time bar — present once any scheduler chunk has been recorded. On
  the card it reads the host's enqueue of a chunk (the runtime never
  synchronizes the device inside a span).
* **Watchpoints** (``watchpoints``): WARN once any in-run watch tripped.
* **Per-core bytes** (``core_bytes[...]``): a partitioned net's plan
  (``compile(partition=...)``), each core's verified ledger bytes against
  its per-core ceiling; without a net, the
  ``repro_partition_core_bytes`` gauges that ``plan_partition`` publishes.

Status aggregates worst-of; the dict shape is JSON-safe and stable.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.sizing import M33, HardwareSpec
from repro_torch.memory.ledger import MCU_BUDGET_BYTES, MemoryLedger
from repro_torch.telemetry import metrics as paper_metrics

__all__ = [
    "PASS", "WARN", "FAIL",
    "HealthCheck",
    "budget_check",
    "core_checks",
    "health_snapshot",
    "measured_serve_check",
    "realtime_check",
    "rung_checks",
    "watch_check",
]

PASS, WARN, FAIL = "pass", "warn", "fail"
_SEVERITY = {PASS: 0, WARN: 1, FAIL: 2}


@dataclasses.dataclass(frozen=True)
class HealthCheck:
    """One evaluated SLO: ``value`` against ``limit`` with a verdict."""

    name: str
    status: str
    value: float
    limit: float
    detail: str

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def realtime_check(*, n_neurons: int, fanin: float, hw: HardwareSpec = M33,
                   mean_rate_hz: float = 25.0, dt_ms: float = 1.0,
                   bytes_per_weight: int = 2,
                   warn_below: float = 0.8) -> HealthCheck:
    """Modeled real-time factor of (N, fanin) on ``hw`` — event-driven
    roofline, rtf = model tick / modeled device tick wall."""
    tick_wall = paper_metrics.device_tick_seconds(
        hw, n_neurons=n_neurons, fanin=fanin,
        active_fraction=mean_rate_hz * dt_ms / 1000.0,
        bytes_per_weight=bytes_per_weight)
    rtf = (dt_ms / 1000.0) / tick_wall
    status = PASS if rtf >= 1.0 else (WARN if rtf >= warn_below else FAIL)
    return HealthCheck(
        name=f"realtime_vs_{hw.name}", status=status,
        value=round(rtf, 4), limit=1.0,
        detail=(f"{n_neurons} neurons, fan-in {fanin:.0f}, "
                f"{mean_rate_hz:.0f} Hz mean rate -> modeled rtf "
                f"{rtf:.2f}x on {hw.name} (>=1 is real time)"))


def budget_check(used_bytes: int, *, budget: int = MCU_BUDGET_BYTES,
                 name: str = "ledger_budget",
                 warn_frac: float = 0.9) -> HealthCheck:
    """Bytes vs a ceiling: fail over, warn within ``1 - warn_frac``."""
    status = (FAIL if used_bytes > budget
              else WARN if used_bytes > warn_frac * budget else PASS)
    return HealthCheck(
        name=name, status=status, value=float(used_bytes),
        limit=float(budget),
        detail=(f"{used_bytes / 1024**2:.3f} MB of "
                f"{budget / 1024**2:.3f} MB "
                f"({used_bytes / budget * 100:.0f}%)"))


def rung_checks(rung_bytes: dict[str, float], *,
                ceiling: int = MCU_BUDGET_BYTES,
                warn_frac: float = 0.9) -> list[HealthCheck]:
    """One budget check per live serving rung against the MCU ceiling."""
    return [budget_check(int(nbytes), budget=ceiling, warn_frac=warn_frac,
                         name=f"rung_bytes[{rung or 'unkeyed'}]")
            for rung, nbytes in sorted(rung_bytes.items())]


def core_checks(core_bytes: dict[str, float], *,
                ceiling: int = MCU_BUDGET_BYTES,
                warn_frac: float = 0.9) -> list[HealthCheck]:
    """One budget check per partition core against the per-core MCU
    ceiling — the paper's 8.477 MB enforced on every core of a
    ``compile(partition=...)`` plan, same discipline as the serving
    rungs."""
    def key(c):
        return (len(c), c)  # "2" < "10" numerically

    return [budget_check(int(core_bytes[c]), budget=ceiling,
                         warn_frac=warn_frac, name=f"core_bytes[{c}]")
            for c in sorted(core_bytes, key=key)]


def measured_serve_check(registry, *, dt_ms: float = 1.0,
                         quantile: float = 0.95) -> HealthCheck | None:
    """p-quantile of live serve µs/tick vs the real-time bar, merged
    across rungs; None until a scheduler chunk has been recorded."""
    hist = registry.get("repro_serve_us_per_tick")
    if hist is None or hist.kind != "histogram":
        return None
    p = hist.quantile(quantile)
    if p is None:
        return None
    limit = dt_ms * 1000.0  # µs of wall per tick at real time
    status = PASS if p <= limit else (WARN if p <= 2 * limit else FAIL)
    return HealthCheck(
        name="serve_realtime_measured", status=status,
        value=round(p, 2), limit=limit,
        detail=(f"p{int(quantile * 100)} serve dispatch "
                f"{p:.1f} us/tick vs {limit:.0f} us real-time bar "
                "(host dispatch wall, all rungs merged)"))


def watch_check(registry) -> HealthCheck | None:
    """Watchpoint verdict: WARN when any in-scan watch tripped this
    process (quarantine count in the detail); None until a watch-enabled
    fleet has been checked (neither counter touched)."""
    trips_c = registry.get("repro_watch_trips_total")
    quars_c = registry.get("repro_quarantines_total")
    if trips_c is None and quars_c is None:
        return None
    trips = sum(trips_c.series().values()) if trips_c is not None else 0.0
    quars = sum(quars_c.series().values()) if quars_c is not None else 0.0
    by_watch: dict[str, float] = {}
    if trips_c is not None:
        for key, value in trips_c.series().items():
            name = dict(key).get("watch", "?")
            by_watch[name] = by_watch.get(name, 0.0) + value
    detail = (f"{int(trips)} watch trip(s) "
              f"({', '.join(f'{k}={int(v)}' for k, v in sorted(by_watch.items()))}), "
              f"{int(quars)} tenant(s) quarantined"
              if trips else "no watch trips recorded")
    return HealthCheck(
        name="watchpoints", status=WARN if trips else PASS,
        value=trips, limit=0.0, detail=detail)


def _rungs_from_registry(registry) -> dict[str, float]:
    g = registry.get("repro_serve_rung_bytes")
    if g is None or g.kind != "gauge":
        return {}
    return {dict(key).get("rung", "unkeyed"): value
            for key, value in g.series().items()}


def _cores_from_registry(registry) -> dict[str, float]:
    g = registry.get("repro_partition_core_bytes")
    if g is None or g.kind != "gauge":
        return {}
    return {dict(key).get("core", "?"): value
            for key, value in g.series().items()}


def health_snapshot(net=None, *, hw: HardwareSpec = M33,
                    ledger: MemoryLedger | None = None,
                    mcu_ceiling: int = MCU_BUDGET_BYTES,
                    mean_rate_hz: float = 25.0, dt_ms: float = 1.0,
                    registry=None) -> dict[str, Any]:
    """Evaluate everything evaluable and aggregate worst-of.

    With a compiled ``net``: modeled real-time factor on ``hw``, its
    ledger vs budget, its serving rungs vs the MCU ceiling. Without one,
    rung bytes come from the live gauges, so a metrics-only process still
    gets the memory checks. A partitioned ``net`` (``compile(partition=)``)
    adds one check per core, its verified ledger bytes against the plan's
    per-core ceiling, and its unbudgeted global ledger answers to cores ×
    that ceiling. The measured-latency and watch checks ride the process
    registry either way.
    """
    from repro_torch import obs

    registry = registry if registry is not None else obs.registry()
    checks: list[HealthCheck] = []

    if net is not None:
        policy_name = getattr(getattr(net, "policy", None), "name", "")
        checks.append(realtime_check(
            n_neurons=net.n_neurons,
            fanin=net.n_synapses / max(net.n_neurons, 1),
            hw=hw, mean_rate_hz=mean_rate_hz, dt_ms=dt_ms,
            bytes_per_weight=2 if "16" in policy_name else 4))
        ledger = ledger if ledger is not None else net.ledger
    plan = getattr(net, "partition", None)
    if ledger is not None:
        # A partitioned, unbudgeted ledger answers to the fleet's capacity
        # (cores × the per-core ceiling), not one MCU: the per-core checks
        # below hold each core to the single-device ceiling.
        fallback = mcu_ceiling
        if plan is not None:
            fallback = (plan.spec.core_budget_bytes or mcu_ceiling) * plan.n_cores
        checks.append(budget_check(
            ledger.total_used,
            budget=ledger.budget if ledger.budget else fallback))
        checks.extend(rung_checks(ledger.serve_rung_bytes(), ceiling=mcu_ceiling))
    else:
        checks.extend(rung_checks(_rungs_from_registry(registry), ceiling=mcu_ceiling))
    if plan is not None:
        checks.extend(core_checks(
            {str(c): float(b) for c, b in plan.core_bytes().items()},
            ceiling=plan.spec.core_budget_bytes or mcu_ceiling))
    else:
        checks.extend(core_checks(_cores_from_registry(registry), ceiling=mcu_ceiling))

    measured = measured_serve_check(registry, dt_ms=dt_ms)
    if measured is not None:
        checks.append(measured)

    watches = watch_check(registry)
    if watches is not None:
        checks.append(watches)

    status = max((c.status for c in checks),
                 key=_SEVERITY.__getitem__, default=PASS)
    return {
        "status": status,
        "hardware": hw.name,
        "mcu_budget_bytes": mcu_ceiling,
        "checks": [c.as_dict() for c in checks],
    }
