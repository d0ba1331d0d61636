"""In-run monitors — CARLsim's SpikeMonitor/GroupMonitor, folded into the tick.

The reference's ``repro.telemetry.monitors`` on torch tensors. A monitor
is a *declarative spec* (a small frozen dataclass) attached to the network
at compile time (``NetworkBuilder.compile(monitors=...)`` stores the
resolved tuple in ``NetStatic.monitors``). The engine keeps the specs'
accumulators through a run (``Engine.run(n, record="monitors")``), so
telemetry takes O(N) device memory whatever the run's length, while
``record="raster"`` stays as it was.

Monitor kinds:

* :class:`SpikeCount` — exact integer spike totals: per-neuron int32
  counts through the run, per-group sums once at its end. The derived
  group rates are **bit-for-bit** equal to the post-hoc
  ``repro_torch.core.monitors.group_rates`` (exact counts through the
  shared :func:`repro_torch.telemetry.metrics.rate_from_count`).
* :class:`GroupRate` — exponentially filtered population rate per group
  (Hz): ``r += (dt/tau)·(inst − r)`` per neuron (f32), each operation
  rounded on its own, averaged per group at the end.
* :class:`VoltageProbe` — membrane-potential trace of a *selected* handful
  of neurons, ``[T, k]`` (the probe's ids in order, repeats allowed).
* :class:`WeightNorm` — per-projection L2 weight norms every ``stride``
  ticks (``[⌈T/stride⌉, P]``), over the weights in ``NetState.weights``'
  layout.

Where the tick runs a neuron-phase kernel (``izh4_update``'s run entry,
the ``fused_tick`` kernel), the first ``SpikeCount`` and the first
``GroupRate`` are folded inside that launch (:func:`kernel_slots`), so the
default monitor set costs no device operation per tick; every other
monitor, and every monitor of a net without such a kernel, is the plain
per-tick fold :func:`update`.

The per-group reductions (:func:`flush_carry`, :func:`collect`) run once
per run or flush, on the host, in the order the reference's compiled
reduce takes on the CPU (:func:`repro_torch.kernels.ref.xla_cpu_row_sum`;
a mean is that sum times the f32 reciprocal of the group size, as XLA
rewrites the division): the card's telemetry equals the CPU port's, and
the reference's, bit for bit.

The carry is a tuple aligned with ``static.monitors``: ``[(B,) N]`` int32
for SpikeCount, ``[(B,) N]`` f32 for GroupRate, ``()`` for VoltageProbe
(its rows are per-tick outputs) and ``[(B,) S, P]`` f32 for WeightNorm;
a leading ``[B]`` over lanes.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels.ref import rate_fold_ref, xla_cpu_row_sum

__all__ = [
    "SpikeCount",
    "GroupRate",
    "VoltageProbe",
    "WeightNorm",
    "MonitorSpec",
    "DEFAULT_MONITORS",
    "CUMULATIVE",
    "resolve",
    "n_snapshots",
    "carry_struct",
    "init_carry",
    "chunk_carry",
    "flush_carry",
    "kernel_slots",
    "rate_constants",
    "update",
    "collect",
    "summarize",
]

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SpikeCount:
    """Exact spike totals: per-neuron int32 in the carry, per-group out."""

    name: str = "spike_count"


@dataclasses.dataclass(frozen=True)
class GroupRate:
    """Exponentially filtered population rate (Hz): per-neuron f32 in the
    carry, per-group mean out."""

    tau_ms: float = 100.0
    name: str = "group_rate"


@dataclasses.dataclass(frozen=True)
class VoltageProbe:
    """Membrane-potential trace of ``neurons`` (global ids), ``[T, k]``."""

    neurons: tuple[int, ...] = ()
    name: str = "vprobe"


@dataclasses.dataclass(frozen=True)
class WeightNorm:
    """Per-projection L2 weight norms, snapshotted every ``stride`` ticks."""

    stride: int = 100
    name: str = "weight_norm"


MonitorSpec = SpikeCount | GroupRate | VoltageProbe | WeightNorm

# What compile(monitors="default") attaches: exact counts (the paper's
# accuracy metric, bit-parity group rates) and the filtered rate.
DEFAULT_MONITORS: tuple[MonitorSpec, ...] = (SpikeCount(), GroupRate())

# Monitor kinds whose accumulators are meaningful across runs: their carry
# slots persist over chunked serving calls (``run(tel_carry=...)``) until a
# host flush drains them. VoltageProbe rows and WeightNorm snapshots are
# per-chunk outputs, made anew every call.
CUMULATIVE = (SpikeCount, GroupRate)


def resolve(specs, *, n: int, n_projections: int,
            dt: float = 1.0) -> tuple[MonitorSpec, ...]:
    """Validate a monitor set at compile time; returns the resolved tuple.

    ``specs`` may be ``"default"`` (→ :data:`DEFAULT_MONITORS`), ``None``
    or ``()`` (no monitors), or an iterable of spec instances. Raises on
    duplicate names, probe ids outside ``[0, n)``, or degenerate
    stride/tau (a filter with ``tau_ms < dt`` has ``|1 − α| > 1`` and
    diverges): the reference's errors.
    """
    if isinstance(specs, str):
        if specs != "default":
            raise ValueError(f"unknown monitor preset {specs!r}")
        specs = DEFAULT_MONITORS
    if specs is None:
        specs = ()
    specs = tuple(specs)
    seen: set[str] = set()
    for s in specs:
        if not isinstance(s, (SpikeCount, GroupRate, VoltageProbe, WeightNorm)):
            raise TypeError(f"not a monitor spec: {s!r}")
        if s.name in seen:
            raise ValueError(f"duplicate monitor name {s.name!r}")
        seen.add(s.name)
        if isinstance(s, GroupRate) and not s.tau_ms >= dt:
            raise ValueError(
                f"GroupRate tau_ms must be >= dt ({dt} ms) for a stable "
                f"filter, got {s.tau_ms}")
        if isinstance(s, VoltageProbe):
            if not s.neurons:
                raise ValueError("VoltageProbe needs at least one neuron id")
            bad = [i for i in s.neurons if not 0 <= int(i) < n]
            if bad:
                raise ValueError(f"VoltageProbe ids out of range [0, {n}): {bad}")
        if isinstance(s, WeightNorm):
            if s.stride < 1:
                raise ValueError(f"WeightNorm stride must be >= 1, got {s.stride}")
            if n_projections == 0:
                raise ValueError("WeightNorm on a network with no projections")
    return specs


def n_snapshots(n_steps: int, stride: int) -> int:
    return -(-n_steps // stride)


def _slots(specs, n: int, n_projections: int, n_steps: int, lead=()):
    """(shape, dtype) of every spec's carry slot; None for VoltageProbe."""
    out = []
    for s in specs:
        if isinstance(s, SpikeCount):
            out.append(((*lead, n), torch.int32))
        elif isinstance(s, GroupRate):
            out.append(((*lead, n), f32))
        elif isinstance(s, VoltageProbe):
            out.append(None)
        else:
            out.append(((*lead, n_snapshots(n_steps, s.stride), n_projections), f32))
    return out


def carry_struct(specs: tuple[MonitorSpec, ...], n: int, n_projections: int,
                 n_steps: int) -> tuple:
    """Meta tensors (counted, never allocated) of all telemetry storage of
    an ``n_steps`` run: the accumulators and the probe rows, the peak
    monitor-state bytes that ``network.compile`` registers in the memory
    ledger (stage "7. Auxiliary Data"), O(N + probes·T + snapshots·P)."""
    out = []
    for s, slot in zip(specs, _slots(specs, n, n_projections, n_steps)):
        shape, dtype = slot if slot is not None else ((n_steps, len(s.neurons)), f32)
        out.append(torch.empty(shape, dtype=dtype, device="meta"))
    return tuple(out)


def init_carry(static, n_steps: int, *, device="cpu", lanes: int | None = None) -> tuple:
    """Zeroed accumulators aligned with ``static.monitors`` on ``device``
    (a leading ``[lanes]`` where given); VoltageProbe's slot is ``()``."""
    lead = () if lanes is None else (lanes,)
    return tuple(() if slot is None else torch.zeros(slot[0], dtype=slot[1], device=device)
                 for slot in _slots(static.monitors, static.n, len(static.projections),
                                    n_steps, lead))


def chunk_carry(static, carry: tuple | None, n_steps: int, *, device="cpu",
                lanes: int | None = None) -> tuple:
    """Telemetry carry for the next chunked call of ``n_steps`` ticks:
    cumulative slots resume from ``carry`` (zeroed when ``None``, a fresh
    session), per-chunk slots are made anew at the chunk's size. This is
    what ``repro_torch.serve`` feeds to ``run(tel_carry=...)``."""
    fresh = init_carry(static, n_steps, device=device, lanes=lanes)
    if carry is None:
        return fresh
    return tuple(c if isinstance(s, CUMULATIVE) else f
                 for s, c, f in zip(static.monitors, carry, fresh))


def _group_sums(static, c: torch.Tensor) -> np.ndarray:
    """Per-group int32 spike totals of ``[(B,) N]`` counts, on the host."""
    host = c.detach().cpu()
    return torch.stack([host[..., g.start:g.start + g.size].sum(dim=-1, dtype=torch.int32)
                        for g in static.groups], dim=-1).numpy()


def _group_means(static, c: torch.Tensor) -> np.ndarray:
    """Per-group f32 means of ``[(B,) N]`` filter levels, on the host, in
    the reference's compiled order: the group's sum in XLA CPU's order
    times ``float32(1 / size)``. Groups of one size are summed together
    (the order is per row), so a run's end costs a few dozen ops."""
    host = c.detach().cpu()
    out = torch.empty((*host.shape[:-1], len(static.groups)), dtype=f32)
    by_size: dict[int, list[int]] = {}
    for k, g in enumerate(static.groups):
        by_size.setdefault(g.size, []).append(k)
    for size, ks in by_size.items():
        rows = torch.stack([host[..., static.groups[k].start:static.groups[k].start + size]
                            for k in ks], dim=-2)
        out[..., ks] = xla_cpu_row_sum(rows) * torch.tensor(np.float32(1.0 / np.float32(size)))
    return out.numpy()


def flush_carry(static, carry: tuple) -> tuple[dict, tuple]:
    """Drain the cumulative accumulators to the host; returns
    ``(host_values, carry')`` (per-chunk slots pass through untouched).

    ``host_values`` maps monitor name → numpy array of per-group values
    (``[G]``, or ``[B, G]`` for a lane-batched carry), the same reductions
    :func:`collect` runs. ``SpikeCount`` is a windowed sum: the flushed
    counts are exact per-group totals since the previous flush and the
    slot re-zeros on its device, so the flushes of a chunk sequence sum to
    the uninterrupted run's totals. ``GroupRate`` is a filter level: the
    flush reports it and the filter state is kept (zeroing it would
    restart the EMA from 0). O(N) per flush.
    """
    out: dict = {}
    new = []
    for s, c in zip(static.monitors, carry):
        if isinstance(s, SpikeCount):
            out[s.name] = _group_sums(static, c)
            new.append(torch.zeros_like(c))
        elif isinstance(s, GroupRate):
            out[s.name] = _group_means(static, c)
            new.append(c)  # the filter level persists
        else:
            new.append(c)
    return out, tuple(new)


def rate_constants(static, spec: GroupRate) -> tuple[float, float]:
    """A GroupRate's ``(alpha, inst)``, each an f32 value held as a Python
    float: ``alpha = float32(dt / tau_ms)`` (the quotient in double,
    then rounded) and ``inst = float32(1000 / dt)``, the rate of a spike
    this tick."""
    return (float(np.float32(static.dt / spec.tau_ms)),
            float(np.float32(1000.0 / static.dt)))


def kernel_slots(static) -> tuple[int | None, int | None]:
    """The positions in ``static.monitors`` of the first SpikeCount and the
    first GroupRate (None where there is none): the two slots a neuron
    kernel folds into its launch."""
    count = next((k for k, s in enumerate(static.monitors) if isinstance(s, SpikeCount)), None)
    rate = next((k for k, s in enumerate(static.monitors) if isinstance(s, GroupRate)), None)
    return count, rate


def update(static, carry: tuple, i: int, spikes: torch.Tensor, v: torch.Tensor,
           weights: tuple, *, skip=()) -> tuple[tuple, tuple]:
    """One telemetry tick: fold this tick's spikes (``[(B,) N]`` bool or
    f32 0/1), stored membrane potentials ``v`` and weights
    (``NetState.weights``' layout, a leading ``[B]`` over lanes) into the
    accumulators, in place on the carry's tensors (the run's own).
    Returns ``(carry, ys)`` with ``ys`` aligned to ``static.monitors``:
    a VoltageProbe's f32 row, None for the others. The monitors at the
    positions in ``skip`` are left alone (a kernel folds them).

    ``i`` is the local step index within the run (0-based): a WeightNorm
    snapshots the norms of the weights after this tick's plasticity at
    ``i % stride == 0`` into row ``i // stride``. The GroupRate fold is
    ``c + alpha * (inst - c)`` with ``inst = spikes * float32(1000/dt)``,
    every operation rounded on its own.
    """
    ys = []
    for k, (s, c) in enumerate(zip(static.monitors, carry)):
        y = None
        if k in skip:
            pass
        elif isinstance(s, SpikeCount):
            c += spikes.to(torch.int32)
        elif isinstance(s, GroupRate):
            rate_fold_ref(c, spikes, *rate_constants(static, s))
        elif isinstance(s, VoltageProbe):
            y = torch.index_select(v, -1, _probe_ids(s.neurons, v.device)).to(f32)
        elif isinstance(s, WeightNorm) and i % s.stride == 0:
            c[..., i // s.stride, :] = weight_norms(weights, c.dim() - 2)
        ys.append(y)
    return carry, tuple(ys)


@functools.lru_cache(maxsize=64)
def _probe_ids(neurons: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A probe's ids as an int64 tensor on ``device``, made once."""
    return torch.tensor(neurons, dtype=torch.int64, device=device)


def weight_norms(weights: tuple, lead: int = 0) -> torch.Tensor:
    """``[(B,) P]`` f32 L2 norms of the weights (each ``[(B,) ...]``, ``lead``
    leading lane dimensions): each projection's squares summed in XLA
    CPU's nested-window order over its flattened entries, the same order
    on either device."""
    return torch.stack([
        torch.sqrt(xla_cpu_row_sum(torch.square(w.to(f32)).flatten(start_dim=lead)))
        for w in weights], dim=-1)


def collect(static, carry: tuple, ys: tuple) -> dict:
    """The telemetry output dict ``{name: tensor}`` from the final carry
    and the stacked per-tick rows ``ys`` (a VoltageProbe's ``[(B,) T, k]``,
    None elsewhere). The per-group reductions happen here, once per run,
    on the host (CPU tensors: ``[(B,) G]``); probe rows and WeightNorm
    snapshots stay on their device."""
    out = {}
    for s, c, y in zip(static.monitors, carry, ys):
        if isinstance(s, SpikeCount):
            out[s.name] = torch.from_numpy(_group_sums(static, c))
        elif isinstance(s, GroupRate):
            out[s.name] = torch.from_numpy(_group_means(static, c))
        elif isinstance(s, VoltageProbe):
            out[s.name] = y
        else:
            out[s.name] = c
    return out


def summarize(static, telemetry: dict, n_steps: int) -> dict:
    """Host-side summary of a telemetry output dict (the streaming
    counterpart of ``repro_torch.core.monitors.population_summary``).

    Group rates go through
    :func:`repro_torch.telemetry.metrics.rate_from_count`, the expression
    the post-hoc raster path uses, so for a run of equal length the two
    are bit-for-bit identical.
    """
    from repro_torch.telemetry.metrics import rate_from_count

    out: dict = {
        "n_ticks": int(n_steps),
        "model_time_s": n_steps * static.dt / 1000.0,
    }
    for spec in static.monitors:
        val = telemetry[spec.name]
        val = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
        if isinstance(spec, SpikeCount):
            out["group_spike_counts"] = {
                g.name: int(c) for g, c in zip(static.groups, val)
            }
            out["total_spikes"] = int(val.sum())
            out["group_rates"] = {
                g.name: rate_from_count(c, g.size, n_steps, static.dt)
                for g, c in zip(static.groups, val)
            }
            out["mean_rate_hz"] = rate_from_count(
                int(val.sum()), static.n, n_steps, static.dt)
        elif isinstance(spec, GroupRate):
            out["group_rate_filtered_hz"] = {
                g.name: float(r) for g, r in zip(static.groups, val)
            }
        else:  # VoltageProbe / WeightNorm: pass the array through
            out[spec.name] = val
    return out
