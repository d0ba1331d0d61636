"""In-run watchpoints — health sentinels riding every run of a net.

The reference's ``repro.obs.watch`` on torch tensors. On a deployed MCU
there is no debugger: the runtime itself must notice when a tenant goes
wrong (NaN'd fp16 state, runaway or silent spiking, plastic weight
divergence) and say so *without* perturbing the simulation. Watches
follow the telemetry monitors' pattern (:mod:`repro_torch.telemetry.
monitors`): a compile-time spec tuple on ``NetStatic.watches``, folded
through every tick of a run as O(1)-memory reductions over the tick's
observables. They are pure reads of the tick's output, so rasters, state,
weights and telemetry are bitwise identical with watches compiled in or
out, and their verdicts drain on the host at chunk/flush boundaries only.

Specs
-----
- :class:`NonFinite` — NaN/Inf sentinel on the stored membrane state
  every tick and on plastic weights every ``weight_stride`` ticks. The
  fp16 poisoned-lane detector.
- :class:`RateBand` — per-group mean firing rate must sit in
  ``[lo_hz, hi_hz]`` over the drained window (runaway detection).
- :class:`WeightDrift` — relative L2 drift of each projection's weights vs
  its compile-time baseline (``compile()`` fills the baseline from
  ``state0``, with the expression ``telemetry.WeightNorm`` reports).
- :class:`Silent` — longest run of consecutive zero-spike ticks; a network
  that has died reports it even though nothing is NaN.

The carry has the reference's layout and dtypes, one slot tuple per spec,
with a leading ``[B]`` over lanes: NonFinite ``(bad_v, bad_w)`` int32,
RateBand ``(counts [N] int32, ticks int32)``, WeightDrift ``(norms [P]
f32,)``, Silent ``(run, max_run)`` int32. Shapes do not depend on the
chunk length, so the same accumulators ride any chunking
(``serve.LaneScheduler`` stacks one carry per lane).

Where a run ticks through a neuron kernel (``izh4_update``'s run entry,
the ``fused_tick`` kernel), the first RateBand, Silent and NonFinite fold
inside its launch (:func:`kernel_slots`): the RateBand as a count per
neuron, the Silent and the NonFinite as per-lane words kept with plain
stores, no atomics (:func:`kernel_words`, converted from and back to the
carry once per run; ``common.cuh``'s ``watch_mark`` and ``watch_fold``),
so the default set adds no device operation per tick. The plastic-weight
half of NonFinite and WeightDrift run as plain ops on their stride's
ticks, as does every watch of a net without such a kernel (:func:`update`
is the reference's plain fold).
:func:`drain` is host-side and returns typed :class:`WatchVerdict`
records plus the reset carry for the next window.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "NonFinite", "RateBand", "WeightDrift", "Silent", "WatchSpec",
    "WatchVerdict", "DEFAULT_WATCHES", "resolve", "carry_struct",
    "init_carry", "update", "drain", "alert", "kernel_slots", "kernel_words",
    "carry_from_words",
]

_EPS = 1e-9
i32 = torch.int32


@dataclasses.dataclass(frozen=True)
class NonFinite:
    """NaN/Inf sentinel: membrane state every tick, plastic weights every
    ``weight_stride`` ticks (strided like ``telemetry.WeightNorm``: the
    weight reduction is O(nnz), the state check is O(N))."""
    weight_stride: int = 100
    name: str = "nonfinite"


@dataclasses.dataclass(frozen=True)
class RateBand:
    """Per-group mean rate must sit inside ``[lo_hz, hi_hz]`` over the
    drained window. The default band only catches runaway activity; set
    ``lo_hz`` > 0 to also require a minimum rate."""
    lo_hz: float = 0.0
    hi_hz: float = 1000.0
    name: str = "rate_band"


@dataclasses.dataclass(frozen=True)
class WeightDrift:
    """Relative L2 drift of each projection's weights vs the compile-time
    baseline: trips when ``|‖w‖ - ‖w₀‖| / ‖w₀‖ > limit`` for any
    projection. ``baseline`` is filled by ``compile()`` from ``state0``
    (the expression ``telemetry.WeightNorm`` reports)."""
    limit: float = 0.5
    stride: int = 100
    baseline: tuple[float, ...] | None = None
    name: str = "weight_drift"


@dataclasses.dataclass(frozen=True)
class Silent:
    """Trips when the network produced zero spikes for ``window``
    consecutive ticks anywhere in the drained window."""
    window: int = 500
    name: str = "silent"


WatchSpec = NonFinite | RateBand | WeightDrift | Silent

#: The serving-plane default: poisoned-state detection, runaway-rate band,
#: and dead-network detection. ``WeightDrift`` is opt-in (it needs plastic
#: projections to be meaningful).
DEFAULT_WATCHES: tuple[WatchSpec, ...] = (NonFinite(), RateBand(), Silent())


@dataclasses.dataclass(frozen=True)
class WatchVerdict:
    """One drained watch verdict — the typed alert record."""
    watch: str  # spec name (unique per compiled net)
    kind: str  # spec class name
    tripped: bool
    value: float  # measured quantity (count, rate, drift, run length)
    limit: float  # the violated (or guarding) bound
    detail: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def resolve(specs, *, n: int, n_projections: int, dt: float = 1.0,
            baseline_norms: tuple[float, ...] | None = None,
            ) -> tuple[WatchSpec, ...]:
    """Validate and normalize a watch request at compile time.

    ``specs`` may be None (no watches), ``"default"`` (:data:`DEFAULT_WATCHES`),
    a single spec, or a tuple of specs. ``baseline_norms`` (one L2 norm per
    projection, from ``state0``) fills any :class:`WeightDrift` whose
    ``baseline`` was left None. The reference's errors.
    """
    if specs is None:
        return ()
    if specs == "default":
        specs = DEFAULT_WATCHES
    if isinstance(specs, WatchSpec):
        specs = (specs,)
    specs = tuple(specs)

    seen: set[str] = set()
    out = []
    for s in specs:
        if not isinstance(s, WatchSpec):
            raise ValueError(f"not a watch spec: {s!r}")
        if s.name in seen:
            raise ValueError(f"duplicate watch name {s.name!r}")
        seen.add(s.name)
        if isinstance(s, NonFinite):
            if s.weight_stride < 1:
                raise ValueError(f"{s.name}: weight_stride must be >= 1")
        elif isinstance(s, RateBand):
            if not (0.0 <= s.lo_hz <= s.hi_hz):
                raise ValueError(
                    f"{s.name}: need 0 <= lo_hz <= hi_hz, "
                    f"got [{s.lo_hz}, {s.hi_hz}]")
        elif isinstance(s, WeightDrift):
            if s.stride < 1:
                raise ValueError(f"{s.name}: stride must be >= 1")
            if s.limit <= 0.0:
                raise ValueError(f"{s.name}: limit must be > 0")
            if n_projections == 0:
                raise ValueError(f"{s.name}: network has no projections")
            if s.baseline is None:
                if baseline_norms is None:
                    raise ValueError(
                        f"{s.name}: no baseline and no baseline_norms")
                s = dataclasses.replace(
                    s, baseline=tuple(float(b) for b in baseline_norms))
            if len(s.baseline) != n_projections:
                raise ValueError(
                    f"{s.name}: baseline has {len(s.baseline)} entries "
                    f"for {n_projections} projections")
        elif isinstance(s, Silent):
            if s.window < 1:
                raise ValueError(f"{s.name}: window must be >= 1")
        out.append(s)
    return tuple(out)


def _slots(specs, n: int, n_projections: int, lead=()) -> list[list]:
    """(shape, dtype) of every spec's carry slots, a list per spec."""
    out = []
    for s in specs:
        if isinstance(s, RateBand):
            out.append([((*lead, n), i32), (lead, i32)])
        elif isinstance(s, WeightDrift):
            out.append([((*lead, n_projections), torch.float32)])
        else:  # NonFinite, Silent: two int32 scalars
            out.append([(lead, i32), (lead, i32)])
    return out


def carry_struct(specs, n: int, n_projections: int) -> tuple:
    """Meta tensors (counted, never allocated) of the watch carry, flat, for
    the memory ledger. Shapes are chunk-length independent."""
    return tuple(torch.empty(shape, dtype=dtype, device="meta")
                 for slots in _slots(specs, n, n_projections) for shape, dtype in slots)


def init_carry(static, *, device="cpu", lanes: int | None = None) -> tuple:
    """Fresh accumulators for ``static.watches``, one slot tuple per spec,
    on ``device`` (a leading ``[lanes]`` where given): zeros, but a
    WeightDrift's norms, which start at its baseline."""
    lead = () if lanes is None else (lanes,)
    carry = []
    for s, slots in zip(static.watches,
                        _slots(static.watches, static.n, len(static.projections), lead)):
        if isinstance(s, WeightDrift):
            base = torch.tensor(s.baseline, dtype=torch.float32, device=device)
            carry.append((base.expand(*lead, -1).clone(),))
        else:
            carry.append(tuple(torch.zeros(shape, dtype=dtype, device=device)
                               for shape, dtype in slots))
    return tuple(carry)


def _l2(weights: tuple, lead: int) -> torch.Tensor:
    """``[(B,) P]`` L2 norms: ``telemetry.WeightNorm``'s expression, so
    drift baselines and live norms are computed identically."""
    from repro_torch.telemetry.monitors import weight_norms

    return weight_norms(weights, lead)


def _plastic_finite(static, weights: tuple, lead: int) -> torch.Tensor | None:
    """``[(B,)]`` bool: every plastic projection's weights finite (None for
    a net without plastic projections)."""
    plastic = [w for w, cfg in zip(weights, static.stdp) if cfg is not None]
    if not plastic:
        return None
    ok = None
    for w in plastic:
        fin = torch.isfinite(w).flatten(start_dim=lead).all(dim=-1)
        ok = fin if ok is None else ok & fin
    return ok


def update(static, carry: tuple, i: int, spikes: torch.Tensor, v: torch.Tensor,
           weights: tuple) -> tuple:
    """One watch tick, the reference's plain fold: this tick's observables
    into new accumulators (the carry's tensors are left as they were).

    Pure reads of the tick's output. ``i`` is the local step index of the
    run (strided checks), ``spikes`` the ``[(B,) N]`` spike row (bool or f32
    0/1), ``v`` the stored membrane ``[(B,) N]`` and ``weights`` the
    post-plasticity weights in ``NetState.weights``' layout.
    """
    if spikes.dtype != torch.bool:
        spikes = spikes != 0
    lead = spikes.dim() - 1
    new = []
    for s, c in zip(static.watches, carry):
        if isinstance(s, NonFinite):
            bad_v, bad_w = c
            bad_v = bad_v + (~torch.isfinite(v).all(dim=-1)).to(i32)
            if i % s.weight_stride == 0:
                ok = _plastic_finite(static, weights, lead)
                if ok is not None:
                    bad_w = bad_w + (~ok).to(i32)
            new.append((bad_v, bad_w))
        elif isinstance(s, RateBand):
            counts, ticks = c
            new.append((counts + spikes.to(i32), ticks + 1))
        elif isinstance(s, WeightDrift):
            (norms,) = c
            if i % s.stride == 0:
                norms = _l2(weights, lead)
            new.append((norms,))
        elif isinstance(s, Silent):
            run, max_run = c
            run = torch.where(spikes.any(dim=-1), 0, run + 1).to(i32)
            new.append((run, torch.maximum(max_run, run)))
    return tuple(new)


def kernel_slots(static) -> tuple[int | None, int | None, int | None]:
    """The positions in ``static.watches`` of the first RateBand, Silent and
    NonFinite (None where there is none): the watches a neuron kernel
    folds into its launch."""
    def first(kind):
        return next((k for k, s in enumerate(static.watches) if isinstance(s, kind)), None)

    return first(RateBand), first(Silent), first(NonFinite)


def kernel_words(spec, slot: tuple) -> torch.Tensor:
    """The per-lane words ``[(B,) 4]`` int32 a run keeps for a Silent or a
    NonFinite spec from its carry slot, which the kernels (``common.cuh``'s
    ``watch_mark`` and ``watch_fold``) and
    :func:`repro_torch.kernels.ref.watch_fold_ref` fold tick by tick:

    * Silent ``(run, max_run)`` → ``{last, gap, 0, 0} = {-1 - run,
      max_run, 0, 0}``: ``last`` the local step of the last spike (a run of
      ``run`` silent ticks before step 0 puts it at ``-1 - run``), ``gap``
      the longest silent run closed by a spike;
    * NonFinite ``(bad_v, bad_w)`` → ``{ticks, 0, 0, 0} = {bad_v, 0, 0, 0}``.

    Words 2 and 3 are the flags of the even and odd steps: a tick sets its
    parity's flag where a neuron spiked (had a non-finite membrane), and
    the next tick folds it into the first two words and clears it; the last
    tick's flag is folded by :func:`carry_from_words`.
    """
    first, second = slot
    zero = torch.zeros_like(first)
    if isinstance(spec, Silent):
        return torch.stack([-1 - first, second, zero, zero], dim=-1).to(i32).contiguous()
    return torch.stack([first, zero, zero, zero], dim=-1).to(i32).contiguous()


def carry_from_words(spec, words: torch.Tensor, slot: tuple, n_steps: int) -> tuple:
    """The carry slot after an ``n_steps``-tick run from its words (the
    inverse of :func:`kernel_words`, ``slot`` the run's first carry), the
    last tick's flag folded first: a Silent's run is the steps since the
    last spike, ``n_steps - 1 - last``, and its longest run the larger of
    ``gap`` and that; a NonFinite's ``bad_v`` is the tick count and its
    ``bad_w`` the slot's."""
    if n_steps == 0:
        return slot
    last_step = n_steps - 1
    flag = words[..., 2 + (last_step & 1)] != 0
    if isinstance(spec, Silent):
        last, gap = words[..., 0], words[..., 1]
        if last_step > 0:
            gap = torch.where(flag, torch.maximum(gap, last_step - 1 - last), gap)
        last = torch.where(flag, last_step, last)
        run = (last_step - last).to(i32)
        return run, torch.maximum(gap, run).to(i32)
    return (words[..., 0] + flag).to(i32), slot[1]


def _value(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def drain(static, carry: tuple) -> tuple[list[WatchVerdict], tuple]:
    """Host-side verdict pass: evaluate each watch over the accumulated
    window and reset the window. Returns ``(verdicts, carry')`` where
    ``carry'`` starts the next window (level quantities — drift norms, the
    current silent run — persist; window counters reset), as tensors on
    the carry's device. One lane's carry (no leading ``[B]``). The
    reference's verdicts, field for field.
    """
    verdicts: list[WatchVerdict] = []
    new: list = []
    for s, c in zip(static.watches, carry):
        dev = c[0].device if isinstance(c[0], torch.Tensor) else "cpu"

        def zero(like=None):
            return torch.zeros(() if like is None else _value(like).shape, dtype=i32,
                               device=dev)

        if isinstance(s, NonFinite):
            bad_v = int(_value(c[0]))
            bad_w = int(_value(c[1]))
            verdicts.append(WatchVerdict(
                s.name, "NonFinite", bad_v + bad_w > 0,
                float(bad_v + bad_w), 0.0,
                f"{bad_v} tick(s) with non-finite neuron state, "
                f"{bad_w} strided check(s) with non-finite plastic weights"))
            new.append((zero(), zero()))
        elif isinstance(s, RateBand):
            counts = _value(c[0])
            ticks = int(_value(c[1]))
            offending: list[str] = []
            worst, bound = 0.0, s.hi_hz
            if ticks:
                for g in static.groups:
                    n_sp = float(counts[g.start:g.start + g.size].sum())
                    rate = 1000.0 * n_sp / (g.size * ticks * static.dt)
                    if not (s.lo_hz <= rate <= s.hi_hz):
                        offending.append(f"{g.name}={rate:.1f}Hz")
                        dev_hz = abs(rate - (s.hi_hz if rate > s.hi_hz else s.lo_hz))
                        if dev_hz >= worst:
                            worst, bound = rate, (s.hi_hz if rate > s.hi_hz else s.lo_hz)
            verdicts.append(WatchVerdict(
                s.name, "RateBand", bool(offending), worst, bound,
                ("groups outside band: " + ", ".join(offending))
                if offending else
                f"all groups in [{s.lo_hz}, {s.hi_hz}] Hz over {ticks} ticks"))
            new.append((zero(c[0]), zero()))
        elif isinstance(s, WeightDrift):
            norms = _value(c[0]).astype(np.float64)
            base = np.asarray(s.baseline, np.float64)
            rel = np.abs(norms - base) / np.maximum(np.abs(base), _EPS)
            j = int(rel.argmax()) if rel.size else 0
            tripped = bool(rel.size and rel[j] > s.limit)
            verdicts.append(WatchVerdict(
                s.name, "WeightDrift", tripped,
                float(rel[j]) if rel.size else 0.0, s.limit,
                f"max relative drift {float(rel[j]):.4f} at projection {j} "
                f"(‖w‖ {float(norms[j]):.4f} vs baseline {float(base[j]):.4f})"
                if rel.size else "no projections"))
            new.append((torch.as_tensor(_value(c[0]), device=dev).clone(),))  # a level: kept
        elif isinstance(s, Silent):
            run = int(_value(c[0]))
            max_run = int(_value(c[1]))
            verdicts.append(WatchVerdict(
                s.name, "Silent", max_run >= s.window, float(max_run),
                float(s.window),
                f"longest zero-spike run {max_run} tick(s) "
                f"(window {s.window})"))
            cur = torch.tensor(run, dtype=i32, device=dev)
            new.append((cur, cur.clone()))  # the current run persists; the max resets
    return verdicts, tuple(new)


def alert(verdicts, **labels) -> list[WatchVerdict]:
    """Publish tripped verdicts to the obs plane (typed tracer events +
    Prometheus counters) and return them. ``labels`` (rung, session, ...)
    tag both the events and the counters (the counters by ``rung`` only)."""
    from repro_torch import obs

    tripped = [v for v in verdicts if v.tripped]
    for v in tripped:
        obs.event("watch_trip", watch=v.watch, kind=v.kind, value=v.value,
                  limit=v.limit, detail=v.detail, **labels)
        obs.inc("repro_watch_trips_total", watch=v.watch,
                **{k: v_ for k, v_ in labels.items() if k == "rung"})
    return tripped
