"""Serving sessions: unbounded horizons as chunk sequences.

A :class:`Session` owns one network's live state (the ``NetState``:
membrane variables, delay ring, plastic weights, traces) and advances it
by chunks: every :meth:`Session.run` feeds the previous call's state back
into ``Engine.run`` with the session's counter-keyed generator stream
(``run(gen_base=...)``), so tick t's stimulus is ``uniform(fold_in(key,
t))`` with t the absolute tick, and k chunks of T/k ticks give the raster,
weights and final state of one uninterrupted run of T ticks, bit for bit
(homeostasis included, as long as every chunk is a multiple of its
period, which ``run`` enforces).

A session's in-run monitors (``record="monitors"``, the default) keep
their cumulative accumulators on the device between calls
(:class:`SessionMonitors`); nothing crosses to the host until a
:meth:`Session.flush`, whose spike counts over a chunk sequence sum to
the uninterrupted run's totals bit for bit.

A session over a net compiled with watches threads their accumulators
through every chunk (``watch_carry``); :meth:`Session.check_watches`
drains them and publishes the tripped verdicts to :mod:`repro_torch.obs`.
Every chunk reports a ``step_chunk`` span and the serving latency
histograms (the host's enqueue of the chunk: the device is not
synchronized), every flush a ``flush`` span and
``repro_serve_flushes_total``, all with ``rung="solo"``.

Sessions are what :class:`repro_torch.serve.LaneScheduler` multiplexes
onto lanes and what :mod:`repro_torch.serve.lifecycle` checkpoints.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
from repro_torch.core import rng
from repro_torch.core.engine import Engine
from repro_torch.core.network import CompiledNetwork, NetState
from repro_torch.obs import watch as wat
from repro_torch.obs.metrics import us_per_tick
from repro_torch.telemetry import monitors as tel

__all__ = ["Session", "SessionMonitors"]


class SessionMonitors:
    """Flushable telemetry accumulators that persist across chunked calls.

    Holds the raw cumulative carry slots (``SpikeCount`` / ``GroupRate``
    per-neuron accumulators) on the device between ``run`` calls;
    :meth:`flush` drains them to the host as per-group values. Spike counts
    re-zero on the device (windowed sums since the last flush); the
    ``GroupRate`` filter level is reported and kept
    (``telemetry.monitors.flush_carry``). Per-chunk monitors
    (``VoltageProbe`` rows, ``WeightNorm`` snapshots) are made anew every
    chunk and come back in each call's ``outputs["telemetry"]``.
    """

    def __init__(self, static, device):
        self.static = static
        self.device = device
        self.carry: tuple | None = None  # None until the first chunk runs
        self.ticks_since_flush = 0

    def chunk_carry(self, n_ticks: int) -> tuple:
        """The ``tel_carry`` to feed the next ``run`` call of ``n_ticks``."""
        return tel.chunk_carry(self.static, self.carry, n_ticks, device=self.device)

    def absorb(self, carry: tuple, n_ticks: int) -> None:
        """Take the raw final carry handed back by ``run``, keeping only the
        cumulative slots (``()`` elsewhere), so the persistent carry's
        structure does not depend on the chunk size."""
        self.carry = tuple(c if isinstance(s, tel.CUMULATIVE) else ()
                           for s, c in zip(self.static.monitors, carry))
        self.ticks_since_flush += n_ticks

    def flush(self) -> dict:
        """Drain the cumulative accumulators to the host: ``{monitor name:
        per-group numpy array, "n_ticks": ticks since the previous
        flush}``. O(N) per flush, whatever the ticks elapsed."""
        if self.carry is None:
            raise RuntimeError("flush() before any chunk has run")
        with obs.span("flush", scope="session"):
            values, self.carry = tel.flush_carry(self.static, self.carry)
            values["n_ticks"] = self.ticks_since_flush
            self.ticks_since_flush = 0
        obs.inc("repro_serve_flushes_total", rung="solo")
        return values


@dataclasses.dataclass
class Session:
    """One tenant's simulation on the net's device, advanced chunk by chunk.

    Build with :meth:`create`; drive with :meth:`run`; persist with
    ``repro_torch.serve.lifecycle.save_session`` / ``restore_session``.
    ``gen_key`` is the base of the generator stream (an int32 ``[2]`` key,
    as :mod:`repro_torch.core.rng` makes); ``monitors`` its
    :class:`SessionMonitors` (None without monitors). Drain telemetry with
    :meth:`flush`, watches with :meth:`check_watches`.
    """

    engine: Engine
    gen_key: torch.Tensor
    state: NetState
    monitors: SessionMonitors | None = None
    ticks: int = 0  # ticks served so far (the state's t)
    # The raw watch accumulators of a net compiled with watches, threaded
    # through every run() and drained by check_watches(); None until the
    # first chunk runs.
    watch_carry: tuple | None = None

    @classmethod
    def create(cls, net: CompiledNetwork | Engine, *, seed: int = 0,
               key: torch.Tensor | None = None, state: NetState | None = None,
               monitors: bool = True) -> "Session":
        """A new session over a compiled network (or an ``Engine``).
        ``seed`` or ``key`` names the session's stimulus stream; ``state``
        resumes from an existing ``NetState`` (an evicted lane, a restored
        checkpoint). ``monitors`` keeps the net's in-run monitors (where it
        has any) in a :class:`SessionMonitors`."""
        engine = net if isinstance(net, Engine) else Engine(net)
        state = state if state is not None else engine.net.state0
        if key is None:
            key = rng.key(seed, state.ring.device)
        static = engine.net.static
        mon = (SessionMonitors(static, state.ring.device)
               if monitors and static.monitors else None)
        return cls(engine=engine, gen_key=key, state=state, monitors=mon, ticks=int(state.t))

    @classmethod
    def from_snapshot(cls, net: CompiledNetwork | Engine, snap) -> "Session":
        """Continue an exported scheduler lane (a
        :class:`repro_torch.serve.LaneSnapshot`) as a solo session: its
        cumulative telemetry and flush counter land in ``monitors``, so the
        next flush reports what the still-scheduled tenant's would."""
        session = cls.create(net, key=snap.gen_key, state=snap.state)
        session.ticks = snap.ticks
        if session.monitors is not None and snap.tel is not None:
            session.monitors.carry = tuple(snap.tel)
            session.monitors.ticks_since_flush = snap.ticks_since_flush
        return session

    def run(self, n_ticks: int, *, record: str = "monitors", **kw) -> dict:
        """Advance the session ``n_ticks``; returns the chunk's outputs.

        ``record="monitors"`` (default) is the serving mode: no ``[T, N]``
        raster exists, and the cumulative telemetry persists in
        ``monitors`` until flushed; ``"both"`` adds the raster;
        ``"raster"`` returns the chunk's ``[T, N]`` raster and ``"none"``
        runs bare."""
        want_mon = record in ("monitors", "both")
        if want_mon:
            if self.monitors is None:
                raise ValueError(
                    "session created with monitors=False (or a monitor-free network) "
                    "cannot record='monitors'")
            kw["tel_carry"] = self.monitors.chunk_carry(n_ticks)
            kw["return_tel_carry"] = True
        want_watch = bool(self.engine.net.static.watches)
        if want_watch and self.watch_carry is not None:
            kw["watch_carry"] = self.watch_carry
        with obs.span("step_chunk", scope="session", n_ticks=n_ticks, record=record) as sp:
            self.state, out = self.engine.run(n_ticks, state=self.state, record=record,
                                              gen_base=self.gen_key, **kw)
        if sp is not None:
            obs.observe("repro_serve_chunk_latency_ms", sp.dur_s * 1e3, scope="session",
                        rung="solo")
            obs.observe("repro_serve_us_per_tick", us_per_tick(sp.dur_s, n_ticks),
                        scope="session", rung="solo")
        if want_mon:
            self.monitors.absorb(out.pop("tel_carry"), n_ticks)
        if want_watch:
            self.watch_carry = out.pop("watch_carry")
        self.ticks += n_ticks
        return out

    def check_watches(self) -> list:
        """Drain the session's watch accumulators: returns every verdict
        (tripped or not) and publishes the tripped ones to the obs plane
        (``watch_trip`` events and counters, ``rung="solo"``); the drained
        window restarts. An empty list until a chunk has run."""
        if not self.engine.net.static.watches:
            raise ValueError("network compiled without watches — pass watches=... "
                             "(e.g. 'default') to compile()")
        if self.watch_carry is None:
            return []
        verdicts, self.watch_carry = wat.drain(self.engine.net.static, self.watch_carry)
        wat.alert(verdicts, rung="solo")
        return verdicts

    def flush(self) -> dict:
        """Shorthand for ``self.monitors.flush()``."""
        if self.monitors is None:
            raise ValueError("session has no monitors")
        return self.monitors.flush()

    def spike_raster(self, n_ticks: int, **kw) -> torch.Tensor:
        """Advance ``n_ticks``, returning the chunk's ``[T, N]`` bool raster
        (on the net's device)."""
        return self.run(n_ticks, record="raster", **kw)["spikes"]
