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

Sessions are what :class:`repro_torch.serve.LaneScheduler` multiplexes
onto lanes and what :mod:`repro_torch.serve.lifecycle` checkpoints. The
in-run monitors of a session (``record="monitors"``, ``SessionMonitors``,
``flush``) wait for the telemetry port (ROADMAP A6) and its watchpoints
(``check_watches``) for the observability port (ROADMAP A10).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import rng
from repro_torch.core.engine import Engine
from repro_torch.core.network import CompiledNetwork, NetState

__all__ = ["Session"]


@dataclasses.dataclass
class Session:
    """One tenant's simulation on the net's device, advanced chunk by chunk.

    Build with :meth:`create`; drive with :meth:`run`; persist with
    ``repro_torch.serve.lifecycle.save_session`` / ``restore_session``.
    ``gen_key`` is the base of the generator stream (an int32 ``[2]`` key,
    as :mod:`repro_torch.core.rng` makes); ``monitors`` is always None
    here (ROADMAP A6).
    """

    engine: Engine
    gen_key: torch.Tensor
    state: NetState
    monitors: None = None
    ticks: int = 0  # ticks served so far (the state's t)

    @classmethod
    def create(cls, net: CompiledNetwork | Engine, *, seed: int = 0,
               key: torch.Tensor | None = None, state: NetState | None = None,
               monitors: bool = True) -> "Session":
        """A new session over a compiled network (or an ``Engine``).
        ``seed`` or ``key`` names the session's stimulus stream; ``state``
        resumes from an existing ``NetState`` (an evicted lane, a restored
        checkpoint). ``monitors`` is accepted for the reference's signature:
        the port's nets carry no monitors yet, so a session has none."""
        engine = net if isinstance(net, Engine) else Engine(net)
        state = state if state is not None else engine.net.state0
        if key is None:
            key = rng.key(seed, state.ring.device)
        return cls(engine=engine, gen_key=key, state=state, ticks=int(state.t))

    @classmethod
    def from_snapshot(cls, net: CompiledNetwork | Engine, snap) -> "Session":
        """Continue an exported scheduler lane (a
        :class:`repro_torch.serve.LaneSnapshot`) as a solo session."""
        session = cls.create(net, key=snap.gen_key, state=snap.state)
        session.ticks = snap.ticks
        return session

    def run(self, n_ticks: int, *, record: str = "monitors", **kw) -> dict:
        """Advance the session ``n_ticks``; returns the chunk's outputs.

        ``record="raster"`` returns the chunk's ``[T, N]`` raster and
        ``"none"`` runs bare; the reference's default, ``"monitors"``
        (and ``"both"``), raises ``NotImplementedError`` until the
        telemetry port (ROADMAP A6)."""
        if record in ("monitors", "both"):
            raise NotImplementedError(
                f"Session.run(record={record!r}): in-run monitors and flushable session "
                "telemetry are not ported to repro_torch yet (ROADMAP A6); use "
                "record='raster' or 'none'")
        self.state, out = self.engine.run(n_ticks, state=self.state, record=record,
                                          gen_base=self.gen_key, **kw)
        self.ticks += n_ticks
        return out

    def check_watches(self) -> list:
        raise NotImplementedError("Session.check_watches: in-run watchpoints are not "
                                  "ported to repro_torch yet (ROADMAP A10)")

    def flush(self) -> dict:
        raise ValueError("session has no monitors")

    def spike_raster(self, n_ticks: int, **kw) -> torch.Tensor:
        """Advance ``n_ticks``, returning the chunk's ``[T, N]`` bool raster
        (on the net's device)."""
        return self.run(n_ticks, record="raster", **kw)["spikes"]
