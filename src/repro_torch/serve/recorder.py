"""Post-mortem replay — re-run a recorded lane window bit for bit.

The reference's ``repro.serve.recorder``. The flight recorder
(``LaneScheduler(flight_window=K)``) keeps the last K chunk-boundary
:class:`~repro_torch.serve.LaneSnapshot` s per tenant; when a watchpoint
trips and the tenant is quarantined, those snapshots are the evidence.
:func:`replay` turns one of them back into a live solo
:class:`~repro_torch.serve.Session` and advances it. A lane snapshot
carries everything the chunking guarantee needs (the state, the
counter-keyed generator base, the absolute tick), so the replay gives the
lane's window bit for bit: the same spikes, plastic weights and final
state as the lane produced live. A replay can therefore record more than
serving ever paid for: ``record="raster"`` for the full ``[T, N]`` spike
picture.
"""
from __future__ import annotations

from repro_torch import obs
from repro_torch.core.engine import Engine
from repro_torch.core.network import CompiledNetwork
from repro_torch.serve.scheduler import LaneSnapshot
from repro_torch.serve.session import Session

__all__ = ["replay"]


def replay(net: CompiledNetwork | Engine, snap: LaneSnapshot, n_ticks: int, *,
           record: str = "raster", **kw):
    """Re-run ``n_ticks`` from a recorded snapshot; returns ``(session,
    outputs)``.

    ``net`` must be the compiled network the snapshot came from (or an
    :class:`Engine` over it): the snapshot's state is written back as it
    is. ``record`` defaults to ``"raster"``; other keyword arguments pass
    through to :meth:`Session.run`. Tick ``snap.ticks + i`` here is tick
    ``snap.ticks + i`` of the lane: the stimulus is keyed by
    ``(snap.gen_key, absolute tick)`` and the state carries the ring's
    phase and the plasticity traces.
    """
    session = Session.from_snapshot(net, snap)
    with obs.span("replay", session=snap.session_id, from_tick=snap.ticks, n_ticks=n_ticks):
        out = session.run(n_ticks, record=record, **kw)
    obs.event("replay", session=snap.session_id, from_tick=snap.ticks, n_ticks=n_ticks,
              record=record)
    return session, out
