"""Multi-tenant lane scheduler: same-topology sessions on the lanes of one run.

N tenants whose networks share one compiled topology (the same
``NetStatic`` and ``NetParams``) live in the lanes of one batched
``NetState`` (:mod:`repro_torch.core.lanes`): each lane has its own
membrane state, delay ring, weights and traces, its own tick, its own
counter-keyed generator stream and its own ``active`` flag.
:meth:`LaneScheduler.step` advances every lane one chunk. On a
:func:`repro_torch.core.engine.batched_route` net that chunk is one tick
loop for all lanes, one launch per kernel per tick (``izh4_update`` over
every lane, ``syn_gather`` or the dense buckets' ``syn_matmul`` over every
lane's own weight tables; on a plastic or STP net one ``plastic_drive``,
``stdp_gather`` and ``stdp_update`` over every lane's own plastic weights
and traces, DA-STDP, STP and homeostasis on the lane axis; on a
``fused_tick`` net one ``fused_tick``), through propagation launchers built
once per scheduler (:class:`repro_torch.core.backend.LanePropagation`; an
admit or a restore writes its lane's weights into them; the plastic
launchers are built per chunk on the lanes' current weights, which, with
the traces, homeostasis rates and STP state, live in the lanes' state);
any other net (the ``loop`` oracle, IZH9/LIF groups, RK4) advances its
lanes one after another through ``engine.run``, each lane on its own
launchers.

Lanes are slots: :meth:`~LaneScheduler.admit` writes a session into a free
lane, :meth:`~LaneScheduler.evict` copies its state back out (resumable bit
for bit as a solo :class:`repro_torch.serve.Session` or elsewhere).
Idle lanes keep ticking, gated by their ``active`` flag: their generators
draw no spike, so the network relaxes toward rest and emits no event, and
homeostasis holds. :meth:`~LaneScheduler.export` and
:meth:`~LaneScheduler.restore` move a lane between schedulers as a
:class:`LaneSnapshot`, its raw cumulative telemetry and flush counter
included.

Under ``record="monitors"`` (the default) every lane keeps its own in-run
monitors (``[B, ...]`` accumulators on the device, the default set folded
inside the neuron kernel's launch); :meth:`~LaneScheduler.flush` drains a
lane's to the host, and nothing else crosses.

The lanes' state and telemetry are registered in the network's memory
ledger under stage "8. Serve Lanes" (``serve.lanes[.<ledger_key>]`` and
``serve.telemetry[.<ledger_key>]``; a second scheduler on the same net
and key replaces the registrations).

Left to later ports: watchpoints, the flight recorder and quarantine
(A10), and the mesh-sharded lane axis (``mesh=``, A11).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import NamedTuple

import torch

from repro_torch.core import backend as be
from repro_torch.core import rng
from repro_torch.core.engine import _run_lanes, batched_route, run
from repro_torch.core.lanes import broadcast_state, lane_state, set_lane
from repro_torch.core.network import CompiledNetwork, NetState
from repro_torch.precision.policy import tree_bytes
from repro_torch.telemetry import monitors as tel

__all__ = ["LaneScheduler", "LaneSnapshot", "Evicted"]


@dataclasses.dataclass(frozen=True)
class _LaneInfo:
    """Host-side bookkeeping for one occupied lane."""

    session_id: str
    ticks: int = 0


def _lane_tel(carry: tuple, lane: int) -> tuple:
    """One lane's slots of a lane-batched telemetry carry (``()`` stays)."""
    return tuple(c[lane] if isinstance(c, torch.Tensor) else c for c in carry)


def _set_lane_tel(carry: tuple, lane: int, values: tuple) -> None:
    """Write one lane's slots into a lane-batched telemetry carry, in place
    (a slot that ``values`` holds as ``()`` is left as it was)."""
    for c, x in zip(carry, values):
        if isinstance(x, torch.Tensor):
            c[lane] = x


class Evicted(NamedTuple):
    """What :meth:`LaneScheduler.evict` hands back: the lane's state and
    stimulus key, enough to resume it bit for bit elsewhere
    (``Session.create(net, key=ev.gen_key, state=ev.state)`` or a
    re-admit), and the final telemetry flush (None for ``record="none"``)."""

    state: NetState
    gen_key: torch.Tensor
    flush: dict | None


class LaneSnapshot(NamedTuple):
    """A lane copied out without flushing: the migration payload that
    :meth:`LaneScheduler.restore` and ``serve.lifecycle.save_lane`` take.
    ``tel`` holds the raw cumulative telemetry slots (``()`` where a
    monitor is per-chunk; None for ``record="none"``), so a restore
    continues the tenant's flush accounting as if it had never moved."""

    session_id: str
    state: NetState
    gen_key: torch.Tensor
    tel: tuple | None
    ticks: int
    ticks_since_flush: int


class LaneScheduler:
    """Admit/evict/step scheduler over ``capacity`` lanes of one compiled
    network.

    All admitted sessions share ``net`` (topology, parameters and
    precision policy). ``record`` is ``"monitors"`` (default; the net must
    carry monitors: every lane accumulates flushable telemetry) or
    ``"none"``. ``mesh`` (A11) and ``flight_window > 0`` (A10) raise
    ``NotImplementedError``. ``ledger_key`` namespaces the ledger
    registrations (``serve.lanes.<key>``, ``serve.telemetry.<key>``).
    """

    def __init__(self, net: CompiledNetwork, capacity: int, *, record: str = "monitors",
                 mesh=None, mesh_axis: str = "lanes", ledger_key: str | None = None,
                 flight_window: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if flight_window < 0:
            raise ValueError(f"flight_window must be >= 0, got {flight_window}")
        if record not in ("monitors", "none"):
            raise ValueError(f"record must be 'monitors' or 'none', got {record!r} — "
                             "raster modes would materialize [T, N] per lane")
        if record == "monitors" and not net.static.monitors:
            raise ValueError("record='monitors' needs a network compiled with monitors")
        if mesh is not None:
            raise NotImplementedError(
                "LaneScheduler(mesh=...): sharding the lane axis across cards is not "
                "ported to repro_torch yet (ROADMAP A11)")
        if flight_window:
            raise NotImplementedError(
                "LaneScheduler(flight_window=...): the flight recorder is not ported to "
                "repro_torch yet (ROADMAP A10)")
        self.net = net
        self.capacity = capacity
        self.record = record
        self.states: NetState = broadcast_state(net.state0, capacity)
        dev = net.state0.ring.device
        self.gen_keys = rng.key(0, dev).expand(capacity, 2).clone()
        self.active = torch.zeros((capacity,), dtype=torch.bool, device=dev)
        self._lanes: list[_LaneInfo | None] = [None] * capacity
        self._ticks_since_flush = [0] * capacity
        self._tel = (tel.init_carry(net.static, 1, device=dev, lanes=capacity)
                     if record == "monitors" else ())
        # The batched route's launchers, kept across chunks: admit and
        # restore write a lane's weights into them.
        self._prop = (be.LanePropagation(net.static, net.params, self.states.weights, capacity)
                      if batched_route(net.static) else None)
        suffix = f".{ledger_key}" if ledger_key else ""
        self._ledger_names = (f"serve.lanes{suffix}", f"serve.telemetry{suffix}")
        for name in self._ledger_names:
            net.ledger.release(name)
        with net.ledger.stage("8. Serve Lanes"):
            net.ledger.register(self._ledger_names[0], self._ledger_tree())
            if self._tel:
                net.ledger.register(self._ledger_names[1], self._tel)

    def _ledger_tree(self):
        """The lanes' state as the ledger counts it: the tensors and, as the
        reference's int32 tick array, 4 bytes a lane for ``t`` (a meta
        tensor: counted, never allocated)."""
        return self.states._replace(
            t=torch.empty((self.capacity,), dtype=torch.int32, device="meta"))

    def close(self) -> None:
        """Drop this scheduler's ledger registrations."""
        for name in self._ledger_names:
            self.net.ledger.release(name)

    # -- occupancy ------------------------------------------------------------
    @property
    def occupancy(self) -> int:
        return sum(1 for s in self._lanes if s is not None)

    @property
    def session_ids(self) -> list[str]:
        return [s.session_id for s in self._lanes if s is not None]

    @property
    def free_lanes(self) -> list[int]:
        return [i for i, s in enumerate(self._lanes) if s is None]

    @property
    def lane_sessions(self) -> list[str | None]:
        """Per-lane occupancy (session id or None)."""
        return [s.session_id if s is not None else None for s in self._lanes]

    @property
    def session_bytes(self) -> int:
        """Device bytes one admitted session costs: its lane's slice of the
        state and of the telemetry accumulators."""
        return (tree_bytes(self._ledger_tree()) + tree_bytes(self._tel)) // self.capacity

    def lane_of(self, session_id: str) -> int:
        for i, s in enumerate(self._lanes):
            if s is not None and s.session_id == session_id:
                return i
        raise KeyError(session_id)

    # -- admit / evict --------------------------------------------------------
    def admit(self, session_id: str, *, seed: int | None = None,
              key: torch.Tensor | None = None, state: NetState | None = None,
              lane: int | None = None) -> int:
        """Place a session into a free lane (the first, or ``lane``);
        returns the lane. ``seed``/``key`` name its stimulus stream (by
        default the seed ``crc32(session_id)``, stable across processes);
        ``state`` resumes an existing session instead of the net's
        ``state0``. The lane's telemetry is zeroed whole (counts and filter
        levels: an evict keeps the level and an export drains nothing)."""
        free = self.free_lanes
        if not free:
            raise RuntimeError(f"scheduler full ({self.capacity} lanes) — evict before "
                               "admitting")
        if any(s is not None and s.session_id == session_id for s in self._lanes):
            raise ValueError(f"session id {session_id!r} already admitted")
        if lane is None:
            lane = free[0]
        elif lane not in free:
            raise ValueError(f"lane {lane} is not free (free lanes: {free[:8]}...)"
                             if len(free) > 8 else
                             f"lane {lane} is not free (free lanes: {free})")
        if key is None:
            key = rng.key(seed if seed is not None else zlib.crc32(session_id.encode()),
                          self.gen_keys.device)
        state = state if state is not None else self.net.state0
        self.states = set_lane(self.states, lane, state)
        if self._prop is not None:
            self._prop.set_lane(lane, state.weights)
        self.gen_keys[lane] = key
        self.active[lane] = True
        for c in self._tel:
            if isinstance(c, torch.Tensor):
                c[lane].zero_()
        self._lanes[lane] = _LaneInfo(session_id=session_id, ticks=int(state.t))
        self._ticks_since_flush[lane] = 0
        return lane

    def evict(self, session_id: str) -> Evicted:
        """Remove a session; returns its state, stimulus key and final
        telemetry flush (:class:`Evicted`). The lane goes idle until the
        next admit. The flush drains the tenant's telemetry: a move that
        keeps the flush accounting is :meth:`export`."""
        lane = self.lane_of(session_id)
        state = lane_state(self.states, lane)
        gen_key = self.gen_keys[lane].clone()
        final = self.flush(session_id) if self._tel else None
        self.active[lane] = False
        self._lanes[lane] = None
        return Evicted(state=state, gen_key=gen_key, flush=final)

    # -- migration ------------------------------------------------------------
    def snapshot(self, session_id: str) -> LaneSnapshot:
        """A session's :class:`LaneSnapshot`, leaving it in its lane."""
        lane = self.lane_of(session_id)
        tel_lane = None
        if self._tel:
            tel_lane = tuple(c[lane].clone() if isinstance(s, tel.CUMULATIVE) else ()
                             for s, c in zip(self.net.static.monitors, self._tel))
        return LaneSnapshot(session_id=session_id, state=lane_state(self.states, lane),
                            gen_key=self.gen_keys[lane].clone(), tel=tel_lane,
                            ticks=self._lanes[lane].ticks,
                            ticks_since_flush=self._ticks_since_flush[lane])

    def export(self, session_id: str) -> LaneSnapshot:
        """Copy a session out and free its lane: the payload of
        :meth:`restore` on another scheduler over the same net."""
        lane = self.lane_of(session_id)
        snap = self.snapshot(session_id)
        self.active[lane] = False
        self._lanes[lane] = None
        return snap

    def restore(self, snap: LaneSnapshot) -> int:
        """Admit an exported lane, its telemetry accumulators and flush
        counter carried through; returns its new lane."""
        lane = self.admit(snap.session_id, key=snap.gen_key, state=snap.state)
        if self._tel and snap.tel is not None:
            _set_lane_tel(self._tel, lane, snap.tel)
        self._ticks_since_flush[lane] = snap.ticks_since_flush
        return lane

    def export_all(self) -> list[LaneSnapshot]:
        """Export every occupied lane, in lane order."""
        return [self.export(s.session_id) for s in list(self._lanes) if s is not None]

    # -- advance --------------------------------------------------------------
    def step(self, n_ticks: int) -> None:
        """Advance every lane ``n_ticks``, idle ones gated silent; nothing is
        read back to the host."""
        static, params = self.net.static, self.net.params
        mon = dict(record=self.record)
        if self._tel:
            mon.update(tel_carry=tel.chunk_carry(static, self._tel, n_ticks,
                                                 device=self.active.device,
                                                 lanes=self.capacity),
                       return_tel_carry=True)
        if self._prop is not None:
            self.states, out = _run_lanes(static, params, self.states, n_ticks,
                                          gen_base=self.gen_keys, active=self.active,
                                          prop=self._prop, **mon)
            if self._tel:
                self._tel = out["tel_carry"]
        else:
            carry = mon.get("tel_carry")
            for lane in range(self.capacity):
                if carry is not None:
                    mon["tel_carry"] = _lane_tel(carry, lane)
                final, out = run(static, params, lane_state(self.states, lane), n_ticks,
                                 gen_base=self.gen_keys[lane], active=self.active[lane], **mon)
                self.states = set_lane(self.states, lane, final)
                if carry is not None:
                    _set_lane_tel(carry, lane, out["tel_carry"])
            if carry is not None:
                self._tel = carry
        for i, info in enumerate(self._lanes):
            if info is not None:
                self._lanes[i] = dataclasses.replace(info, ticks=info.ticks + n_ticks)
                self._ticks_since_flush[i] += n_ticks

    # -- telemetry ------------------------------------------------------------
    def flush(self, session_id: str) -> dict:
        """Drain one session's cumulative telemetry to the host: per-group
        spike counts since its last flush (the lane's counts re-zeroed) and
        the current filtered group rates (the level kept)."""
        if not self._tel:
            raise ValueError("scheduler built with record='none'")
        lane = self.lane_of(session_id)
        values, zeroed = tel.flush_carry(self.net.static, _lane_tel(self._tel, lane))
        _set_lane_tel(self._tel, lane, zeroed)
        values["n_ticks"] = self._ticks_since_flush[lane]
        self._ticks_since_flush[lane] = 0
        return values

    def flush_all(self) -> dict[str, dict]:
        return {s.session_id: self.flush(s.session_id) for s in self._lanes if s is not None}

    # -- later ports ----------------------------------------------------------

    def check_watches(self) -> dict[str, list]:
        raise NotImplementedError("LaneScheduler.check_watches: in-run watchpoints are "
                                  "not ported to repro_torch yet (ROADMAP A10)")

    def quarantine(self, session_id: str, verdicts=()):
        raise NotImplementedError("LaneScheduler.quarantine: quarantine and the flight "
                                  "recorder are not ported to repro_torch yet (ROADMAP A10)")
