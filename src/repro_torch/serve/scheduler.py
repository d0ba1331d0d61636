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

A net compiled with watches (``compile(watches="default")``) keeps every
lane's watch accumulators through every chunk (the default set inside the
neuron kernel's launch too); :meth:`~LaneScheduler.check_watches` copies
the fleet's to the host in one transfer, drains each occupied lane and
names the tenants whose watches tripped, and
:meth:`~LaneScheduler.quarantine` evicts such a tenant with its evidence
(:class:`Quarantined`: its snapshot, the verdicts and its flight window).
With ``flight_window=K`` the scheduler keeps each tenant's last K
chunk-boundary :class:`LaneSnapshot` s (:meth:`~LaneScheduler.flight`),
which ``serve.recorder.replay`` re-runs bit for bit.

The lanes' state, telemetry and watches are registered in the network's
memory ledger under stage "8. Serve Lanes" (``serve.lanes[.<ledger_key>]``,
``serve.telemetry[.<ledger_key>]``, ``serve.watch[.<ledger_key>]``; a
second scheduler on the same net and key replaces the registrations).
Admit, evict, export, restore, step and flush report spans, counters,
gauges and histograms to :mod:`repro_torch.obs` under the reference's
names; a step's span times the host's enqueue of the chunk and never
synchronizes the device.

**Mesh sharding** (``mesh=``, a device-list mesh,
:func:`repro_torch.core.distributed.lane_mesh`): the lane axis is cut
into contiguous blocks, one per mesh entry. Each block ticks on its
entry's device through launchers of its own (built on that device at the
first step), with no exchange at all, since lanes never interact; every
lane's state, flushes and watches equal the unsharded scheduler's, bit
for bit. The lanes' state stays on the net's device between chunks: a
chunk hands each block its lanes (views where the block's device is the
net's, copies elsewhere) and writes each block's final state, telemetry
and watch carries back into its lanes of those tensors, in place. That
write-back is one copy of every lane's state per chunk, on one card (or
on ``["cpu"] * k``) too.
"""
from __future__ import annotations

import dataclasses
import zlib
from collections import deque
from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core import backend as be
from repro_torch.core import rng
from repro_torch.core.distributed import device_context
from repro_torch.core.engine import _run_lanes, batched_route, run
from repro_torch.core.lanes import broadcast_state, lane_state, set_lane
from repro_torch.core.network import CompiledNetwork, NetState, _to_device
from repro_torch.obs import watch as wat
from repro_torch.obs.metrics import us_per_tick
from repro_torch.precision.policy import tree_bytes
from repro_torch.telemetry import monitors as tel

__all__ = ["LaneScheduler", "LaneSnapshot", "Evicted", "Quarantined"]


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


def _lane_watch(carry: tuple, lane: int) -> tuple:
    """One lane's slots of a lane-batched watch carry (views)."""
    return tuple(tuple(x[lane] for x in slot) for slot in carry)


def _set_lane_watch(carry: tuple, lane: int, values: tuple) -> None:
    """Write one lane's slots into a lane-batched watch carry, in place."""
    for slot, vals in zip(carry, values):
        for x, v in zip(slot, vals):
            x[lane].copy_(torch.as_tensor(v))


def _flat_int32(carry: tuple) -> torch.Tensor:
    """A lane-batched watch carry as one int32 ``[B, W]`` tensor (f32 slots
    bit-cast), so the fleet crosses to the host in one copy."""
    cols = [x.reshape(x.shape[0], -1) for slot in carry for x in slot]
    return torch.cat([c.view(torch.int32) if c.dtype == torch.float32 else c for c in cols],
                     dim=1)


def _unflat_int32(flat: torch.Tensor, like: tuple) -> tuple:
    """:func:`_flat_int32`'s inverse: ``flat`` split into ``like``'s slots
    (its shapes and dtypes, on ``flat``'s device)."""
    out, at = [], 0
    for slot in like:
        vals = []
        for x in slot:
            width = x[0].numel()
            col = flat[:, at:at + width]
            at += width
            if x.dtype == torch.float32:
                col = col.contiguous().view(torch.float32)
            vals.append(col.reshape(x.shape).clone())
        out.append(tuple(vals))
    return tuple(out)


def _lanes_of(tree, b0: int, b1: int, device):
    """Lanes ``[b0, b1)`` of a lane-batched tree (a batched ``NetState``, a
    telemetry or watch carry) on ``device``; non-tensor leaves stay."""
    if isinstance(tree, torch.Tensor):
        return tree[b0:b1].to(device)
    if isinstance(tree, NetState) and tree.t is not None:
        return _lanes_of(tree._replace(t=None), b0, b1, device)._replace(t=tree.t[b0:b1])
    if isinstance(tree, tuple):
        items = [_lanes_of(x, b0, b1, device) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _put_lanes(dst, src, b0: int):
    """Write the lane block ``src`` into lanes ``[b0, b0 + B)`` of the
    lane-batched tree ``dst``, in place on its tensors
    (:func:`_lanes_of`'s inverse); returns ``dst`` with the block's ticks."""
    if isinstance(dst, torch.Tensor):
        if isinstance(src, torch.Tensor):  # a telemetry slot may come back as ()
            dst[b0:b0 + src.shape[0]].copy_(src)
        return dst
    if isinstance(dst, NetState) and dst.t is not None:
        _put_lanes(dst._replace(t=None), src._replace(t=None), b0)
        return dst._replace(t=dst.t[:b0] + tuple(src.t) + dst.t[b0 + len(src.t):])
    if isinstance(dst, tuple):
        for x, y in zip(dst, src, strict=True):
            _put_lanes(x, y, b0)
    return dst


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


class Quarantined(NamedTuple):
    """What :meth:`LaneScheduler.quarantine` hands back: the evidence of a
    tripped tenant. Its no-flush snapshot (resumable and replayable bit
    for bit), the watch verdicts that tripped, and its flight window (the
    last K chunk-boundary :class:`LaneSnapshot` s, oldest first). Persist
    it with ``serve.lifecycle.dump_quarantine``."""

    session_id: str
    snapshot: LaneSnapshot
    verdicts: tuple
    recording: tuple


class LaneScheduler:
    """Admit/evict/step scheduler over ``capacity`` lanes of one compiled
    network.

    All admitted sessions share ``net`` (topology, parameters and
    precision policy). ``record`` is ``"monitors"`` (default; the net must
    carry monitors: every lane accumulates flushable telemetry) or
    ``"none"``. ``flight_window`` K > 0 keeps every tenant's last K
    chunk-boundary snapshots. ``mesh`` (a device-list mesh) with
    ``mesh_axis`` shards the lane axis into one contiguous block per mesh
    entry (``capacity`` a multiple of the axis size). ``ledger_key``
    namespaces the ledger
    registrations (``serve.lanes.<key>``, ``serve.telemetry.<key>``,
    ``serve.watch.<key>``) and names the scheduler's obs series
    (``rung=<key>``, else ``rung=cap<capacity>``).
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
            if mesh_axis not in mesh.shape:
                raise ValueError(f"mesh has no axis {mesh_axis!r} (axes: "
                                 f"{tuple(mesh.shape)})")
            if capacity % mesh.shape[mesh_axis]:
                raise ValueError(
                    f"capacity ({capacity}) must be a multiple of the mesh axis size "
                    f"({mesh.shape[mesh_axis]}) — lanes shard evenly, no ragged device "
                    "gets a partial lane block")
        self.net = net
        self.capacity = capacity
        self.record = record
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.states: NetState = broadcast_state(net.state0, capacity)
        dev = net.state0.ring.device
        # Lane blocks: (device, first lane, end), one per mesh entry; the
        # whole capacity on the net's device without a mesh.
        if mesh is None:
            self._blocks = ((dev, 0, capacity),)
        else:
            per = capacity // mesh.shape[mesh_axis]
            self._blocks = tuple((d, k * per, (k + 1) * per)
                                 for k, d in enumerate(mesh.devices))
        self._params = tuple(_to_device(net.params, d) for d, _, _ in self._blocks)
        self.gen_keys = rng.key(0, dev).expand(capacity, 2).clone()
        self.active = torch.zeros((capacity,), dtype=torch.bool, device=dev)
        self._lanes: list[_LaneInfo | None] = [None] * capacity
        self._ticks_since_flush = [0] * capacity
        self._tel = (tel.init_carry(net.static, 1, device=dev, lanes=capacity)
                     if record == "monitors" else ())
        # Watch accumulators (compile(watches=...)), one carry per lane,
        # threaded through every chunk and drained by check_watches().
        self._watch = (wat.init_carry(net.static, device=dev, lanes=capacity)
                       if net.static.watches else ())
        # The flight recorder: each tenant's last K chunk-boundary snapshots.
        self.flight_window = int(flight_window)
        self._flight: dict[str, deque] = {}
        # The batched route's launchers, one set per lane block, built at
        # the first step and kept across chunks (that step is the
        # scheduler's compile): admit and restore write a lane's weights
        # into its block's.
        self._prop = [None] * len(self._blocks)
        self._batched = batched_route(net.static)
        suffix = f".{ledger_key}" if ledger_key else ""
        self._ledger_names = (f"serve.lanes{suffix}", f"serve.telemetry{suffix}",
                              f"serve.watch{suffix}")
        # The label of this scheduler's obs series: the ledger key (a ladder
        # rung), else the capacity.
        self._obs_rung = ledger_key or f"cap{capacity}"
        for name in self._ledger_names:
            net.ledger.release(name)
        with net.ledger.stage("8. Serve Lanes"):
            net.ledger.register(self._ledger_names[0], self._ledger_tree())
            if self._tel:
                net.ledger.register(self._ledger_names[1], self._tel)
            if self._watch:
                net.ledger.register(self._ledger_names[2], self._watch)
        if obs.enabled():
            self._obs_occupancy()

    def _ledger_tree(self):
        """The lanes' state as the ledger counts it: the tensors and, as the
        reference's int32 tick array, 4 bytes a lane for ``t`` (a meta
        tensor: counted, never allocated)."""
        return self.states._replace(
            t=torch.empty((self.capacity,), dtype=torch.int32, device="meta"))

    def close(self) -> None:
        """Drop this scheduler's ledger registrations and occupancy gauges."""
        for name in self._ledger_names:
            self.net.ledger.release(name)
        for gauge in ("repro_serve_lane_occupancy", "repro_serve_lane_capacity"):
            obs.remove_gauge(gauge, rung=self._obs_rung)

    def _obs_occupancy(self) -> None:
        obs.gauge("repro_serve_lane_occupancy", float(self.occupancy), rung=self._obs_rung)
        obs.gauge("repro_serve_lane_capacity", float(self.capacity), rung=self._obs_rung)

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
        state and of the telemetry and watch accumulators."""
        return (tree_bytes(self._ledger_tree()) + tree_bytes(self._tel)
                + tree_bytes(self._watch)) // self.capacity

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
        levels: an evict keeps the level and an export drains nothing) and
        its watches start anew (init values: a WeightDrift's norms start at
        its baseline)."""
        with obs.span("admit", rung=self._obs_rung, session=session_id):
            lane = self._admit_impl(session_id, seed=seed, key=key, state=state, lane=lane)
        if obs.enabled():
            obs.inc("repro_serve_admits_total", rung=self._obs_rung)
            self._obs_occupancy()
        return lane

    def _admit_impl(self, session_id: str, *, seed, key, state, lane) -> int:
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
        k, (d, b0, _) = self._block_of(lane)
        if self._prop[k] is not None:
            self._prop[k].set_lane(lane - b0, _to_device(state.weights, d))
        self.gen_keys[lane] = key
        self.active[lane] = True
        for c in self._tel:
            if isinstance(c, torch.Tensor):
                c[lane].zero_()
        if self._watch:
            _set_lane_watch(self._watch, lane,
                            wat.init_carry(self.net.static, device=self.active.device))
        self._lanes[lane] = _LaneInfo(session_id=session_id, ticks=int(state.t))
        self._ticks_since_flush[lane] = 0
        return lane

    def evict(self, session_id: str) -> Evicted:
        """Remove a session; returns its state, stimulus key and final
        telemetry flush (:class:`Evicted`). The lane goes idle until the
        next admit. The flush drains the tenant's telemetry: a move that
        keeps the flush accounting is :meth:`export`."""
        with obs.span("evict", rung=self._obs_rung, session=session_id):
            lane = self.lane_of(session_id)
            state = lane_state(self.states, lane)
            gen_key = self.gen_keys[lane].clone()
            final = self.flush(session_id) if self._tel else None
            self.active[lane] = False
            self._lanes[lane] = None
            self._flight.pop(session_id, None)
        if obs.enabled():
            obs.inc("repro_serve_evicts_total", rung=self._obs_rung)
            self._obs_occupancy()
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
        with obs.span("export", rung=self._obs_rung, session=session_id):
            lane = self.lane_of(session_id)
            snap = self.snapshot(session_id)
            self.active[lane] = False
            self._lanes[lane] = None
        if obs.enabled():
            obs.inc("repro_serve_exports_total", rung=self._obs_rung)
            self._obs_occupancy()
        return snap

    def restore(self, snap: LaneSnapshot) -> int:
        """Admit an exported lane, its telemetry accumulators and flush
        counter carried through; returns its new lane."""
        with obs.span("restore", rung=self._obs_rung, session=snap.session_id):
            lane = self.admit(snap.session_id, key=snap.gen_key, state=snap.state)
            if self._tel and snap.tel is not None:
                _set_lane_tel(self._tel, lane, snap.tel)
            self._ticks_since_flush[lane] = snap.ticks_since_flush
        obs.inc("repro_serve_restores_total", rung=self._obs_rung)
        return lane

    def export_all(self) -> list[LaneSnapshot]:
        """Export every occupied lane, in lane order."""
        return [self.export(s.session_id) for s in list(self._lanes) if s is not None]

    # -- advance --------------------------------------------------------------
    def step(self, n_ticks: int) -> None:
        """Advance every lane ``n_ticks``, idle ones gated silent; nothing is
        read back to the host. The span times the host's enqueue of the
        chunk (the device is not synchronized)."""
        if not obs.enabled():
            return self._step_impl(n_ticks)
        occ = self.occupancy
        before = obs.build_count()
        with obs.span("step_chunk", rung=self._obs_rung, n_ticks=n_ticks,
                      occupancy=occ) as sp:
            self._step_impl(n_ticks)
        obs.note_dispatch("serve.step_lanes", before)
        obs.observe("repro_serve_chunk_latency_ms", sp.dur_s * 1e3, scope="scheduler",
                    rung=self._obs_rung)
        obs.observe("repro_serve_us_per_tick", us_per_tick(sp.dur_s, n_ticks),
                    scope="scheduler", rung=self._obs_rung)
        obs.inc("repro_serve_ticks_total", float(n_ticks * occ), rung=self._obs_rung)

    def _block_of(self, lane: int):
        """``(k, (device, first lane, end))`` of the lane block holding
        ``lane``."""
        for k, block in enumerate(self._blocks):
            if block[1] <= lane < block[2]:
                return k, block
        raise IndexError(lane)

    def _step_impl(self, n_ticks: int) -> None:
        static = self.net.static
        home = self.active.device
        mon = dict(record=self.record)
        if self._tel:
            mon.update(tel_carry=tel.chunk_carry(static, self._tel, n_ticks, device=home,
                                                 lanes=self.capacity),
                       return_tel_carry=True)
        if self._batched:
            whole = len(self._blocks) == 1
            finals, outs = [], []
            for k, (d, b0, b1) in enumerate(self._blocks):
                def part(x, d=d, b0=b0, b1=b1):
                    return x if whole or x is None else _lanes_of(x, b0, b1, d)
                states = part(self.states)
                with device_context(d):
                    if self._prop[k] is None:
                        self._prop[k] = be.LanePropagation(static, self._params[k],
                                                           states.weights, b1 - b0)
                        obs.note_build()
                    final, out = _run_lanes(
                        static, self._params[k], states, n_ticks,
                        gen_base=part(self.gen_keys), active=part(self.active),
                        prop=self._prop[k], watch_carry=part(self._watch or None),
                        **{**mon, "tel_carry": part(mon.get("tel_carry"))})
                finals.append(final)
                outs.append(out)
            if whole:
                self.states, out = finals[0], outs[0]
            else:
                # Each block's final state, telemetry and watches go back
                # into its lanes of the home tensors, in place.
                out = {key: mon.get("tel_carry") if key == "tel_carry" else self._watch
                       for key in ("tel_carry", "watch_carry") if key in outs[0]}
                for (_, b0, _), final, o in zip(self._blocks, finals, outs):
                    self.states = _put_lanes(self.states, final, b0)
                    for key in out:
                        _put_lanes(out[key], o[key], b0)
            if self._tel:
                self._tel = out["tel_carry"]
            if self._watch:
                self._watch = out["watch_carry"]
        else:
            carry = mon.get("tel_carry")
            for lane in range(self.capacity):
                k, (d, _, _) = self._block_of(lane)
                if carry is not None:
                    mon["tel_carry"] = _to_device(_lane_tel(carry, lane), d)
                if self._watch:
                    mon["watch_carry"] = _to_device(_lane_watch(self._watch, lane), d)
                with device_context(d):
                    final, out = run(static, self._params[k],
                                     _to_device(lane_state(self.states, lane), d), n_ticks,
                                     gen_base=self.gen_keys[lane].to(d),
                                     active=self.active[lane].to(d), **mon)
                self.states = set_lane(self.states, lane, final)
                if carry is not None:
                    _set_lane_tel(carry, lane, out["tel_carry"])
                if self._watch:
                    _set_lane_watch(self._watch, lane, out["watch_carry"])
            if carry is not None:
                self._tel = carry
        for i, info in enumerate(self._lanes):
            if info is not None:
                self._lanes[i] = dataclasses.replace(info, ticks=info.ticks + n_ticks)
                self._ticks_since_flush[i] += n_ticks
        if self.flight_window:
            self._record_flight()

    def _record_flight(self) -> None:
        """Every occupied lane's chunk-boundary snapshot into its tenant's
        ring (the last ``flight_window`` of them, oldest dropped first)."""
        for info in self._lanes:
            if info is None:
                continue
            ring = self._flight.get(info.session_id)
            if ring is None:
                ring = self._flight[info.session_id] = deque(maxlen=self.flight_window)
            ring.append(self.snapshot(info.session_id))
        if obs.enabled() and self.occupancy:
            obs.event("flight_record", rung=self._obs_rung, sessions=self.occupancy,
                      window=self.flight_window)
            obs.inc("repro_flight_records_total", float(self.occupancy), rung=self._obs_rung)

    def flight(self, session_id: str) -> tuple[LaneSnapshot, ...]:
        """The tenant's recorded flight window, oldest first (empty when the
        recorder is off or no chunk boundary has passed yet)."""
        return tuple(self._flight.get(session_id, ()))

    # -- telemetry ------------------------------------------------------------
    def flush(self, session_id: str) -> dict:
        """Drain one session's cumulative telemetry to the host: per-group
        spike counts since its last flush (the lane's counts re-zeroed) and
        the current filtered group rates (the level kept)."""
        if not self._tel:
            raise ValueError("scheduler built with record='none'")
        lane = self.lane_of(session_id)
        with obs.span("flush", rung=self._obs_rung, session=session_id):
            values, zeroed = tel.flush_carry(self.net.static, _lane_tel(self._tel, lane))
            _set_lane_tel(self._tel, lane, zeroed)
            values["n_ticks"] = self._ticks_since_flush[lane]
            self._ticks_since_flush[lane] = 0
        obs.inc("repro_serve_flushes_total", rung=self._obs_rung)
        return values

    def flush_all(self) -> dict[str, dict]:
        return {s.session_id: self.flush(s.session_id) for s in self._lanes if s is not None}

    # -- watchpoints ----------------------------------------------------------
    def check_watches(self) -> dict[str, list]:
        """Drain every occupied lane's watch accumulators and return the
        tripped verdicts by session id (sessions with none are left out).
        Tripped verdicts go to the obs plane (``watch_trip`` events and
        ``repro_watch_trips_total``). The fleet's accumulators cross to the
        host in one copy and the drained windows go back in one."""
        if not self._watch:
            raise ValueError("network compiled without watches — pass watches=... "
                             "(e.g. 'default') to compile()")
        flat = _flat_int32(self._watch).cpu()
        host = _unflat_int32(flat, self._watch)
        alerts: dict[str, list] = {}
        for lane, info in enumerate(self._lanes):
            if info is None:
                continue
            verdicts, reset = wat.drain(self.net.static, _lane_watch(host, lane))
            _set_lane_watch(host, lane, reset)
            tripped = wat.alert(verdicts, rung=self._obs_rung, session=info.session_id)
            if tripped:
                alerts[info.session_id] = tripped
        self._watch = _unflat_int32(_flat_int32(host).to(self.active.device), self._watch)
        return alerts

    def quarantine(self, session_id: str, verdicts=()) -> Quarantined:
        """Evict a tripped tenant with its evidence: the no-flush
        :class:`LaneSnapshot` (replayable bit for bit), the verdicts that
        tripped and its flight window. The lane is freed; the other lanes
        are untouched. Persist the bundle with
        ``serve.lifecycle.dump_quarantine``."""
        recording = tuple(self._flight.pop(session_id, ()))
        snap = self.export(session_id)
        if obs.enabled():
            obs.event("quarantine", rung=self._obs_rung, session=session_id,
                      watches=",".join(v.watch for v in verdicts), recorded=len(recording))
            obs.inc("repro_quarantines_total", rung=self._obs_rung)
        return Quarantined(session_id=session_id, snapshot=snap, verdicts=tuple(verdicts),
                           recording=recording)
