"""Elastic serving pool: a capacity ladder per topology, a router across them.

The reference's ``repro.serve.pool``, two layers on top of
:class:`~repro_torch.serve.LaneScheduler`:

:class:`CapacityLadder`: lane-count elasticity for ONE compiled topology.
A scheduler's lane count is fixed when it is built (its batched state,
its propagation launchers); the ladder keeps a rung sequence of lane
counts (default N ∈ {1, 8, 64, 512}) and moves the whole tenant fleet
between rungs through :class:`~repro_torch.serve.LaneSnapshot` migration:
an admit beyond the current rung's capacity moves up a rung *before*
placing the new tenant; occupancy that a smaller rung would hold for
``idle_after`` consecutive steps moves down and sheds lane bytes.
Migration is bit for bit: ``export`` copies each lane out raw (state,
plastic weights, stimulus key, cumulative telemetry, flush counter; no
flush) and ``restore`` writes it into the new rung, so no tenant's
raster, weights, generator stream or flush accounting can observe the
move. Each rung's lane bytes are registered in the ledger under its own
names (``serve.lanes.rung64``; ``MemoryLedger.serve_rung_bytes``), only
the occupied rung at any time.

:class:`ServePool`: cross-topology admission router. The pool keys one
ladder per *compile fingerprint* (:func:`compile_fingerprint`, a content
hash of the static plan, the parameter tensors and the initial weights)
and routes ``admit``/``step``/``flush``/``evict`` by session id. Two nets
built from the same config land on the same ladder; any difference that
would change the numerics (topology, propagation mode, backend,
precision policy, weights, monitors) forks a new ladder. Its best-fit
admission reads the tenants' flushed telemetry.

Both layers carry the reference's observability calls (``rung_build`` and
``rung_migrate`` spans, ``repro_rung_migrations_total``, the ``route``
event and ``repro_pool_routes_total``) and its watch surface:
``flight_window`` reaches every rung's scheduler, flight windows survive
rung migrations, and ``check_watches``, ``quarantine`` and ``flight``
route to the tenant's rung. With ``mesh=`` (a device-list mesh) the
ladder's rungs that the mesh axis size divides shard their lanes across
it, and the smaller ones run unsharded, as the reference's do.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.network import CompiledNetwork, NetState
from repro_torch.precision.policy import _flatten
from repro_torch.serve.scheduler import Evicted, LaneScheduler, LaneSnapshot, Quarantined

__all__ = ["CapacityLadder", "ServePool", "compile_fingerprint", "RUNGS"]

RUNGS = (1, 8, 64, 512)


def compile_fingerprint(net: CompiledNetwork) -> str:
    """Content hash identifying a compiled topology for pool routing.

    Covers everything that selects the numerics: the static plan
    (``repr(NetStatic)``: topology, buckets, propagation, backend,
    monitors, policy), every ``NetParams`` tensor (dtype, shape, raw
    bytes: weight images, CSR tables, generator schedules) and the initial
    weights. Two networks with equal fingerprints share a scheduler's lanes
    bit for bit; two identical compiles give the same value (it need not
    equal the reference's hash). Cached on the instance: the parameters do
    not change after compile.
    """
    cached = getattr(net, "_fingerprint", None)
    if cached is not None:
        return cached
    h = hashlib.sha1(repr(net.static).encode())
    for leaf in _flatten((net.params, net.state0.weights))[0]:
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            # numpy has no bf16: hash its bits (the dtype is in the static plan)
            arr = (leaf.view(torch.int16) if leaf.dtype == torch.bfloat16 else leaf).numpy()
        else:
            arr = np.asarray(leaf)
        h.update(str((arr.dtype, arr.shape)).encode())
        h.update(arr.tobytes())
    fp = h.hexdigest()
    net._fingerprint = fp
    return fp


class CapacityLadder:
    """Elastic lane capacity for one topology through rung-to-rung migration.

    The ladder builds a :class:`LaneScheduler` at the smallest rung that
    fits the fleet on the first admit, and migrates the whole fleet
    (``export_all`` → ``restore``) whenever occupancy crosses rung
    boundaries: up on the admit that would overflow, down after
    ``idle_after`` consecutive :meth:`step` calls during which a smaller
    rung would have sufficed (hysteresis: one transient eviction does not
    thrash the ladder). Per-rung ledger names carry ``ledger_prefix``.
    ``flight_window`` is every rung's scheduler's. With a ``mesh`` (a
    device-list mesh), a rung that the mesh axis size divides runs
    sharded; a smaller or indivisible rung runs unsharded.
    """

    def __init__(self, net: CompiledNetwork, *, rungs=RUNGS, record: str = "monitors",
                 mesh=None, mesh_axis: str = "lanes", idle_after: int = 2,
                 ledger_prefix: str = "", lane_chooser=None, flight_window: int = 0):
        if not rungs:
            raise ValueError("need at least one rung")
        self.net = net
        self.flight_window = flight_window
        # Optional admission policy hook: called with the live scheduler,
        # returns a free lane (or None for first-fit); the pool's best-fit
        # policy routes through it.
        self._lane_chooser = lane_chooser
        self.rungs = tuple(sorted(set(int(r) for r in rungs)))
        self.record = record
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.idle_after = idle_after
        self.ledger_prefix = ledger_prefix
        self.migrations = 0
        self._sched: LaneScheduler | None = None
        self._idle_steps = 0

    # -- rung plumbing --------------------------------------------------------
    @property
    def rung(self) -> int | None:
        """The current rung's lane count (None before the first admit)."""
        return self._sched.capacity if self._sched else None

    @property
    def scheduler(self) -> LaneScheduler | None:
        return self._sched

    def rung_for(self, n_tenants: int) -> int:
        """The smallest rung with at least ``n_tenants`` lanes."""
        for r in self.rungs:
            if r >= n_tenants:
                return r
        raise RuntimeError(f"{n_tenants} tenants exceed the top rung "
                           f"({self.rungs[-1]} lanes) — extend rungs=")

    def _build(self, n: int) -> LaneScheduler:
        key = f"{self.ledger_prefix}rung{n}"
        mesh = self.mesh
        if mesh is not None and n % mesh.shape[self.mesh_axis]:
            mesh = None  # a rung smaller than the mesh: run unsharded
        with obs.span("rung_build", rung=n, ledger_key=key):
            return LaneScheduler(self.net, n, record=self.record, mesh=mesh,
                                 mesh_axis=self.mesh_axis, ledger_key=key,
                                 flight_window=self.flight_window)

    def _migrate(self, new_rung: int) -> None:
        """Move the whole fleet to ``new_rung`` through raw lane snapshots
        (no flush, no stream perturbation, no telemetry drain), releasing
        the old rung's ledger registrations. The flight windows move with
        the fleet."""
        old_rung = self._sched.capacity if self._sched else 0
        with obs.span("rung_migrate", from_rung=old_rung, to_rung=new_rung,
                      tenants=self.occupancy):
            snaps: list[LaneSnapshot] = []
            flights: dict = {}
            if self._sched is not None:
                snaps = self._sched.export_all()
                flights = dict(self._sched._flight)
                self._sched.close()
            self._sched = self._build(new_rung)
            for snap in snaps:
                self._sched.restore(snap)
            self._sched._flight.update(flights)
        obs.inc("repro_rung_migrations_total", direction="up" if new_rung > old_rung else "down")
        self.migrations += 1
        self._idle_steps = 0

    # -- tenant API -----------------------------------------------------------
    def admit(self, session_id: str, *, seed: int | None = None,
              key: torch.Tensor | None = None, state: NetState | None = None) -> int:
        self._ensure_capacity(self.occupancy + 1)
        lane = self._lane_chooser(self._sched) if self._lane_chooser is not None else None
        return self._sched.admit(session_id, seed=seed, key=key, state=state, lane=lane)

    def _ensure_capacity(self, n_tenants: int) -> None:
        """A first build, or an up-rung migration, so ``n_tenants`` fit."""
        if self._sched is None:
            self._sched = self._build(self.rung_for(n_tenants))
        elif n_tenants > self._sched.capacity:
            self._migrate(self.rung_for(n_tenants))
        self._idle_steps = 0

    def restore(self, snap: LaneSnapshot) -> int:
        """Admit an exported or checkpointed lane snapshot, moving up a rung
        first if full; its telemetry and flush counter carry over."""
        self._ensure_capacity(self.occupancy + 1)
        return self._sched.restore(snap)

    def evict(self, session_id: str) -> Evicted:
        return self._sched.evict(session_id)

    def export(self, session_id: str) -> LaneSnapshot:
        return self._sched.export(session_id)

    def snapshot(self, session_id: str) -> LaneSnapshot:
        """A lane's snapshot, the tenant left serving."""
        return self._sched.snapshot(session_id)

    def flush(self, session_id: str) -> dict:
        return self._sched.flush(session_id)

    def check_watches(self) -> dict[str, list]:
        """Drain the rung's watch accumulators
        (:meth:`LaneScheduler.check_watches`); {} before the first admit."""
        return self._sched.check_watches() if self._sched else {}

    def quarantine(self, session_id: str, verdicts=()) -> Quarantined:
        return self._sched.quarantine(session_id, verdicts)

    def flight(self, session_id: str) -> tuple:
        """The tenant's recorded flight window, oldest first."""
        return self._sched.flight(session_id) if self._sched else ()

    def step(self, n_ticks: int) -> None:
        """Advance every lane one chunk, then apply the down-rung rule:
        after ``idle_after`` consecutive steps during which the fleet fit a
        smaller rung, migrate down and shed the spare lane bytes."""
        if self._sched is None:
            return
        self._sched.step(n_ticks)
        target = self.rung_for(max(1, self._sched.occupancy))
        if target < self._sched.capacity:
            self._idle_steps += 1
            if self._idle_steps >= self.idle_after:
                self._migrate(target)
        else:
            self._idle_steps = 0

    @property
    def occupancy(self) -> int:
        return self._sched.occupancy if self._sched else 0

    @property
    def session_ids(self) -> list[str]:
        return self._sched.session_ids if self._sched else []


class ServePool:
    """Cross-topology admission router: one :class:`CapacityLadder` per
    compile fingerprint, sessions routed by id.

    ``admit`` takes the tenant's *network*: the pool fingerprints it and
    lands the session on the matching ladder (building one on first
    sight). ``step`` advances every ladder; per-session calls
    (``flush``/``evict``/``export``) route through the session table.
    ``policy="best_fit"`` packs tenants into ``bin_lanes``-wide lane blocks,
    ties broken by the tenants' flushed activity.
    """

    def __init__(self, *, rungs=RUNGS, record: str = "monitors", mesh=None,
                 mesh_axis: str = "lanes", idle_after: int = 2, policy: str = "first_fit",
                 bin_lanes: int = 8, flight_window: int = 0):
        if policy not in ("first_fit", "best_fit"):
            raise ValueError(f"unknown admission policy {policy!r} — "
                             "'first_fit' or 'best_fit'")
        if bin_lanes < 1:
            raise ValueError(f"bin_lanes must be >= 1, got {bin_lanes}")
        self._opts = dict(rungs=rungs, record=record, mesh=mesh, mesh_axis=mesh_axis,
                          idle_after=idle_after, flight_window=flight_window)
        self.policy = policy
        self.bin_lanes = bin_lanes
        self._ladders: dict[str, CapacityLadder] = {}
        self._nets: dict[str, CompiledNetwork] = {}
        self._routes: dict[str, str] = {}  # session id -> fingerprint
        # session id -> most recent flush-reported activity (mean filtered
        # group rate, Hz): the best-fit tie-breaker.
        self._activity: dict[str, float] = {}

    # -- topology table -------------------------------------------------------
    @property
    def fingerprints(self) -> list[str]:
        return list(self._ladders)

    def ladder_of(self, session_id: str) -> CapacityLadder:
        return self._ladders[self._routes[session_id]]

    def network_of(self, session_id: str) -> CompiledNetwork:
        return self._nets[self._routes[session_id]]

    @property
    def session_ids(self) -> list[str]:
        return list(self._routes)

    @property
    def occupancy(self) -> int:
        return len(self._routes)

    # -- tenant API -----------------------------------------------------------
    def admit(self, net: CompiledNetwork, session_id: str, *, seed: int | None = None,
              key: torch.Tensor | None = None, state: NetState | None = None) -> str:
        """Route a session onto its topology's ladder; returns the compile
        fingerprint (the ladder's key)."""
        if session_id in self._routes:
            raise ValueError(f"session id {session_id!r} already admitted")
        fp, ladder = self._ladder_for(net)
        obs.event("route", session=session_id, fingerprint=fp[:8])
        obs.inc("repro_pool_routes_total", fingerprint=fp[:8])
        ladder.admit(session_id, seed=seed, key=key, state=state)
        self._routes[session_id] = fp
        return fp

    def _ladder_for(self, net: CompiledNetwork) -> tuple[str, CapacityLadder]:
        fp = compile_fingerprint(net)
        ladder = self._ladders.get(fp)
        if ladder is None:
            chooser = self._choose_lane if self.policy == "best_fit" else None
            ladder = CapacityLadder(net, ledger_prefix=f"{fp[:8]}.", lane_chooser=chooser,
                                    **self._opts)
            self._ladders[fp] = ladder
            self._nets[fp] = net
        return fp, ladder

    # -- admission policy -----------------------------------------------------
    def _choose_lane(self, sched) -> int | None:
        """Best-fit bin packing over ``bin_lanes``-wide lane blocks: a new
        tenant lands in the fullest block that still has a free lane; ties
        go to the block with the lowest aggregate recent activity (the mean
        filtered group rates each ``flush`` reported), then to the lower
        block. None (first-fit) when there is nothing to choose."""
        lanes = sched.lane_sessions
        if not lanes:
            return None
        nb = self.bin_lanes
        best = None  # (-(occupied), activity, block start, first free lane)
        for b0 in range(0, len(lanes), nb):
            block = lanes[b0:b0 + nb]
            free = [b0 + i for i, s in enumerate(block) if s is None]
            if not free:
                continue
            occupied = len(block) - len(free)
            activity = sum(self._activity.get(s, 0.0) for s in block if s is not None)
            cand = (-occupied, activity, b0, free[0])
            if best is None or cand < best:
                best = cand
        return best[3] if best is not None else None

    def _note_activity(self, session_id: str, values: dict) -> None:
        """Record a tenant's flush-reported activity: the mean of any
        rate-valued monitor (the default GroupRate level), else spikes per
        tick from count monitors."""
        for k in sorted(k for k in values if "rate" in k):
            arr = np.asarray(values[k], dtype=np.float64)
            if arr.size:
                self._activity[session_id] = float(arr.mean())
                return
        n_ticks = max(int(values.get("n_ticks", 0)), 1)
        for k in sorted(values):
            if k == "n_ticks":
                continue
            arr = np.asarray(values[k], dtype=np.float64)
            if arr.size:
                self._activity[session_id] = float(arr.sum()) / n_ticks
                return

    def evict(self, session_id: str) -> Evicted:
        ev = self.ladder_of(session_id).evict(session_id)
        del self._routes[session_id]
        self._activity.pop(session_id, None)
        return ev

    def export(self, session_id: str) -> LaneSnapshot:
        snap = self.ladder_of(session_id).export(session_id)
        del self._routes[session_id]
        self._activity.pop(session_id, None)
        return snap

    def restore(self, net: CompiledNetwork, snap: LaneSnapshot) -> str:
        """Re-admit an exported lane snapshot under its session id (a move
        between pools or processes, with ``serve.lifecycle``)."""
        if snap.session_id in self._routes:
            raise ValueError(f"session id {snap.session_id!r} already admitted")
        fp, ladder = self._ladder_for(net)
        obs.event("route", session=snap.session_id, fingerprint=fp[:8])
        obs.inc("repro_pool_routes_total", fingerprint=fp[:8])
        ladder.restore(snap)
        self._routes[snap.session_id] = fp
        return fp

    def flush(self, session_id: str) -> dict:
        values = self.ladder_of(session_id).flush(session_id)
        self._note_activity(session_id, values)
        return values

    def step(self, n_ticks: int) -> None:
        """One chunk for every ladder."""
        for ladder in self._ladders.values():
            ladder.step(n_ticks)

    def snapshot(self, session_id: str) -> LaneSnapshot:
        """A lane's snapshot, the tenant left serving."""
        return self.ladder_of(session_id).snapshot(session_id)

    # -- watchpoints and post-mortems -------------------------------------------
    def check_watches(self) -> dict[str, list]:
        """Drain every watch-carrying ladder's accumulators; the merged
        ``{session_id: [tripped verdicts]}`` of the whole pool (ladders over
        nets without watches are skipped)."""
        alerts: dict[str, list] = {}
        for ladder in self._ladders.values():
            if ladder.net.static.watches:
                alerts.update(ladder.check_watches())
        return alerts

    def quarantine(self, session_id: str, verdicts=()) -> Quarantined:
        """Evict a tripped tenant with its evidence (its snapshot and flight
        window); its route and activity entries go with it. The other lanes
        are untouched."""
        q = self.ladder_of(session_id).quarantine(session_id, verdicts)
        del self._routes[session_id]
        self._activity.pop(session_id, None)
        return q

    def flight(self, session_id: str) -> tuple:
        """The tenant's recorded flight window, oldest first."""
        return self.ladder_of(session_id).flight(session_id)
