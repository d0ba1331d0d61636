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

The reference's observability calls (spans, counters, route events) wait
for ROADMAP A10, as do watchpoints, quarantine and the flight recorder
(those methods raise); the mesh-sharded lane axis (``mesh=``) is A11.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.core.network import CompiledNetwork, NetState
from repro_torch.serve.scheduler import Evicted, LaneScheduler, LaneSnapshot

__all__ = ["CapacityLadder", "ServePool", "compile_fingerprint", "RUNGS"]

RUNGS = (1, 8, 64, 512)


def _leaves(tree):
    """The tensors and numbers of a tree of NamedTuples, tuples, lists and
    dicts, in order (None and ``()`` hold none)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


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
    for leaf in _leaves((net.params, net.state0.weights)):
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        h.update(str((arr.dtype, arr.shape)).encode())
        h.update(arr.tobytes())
    fp = h.hexdigest()
    net._fingerprint = fp
    return fp


def _unported_watches(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: in-run watchpoints, quarantine and the flight "
                               "recorder are not ported to repro_torch yet (ROADMAP A10)")


class CapacityLadder:
    """Elastic lane capacity for one topology through rung-to-rung migration.

    The ladder builds a :class:`LaneScheduler` at the smallest rung that
    fits the fleet on the first admit, and migrates the whole fleet
    (``export_all`` → ``restore``) whenever occupancy crosses rung
    boundaries: up on the admit that would overflow, down after
    ``idle_after`` consecutive :meth:`step` calls during which a smaller
    rung would have sufficed (hysteresis: one transient eviction does not
    thrash the ladder). Per-rung ledger names carry ``ledger_prefix``.
    ``mesh`` (A11) and ``flight_window > 0`` (A10) raise.
    """

    def __init__(self, net: CompiledNetwork, *, rungs=RUNGS, record: str = "monitors",
                 mesh=None, mesh_axis: str = "lanes", idle_after: int = 2,
                 ledger_prefix: str = "", lane_chooser=None, flight_window: int = 0):
        if not rungs:
            raise ValueError("need at least one rung")
        if mesh is not None:
            raise NotImplementedError(
                "CapacityLadder(mesh=...): sharding the lane axis across cards is not "
                "ported to repro_torch yet (ROADMAP A11)")
        if flight_window:
            raise NotImplementedError(
                "CapacityLadder(flight_window=...): the flight recorder is not ported to "
                "repro_torch yet (ROADMAP A10)")
        self.net = net
        self.flight_window = flight_window
        # Optional admission policy hook: called with the live scheduler,
        # returns a free lane (or None for first-fit); the pool's best-fit
        # policy routes through it.
        self._lane_chooser = lane_chooser
        self.rungs = tuple(sorted(set(int(r) for r in rungs)))
        self.record = record
        self.mesh = None
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
        return LaneScheduler(self.net, n, record=self.record,
                             ledger_key=f"{self.ledger_prefix}rung{n}")

    def _migrate(self, new_rung: int) -> None:
        """Move the whole fleet to ``new_rung`` through raw lane snapshots
        (no flush, no stream perturbation, no telemetry drain), releasing
        the old rung's ledger registrations."""
        snaps: list[LaneSnapshot] = []
        if self._sched is not None:
            snaps = self._sched.export_all()
            self._sched.close()
        self._sched = self._build(new_rung)
        for snap in snaps:
            self._sched.restore(snap)
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
        raise _unported_watches("CapacityLadder.check_watches")

    def quarantine(self, session_id: str, verdicts=()):
        raise _unported_watches("CapacityLadder.quarantine")

    def flight(self, session_id: str) -> tuple:
        raise _unported_watches("CapacityLadder.flight")

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
        if mesh is not None:
            raise NotImplementedError(
                "ServePool(mesh=...): sharding the lane axis across cards is not ported "
                "to repro_torch yet (ROADMAP A11)")
        if flight_window:
            raise NotImplementedError(
                "ServePool(flight_window=...): the flight recorder is not ported to "
                "repro_torch yet (ROADMAP A10)")
        self._opts = dict(rungs=rungs, record=record, mesh_axis=mesh_axis,
                          idle_after=idle_after)
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

    # -- later ports ----------------------------------------------------------
    def check_watches(self) -> dict[str, list]:
        raise _unported_watches("ServePool.check_watches")

    def quarantine(self, session_id: str, verdicts=()):
        raise _unported_watches("ServePool.quarantine")

    def flight(self, session_id: str) -> tuple:
        raise _unported_watches("ServePool.flight")
