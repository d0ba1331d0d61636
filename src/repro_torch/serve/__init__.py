"""Session-based serving on the simulation engine (the reference's
``repro.serve``):

* :class:`Session`: one tenant's state advanced chunk by chunk, bit for
  bit the uninterrupted run, with flushable in-run telemetry
  (:class:`SessionMonitors`) and watches (``check_watches``).
* :class:`LaneScheduler`: N same-topology sessions on the lanes of one
  batched state (admit, evict, export, restore, step, flush), idle lanes
  gated silent, each lane's telemetry and watches its own, the lanes'
  bytes in the memory ledger; ``check_watches`` names the tenants whose
  watches tripped, ``quarantine`` evicts one with its evidence
  (:class:`Quarantined`), and ``flight_window`` keeps each tenant's last
  chunk-boundary snapshots.
* :class:`CapacityLadder` / :class:`ServePool` (``serve/pool.py``):
  lane-count elasticity over rungs (N ∈ {1, 8, 64, 512}) and a
  cross-topology admission router keyed by compile fingerprint, with the
  same watch surface.
* :mod:`repro_torch.serve.lifecycle`: session and lane checkpoints in the
  reference's format, telemetry included (:func:`save_session`,
  :func:`restore_session`, :func:`save_lane`, :func:`restore_lane`), and
  quarantine dumps with bounded retention (:func:`dump_quarantine`,
  :func:`rotate_dumps`).
* :func:`replay` (``serve/recorder.py``): a recorded snapshot re-run bit
  for bit.

Every layer reports to :mod:`repro_torch.obs` under the reference's
metric and event names. ``LaneScheduler``, ``CapacityLadder`` and
``ServePool`` take ``mesh=`` (a device-list mesh,
:func:`repro_torch.core.distributed.lane_mesh`): the lane axis in one
block per mesh entry, each on its entry's device.
"""
from repro_torch.serve.lifecycle import (
    CheckpointError,
    RetentionError,
    dump_quarantine,
    latest_session_step,
    restore_lane,
    restore_session,
    rotate_dumps,
    save_lane,
    save_session,
)
from repro_torch.serve.pool import RUNGS, CapacityLadder, ServePool, compile_fingerprint
from repro_torch.serve.recorder import replay
from repro_torch.serve.scheduler import Evicted, LaneScheduler, LaneSnapshot, Quarantined
from repro_torch.serve.session import Session, SessionMonitors

__all__ = [
    "CapacityLadder",
    "CheckpointError",
    "Evicted",
    "LaneScheduler",
    "LaneSnapshot",
    "Quarantined",
    "RUNGS",
    "RetentionError",
    "ServePool",
    "Session",
    "SessionMonitors",
    "compile_fingerprint",
    "dump_quarantine",
    "latest_session_step",
    "replay",
    "restore_lane",
    "restore_session",
    "rotate_dumps",
    "save_lane",
    "save_session",
]
