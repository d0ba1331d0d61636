"""Session-based serving on the simulation engine (the reference's
``repro.serve``), as far as it is ported:

* :class:`Session`: one tenant's state advanced chunk by chunk, bit for
  bit the uninterrupted run, with flushable in-run telemetry
  (:class:`SessionMonitors`).
* :class:`LaneScheduler`: N same-topology sessions on the lanes of one
  batched state (admit, evict, export, restore, step, flush), idle lanes
  gated silent, each lane's telemetry its own, the lanes' bytes in the
  memory ledger.
* :class:`CapacityLadder` / :class:`ServePool` (``serve/pool.py``):
  lane-count elasticity over rungs (N ∈ {1, 8, 64, 512}) and a
  cross-topology admission router keyed by compile fingerprint.
* :mod:`repro_torch.serve.lifecycle`: session and lane checkpoints in the
  reference's format, telemetry included (:func:`save_session`,
  :func:`restore_session`, :func:`save_lane`, :func:`restore_lane`).

Later ports: watchpoints, quarantine and the flight recorder
(``serve/recorder.py``) and the pool's observability calls after ROADMAP
A10; the mesh-sharded lane axis after A11.
"""
from repro_torch.serve.lifecycle import (
    CheckpointError,
    latest_session_step,
    restore_lane,
    restore_session,
    save_lane,
    save_session,
)
from repro_torch.serve.pool import RUNGS, CapacityLadder, ServePool, compile_fingerprint
from repro_torch.serve.scheduler import Evicted, LaneScheduler, LaneSnapshot
from repro_torch.serve.session import Session, SessionMonitors

__all__ = [
    "CapacityLadder",
    "CheckpointError",
    "Evicted",
    "LaneScheduler",
    "LaneSnapshot",
    "RUNGS",
    "ServePool",
    "Session",
    "SessionMonitors",
    "compile_fingerprint",
    "latest_session_step",
    "restore_lane",
    "restore_session",
    "save_lane",
    "save_session",
]
