"""Session-based serving on the simulation engine (the reference's
``repro.serve``), as far as it is ported:

* :class:`Session`: one tenant's state advanced chunk by chunk, bit for
  bit the uninterrupted run.
* :class:`LaneScheduler`: N same-topology sessions on the lanes of one
  batched state (admit, evict, export, restore, step), idle lanes gated
  silent, the lanes' bytes in the memory ledger.
* :mod:`repro_torch.serve.lifecycle`: session and lane checkpoints in the
  reference's format (:func:`save_session`, :func:`restore_session`,
  :func:`save_lane`, :func:`restore_lane`).

Later ports: session and lane telemetry (``SessionMonitors``, ``flush``)
and the capacity ladder and pool (``serve/pool.py``) after ROADMAP A6;
watchpoints, quarantine and the flight recorder (``serve/recorder.py``)
after A10; the mesh-sharded lane axis after A11.
"""
from repro_torch.serve.lifecycle import (
    CheckpointError,
    latest_session_step,
    restore_lane,
    restore_session,
    save_lane,
    save_session,
)
from repro_torch.serve.scheduler import Evicted, LaneScheduler, LaneSnapshot
from repro_torch.serve.session import Session

__all__ = [
    "CheckpointError",
    "Evicted",
    "LaneScheduler",
    "LaneSnapshot",
    "Session",
    "latest_session_step",
    "restore_lane",
    "restore_session",
    "save_lane",
    "save_session",
]
