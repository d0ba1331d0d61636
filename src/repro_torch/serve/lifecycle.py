"""Session and lane checkpoints, in the reference's format.

:func:`save_session` / :func:`restore_session` persist a live session (its
``NetState``: weights mid-STDP, delay ring, homeostasis averages; its
stimulus key; its tick cursor) and :func:`save_lane` /
:func:`restore_lane` a scheduler lane (a :class:`LaneSnapshot`), through
:mod:`repro_torch.checkpoint.ckpt`'s atomic npz writer. The payload is the
reference's (``repro.serve.lifecycle``) leaf for leaf: a ``fmt`` format
stamp, the state with its tick as int32 and its key as the two ``uint32``
key words (the port keeps them as int32 bit patterns), ``gen_key``,
``ticks``, ``tel`` (the cumulative telemetry slots: a SpikeCount's int32
counts and a GroupRate's f32 levels per neuron) and ``tel_ticks`` (ticks
since the last flush), and a lane's ``session_id`` as UTF-8 bytes. So a
session saved by either package resumes in the other and continues bit
for bit, its next flush included.

Restore validates the file before reading the payload and raises
:class:`CheckpointError` (with the file's path and the implicated key) for
a corrupt or truncated archive, a missing or foreign format stamp, and a
missing payload key, with a ``checkpoint_restore`` failure event on the
obs trace. Saves and restores report spans and counters
(``repro_checkpoint_saves_total``, ``repro_checkpoint_restores_total``).

Quarantine dumps (:func:`dump_quarantine`) persist a quarantined tenant's
evidence, every snapshot through :func:`save_lane`, in the reference's
layout and manifest, so either package restores the other's dump;
:func:`rotate_dumps` caps their count and bytes (:class:`RetentionError`).
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import ckpt
from repro_torch.core.engine import Engine
from repro_torch.core.network import CompiledNetwork, NetState
from repro_torch.serve.scheduler import LaneSnapshot
from repro_torch.serve.session import Session
from repro_torch.telemetry import monitors as tel

__all__ = ["CheckpointError", "RetentionError", "save_session", "restore_session",
           "latest_session_step", "save_lane", "restore_lane", "dump_quarantine",
           "rotate_dumps"]

#: Format version stamped into every lifecycle checkpoint; restore refuses
#: any other (the reference's ``_CKPT_FORMAT``).
_CKPT_FORMAT = 1


class CheckpointError(RuntimeError):
    """A lifecycle checkpoint could not be read back: a corrupt or
    truncated archive, a missing payload key, or a format this build does
    not read. ``path`` is the file; ``key`` the implicated payload key
    (``"fmt"`` for the format stamp), where there is one."""

    def __init__(self, message: str, *, path: str | None = None, key: str | None = None):
        super().__init__(message)
        self.path = path
        self.key = key


class RetentionError(CheckpointError):
    """Quarantine-dump retention misconfigured or unenforceable: invalid
    caps (``keep_last < 1``, ``max_bytes < 1``) or a dump root that exists
    but is not a directory."""


def _key_words(key: torch.Tensor) -> np.ndarray:
    """A port key (int32 ``[2]``) as the reference writes it: ``uint32``."""
    return key.detach().cpu().numpy().view(np.uint32)


def _port_key(words: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(words, np.uint32).view(np.int32).copy()).to(device)


def _pack(state: NetState) -> NetState:
    return state._replace(t=np.int32(state.t), key=_key_words(state.key))


def _unpack(payload: NetState, like: NetState) -> NetState:
    return payload._replace(t=int(payload.t), key=_port_key(payload.key, like.key.device))


def _template(net_state: NetState) -> NetState:
    """The restore template of a state: its tensors, the tick as int32 and
    the key as ``uint32`` words."""
    return net_state._replace(t=np.int32(0), key=np.zeros(2, np.uint32))


def _tel_template(static, device) -> tuple:
    """The restore template of a persistent telemetry carry: the cumulative
    slots at their compiled shapes, ``()`` elsewhere (as
    ``SessionMonitors.absorb`` strips them)."""
    return tuple(c if isinstance(s, tel.CUMULATIVE) else ()
                 for s, c in zip(static.monitors, tel.init_carry(static, 1, device=device)))


def _fail(message: str, *, path: str, key: str | None = None):
    """Record the failure on the obs plane, then raise the typed error."""
    obs.event("checkpoint_restore", status="error", path=path, key=key or "", reason=message)
    obs.inc("repro_checkpoint_restores_total", status="error")
    raise CheckpointError(f"{message} [{path}]", path=path, key=key)


def _inspect(ckpt_dir: str, step: int) -> bool:
    """Validate a checkpoint file before restoring from it; returns whether
    it holds telemetry accumulators (a session saved before its first
    chunk, or over a monitor-free net, holds none)."""
    path = ckpt.step_path(ckpt_dir, step)
    try:
        with np.load(path, allow_pickle=False) as data:
            files = set(data.files)
            fmt = int(data["['fmt']"]) if "['fmt']" in files else None
            has_tel = any(k.startswith("['tel']") for k in files)
    except FileNotFoundError:
        raise  # a missing file is not a bad file
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
        _fail(f"corrupt or truncated checkpoint: {e}", path=path)
    if fmt is None:
        _fail("checkpoint has no format stamp (foreign or pre-versioning writer)",
              path=path, key="fmt")
    if fmt != _CKPT_FORMAT:
        _fail(f"unsupported checkpoint format {fmt} (this build reads {_CKPT_FORMAT})",
              path=path, key="fmt")
    return has_tel


def _restore_payload(ckpt_dir: str, step: int, like: dict) -> dict:
    """``ckpt.restore`` with missing-key errors typed and path-tagged."""
    try:
        return ckpt.restore(ckpt_dir, step, like)
    except KeyError as e:
        _fail(f"checkpoint missing payload key {e.args[0]!r}",
              path=ckpt.step_path(ckpt_dir, step), key=str(e.args[0]))


def _latest(ckpt_dir: str, step: int | None, what: str) -> int:
    if step is None:
        step = ckpt.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no {what} checkpoints in {ckpt_dir}")
    return step


def save_session(ckpt_dir: str, session: Session, *, step: int | None = None) -> str:
    """Atomically persist a session; returns the checkpoint path. ``step``
    defaults to the session's tick cursor."""
    has_tel = session.monitors is not None and session.monitors.carry is not None
    payload = {
        "fmt": np.int32(_CKPT_FORMAT),
        "state": _pack(session.state),
        "gen_key": _key_words(session.gen_key),
        "ticks": np.int32(session.ticks),
        "tel": session.monitors.carry if has_tel else (),
        "tel_ticks": np.int32(session.monitors.ticks_since_flush if has_tel else 0),
    }
    step = step if step is not None else session.ticks
    with obs.span("checkpoint_save", kind="session", step=step):
        path = ckpt.save(ckpt_dir, step, payload)
    obs.inc("repro_checkpoint_saves_total", kind="session")
    return path


def restore_session(ckpt_dir: str, net: CompiledNetwork | Engine, *,
                    step: int | None = None) -> Session:
    """Rebuild a session from a checkpoint (the newest, by default) over
    the same compiled network; its next ``run(k)`` reproduces the session
    that never stopped, bit for bit."""
    engine = net if isinstance(net, Engine) else Engine(net)
    step = _latest(ckpt_dir, step, "session")
    with obs.span("checkpoint_restore", kind="session", step=step):
        has_tel = _inspect(ckpt_dir, step)
        state0 = engine.net.state0
        dev = state0.ring.device
        like = {"state": _template(state0), "gen_key": np.zeros(2, np.uint32),
                "ticks": np.int32(0),
                "tel": _tel_template(engine.net.static, dev) if has_tel else (),
                "tel_ticks": np.int32(0)}
        payload = _restore_payload(ckpt_dir, step, like)
        session = Session.create(engine, key=_port_key(payload["gen_key"], state0.key.device),
                                 state=_unpack(payload["state"], state0))
        session.ticks = int(payload["ticks"])
        if session.monitors is not None and has_tel:
            session.monitors.carry = tuple(payload["tel"])
            session.monitors.ticks_since_flush = int(payload["tel_ticks"])
    obs.inc("repro_checkpoint_restores_total", status="ok")
    return session


def save_lane(ckpt_dir: str, snap: LaneSnapshot, *, step: int | None = None) -> str:
    """Persist an exported scheduler lane; ``step`` defaults to the lane's
    tick cursor."""
    payload = {
        "fmt": np.int32(_CKPT_FORMAT),
        "session_id": np.frombuffer(snap.session_id.encode(), np.uint8),
        "state": _pack(snap.state),
        "gen_key": _key_words(snap.gen_key),
        "ticks": np.int32(snap.ticks),
        "tel": snap.tel if snap.tel is not None else (),
        "tel_ticks": np.int32(snap.ticks_since_flush),
    }
    step = step if step is not None else snap.ticks
    with obs.span("checkpoint_save", kind="lane", step=step):
        path = ckpt.save(ckpt_dir, step, payload)
    obs.inc("repro_checkpoint_saves_total", kind="lane")
    return path


def restore_lane(ckpt_dir: str, net: CompiledNetwork | Engine, *,
                 step: int | None = None) -> LaneSnapshot:
    """Rebuild a :class:`LaneSnapshot` from disk (the newest, by default),
    ready for ``LaneScheduler.restore`` over the same compiled network."""
    engine = net if isinstance(net, Engine) else Engine(net)
    step = _latest(ckpt_dir, step, "lane")
    with obs.span("checkpoint_restore", kind="lane", step=step):
        has_tel = _inspect(ckpt_dir, step)
        state0 = engine.net.state0
        like = {"session_id": np.zeros((0,), np.uint8), "state": _template(state0),
                "gen_key": np.zeros(2, np.uint32), "ticks": np.int32(0),
                "tel": _tel_template(engine.net.static, state0.ring.device) if has_tel else (),
                "tel_ticks": np.int32(0)}
        payload = _restore_payload(ckpt_dir, step, like)
        snap = LaneSnapshot(
            session_id=bytes(np.asarray(payload["session_id"])).decode(),
            state=_unpack(payload["state"], state0),
            gen_key=_port_key(payload["gen_key"], state0.key.device),
            tel=tuple(payload["tel"]) if has_tel else None, ticks=int(payload["ticks"]),
            ticks_since_flush=int(payload["tel_ticks"]))
    obs.inc("repro_checkpoint_restores_total", status="ok")
    return snap


def latest_session_step(ckpt_dir: str) -> int | None:
    """Newest saved session step (tick cursor), or None."""
    return ckpt.latest_step(ckpt_dir)


# -- quarantine dump retention --------------------------------------------------
#
# A quarantined tenant leaves evidence on disk: its final snapshot, the
# flight window behind it, and a manifest tying both to the verdicts that
# tripped. Retention is count- and byte-capped, oldest dumps dropped first,
# the newest always kept.

def _dump_dirs(dump_dir: str) -> list[str]:
    """Completed dump directories under ``dump_dir``, oldest first. Only
    directories holding a ``manifest.json`` count: a crashed half-written
    dump is never rotation's to delete."""
    if not os.path.isdir(dump_dir):
        return []
    out = []
    for name in os.listdir(dump_dir):
        d = os.path.join(dump_dir, name)
        if os.path.isdir(d) and os.path.isfile(os.path.join(d, "manifest.json")):
            out.append(d)
    out.sort(key=lambda d: (os.path.getmtime(os.path.join(d, "manifest.json")), d))
    return out


def _dir_bytes(d: str) -> int:
    total = 0
    for root, _, files in os.walk(d):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    return total


def rotate_dumps(dump_dir: str, *, keep_last: int = 8,
                 max_bytes: int | None = None) -> list[str]:
    """Enforce the retention caps over ``dump_dir``; returns what was
    removed (paths, oldest first).

    Keeps at most ``keep_last`` dumps and (when ``max_bytes`` is set) at
    most that many bytes in all, dropping the oldest manifest first; the
    newest dump survives even if it alone exceeds ``max_bytes``. The
    footprint left lands on the ``repro_quarantine_dump_bytes`` gauge.
    """
    if keep_last < 1:
        raise RetentionError(f"keep_last must be >= 1, got {keep_last} — retention may "
                             "never delete the newest dump", path=dump_dir)
    if max_bytes is not None and max_bytes < 1:
        raise RetentionError(f"max_bytes must be >= 1 (or None), got {max_bytes}",
                             path=dump_dir)
    if os.path.exists(dump_dir) and not os.path.isdir(dump_dir):
        raise RetentionError(f"dump root is not a directory: {dump_dir}", path=dump_dir)
    dumps = _dump_dirs(dump_dir)
    sizes = {d: _dir_bytes(d) for d in dumps}
    removed: list[str] = []
    while len(dumps) > 1 and (len(dumps) > keep_last or (
            max_bytes is not None and sum(sizes[d] for d in dumps) > max_bytes)):
        victim = dumps.pop(0)
        shutil.rmtree(victim)
        removed.append(victim)
    obs.gauge("repro_quarantine_dump_bytes", float(sum(sizes[d] for d in dumps)))
    return removed


def dump_quarantine(dump_dir: str, q, *, keep_last: int = 8,
                    max_bytes: int | None = None) -> str:
    """Persist a :class:`~repro_torch.serve.Quarantined` tenant's evidence;
    returns the dump directory.

    The reference's layout (one directory per quarantine, named by session
    id and tick so that repeat offenders do not collide)::

        <dump_dir>/<session_id>_<ticks>/
            final/step_*.npz    # the evicted lane's snapshot
            flight/step_*.npz   # the flight window, one per chunk boundary
            manifest.json       # verdicts, ticks, files, bytes

    Every snapshot goes through :func:`save_lane`, so any of them feeds
    ``serve.recorder.replay`` or a scheduler's ``restore`` (this package's
    or the reference's) through ``restore_lane``. The manifest is written
    last (a temporary file, then a rename): a dump without one is a crashed
    write, which rotation leaves alone. The retention caps are enforced on
    the way out (:func:`rotate_dumps`).
    """
    snap = q.snapshot
    ddir = os.path.join(dump_dir, f"{q.session_id}_{snap.ticks:010d}")
    os.makedirs(ddir, exist_ok=True)
    with obs.span("checkpoint_save", kind="quarantine_dump", session=q.session_id,
                  step=snap.ticks):
        final_path = save_lane(os.path.join(ddir, "final"), snap)
        flight_paths = [save_lane(os.path.join(ddir, "flight"), s) for s in q.recording]
        manifest = {
            "format": _CKPT_FORMAT,
            "session_id": q.session_id,
            "ticks": int(snap.ticks),
            "verdicts": [v.as_dict() for v in q.verdicts],
            "final": os.path.relpath(final_path, ddir),
            "flight": [os.path.relpath(p, ddir) for p in flight_paths],
            "flight_ticks": [int(s.ticks) for s in q.recording],
            "bytes": _dir_bytes(ddir),
        }
        tmp = os.path.join(ddir, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2)
        os.replace(tmp, os.path.join(ddir, "manifest.json"))
    rotate_dumps(dump_dir, keep_last=keep_last, max_bytes=max_bytes)
    return ddir
