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
missing payload key. Quarantine dumps and their retention wait for A10.
"""
from __future__ import annotations

import zipfile

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.engine import Engine
from repro_torch.core.network import CompiledNetwork, NetState
from repro_torch.serve.scheduler import LaneSnapshot
from repro_torch.serve.session import Session
from repro_torch.telemetry import monitors as tel

__all__ = ["CheckpointError", "save_session", "restore_session", "latest_session_step",
           "save_lane", "restore_lane"]

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
    return ckpt.save(ckpt_dir, step if step is not None else session.ticks, payload)


def restore_session(ckpt_dir: str, net: CompiledNetwork | Engine, *,
                    step: int | None = None) -> Session:
    """Rebuild a session from a checkpoint (the newest, by default) over
    the same compiled network; its next ``run(k)`` reproduces the session
    that never stopped, bit for bit."""
    engine = net if isinstance(net, Engine) else Engine(net)
    step = _latest(ckpt_dir, step, "session")
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
    return ckpt.save(ckpt_dir, step if step is not None else snap.ticks, payload)


def restore_lane(ckpt_dir: str, net: CompiledNetwork | Engine, *,
                 step: int | None = None) -> LaneSnapshot:
    """Rebuild a :class:`LaneSnapshot` from disk (the newest, by default),
    ready for ``LaneScheduler.restore`` over the same compiled network."""
    engine = net if isinstance(net, Engine) else Engine(net)
    step = _latest(ckpt_dir, step, "lane")
    has_tel = _inspect(ckpt_dir, step)
    state0 = engine.net.state0
    like = {"session_id": np.zeros((0,), np.uint8), "state": _template(state0),
            "gen_key": np.zeros(2, np.uint32), "ticks": np.int32(0),
            "tel": _tel_template(engine.net.static, state0.ring.device) if has_tel else (),
            "tel_ticks": np.int32(0)}
    payload = _restore_payload(ckpt_dir, step, like)
    return LaneSnapshot(
        session_id=bytes(np.asarray(payload["session_id"])).decode(),
        state=_unpack(payload["state"], state0),
        gen_key=_port_key(payload["gen_key"], state0.key.device),
        tel=tuple(payload["tel"]) if has_tel else None, ticks=int(payload["ticks"]),
        ticks_since_flush=int(payload["tel_ticks"]))


def latest_session_step(ckpt_dir: str) -> int | None:
    """Newest saved session step (tick cursor), or None."""
    return ckpt.latest_step(ckpt_dir)
