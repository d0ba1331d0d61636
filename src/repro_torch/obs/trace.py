"""Bounded structured tracing — nested spans + typed instants over a ring.

The serving runtime's flight recorder: a :class:`Tracer` holds the last
``capacity`` events in a ``deque`` ring (old events fall off the back, a
``dropped`` counter says how many — an unbounded horizon must not grow an
unbounded trace), timestamps everything on ``time.monotonic_ns()`` (wall
clock steps/NTP slews would corrupt span durations; the wall-clock anchor
of the ring's epoch is kept separately for correlation), and exports to
two formats:

* :meth:`Tracer.to_jsonl` — one JSON object per line, a ``{"meta": ...}``
  header first; trivially greppable/streamable.
* :meth:`Tracer.to_chrome` — the Chrome trace event format (complete
  ``"X"`` events for spans, ``"i"`` instants), loadable as-is in Perfetto
  (https://ui.perfetto.dev) or ``chrome://tracing``.

Everything here is host-side Python: spans wrap the host's enqueue of a
run or a chunk and scheduler bookkeeping, never a device computation, and
never synchronize the device, which is why the runtime gives bitwise-
identical device results with tracing on or off
(``tests/test_torch_obs.py``). The event vocabulary the runtime emits is
:data:`EVENT_KINDS`, the reference's (``repro.obs.trace``) name for name;
unknown names are allowed (category ``"custom"``) so tests and callers can
tag their own.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, IO

__all__ = ["EVENT_KINDS", "TraceEvent", "Tracer"]

# The typed vocabulary the instrumented runtime emits (category "runtime").
EVENT_KINDS = frozenset({
    "compile",            # a dispatch built or loaded kernels or launchers
    "jit_cache_hit",      # a dispatch reused what earlier ones built
    "admit",              # LaneScheduler.admit / ladder/pool admission
    "evict",              # LaneScheduler.evict (drains a final flush)
    "step_chunk",         # one chunk dispatch (scheduler fleet or session)
    "engine_run",         # one Engine.run / run_batch dispatch
    "flush",              # telemetry drain to the host
    "export",             # lane sliced out raw (migration payload)
    "restore",            # lane snapshot written back into a scheduler
    "rung_build",         # CapacityLadder built a rung's scheduler
    "rung_migrate",       # whole-fleet move between capacity rungs
    "route",              # ServePool fingerprint routing decision
    "checkpoint_save",    # lifecycle save_session / save_lane
    "checkpoint_restore", # lifecycle restore_session / restore_lane
    "watch_trip",         # an in-run watchpoint verdict tripped (alert)
    "quarantine",         # a tripped tenant evicted with its evidence
    "flight_record",      # flight recorder captured chunk-boundary snaps
    "replay",             # post-mortem re-run from a recorded snapshot
})


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One recorded span or instant.

    ``ts_us`` is microseconds since the tracer's monotonic epoch;
    ``dur_us`` is 0 for instants (``ph="i"``). ``depth`` is the nesting
    depth at emission (span stacks are per-thread), ``tid`` a small
    stable per-thread id.
    """

    name: str
    ph: str  # "X" complete span | "i" instant
    ts_us: float
    dur_us: float
    tid: int
    depth: int
    cat: str
    args: dict[str, Any]


def _cat(name: str) -> str:
    return "runtime" if name in EVENT_KINDS else "custom"


class _Span:
    """Context manager recording one complete ("X") event on exit.

    Exposes ``dur_s`` after ``__exit__`` so instrumentation sites can feed
    the same measurement into a histogram without a second timer read
    ambiguity. If the body raises, the span still records, tagged with
    ``args["error"]``.
    """

    __slots__ = ("_tracer", "name", "args", "_t0_us", "depth", "dur_s")

    def __init__(self, tracer: "Tracer", name: str, args: dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.dur_s = 0.0

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self.depth = len(stack)
        stack.append(self.name)
        self._t0_us = self._tracer._now_us()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end_us = self._tracer._now_us()
        stack = self._tracer._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        dur_us = end_us - self._t0_us
        self.dur_s = dur_us / 1e6
        args = self.args
        if exc_type is not None:
            args = {**args, "error": exc_type.__name__}
        self._tracer._append(TraceEvent(
            name=self.name, ph="X", ts_us=self._t0_us, dur_us=dur_us,
            tid=self._tracer._tid(), depth=self.depth, cat=_cat(self.name),
            args=args))
        return False


class Tracer:
    """Ring-buffered span/event recorder with JSONL and Chrome exporters."""

    def __init__(self, capacity: int = 8192):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buf: deque[TraceEvent] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._tids: dict[int, int] = {}
        self._tid_counter = itertools.count(1)
        self.dropped = 0
        self._epoch_ns = time.monotonic_ns()
        self.epoch_unix = time.time()  # wall anchor of ts_us == 0

    # -- recording --------------------------------------------------------
    def span(self, name: str, **args: Any) -> _Span:
        """Context manager: ``with tracer.span("step_chunk", rung=...):``."""
        return _Span(self, name, args)

    def event(self, name: str, **args: Any) -> None:
        """Record an instant (``ph="i"``) event."""
        self._append(TraceEvent(
            name=name, ph="i", ts_us=self._now_us(), dur_us=0.0,
            tid=self._tid(), depth=len(self._stack()), cat=_cat(name),
            args=args))

    def _append(self, ev: TraceEvent) -> None:
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(ev)

    # -- inspection -------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def snapshot(self) -> list[TraceEvent]:
        """The retained events, oldest first (a copy; safe to iterate)."""
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    # -- exporters --------------------------------------------------------
    def to_jsonl(self, path_or_file: str | IO[str]) -> None:
        """One JSON object per line; first line is a ``{"meta": ...}``
        header carrying the wall-clock epoch and drop count."""
        events = self.snapshot()
        meta = {"meta": {
            "epoch_unix": self.epoch_unix,
            "clock": "monotonic",
            "capacity": self.capacity,
            "dropped": self.dropped,
            "retained": len(events),
        }}

        def write(f: IO[str]) -> None:
            f.write(json.dumps(meta, default=str) + "\n")
            for e in events:
                f.write(json.dumps(dataclasses.asdict(e), default=str) + "\n")

        if isinstance(path_or_file, str):
            parent = os.path.dirname(path_or_file)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(path_or_file, "w") as f:
                write(f)
        else:
            write(path_or_file)

    def to_chrome(self, path_or_file: str | IO[str]) -> None:
        """Chrome trace event format (JSON object with ``traceEvents``) —
        open the file directly in Perfetto or ``chrome://tracing``.
        Timestamps are the native microseconds the format expects."""
        pid = os.getpid()
        trace_events: list[dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "repro_torch.obs"},
        }]
        for e in self.snapshot():
            ev: dict[str, Any] = {
                "name": e.name, "cat": e.cat, "ph": e.ph, "ts": e.ts_us,
                "pid": pid, "tid": e.tid, "args": e.args,
            }
            if e.ph == "X":
                ev["dur"] = e.dur_us
            else:
                ev["s"] = "t"  # instant scoped to its thread track
            trace_events.append(ev)
        doc = {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "otherData": {"epoch_unix": self.epoch_unix,
                          "dropped": self.dropped},
        }
        if isinstance(path_or_file, str):
            parent = os.path.dirname(path_or_file)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(path_or_file, "w") as f:
                json.dump(doc, f, default=str)
        else:
            json.dump(doc, path_or_file, default=str)

    # -- internals --------------------------------------------------------
    def _now_us(self) -> float:
        return (time.monotonic_ns() - self._epoch_ns) / 1e3

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, next(self._tid_counter))
        return tid

    def _stack(self) -> list[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack
