"""Memory ledger: the paper's TLSF ramp-up accounting over torch tensors.

The paper instruments CARLsim's seven load steps (Init, Random Gen, Conn
Info, Syn State, Neuron State, Group State, Auxiliary Data) and prints
Tables III/IV. ``NetworkBuilder.compile`` registers every tensor it
allocates under those stage names; the ledger counts bytes exactly
(numel × element size) and enforces a device budget (8.477 MB emulates
the MCU). Serving adds an eighth stage, "8. Serve Lanes": a
``repro_torch.serve.LaneScheduler`` registers its per-lane state there
under ``serve.lanes[.<key>]`` and releases it when it closes or is
replaced. Every register and release republishes the ledger's bytes as
observability gauges (``repro_ledger_bytes``, ``repro_ledger_stage_bytes``,
``repro_ledger_total_bytes``, ``repro_serve_rung_bytes``), as the
reference's ledger does.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Any, Iterator

from repro_torch import obs
from repro_torch.precision.policy import tree_bytes

__all__ = ["MemoryBudgetError", "MemoryLedger", "PAPER_STAGES",
           "MCU_BUDGET_BYTES"]

# The seven CARLsim load steps from the paper (Tables III/IV).
PAPER_STAGES = (
    "1. CARLsim Init.",
    "2. Random Gen.",
    "3. Conn. Info",
    "4. Syn. State",
    "5. Neuron State",
    "6. Group State",
    "7. Auxiliary Data",
)

MCU_BUDGET_BYTES = int(8.477 * 1024**2)  # SparkFun Pro Micro SRAM+PSRAM (Table III)


class MemoryBudgetError(RuntimeError):
    """Raised when a registration would exceed the device budget."""


@dataclasses.dataclass
class _Entry:
    stage: str
    name: str
    nbytes: int


class MemoryLedger:
    """Stage-by-stage byte accounting with budget enforcement."""

    def __init__(self, budget: int | None = None, *, name: str = "device"):
        self.budget = budget
        self.name = name
        self._entries: list[_Entry] = []
        self._current_stage: str | None = None

    def child(self, suffix: str, budget: int | None = None) -> "MemoryLedger":
        """A derived ledger named ``<name>/<suffix>`` with its own budget
        (``budget``, else this ledger's): one per partition core, so the
        paper's 8.477 MB ceiling holds per core rather than globally."""
        return MemoryLedger(budget=self.budget if budget is None else budget,
                            name=f"{self.name}/{suffix}")

    @contextmanager
    def stage(self, stage: str) -> Iterator[None]:
        prev, self._current_stage = self._current_stage, stage
        try:
            yield
        finally:
            self._current_stage = prev

    def register(self, name: str, tree: Any, *, stage: str | None = None) -> int:
        """Account a tree of tensors' bytes; returns the bytes added."""
        stage = stage or self._current_stage or "7. Auxiliary Data"
        nbytes = tree_bytes(tree)
        if self.budget is not None and self.total_used + nbytes > self.budget:
            raise MemoryBudgetError(
                f"{self.name}: stage {stage!r} adding {nbytes / 1024**2:.3f} MB "
                f"exceeds budget {self.budget / 1024**2:.3f} MB "
                f"(used {self.total_used / 1024**2:.3f} MB)"
            )
        self._entries.append(_Entry(stage=stage, name=name, nbytes=nbytes))
        self._obs_sync()
        return nbytes

    def release(self, name: str) -> int:
        """Remove the entries registered under ``name``; returns the bytes
        freed."""
        freed = sum(e.nbytes for e in self._entries if e.name == name)
        self._entries = [e for e in self._entries if e.name != name]
        self._obs_sync()
        return freed

    def _obs_sync(self) -> None:
        """Republish this ledger's live bytes as obs gauges (per name, per
        stage, total, per serving rung). Stale series of released
        registrations are dropped first, so the gauges always mirror
        ``name_bytes()``, also after a rung migration sheds its old lanes."""
        if not obs.enabled():
            return
        for g in ("repro_ledger_bytes", "repro_ledger_stage_bytes",
                  "repro_ledger_total_bytes", "repro_serve_rung_bytes"):
            obs.remove_gauge(g, ledger=self.name)
        for name, nb in self.name_bytes().items():
            obs.gauge("repro_ledger_bytes", float(nb), ledger=self.name, name=name)
        for stage, nb in self.stage_bytes().items():
            obs.gauge("repro_ledger_stage_bytes", float(nb), ledger=self.name, stage=stage)
        obs.gauge("repro_ledger_total_bytes", float(self.total_used), ledger=self.name)
        for rung, nb in self.serve_rung_bytes().items():
            obs.gauge("repro_serve_rung_bytes", float(nb), ledger=self.name,
                      rung=rung or "unkeyed")

    @property
    def total_used(self) -> int:
        return sum(e.nbytes for e in self._entries)

    @property
    def total_available(self) -> int | None:
        """Bytes left under the budget (None when unbudgeted)."""
        if self.budget is None:
            return None
        return self.budget - self.total_used

    def stage_bytes(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self._entries:
            out[e.stage] = out.get(e.stage, 0) + e.nbytes
        return out

    def name_bytes(self) -> dict[str, int]:
        """Bytes per registration name, summed across stages."""
        out: dict[str, int] = {}
        for e in self._entries:
            out[e.name] = out.get(e.name, 0) + e.nbytes
        return out

    def monitor_bytes(self) -> int:
        """Telemetry/monitor payload bytes: the in-run accumulator state
        (``monitor.telemetry``, registered by ``network.compile``: the peak
        monitor-state footprint of a ``record="monitors"`` run) plus any
        post-hoc raster buffer hint (``monitor.spikes``)."""
        nb = self.name_bytes()
        return sum(v for k, v in nb.items() if k.startswith("monitor."))

    def serve_bytes(self) -> int:
        """Serving bytes: the per-lane session state registered by
        ``repro_torch.serve.LaneScheduler`` (the ``serve.*`` names of stage
        "8. Serve Lanes")."""
        nb = self.name_bytes()
        return sum(v for k, v in nb.items() if k.startswith("serve."))

    def serve_rung_bytes(self) -> dict[str, int]:
        """Serving bytes per ledger key: ``serve.lanes`` and
        ``serve.telemetry`` registrations grouped by the suffix after the
        prefix (``serve.lanes.rung64`` under ``"rung64"``; an un-keyed
        scheduler under ``""``)."""
        out: dict[str, int] = {}
        for e in self._entries:
            for prefix in ("serve.lanes", "serve.telemetry"):
                if e.name == prefix or e.name.startswith(prefix + "."):
                    key = e.name[len(prefix) + 1:]
                    out[key] = out.get(key, 0) + e.nbytes
        return out

    def synapse_bytes(self) -> int:
        """Connectivity + weight payload bytes (the paper's fp16 headline):
        dense masks/weights plus CSR index tables, whichever each
        projection stores."""
        nb = self.name_bytes()
        return sum(nb.get(k, 0) for k in ("weights", "masks", "csr.indices"))

    def rampup_rows(self) -> list[dict[str, float]]:
        """Rows in the paper's Table III/IV format (MB), in stage order."""
        per_stage = self.stage_bytes()
        ordered = [s for s in PAPER_STAGES if s in per_stage]
        ordered += [s for s in per_stage if s not in PAPER_STAGES]
        rows, used = [], 0
        for s in ordered:
            used += per_stage[s]
            row = {
                "stage": s,
                "mem_size_mb": per_stage[s] / 1024**2,
                "total_used_mb": used / 1024**2,
            }
            if self.budget is not None:
                row["total_available_mb"] = (self.budget - used) / 1024**2
            rows.append(row)
        return rows

    def format_table(self) -> str:
        """Render the ramp-up in the paper's Table III layout."""
        lines = []
        header = f"{'Simulation load step':<24}{'Mem. Size':>12}{'Total Used':>12}"
        if self.budget is not None:
            header += f"{'Total Available':>18}"
            lines.append(
                f"{'(budget)':<24}{'':>12}{'':>12}{self.budget / 1024**2:>15.3f} MB"
            )
        lines.insert(0, header)
        for row in self.rampup_rows():
            line = (
                f"{row['stage']:<24}"
                f"{row['mem_size_mb']:>9.3f} MB"
                f"{row['total_used_mb']:>9.3f} MB"
            )
            if "total_available_mb" in row:
                line += f"{row['total_available_mb']:>15.3f} MB"
            lines.append(line)
        return "\n".join(lines)
