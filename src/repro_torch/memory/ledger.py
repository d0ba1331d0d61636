"""Memory ledger: the paper's TLSF ramp-up accounting over torch tensors.

The paper instruments CARLsim's seven load steps (Init, Random Gen, Conn
Info, Syn State, Neuron State, Group State, Auxiliary Data) and prints
Tables III/IV. ``NetworkBuilder.compile`` registers every tensor it
allocates under those stage names; the ledger counts bytes exactly
(numel × element size) and enforces a device budget (8.477 MB emulates
the MCU).
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Any, Iterator

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
        return nbytes

    @property
    def total_used(self) -> int:
        return sum(e.nbytes for e in self._entries)

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

    def synapse_bytes(self) -> int:
        """Connectivity + weight payload bytes (the paper's fp16 headline):
        dense masks/weights plus CSR index tables, whichever each
        projection stores."""
        nb = self.name_bytes()
        return sum(nb.get(k, 0) for k in ("weights", "masks", "csr.indices"))
