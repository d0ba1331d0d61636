from repro_torch.memory.ledger import (
    MCU_BUDGET_BYTES,
    PAPER_STAGES,
    MemoryBudgetError,
    MemoryLedger,
)

__all__ = ["MCU_BUDGET_BYTES", "PAPER_STAGES", "MemoryBudgetError",
           "MemoryLedger"]
