"""Network configurations: the paper's Synfire nets."""
from repro_torch.configs.synfire4 import (
    SYNFIRE4,
    SYNFIRE4_MINI,
    SYNFIRE4_X10,
    SynfireConfig,
    build_synfire,
    scale_synfire,
)

__all__ = ["SYNFIRE4", "SYNFIRE4_MINI", "SYNFIRE4_X10", "SynfireConfig",
           "build_synfire", "scale_synfire"]
