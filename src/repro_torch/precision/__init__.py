from repro_torch.precision.policy import (
    POLICIES,
    PrecisionPolicy,
    get_policy,
    tree_bytes,
)

__all__ = ["POLICIES", "PrecisionPolicy", "get_policy", "tree_bytes"]
