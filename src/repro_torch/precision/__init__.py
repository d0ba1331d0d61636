from repro_torch.precision.policy import (
    POLICIES,
    PrecisionPolicy,
    get_policy,
    load_tree,
    store_tree,
    tree_bytes,
)
from repro_torch.precision.quant import QTensor, dequantize, quantize_int8

__all__ = [
    "POLICIES",
    "PrecisionPolicy",
    "get_policy",
    "load_tree",
    "store_tree",
    "tree_bytes",
    "QTensor",
    "dequantize",
    "quantize_int8",
]
