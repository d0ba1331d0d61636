"""Precision policies: the paper's fp16-storage technique as a knob.

The paper stores CARLsim's synaptic data as IEEE binary16 while arithmetic
is promoted to f32 (ARM softfp promotes ``__fp16`` operands). A
:class:`PrecisionPolicy` names the *storage* dtypes of data at rest
(synaptic weights and LM parameters; neuron state, the delay ring and KV
caches) and the *compute* dtype math runs in, f32 under both policies.
``fp16`` reproduces the paper; ``fp32`` is its reference build.
Downcasts round to nearest even, as ``torch.Tensor.to`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["PrecisionPolicy", "POLICIES", "get_policy", "tree_bytes"]


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Storage dtype assignment, mirroring the paper's fp16 port.

    Attributes:
      name: registry key.
      param_storage: dtype of synaptic weights and LM parameters at rest.
      state_storage: dtype of large mutable state at rest (neuron state,
        delay ring, KV caches).
      compute: dtype math and activations run in (softfp promotion
        analogue).
    """

    name: str
    param_storage: torch.dtype
    state_storage: torch.dtype
    compute: torch.dtype = torch.float32


POLICIES: dict[str, PrecisionPolicy] = {
    # The paper's reference build: IEEE single floats everywhere.
    "fp32": PrecisionPolicy("fp32", torch.float32, torch.float32),
    # The paper's contribution: IEEE fp16 storage, f32 compute (softfp).
    "fp16": PrecisionPolicy("fp16", torch.float16, torch.float16),
}


def get_policy(name: str) -> PrecisionPolicy:
    try:
        return POLICIES[name]
    except KeyError as e:
        raise KeyError(
            f"unknown precision policy {name!r}; have {sorted(POLICIES)}") from e


def tree_bytes(tree: Any) -> int:
    """Total bytes of the tensors in a nested tuple/list/dict/NamedTuple.

    ``None`` and other non-tensor leaves count nothing. A tensor on the
    ``meta`` device counts its bytes without holding any (the ledger's
    monitor-buffer hint).
    """
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    return 0
