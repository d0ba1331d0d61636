"""Precision policies: the paper's fp16-storage technique as a knob.

The paper stores CARLsim's synaptic data as IEEE binary16 while arithmetic
is promoted to f32 (ARM softfp promotes ``__fp16`` operands). A
:class:`PrecisionPolicy` names a *storage* dtype for data at rest
(synaptic weights and LM parameters; neuron state, the delay ring and KV
caches) and a *compute* dtype that data is upcast to before math.
``fp16`` reproduces the paper; ``fp32`` is its reference build;
``bf16``, ``fp16_opt`` (bf16 activations) and ``fp16_sr`` (stochastic
rounding on writeback) are the reference's beyond-paper policies, field
for field. Downcasts round to nearest even, as ``torch.Tensor.to`` does,
unless the policy rounds stochastically and a key is given.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = ["PrecisionPolicy", "POLICIES", "get_policy", "store_tree", "load_tree",
           "tree_leaves", "tree_map",
           "tree_bytes"]

_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Storage/compute dtype assignment, mirroring the paper's fp16 port.

    Attributes:
      name: registry key.
      param_storage: dtype of synaptic weights and LM parameters at rest.
      state_storage: dtype of large mutable state at rest (neuron state,
        delay ring, KV caches).
      compute: dtype math and activations run in (softfp promotion
        analogue).
      accum: accumulator dtype of reductions and matmuls.
      master_fp32: keep an f32 master copy of trainable parameters (LM
        training with fp16 storage needs it; simulation does not).
      loss_scale: static loss scale for fp16 gradients (None: no scaling).
      stochastic_round: round stochastically, not to nearest, on a downcast
        given a key.
    """

    name: str
    param_storage: torch.dtype
    state_storage: torch.dtype
    compute: torch.dtype
    accum: torch.dtype
    master_fp32: bool = False
    loss_scale: float | None = None
    stochastic_round: bool = False

    def store(self, x: torch.Tensor, *, key: torch.Tensor | None = None) -> torch.Tensor:
        """``x`` downcast to the parameter storage dtype; ``key`` is a
        threefry key (:func:`repro_torch.core.rng.key`)."""
        return _downcast(x, self.param_storage, self.stochastic_round, key)

    def store_state(self, x: torch.Tensor, *,
                    key: torch.Tensor | None = None) -> torch.Tensor:
        return _downcast(x, self.state_storage, self.stochastic_round, key)

    def load(self, x: torch.Tensor) -> torch.Tensor:
        """Stored data upcast to the compute dtype (softfp promotion);
        integer data (spike counts, indices) passes through."""
        if x.dtype in _FLOATS:
            return x.to(self.compute)
        return x

    @property
    def bytes_per_param(self) -> int:
        return torch.empty((), dtype=self.param_storage).element_size()


def _downcast(x, dtype: torch.dtype, stochastic: bool, key) -> torch.Tensor:
    x = torch.as_tensor(x)
    if not x.is_floating_point() or x.dtype == dtype:
        return x
    if (stochastic and key is not None
            and torch.empty((), dtype=dtype).element_size() < x.element_size()):
        return _stochastic_round(x, dtype, key)
    return x.to(dtype)


_MANTISSA_BITS = {torch.float16: 10, torch.bfloat16: 7}
# The smallest subnormal of each type as the reference's floor of the ulp.
# bf16's, 2**-133, is an f32 subnormal, which XLA CPU flushes to zero.
_MIN_ULP = {torch.float16: 2.0**-24, torch.bfloat16: 0.0}
_TINY = torch.finfo(torch.float32).tiny  # 2**-126

# XLA CPU's exp2 at the integer exponents k = -125 .. 120, as its f32 bit
# pattern less 2**k's: it evaluates exp(k * ln 2), which misses 2**k by up
# to 67 ulps outside |k| <= 10, and returns 0.0 for k <= -126 (probed on
# jax 0.9.0, tests/test_torch_precision.py holds it).
_EXP2_LO = -125
_EXP2_ULPS = (
    26, 14, 2, -20, -44, 30, 18, 6, -12, -36, -60, 22, 10, -4, -28, -52, 26, 14,
    2, -19, -43, -67, 18, 6, -11, -35, -59, 22, 10, -3, -27, -51, 27, 15, 3,
    -19, 11, -3, -27, 7, -11, -35, 3, -19, 11, -3, -27, 7, -10, 15, 3, -18, 11,
    -2, -26, 7, -10, -34, 3, -18, 11, -2, -26, 7, -10, 15, 3, -18, 11, -2, -26,
    7, -10, -34, 3, -18, 11, -2, -26, 7, -9, -1, 3, -17, -9, -1, 3, 7, -9, -1,
    3, -17, -9, -1, 4, 8, -9, -1, 4, -17, -9, -1, 4, -1, -9, -1, 4, -1, -9, -1,
    4, 0, -8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 4, 0, -8, 0, 4, 0, -7, 0, 4, 0, -7, 0, 4, 8, -7, 0, 4, -15, -7, 1,
    5, 9, -7, 1, 5, -15, -7, 1, 5, 9, -7, 1, 5, -15, 13, 1, -22, 9, -6, 17, 5,
    -14, 13, 1, -22, 9, -6, -30, 5, -14, 13, 1, -22, 9, -6, 17, 5, -14, 13, 1,
    -22, 9, -6, -30, 5, -14, 13, 1, -21, 9, -5, 17, 5, -13, 13, 1, -21, 9, -5,
    -29, -53, 26, 14, 2, -21, -45, 30, 18, 6, -13, -37, 34, 22, 10, -5, -29,
    -53, 26, 14, 2, -20, -44, 30, 18, 6, -12, -36, -60)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """f32 subnormals flushed to a zero of their sign, as XLA CPU's
    arithmetic reads and writes them."""
    return torch.where(x.abs() < _TINY, x * 0.0, x)


def xla_exp2(k: torch.Tensor) -> torch.Tensor:
    """XLA CPU's f32 exp2 at integer exponents ``k`` (int32, at most 120)."""
    ulps = torch.tensor(_EXP2_ULPS, dtype=torch.int32, device=k.device)
    at = (k - _EXP2_LO).clamp(0, len(_EXP2_ULPS) - 1)
    bits = ((k + 127) << 23) + ulps[at]
    return torch.where(k >= _EXP2_LO, bits, 0).view(torch.float32)


def _stochastic_round(x: torch.Tensor, dtype: torch.dtype, key: torch.Tensor) -> torch.Tensor:
    """Unbiased stochastic rounding f32 -> {f16, bf16}, the reference's
    arithmetic as XLA CPU evaluates it, on any device.

    The target ulp at each value is 2**(e - 1 - mantissa bits) for normals
    (XLA CPU's exp2 of that exponent, :func:`xla_exp2`), floored at the
    smallest subnormal; the value rounds down to that grid, then up with
    probability the remainder over the ulp, against uniforms drawn from
    ``key`` (:func:`repro_torch.core.rng.uniform`, ``jax.random.uniform``'s
    bits). Every input and result is flushed to zero where XLA CPU's
    arithmetic flushes it: f32 subnormals round to +-0.0, and under bf16 a
    value whose ulp would fall below 2**-125 becomes NaN, as in the
    reference.
    """
    mant = _MANTISSA_BITS[dtype]
    x32 = _ftz(x.to(torch.float32))
    _, e = torch.frexp(torch.where(x32 == 0, 1.0, x32))  # |x| = m * 2**e, m in [0.5, 1)
    ulp = torch.clamp(xla_exp2(e - 1 - mant), min=_MIN_ULP[dtype])
    down = _ftz(torch.floor(x32 / ulp) * ulp)
    p_up = _ftz(_ftz(x32 - down) / ulp)
    from repro_torch.core import rng  # core imports this module

    u = rng.uniform(key.to(x32.device), tuple(x32.shape))
    out32 = _ftz(down + torch.where(u < p_up, ulp, 0.0))
    fmax = torch.finfo(dtype).max
    return out32.clamp(-fmax, fmax).to(dtype)


POLICIES: dict[str, PrecisionPolicy] = {
    # The paper's reference build: IEEE single floats everywhere.
    "fp32": PrecisionPolicy("fp32", torch.float32, torch.float32, torch.float32,
                            torch.float32),
    # The paper's contribution: IEEE fp16 storage, f32 compute (softfp).
    "fp16": PrecisionPolicy("fp16", torch.float16, torch.float16, torch.float32,
                            torch.float32, master_fp32=True, loss_scale=2.0**12),
    # Beyond the paper: bf16 storage, a wider exponent for LM dynamic range.
    "bf16": PrecisionPolicy("bf16", torch.bfloat16, torch.bfloat16, torch.float32,
                            torch.float32, master_fp32=True),
    # Beyond the paper: fp16 storage with bf16 activations (f32 accumulation,
    # norms and softmax).
    "fp16_opt": PrecisionPolicy("fp16_opt", torch.float16, torch.float16, torch.bfloat16,
                                torch.float32, master_fp32=True, loss_scale=2.0**12),
    # Beyond the paper: fp16 storage, stochastic rounding on writeback.
    "fp16_sr": PrecisionPolicy("fp16_sr", torch.float16, torch.float16, torch.float32,
                               torch.float32, master_fp32=True, loss_scale=2.0**12,
                               stochastic_round=True),
}


def get_policy(name: str) -> PrecisionPolicy:
    try:
        return POLICIES[name]
    except KeyError as e:
        raise KeyError(
            f"unknown precision policy {name!r}; have {sorted(POLICIES)}") from e


# -- trees ------------------------------------------------------------------


def _flatten(tree: Any) -> tuple[list, Callable[[list], Any]]:
    """The leaves of a nested dict/tuple/list/NamedTuple in
    ``jax.tree.flatten``'s order (dict keys sorted, ``None`` an empty
    subtree), and the function that rebuilds the tree from new leaves (a
    dict in sorted key order, as ``jax.tree.unflatten`` rebuilds it)."""
    if tree is None:
        return [], lambda leaves: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]

        def rebuild(leaves):
            out, i = {}, 0
            for k, (sub, build) in zip(keys, parts):
                out[k] = build(leaves[i:i + len(sub)])
                i += len(sub)
            return out
        return [x for sub, _ in parts for x in sub], rebuild
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(x) for x in tree]

        def rebuild(leaves):
            out, i = [], 0
            for sub, build in parts:
                out.append(build(leaves[i:i + len(sub)]))
                i += len(sub)
            if hasattr(tree, "_fields"):
                return type(tree)(*out)
            return type(tree)(out)
        return [x for sub, _ in parts for x in sub], rebuild
    return [tree], lambda leaves: leaves[0]


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves``' order (dict keys sorted)."""
    return _flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any):
    """``tree`` rebuilt from ``fn`` of its leaves and the same-placed leaves of
    ``rest`` (trees of its structure), as ``jax.tree.map``."""
    leaves, rebuild = _flatten(tree)
    return rebuild([fn(*xs) for xs in zip(leaves, *map(tree_leaves, rest))])


def store_tree(tree: Any, policy: PrecisionPolicy, *, key: torch.Tensor | None = None):
    """Every floating leaf of ``tree`` downcast to the parameter storage
    dtype; under stochastic rounding leaf ``i`` draws from key ``i`` of
    ``rng.split(key, n_leaves)``, as the reference's does."""
    from repro_torch.core import rng

    leaves, rebuild = _flatten(tree)
    if key is not None and policy.stochastic_round:
        keys = list(rng.split(key, len(leaves)))
    else:
        keys = [None] * len(leaves)
    return rebuild([policy.store(x, key=k) for x, k in zip(leaves, keys)])


def load_tree(tree: Any, policy: PrecisionPolicy):
    """Every floating leaf of ``tree`` upcast to the compute dtype."""
    leaves, rebuild = _flatten(tree)
    return rebuild([policy.load(torch.as_tensor(x)) for x in leaves])


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
