"""LM meshes, sharding plans and the one-process lowering's sharded tensors
(``repro/launch/mesh.py``).

The plan is the reference's, rule for rule: every >= 2-D weight is sharded
FSDP-style over ``data`` on its input dim and tensor-parallel over
``model`` on its output dim; MoE experts shard over ``model`` (EP) where
the expert count divides the axis, else inside each expert (TP); the
batch shards over ``("pod", "data")``; KV caches over the batch and the
head dim (``KV_CACHE_LAYOUT`` ``"headdim"``) or the cache's sequence
(``"seq"``). Rules apply to a leaf's trailing dims by its name in the
parameter tree (``transformer.params_tree``'s layout, whose path keys are
the reference's); :func:`fit_spec` drops a sharding the axes do not divide.

A mesh is a device list (:class:`~repro_torch.core.distributed.DeviceMesh`,
N-D, repeats allowed: ``["cpu"] * 4`` on the CPU, ``[card] * 8`` on one
card). The tensors laid out per a :class:`NamedSharding`, and the
collectives over named axes, are :mod:`repro_torch.launch.sharded`'s.

The compute plan (:func:`compute_plan`, port-only) says what each rank of
a ``model`` group computes under the Megatron lowering of
``models/tasks.py`` (:func:`model_compute`): its query heads, the KV heads
they read, its range of ``d_ff`` and of the vocabulary, its experts (EP)
or its range of ``d_expert`` (TP) as the expert rules choose, its range of
``d_shared``, of Mamba's ``d_inner`` and of the RG-LRU's ``lru_width``,
each a balanced contiguous range.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core.distributed import DeviceMesh, device_grid
from repro_torch.precision.policy import _flatten

__all__ = ["Mesh", "P", "NamedSharding", "make_production_mesh", "make_host_mesh", "data_axes",
           "model_axes", "param_pspec", "cache_pspec", "fit_spec", "tree_pspecs",
           "batch_pspecs", "named", "KV_CACHE_LAYOUT", "part_axes", "key_paths", "RankPlan",
           "compute_plan", "model_compute", "balanced", "model_size", "expert_parallel"]

Mesh = DeviceMesh


class P:
    """A ``PartitionSpec``: per tensor dim ``None``, an axis name or a
    tuple of axis names (a tuple of one name is that name, as JAX writes
    it). Iterates, indexes and compares as the tuple of its parts (so
    ``tuple(spec)`` equals the reference's)."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.parts == other.parts

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return f"P{self.parts!r}"


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    mesh: DeviceMesh
    spec: P


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16 x 16 (``data``, ``model``) or 2 x 16 x 16 (``pod``, ``data``,
    ``model``) entries on the ``meta`` device: the dry-run's mesh, on which
    nothing is allocated."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return DeviceMesh(device_grid(["meta"] * math.prod(shape), shape), axes)


def make_host_mesh(shape=(2, 2), axes=("data", "model"), devices=None) -> DeviceMesh:
    """A mesh of ``shape`` over ``axes``: ``devices`` (torch devices or
    names, repeats allowed) in row-major order; None means the visible
    cards, cycled to fill the shape (``[card] * 4`` on one card). Tests
    pass ``["cpu"] * 4``."""
    n = math.prod(shape)
    if devices is None:
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not cards:
            raise ValueError("no visible card: pass devices= (e.g. ['cpu'] * n)")
        devices = [cards[i % len(cards)] for i in range(n)]
    if len(devices) != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} devices, got {len(devices)}")
    return DeviceMesh(device_grid(list(devices), tuple(shape)), tuple(axes))


def data_axes(mesh: DeviceMesh):
    """Batch axes: ``("pod", "data")`` when a pod axis exists."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def model_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """The mesh's axes that are not batch axes."""
    d = data_axes(mesh)
    return tuple(a for a in mesh.axis_names if a not in d)


# -- parameter rules -----------------------------------------------------------

# key -> spec over the *trailing* dims of the leaf.
_RULES: dict[str, tuple] = {
    # embeddings / head
    "embed": ("model", "data"),
    "lm_head": ("data", "model"),
    # attention
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    "bq": ("model",),
    "bk": ("model",),
    "bv": ("model",),
    # mlp
    "w_gate": ("data", "model"),
    "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    # mamba
    "in_proj": ("data", "model"),
    "gate_proj": ("data", "model"),
    "x_proj": ("model", None),
    "dt_proj": (None, "model"),
    "dt_bias": ("model",),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "A_log": ("model", None),
    "D": ("model",),
    "out_proj": ("model", "data"),
    # rg-lru
    "w_a": ("data", "model"),
    "w_x": ("data", "model"),
    "b_a": ("model",),
    "b_x": ("model",),
    "lam": ("model",),
    # moe
    "router": ("data", None),
}

# MoE expert tensors: EP over the expert dim when E divides the model axis
# (granite: 32 experts / 16), else tensor-parallel inside each expert
# (qwen2-moe: 60 experts do not divide 16).
_MOE_RULES_EP: dict[str, tuple] = {
    "w_gate": ("model", "data", None),  # [E, D, F]
    "w_up": ("model", "data", None),
    "w_down": ("model", None, "data"),  # [E, F, D]
}
_MOE_RULES_TP: dict[str, tuple] = {
    "w_gate": (None, "data", "model"),
    "w_up": (None, "data", "model"),
    "w_down": (None, "model", "data"),
}


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def param_pspec(keys, leaf: Any, mesh: DeviceMesh) -> P:
    """The spec of a parameter leaf at path ``keys`` (its names, outermost
    first), by trailing-dim rules."""
    keys = list(keys)
    name = keys[-1] if keys else ""
    rule = None
    if "moe" in keys and "shared" not in keys and name in _MOE_RULES_EP:
        shape = _shape(leaf)
        e_dim = shape[-3] if len(shape) >= 3 else 0
        model_size = mesh.shape.get("model", 1)
        ep_ok = e_dim and e_dim % model_size == 0
        rule = _MOE_RULES_EP[name] if ep_ok else _MOE_RULES_TP[name]
    elif name in _RULES:
        rule = _RULES[name]
    ndim = len(_shape(leaf))
    if rule is None or ndim == 0:
        return P()
    rule = rule[-ndim:] if len(rule) > ndim else rule
    return P(*([None] * (ndim - len(rule))), *rule)


# The KV layout lever: "headdim" (default) shards Dh, "seq" the cache's
# sequence dim.
KV_CACHE_LAYOUT = ["headdim"]

# base (unstacked) rank and trailing-dim rule per cache leaf; a stacked
# homogeneous cache's leading [L] stays unsharded.
_CACHE_RULES: dict[str, tuple[int, tuple]] = {
    "k": (4, ("batch", None, None, "model")),  # [B, C, H, Dh]
    "v": (4, ("batch", None, None, "model")),
    "pos": (1, (None,)),
    "conv": (3, ("batch", None, "model")),  # [B, K-1, Di] / [B, 3, W]
    "ssm": (3, ("batch", "model", None)),  # [B, Di, N]
    "h": (2, ("batch", "model")),  # [B, W]
}


def cache_pspec(keys, leaf: Any, mesh: DeviceMesh) -> P:
    """KV/SSM cache leaves: batch over the data axes, features or heads
    (or, under the ``"seq"`` layout, the KV sequence) over ``model``."""
    keys = list(keys)
    name = keys[-1] if keys else ""
    if name not in _CACHE_RULES:
        return P()
    base, rule = _CACHE_RULES[name]
    if name in ("k", "v") and KV_CACHE_LAYOUT[0] == "seq":
        rule = ("batch", "model", None, None)
    d = data_axes(mesh)
    lead = [None] * max(0, len(_shape(leaf)) - base)
    return P(*lead, *(d if r == "batch" else r for r in rule))


def part_axes(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def fit_spec(spec: P, shape: tuple, mesh: DeviceMesh) -> P:
    """Drop the sharding of every dim its axes do not divide evenly (the
    reference's arguments must divide exactly: granite's vocab 49,155 on a
    16-way axis, long_500k's batch of 1)."""
    sizes = mesh.shape
    parts = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, part in zip(shape, parts):
        n = math.prod(sizes[a] for a in part_axes(part))
        out.append(part if part is not None and dim % n == 0 else None)
    return P(*out)


def key_paths(tree, prefix=()):
    """``(keys, leaf)`` per leaf in ``_flatten``'s order: a dict entry by
    its key, a NamedTuple field by its name, a tuple item as ``[i]`` (the
    reference's ``key``, ``name`` or ``str(SequenceKey)``)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from key_paths(tree[k], prefix + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from key_paths(getattr(tree, name), prefix + (name,))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from key_paths(x, prefix + (f"[{i}]",))
    else:
        yield prefix, tree


def tree_pspecs(tree, mesh: DeviceMesh, rule=param_pspec):
    """``tree`` with each leaf replaced by its fitted spec:
    ``fit_spec(rule(keys, leaf, mesh), leaf.shape, mesh)``."""
    _, rebuild = _flatten(tree)
    return rebuild([fit_spec(rule(keys, leaf, mesh), _shape(leaf), mesh)
                    for keys, leaf in key_paths(tree)])


def batch_pspecs(batch, mesh: DeviceMesh):
    """The batch's leading dim over the data axes (fitted), the rest whole."""
    d = data_axes(mesh)

    def spec(keys, leaf, _mesh):
        ndim = len(_shape(leaf))
        return P() if ndim == 0 else P(d, *([None] * (ndim - 1)))

    return tree_pspecs(batch, mesh, rule=spec)


def named(specs, mesh: DeviceMesh):
    """A tree of :class:`P` -> a tree of :class:`NamedSharding`."""
    leaves, rebuild = _flatten(specs)
    return rebuild([NamedSharding(mesh, s) for s in leaves])


# -- the compute plan of the model axis (port-only) -----------------------------------


def model_size(mesh: DeviceMesh) -> int:
    """The size m of the mesh's ``model`` axis (1 without one)."""
    return mesh.shape.get("model", 1)


def balanced(n: int, m: int) -> list[tuple[int, int]]:
    """``n`` split into ``m`` contiguous ranges ``(lo, hi)``, the first ``n
    % m`` one longer than the rest (empty ranges when ``m > n``)."""
    out, lo = [], 0
    for r in range(m):
        hi = lo + n // m + (1 if r < n % m else 0)
        out.append((lo, hi))
        lo = hi
    return out


class RankPlan(NamedTuple):
    """What model rank ``rank`` computes: query heads ``q_heads``, the KV
    heads ``kv_heads`` they read (``[lo, hi)``, global indices; a rank
    whose heads split no KV group recomputes the shared ones), its ``ff``
    range of ``d_ff``, its ``vocab`` range, its ``experts`` and its
    ``expert_ff`` range of ``d_expert`` (EP: a range of experts, each
    whole; TP: every expert, a range of each), its ``shared`` range of
    ``d_shared``, its ``inner`` range of Mamba's ``d_inner`` and its
    ``lru`` range of the RG-LRU's width (``(0, 0)`` where the arch has
    none)."""

    rank: int
    q_heads: tuple[int, int]
    kv_heads: tuple[int, int]
    ff: tuple[int, int]
    vocab: tuple[int, int]
    experts: tuple[int, int] = (0, 0)
    expert_ff: tuple[int, int] = (0, 0)
    shared: tuple[int, int] = (0, 0)
    inner: tuple[int, int] = (0, 0)
    lru: tuple[int, int] = (0, 0)

    @property
    def n_heads(self) -> int:
        return self.q_heads[1] - self.q_heads[0]

    @property
    def n_kv(self) -> int:
        return self.kv_heads[1] - self.kv_heads[0]

    def kv_runs(self, group: int) -> list[tuple[int, int, int]]:
        """The rank's query heads in runs reading one KV head each: ``(q_lo,
        q_hi, kv)`` in local indices (``group`` query heads per KV head)."""
        runs = []
        for q in range(*self.q_heads):
            kv = q // group - self.kv_heads[0]
            if runs and runs[-1][2] == kv:
                runs[-1] = (runs[-1][0], runs[-1][1] + 1, kv)
            else:
                q_lo = q - self.q_heads[0]
                runs.append((q_lo, q_lo + 1, kv))
        return runs


def expert_parallel(cfg, m: int) -> bool:
    """Whether an ``m``-way ``model`` axis splits ``cfg``'s experts EP (the
    expert count divides it: :data:`_MOE_RULES_EP`) or TP (inside each
    expert), as :func:`param_pspec` chooses."""
    return cfg.moe is not None and cfg.moe.n_experts % m == 0


def compute_plan(cfg, m: int) -> list[RankPlan]:
    """Per model rank of an ``m``-way ``model`` axis its heads, ``d_ff``
    range and vocab range. Where ``m <= n_kv_heads`` the ranks split whole
    KV groups, balanced and contiguous (the first ``n_kv % m`` one group
    more: smollm's 5 on 2 ranks as 3 + 2), each taking its groups' query
    heads; else they split the query heads, balanced and contiguous, each
    reading the KV heads its queries read (recomputed on every rank that
    reads them). A rank may hold no head (qwen2-vl's 12 on 16). Experts
    split by :func:`expert_parallel`; ``d_shared``, ``d_inner`` and
    ``lru_width`` balanced and contiguous."""
    g = cfg.n_heads // cfg.n_kv_heads
    if m <= cfg.n_kv_heads:
        kvs = balanced(cfg.n_kv_heads, m)
        qs = [(lo * g, hi * g) for lo, hi in kvs]
    else:
        qs = balanced(cfg.n_heads, m)
        kvs = [(lo // g, (hi - 1) // g + 1) if hi > lo else (0, 0) for lo, hi in qs]
    ffs, vocab = balanced(cfg.d_ff, m), balanced(cfg.vocab_size, m)
    none = [(0, 0)] * m
    experts = expert_ff = shared = inner = lru = none
    if cfg.moe is not None:
        e, f = cfg.moe.n_experts, cfg.moe.d_expert
        if expert_parallel(cfg, m):
            experts, expert_ff = balanced(e, m), [(0, f)] * m
        else:
            experts, expert_ff = [(0, e)] * m, balanced(f, m)
        shared = balanced(cfg.moe.d_shared, m)
    if cfg.ssm is not None:
        inner = balanced(cfg.ssm.expand * cfg.d_model, m)
    if cfg.hybrid is not None:
        lru = balanced(cfg.hybrid.lru_width or cfg.d_model, m)
    return [RankPlan(r, qs[r], kvs[r], ffs[r], vocab[r], experts[r], expert_ff[r], shared[r],
                     inner[r], lru[r]) for r in range(m)]


def model_compute(cfg) -> str:
    """How the mesh lowering's train, prefill and decode steps compute
    ``cfg`` over a ``model`` axis: ``"megatron"`` for every arch (heads,
    ``d_ff``, vocabulary, experts, ``d_inner`` and ``lru_width`` split over
    the ranks, :func:`compute_plan`; decode attends at a rank's heads over
    its KV heads' rows of the cache)."""
    return "megatron"
