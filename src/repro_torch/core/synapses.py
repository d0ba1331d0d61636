"""Synaptic projections: dense delay-bucketed weights and CSR fan-in rows.

CARLsim stores an AoS synapse list and walks it per spike. Here each
projection is either a dense ``[n_pre, n_post]`` weight matrix in the
policy's storage dtype (**fp16 under the paper's policy**) plus a bool
mask, or fixed-width CSR fan-in rows ``[n_post, fanin]``. Axonal delays
become a ring of per-tick current accumulators: a spike at tick t with
delay d lands in ring slot (t + d) mod D.

Connectivity is drawn host-side with a seeded numpy Generator, with the
reference's exact calls in the reference's order, so a seed gives the
same network in both packages. Weights round f32 → storage dtype to
nearest even, as the reference's ``asarray`` does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "CSRFanin",
    "ProjectionSpec",
    "ProjectionParams",
    "build_bernoulli",
    "build_csr_direct",
    "build_fixed_fanin",
    "csr_layout",
    "dense_to_csr",
]


@dataclasses.dataclass(frozen=True)
class ProjectionSpec:
    """Static description of one connection group (paper Table II row).

    ``fanin``/``n_syn`` are filled in at compile time from the realized
    connectivity (max in-degree over post neurons / total synapse count);
    the planner's sparse-vs-dense cost model and the CSR row width both
    key off the *realized* fan-in.
    """

    name: str
    pre_start: int
    pre_size: int
    post_start: int
    post_size: int
    delay_ms: int
    receptor: str  # "exc" or "inh"
    fanin: int = 0  # realized max in-degree (compile-time)
    n_syn: int = 0  # realized synapse count (compile-time)

    @property
    def pre_slice(self) -> slice:
        return slice(self.pre_start, self.pre_start + self.pre_size)

    @property
    def post_slice(self) -> slice:
        return slice(self.post_start, self.post_start + self.post_size)


class ProjectionParams(NamedTuple):
    weight: torch.Tensor  # [pre, post] storage dtype, signed
    mask: torch.Tensor  # [pre, post] bool: which synapses exist


def _weights(w: np.ndarray, storage_dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(storage_dtype)


def build_fixed_fanin(rng: np.random.Generator, spec: ProjectionSpec,
                      fanin: int, weight: float, *,
                      storage_dtype: torch.dtype = torch.float32
                      ) -> ProjectionParams:
    """Fixed fan-in random connectivity: each post neuron draws ``fanin``
    distinct pre neurons (one batched uniform draw + per-row argsort)."""
    n_pre, n_post = spec.pre_size, spec.post_size
    if fanin > n_pre:
        raise ValueError(f"{spec.name}: fanin {fanin} > pre group size {n_pre}")
    order = np.argsort(rng.random((n_post, n_pre)), axis=1)[:, :fanin]
    mask = np.zeros((n_pre, n_post), dtype=bool)
    mask[order.reshape(-1), np.repeat(np.arange(n_post), fanin)] = True
    w = np.where(mask, np.float32(weight), np.float32(0.0))
    return ProjectionParams(weight=_weights(w, storage_dtype),
                            mask=torch.from_numpy(mask))


def build_bernoulli(rng: np.random.Generator, spec: ProjectionSpec,
                    fanin: int, weight: float, *,
                    storage_dtype: torch.dtype = torch.float32
                    ) -> ProjectionParams:
    """CARLsim-style probabilistic connect: each (pre, post) pair exists
    with p = fanin / n_pre, so the *expected* fan-in matches Table II."""
    n_pre, n_post = spec.pre_size, spec.post_size
    mask = rng.random((n_pre, n_post)) < fanin / n_pre
    w = np.where(mask, np.float32(weight), np.float32(0.0))
    return ProjectionParams(weight=_weights(w, storage_dtype),
                            mask=torch.from_numpy(mask))


class CSRFanin(NamedTuple):
    """Fixed-width CSR fan-in layout of one projection.

    ``idx[q, k]`` is the k-th presynaptic source of post neuron ``q``
    (local to the pre group, ascending within a row); ``weight[q, k]`` the
    matching weight in the storage dtype. Short rows are padded with index
    0 and weight +0.0, an exact-zero contribution. ``idx`` is int16 when
    the pre group fits, int32 otherwise. ``valid`` (host numpy) marks real
    synapses against padding.
    """

    idx: torch.Tensor  # [post, fanin] int16/int32
    weight: torch.Tensor  # [post, fanin] storage dtype
    valid: np.ndarray  # [post, fanin] bool


def _idx_table(idx: np.ndarray, n_pre: int) -> torch.Tensor:
    idx_dtype = np.int16 if n_pre <= np.iinfo(np.int16).max else np.int32
    return torch.from_numpy(np.ascontiguousarray(idx.astype(idx_dtype)))


def build_csr_direct(rng: np.random.Generator, spec: ProjectionSpec,
                     fanin: int, weight: float, *, mode: str = "prob",
                     storage_dtype: torch.dtype = torch.float32,
                     chunk: int = 2048) -> CSRFanin:
    """Build a constant-weight random projection straight into CSR fan-in
    rows, never materializing the dense ``[pre, post]`` mask (for layers
    past the compile's dense-build threshold). ``mode="prob"`` draws
    binomial row counts, ``mode="fanin"`` exactly ``fanin`` per row."""
    n_pre, n_post = spec.pre_size, spec.post_size
    if fanin > n_pre:
        raise ValueError(f"{spec.name}: fanin {fanin} > pre group size {n_pre}")
    if mode == "prob":
        counts = rng.binomial(n_pre, fanin / n_pre, size=n_post)
        counts = np.minimum(counts, n_pre).astype(np.int64)
    elif mode == "fanin":
        counts = np.full(n_post, fanin, dtype=np.int64)
    else:
        raise ValueError(f"unknown connect mode {mode!r}")
    f = max(int(counts.max()), 1)
    idx = np.zeros((n_post, f), dtype=np.int64)
    valid = np.arange(f)[None, :] < counts[:, None]
    for q0 in range(0, n_post, chunk):
        q1 = min(q0 + chunk, n_post)
        r = rng.random((q1 - q0, n_pre), dtype=np.float32)
        if f < n_pre:
            cand = np.argpartition(r, f, axis=1)[:, :f]
            sub = np.take_along_axis(r, cand, axis=1)
            cand = np.take_along_axis(cand, np.argsort(sub, axis=1), axis=1)
        else:
            cand = np.argsort(r, axis=1)
        cand = np.where(valid[q0:q1], cand, np.int64(n_pre))
        cand.sort(axis=1)
        idx[q0:q1] = np.where(valid[q0:q1], cand, 0)
    wq = np.where(valid, np.float32(weight), np.float32(0.0))
    return CSRFanin(idx=_idx_table(idx, n_pre),
                    weight=_weights(wq, storage_dtype), valid=valid)


def csr_layout(mask: np.ndarray, *, fanin: int | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """Host-side CSR fan-in layout of a dense bool mask: ``(idx, valid)``,
    both ``[post, fanin]``, ascending pre index per row (a stable argsort
    over ``~mask`` floats the True entries to the front of each column in
    index order), ``idx = 0`` on padding."""
    m = np.asarray(mask)
    counts = m.sum(axis=0)
    f = int(counts.max()) if fanin is None else fanin
    order = np.argsort(~m, axis=0, kind="stable")[:f]  # [f, post]
    valid = np.arange(f)[:, None] < counts[None, :]  # [f, post]
    idx = np.where(valid, order, 0).T  # [post, f]
    return idx, np.ascontiguousarray(valid.T)


def dense_to_csr(mask: torch.Tensor, weight: torch.Tensor, *,
                 fanin: int | None = None,
                 storage_dtype: torch.dtype | None = None) -> CSRFanin:
    """Convert a dense ``[pre, post]`` (mask, weight) pair to CSR fan-in
    rows, host-side, in :func:`csr_layout` order. The weights keep their
    dtype unless ``storage_dtype`` is given."""
    m = mask.cpu().numpy()
    w = weight.cpu().to(torch.float32).numpy()
    idx, valid = csr_layout(m, fanin=fanin)
    wq = np.where(valid, np.take_along_axis(w.T, idx, axis=1), np.float32(0.0))
    return CSRFanin(idx=_idx_table(idx, m.shape[0]),
                    weight=_weights(wq, storage_dtype or weight.dtype),
                    valid=valid)
