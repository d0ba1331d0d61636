"""Carry parameters and state across from the reference package.

The reference's ``NetParams``/``NetState`` leaves arrive as numpy arrays
in one flat dict whose keys name the port's fields:

* params: ``neuron.<field>``, ``masks.<j>`` (dense-stored projections),
  ``gen_rate``, ``gen_until``, ``gen_rate_after``, ``bucket_pre_ids.<b>``,
  ``bucket_post_ids.<b>``, ``bucket_csr_idx.<b>`` (sparse buckets);
* state: ``t``, ``key`` (an int64 scalar, or the reference's two uint32
  key words), ``neurons.v``, ``neurons.u``, ``neurons.refrac``, ``ring``,
  ``weights.<j>``.

Both functions take exactly the keys the port's compiled ``static`` needs
and check each array's shape and dtype against it, so a mid-run reference
state can be resumed on the port (the engine parity tests do).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.network import NetParams, NetState, NetStatic
from repro_torch.core.neurons import NeuronParams, NeuronState
from repro_torch.precision import get_policy

__all__ = ["params_from_numpy", "state_from_numpy"]


class _Reader:
    def __init__(self, arrays: dict, device):
        self._arrays = dict(arrays)
        self._device = torch.device(device)
        self._used: set[str] = set()

    def __call__(self, key: str, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        if key not in self._arrays:
            raise KeyError(f"missing array {key!r}")
        self._used.add(key)
        x = torch.from_numpy(np.array(self._arrays[key], copy=True, order="C"))
        if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
            raise ValueError(f"{key}: expected {dtype} {tuple(shape)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        return x.to(self._device)

    def finish(self) -> None:
        extra = sorted(set(self._arrays) - self._used)
        if extra:
            raise ValueError(f"arrays the compiled network has no field for: {extra}")


def _idx_dtype(n_pre: int) -> torch.dtype:
    return torch.int16 if n_pre <= np.iinfo(np.int16).max else torch.int32


def params_from_numpy(static: NetStatic, arrays: dict, device) -> NetParams:
    read = _Reader(arrays, device)
    n = static.n
    neuron = NeuronParams(**{
        f: read(f"neuron.{f}", (n,), torch.int8 if f == "model" else torch.float32)
        for f in NeuronParams._fields})
    csr = static.csr_projs
    masks = tuple(
        None if j in csr else read(f"masks.{j}", (s.pre_size, s.post_size), torch.bool)
        for j, s in enumerate(static.projections))
    pre_ids, post_ids, csr_idx = [], [], []
    for bi, b in enumerate(static.buckets):
        dense = b.kind == "dense"
        pre_ids.append(read(f"bucket_pre_ids.{bi}", (b.p if dense else 0,), torch.int32))
        post_ids.append(read(f"bucket_post_ids.{bi}", (b.q if dense else 0,), torch.int32))
        csr_idx.append(None if dense else read(
            f"bucket_csr_idx.{bi}", (b.q, b.fanin), _idx_dtype(b.p)))
    out = NetParams(
        neuron=neuron, masks=masks,
        gen_rate=read("gen_rate", (n,), torch.float32),
        gen_until=read("gen_until", (n,), torch.float32),
        gen_rate_after=read("gen_rate_after", (n,), torch.float32),
        bucket_pre_ids=tuple(pre_ids), bucket_post_ids=tuple(post_ids),
        bucket_csr_idx=tuple(csr_idx))
    read.finish()
    return out


def state_from_numpy(static: NetStatic, arrays: dict, device) -> NetState:
    arrays = dict(arrays)
    key = np.ascontiguousarray(np.asarray(arrays.pop("key")))
    if key.nbytes != 8:
        raise ValueError(f"key: expected 8 bytes, got {key.dtype} {key.shape}")
    if key.dtype == np.uint32:  # the reference's (hi, lo) key words
        key_val = (int(key.reshape(2)[0]) << 32 | int(key.reshape(2)[1])) & ((1 << 63) - 1)
    else:
        key_val = int(key.reshape(()).astype(np.int64))
    t = int(np.asarray(arrays.pop("t")))
    read = _Reader(arrays, device)
    policy = get_policy(static.policy_name)
    sdt, wdt, n = policy.state_storage, policy.param_storage, static.n
    neurons = NeuronState(v=read("neurons.v", (n,), sdt),
                          u=read("neurons.u", (n,), sdt),
                          refrac=read("neurons.refrac", (n,), torch.int16))
    fanin = {b.members[0][0]: b.fanin for b in static.buckets if b.kind == "sparse"}
    weights = tuple(
        read(f"weights.{j}",
             (s.post_size, fanin[j]) if j in fanin else (s.pre_size, s.post_size),
             wdt)
        for j, s in enumerate(static.projections))
    state = NetState(
        t=t, key=torch.tensor(key_val, dtype=torch.int64, device=device),
        neurons=neurons,
        ring=read("ring", (static.ring_len, n, 1), sdt),
        weights=weights)
    read.finish()
    return state
