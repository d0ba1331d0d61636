"""Carry parameters and state across from the reference package.

The reference's ``NetParams``/``NetState`` leaves arrive as numpy arrays
in one flat dict whose keys name the port's fields:

* params: ``neuron.<field>``, ``masks.<j>`` (dense-stored projections,
  and the validity rows of plastic CSR-stored ones), ``gen_rate``,
  ``gen_until``, ``gen_rate_after``, ``bucket_pre_ids.<b>``,
  ``bucket_post_ids.<b>``, ``bucket_csr_idx.<b>`` (sparse buckets),
  ``proj_csr_idx.<j>`` (plastic and STP projections; sparse-bucket
  members alias their bucket's table);
* state: ``t``, ``key`` (the reference's two uint32 key words, kept as
  the port's int32 bit patterns), ``neurons.v``, ``neurons.u``, ``neurons.refrac``, ``ring``,
  ``weights.<j>``, ``stp.<j>.u``/``.x`` (STP projections),
  ``stdp.<j>.pre_trace``/``.post_trace`` and, for DA-STDP, ``.elig``
  (plastic projections), ``homeo.<j>`` (projections with homeostasis).

Both functions take exactly the keys the port's compiled ``static`` needs
and check each array's shape and dtype against it, so a mid-run reference
state can be resumed on the port (the engine parity tests do).

:func:`lm_params_from_numpy` carries an LM's parameter tree across: the
reference's nested dict (``embed``, ``lm_head``, ``final_norm``,
``layers`` with its stacked ``[L, ...]`` leaves) as numpy arrays, into
the port's :class:`~repro_torch.models.transformer.Transformer`, dtypes
checked leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.network import NetParams, NetState, NetStatic
from repro_torch.core.neurons import NeuronParams, NeuronState
from repro_torch.core.plasticity import DASTDPState, STDPState
from repro_torch.core.synapses import STPState
from repro_torch.precision import get_policy

__all__ = ["params_from_numpy", "state_from_numpy", "lm_params_from_numpy"]


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
        (read(f"masks.{j}", (s.post_size, s.fanin), torch.bool) if s.plastic else None)
        if j in csr else read(f"masks.{j}", (s.pre_size, s.post_size), torch.bool)
        for j, s in enumerate(static.projections))
    pre_ids, post_ids, csr_idx = [], [], []
    for bi, b in enumerate(static.buckets):
        dense = b.kind == "dense"
        pre_ids.append(read(f"bucket_pre_ids.{bi}", (b.p if dense else 0,), torch.int32))
        post_ids.append(read(f"bucket_post_ids.{bi}", (b.q if dense else 0,), torch.int32))
        csr_idx.append(None if dense else read(
            f"bucket_csr_idx.{bi}", (b.q, b.fanin), _idx_dtype(b.p)))
    # Sparse-bucket members alias their bucket's table, as in the reference;
    # plastic and STP projections bring their own.
    bucket_of = {b.members[0][0]: bi for bi, b in enumerate(static.buckets)
                 if b.kind == "sparse"}
    proj_csr_idx = tuple(
        csr_idx[bucket_of[j]] if j in bucket_of
        else read(f"proj_csr_idx.{j}", (s.post_size, s.fanin), _idx_dtype(s.pre_size))
        if s.plastic or s.stp is not None else None
        for j, s in enumerate(static.projections))
    out = NetParams(
        neuron=neuron, masks=masks,
        gen_rate=read("gen_rate", (n,), torch.float32),
        gen_until=read("gen_until", (n,), torch.float32),
        gen_rate_after=read("gen_rate_after", (n,), torch.float32),
        bucket_pre_ids=tuple(pre_ids), bucket_post_ids=tuple(post_ids),
        bucket_csr_idx=tuple(csr_idx), proj_csr_idx=proj_csr_idx)
    read.finish()
    return out


def state_from_numpy(static: NetStatic, arrays: dict, device) -> NetState:
    arrays = dict(arrays)
    key = np.ascontiguousarray(np.asarray(arrays.pop("key")))
    if key.shape != (2,) or key.dtype not in (np.uint32, np.int32):
        raise ValueError(f"key: expected two uint32 key words, got {key.dtype} "
                         f"{key.shape}")
    t = int(np.asarray(arrays.pop("t")))
    read = _Reader(arrays, device)
    policy = get_policy(static.policy_name)
    sdt, wdt, n = policy.state_storage, policy.param_storage, static.n
    neurons = NeuronState(v=read("neurons.v", (n,), sdt),
                          u=read("neurons.u", (n,), sdt),
                          refrac=read("neurons.refrac", (n,), torch.int16))
    csr = static.csr_projs
    specs = static.projections
    weights = tuple(
        read(f"weights.{j}",
             (s.post_size, s.fanin) if j in csr else (s.pre_size, s.post_size), wdt)
        for j, s in enumerate(specs))
    stp = tuple(
        None if s.stp is None else STPState(
            u=read(f"stp.{j}.u", (s.pre_size,), sdt), x=read(f"stp.{j}.x", (s.pre_size,), sdt))
        for j, s in enumerate(specs))
    stdp = []
    for j, (s, cfg) in enumerate(zip(specs, static.stdp)):
        if cfg is None:
            stdp.append(None)
            continue
        traces = (read(f"stdp.{j}.pre_trace", (s.pre_size,), torch.float32),
                  read(f"stdp.{j}.post_trace", (s.post_size,), torch.float32))
        if cfg.tau_elig is None:
            stdp.append(STDPState(*traces))
        else:
            shape = (s.post_size, s.fanin) if j in csr else (s.pre_size, s.post_size)
            stdp.append(DASTDPState(*traces, elig=read(f"stdp.{j}.elig", shape, sdt)))
    homeo = tuple(
        None if h is None else read(f"homeo.{j}", (s.post_size,), torch.float32)
        for j, (s, h) in enumerate(zip(specs, static.homeo)))
    state = NetState(
        t=t, key=torch.from_numpy(key.view(np.int32).copy()).to(device),
        neurons=neurons,
        ring=read("ring", (static.ring_len, n, 1), sdt),
        weights=weights, stp=stp, stdp=tuple(stdp), homeo=homeo)
    read.finish()
    return state


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def lm_params_from_numpy(cfg, arrays: dict, device, policy):
    """The port's model holding the reference's parameters ``arrays`` (its
    parameter tree with numpy leaves; a homogeneous stack's ``layers``
    leaves are ``[L, ...]``), on ``device``. Raises on a missing or extra
    leaf and on a shape or dtype other than the port's parameter's."""
    from repro_torch.models.transformer import Transformer

    if isinstance(policy, str):
        policy = get_policy(policy)
    flat = _flatten(arrays)
    model = Transformer(cfg, policy, None)
    used = set()
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            key = ".".join([parts[0], *parts[2:]])
            arr = flat.get(key)
            arr = None if arr is None else np.asarray(arr)[int(parts[1])]
        else:
            key = name
            arr = flat.get(key)
        if arr is None:
            raise KeyError(f"missing array {key!r}")
        used.add(key)
        x = torch.from_numpy(np.array(arr, copy=True, order="C"))
        if tuple(x.shape) != tuple(p.shape) or x.dtype != p.dtype:
            raise ValueError(f"{name}: expected {p.dtype} {tuple(p.shape)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        p.data.copy_(x)
    extra = sorted(set(flat) - used)
    if extra:
        raise ValueError(f"arrays the model has no parameter for: {extra}")
    return model.to(torch.device(device))
