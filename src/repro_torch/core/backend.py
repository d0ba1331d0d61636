"""The tick's two hot phases: neuron update and bucketed propagation.

Every bucket of the compile-time plan (``NetStatic.buckets``) is either a
dense ``[P, Q]`` matmul on the tick's spike row (``syn_matmul``) or a CSR
fan-in gather (``syn_gather``); the neuron update of IZH4 networks is the
``izh4_update`` kernel. The wrappers in :mod:`repro_torch.kernels.ops`
launch the CUDA kernels for tensors on the card and run their plain
PyTorch versions for tensors on the CPU, so this module has one code path.

Two departures from the reference, both bitwise neutral:

* Buckets run ungated. The reference skips a bucket whose pre spikes are
  all silent (``lax.cond``); a silent bucket adds exact zeros into an
  accumulator that starts at +0.0 and so is never -0.0, and the reference
  asserts that gating changes no bit. In eager PyTorch the predicate would
  cost a device-to-host sync per bucket per tick.
* The ring is updated in place: the tick writes its commits into the
  caller's ring tensor (``engine.run`` owns a private copy).
"""
from __future__ import annotations

import torch

from repro_torch.core import neurons as nrn
from repro_torch.kernels import ops

__all__ = ["assemble_packed", "update_neurons_dispatch", "propagate_packed"]

f32 = torch.float32


def assemble_packed(static, weights) -> tuple[torch.Tensor, ...]:
    """The per-bucket f32 weight payloads, decoded once per run.

    Dense buckets get their block-dense ``[P, Q]`` image; sparse buckets
    their CSR weight rows ``[Q, fanin]`` decoded to f32.
    """
    packed = []
    for b in static.buckets:
        j0 = b.members[0][0]
        spec0 = static.projections[j0]
        if b.kind == "sparse" or (len(b.members) == 1 and (b.p, b.q) == (
                spec0.pre_size, spec0.post_size)):
            # The decode is the payload: no zero-filled image.
            packed.append(weights[j0].to(f32).contiguous())
            continue
        img = torch.zeros((b.p, b.q), dtype=f32, device=weights[j0].device)
        for j, r0, c0 in b.members:
            spec = static.projections[j]
            img[r0:r0 + spec.pre_size, c0:c0 + spec.post_size] += weights[j].to(f32)
        packed.append(img)
    return tuple(packed)


def update_neurons_dispatch(static, params, neurons: nrn.NeuronState,
                            i_syn: torch.Tensor):
    """Neuron integration step; returns ``(neurons', spiked)``.

    IZH4-only Euler networks (the Synfire workloads) take the
    ``izh4_update`` kernel; generators then hold rest and never spike on
    their own, and a refractory countdown masks the spike flag, as in the
    reference's fast path. Everything else takes the generic
    :func:`repro_torch.core.neurons.update_neurons`.
    """
    state_dtype = neurons.v.dtype
    if not (static.izh4_only and static.method == "euler"):
        return nrn.update_neurons(
            params.neuron, neurons, i_syn, dt=static.dt,
            substeps=static.substeps, method=static.method,
            state_dtype=state_dtype)
    p = params.neuron
    v, u, spiked = ops.izh4_update(neurons.v, neurons.u, i_syn, p.a, p.b,
                                   p.c, p.d, dt=static.dt,
                                   substeps=static.substeps)
    is_gen = p.model == nrn.NeuronModel.GENERATOR
    spiked = spiked & ~is_gen & ~(neurons.refrac > 0)
    v = torch.where(is_gen, p.c, v.to(f32)).to(state_dtype)
    u = torch.where(is_gen, 0.0, u.to(f32)).to(state_dtype)
    refrac = torch.clamp_min(neurons.refrac - 1, 0)
    return nrn.NeuronState(v=v, u=u, refrac=refrac), spiked


def propagate_packed(static, params, spikes: torch.Tensor, ring: torch.Tensor,
                     t: int, packed) -> torch.Tensor:
    """Propagate this tick's spikes through every bucket into ``ring``.

    Each bucket's drive lands in a per-delay ``[N, 1]`` f32 accumulator in
    plan order; then one commit per distinct delay adds the accumulator,
    cast to the ring's dtype first, into ring slot ``(t + d) % ring_len``
    (the reference's ``row + acc.astype(ring.dtype)``). Updates ``ring``
    in place and returns it.
    """
    spikes_f32 = spikes.to(f32)
    acc: dict[int, torch.Tensor] = {}
    for bi, b in enumerate(static.buckets):
        if b.pre_start >= 0:
            pre = spikes_f32[b.pre_start:b.pre_start + b.p]
        else:
            pre = spikes_f32.index_select(0, params.bucket_pre_ids[bi])
        if b.kind == "sparse":
            drive = ops.syn_gather(pre, params.bucket_csr_idx[bi], packed[bi])
        else:
            drive = ops.syn_matmul(pre[None, :], packed[bi])[0]
        a = acc.get(b.delay_ms)
        if a is None:
            a = acc[b.delay_ms] = torch.zeros((static.n, 1), dtype=f32,
                                              device=spikes.device)
        if b.post_start >= 0:
            a[b.post_start:b.post_start + b.q, b.channel] += drive
        else:
            a[:, b.channel].index_add_(0, params.bucket_post_ids[bi], drive)
    for d in sorted(acc):
        ring[(t + d) % static.ring_len] += acc[d].to(ring.dtype)
    return ring
