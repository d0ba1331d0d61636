"""Device-list meshes and the neuron-sharded SNN engine.

The reference shards with ``shard_map`` over a ``jax.sharding.Mesh``: one
Python process drives every device of the mesh. The port's counterpart is
a mesh that is a list of torch devices, driven by one process
(:class:`DeviceMesh`): a core-grid partition's cores
(``repro_torch.core.partition.run_partitioned_mesh``), a lane scheduler's
lane blocks (``serve.LaneScheduler(mesh=)``) and :class:`ShardedSNN`'s
neuron shards each run on their entry's device, and an all-gather is one
copy of each shard's spike row to every other distinct device. A device
may repeat: ``["cpu"] * 4`` is the counterpart of the reference's four
forced host devices, ``[card] * 4`` four shards on one card.

:class:`ShardedSNN` is the reference's pod-scale engine
(``repro/core/distributed.py``): each shard owns its neurons' state and
delay-ring columns and the incoming synapses of its neurons in sparse
fan-in form (``idx`` ``[n, fanin]`` int32 global pre ids, ``w`` in the
storage dtype, a delay per synapse). Per tick the shards all-gather the
global spike bitmap (the only exchange) and add their fan-in into their
ring, one synapse at a time in fan-in order, in the ring's storage dtype,
as the reference's ``ring.at[dslot, rows].add`` does. The reference
computes the step in XLA, not in a Pallas kernel, so plain PyTorch ops are
its port. ``sharded_from_network``, which the reference's ``__all__``
names, is defined nowhere there, and the port has none either.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import rng

__all__ = ["DeviceMesh", "lane_mesh", "core_mesh", "device_context", "ShardedParams",
           "ShardedState", "ShardedSNN", "make_step", "build_sharded"]

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh: ``devices`` (torch devices, repeats allowed) along the
    axis named ``axis``. ``shape[axis]`` is its size, as on the reference's
    ``Mesh``, so code written against ``mesh.shape[mesh_axis]`` reads the
    same."""

    devices: tuple[torch.device, ...]
    axis: str

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """The mesh's devices, each once, in first-seen order."""
        return tuple(dict.fromkeys(self.devices))


def lane_mesh(n: int | None = None, *, axis: str = "lanes", devices=None) -> DeviceMesh:
    """A 1-D mesh for serving-lane sharding (``LaneScheduler(mesh=...)``):
    ``n`` devices (default: all) of ``devices``, which default to the
    visible CUDA devices. Lanes never interact, so this mesh carries no
    exchange. ``devices`` may repeat a device (``["cpu"] * 4``)."""
    if devices is None:
        pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        hint = "pass devices= (a device may repeat) for more"
    else:
        pool = [torch.device(d) for d in devices]
        hint = "the devices list is shorter"
    if n is None:
        n = len(pool)
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got n={n}")
    if n > len(pool):
        raise ValueError(f"requested {n} mesh devices but only {len(pool)} visible — "
                         f"{hint}")
    return DeviceMesh(tuple(pool[:n]), axis)


def core_mesh(n: int | None = None, *, axis: str = "cores", devices=None) -> DeviceMesh:
    """A 1-D mesh for core-grid partitioning (``run_partitioned_mesh``):
    one entry per partition core, spikes exchanged by one all-gather per
    tick over ``axis``. Same device semantics as :func:`lane_mesh`."""
    return lane_mesh(n, axis=axis, devices=devices)


def device_context(device: torch.device):
    """The context a launch on ``device`` runs under: the kernels launch on
    the current card, so another card is made current for it; the current
    card and the CPU need none (entering ``torch.cuda.device`` costs host
    time on every tick of a mesh on one card)."""
    if device.type == "cuda" and device.index not in (None, torch.cuda.current_device()):
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ShardedParams(NamedTuple):
    # Neuron dynamics parameters, sharded on the neuron axis.
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor
    is_gen: torch.Tensor  # bool
    gen_rate: torch.Tensor  # f32 Hz (pulse)
    gen_until: torch.Tensor
    gen_rate_after: torch.Tensor
    # Sparse in-edges: [N, fanin] target-local synapses.
    idx: torch.Tensor  # int32 global pre index
    w: torch.Tensor  # storage dtype
    delay: torch.Tensor  # int32 per-synapse delay in ticks


class ShardedState(NamedTuple):
    t: int  # the tick, a Python int
    key: torch.Tensor  # int32 [2]: the threefry key words, shared by the shards
    v: torch.Tensor
    u: torch.Tensor
    ring: torch.Tensor  # [D, N]


def _shard(tree, k: int, n_local: int, device: torch.device):
    """Shard ``k`` (``n_local`` neurons) of every tensor of ``tree``, on
    ``device``."""
    return type(tree)(*(x.narrow(0, k * n_local, n_local).to(device).contiguous()
                        for x in tree))


def make_step(mesh: DeviceMesh, axis: str, ring_len: int, dt: float):
    """The sharded tick: ``step(shards, state)`` advances every shard one
    tick in place and returns the global spike row (on the mesh's first
    device). ``shards`` is, per mesh entry, ``(params, v, u, ring)`` on its
    device (the shard's ``ShardedParams`` and state tensors), ``state`` the
    tick ``t`` and the shared key; returns ``(t + 1, key', spikes)``.

    Per shard, op for op as the reference's ``_step``: ring slot read and
    zeroed, two 0.5 ms Euler steps of IZH4 in f32, spike and reset, the
    generators from ``fold_in(k_gen, shard index)``; then the all-gather of
    the spike rows; then each shard's fan-in ``spikes[idx] · w`` added into
    ring slot ``(t + delay) mod D`` synapse by synapse in fan-in order, in
    the ring's dtype."""
    if axis != mesh.axis:
        raise ValueError(f"mesh has no axis {axis!r} (axes: {tuple(mesh.shape)})")
    devices = mesh.devices
    first = devices[0]

    def step(shards, t: int, key: torch.Tensor):
        split = rng.split(key)
        key, k_gen = split[0], split[1]
        slot = t % ring_len
        rows = []
        for k, (p, v_s, u_s, ring) in enumerate(shards):
            with device_context(devices[k]):
                i_syn = ring[slot].to(f32, copy=True)
                ring[slot] = 0
                v = v_s.to(f32)
                u = u_s.to(f32)
                for _ in range(2):
                    v = v + 0.5 * dt * (0.04 * v * v + 5.0 * v + 140.0 - u + i_syn)
                    u = u + 0.5 * dt * p.a * (p.b * v - u)
                spiked = (v >= 30.0) & ~p.is_gen
                v = torch.where(spiked, p.c, v)
                u = torch.where(spiked, u + p.d, u)
                kg = rng.fold_in(k_gen.to(devices[k]), k)
                in_pulse = (torch.tensor(t, dtype=f32, device=v.device) * dt) < p.gen_until
                rate = torch.where(in_pulse, p.gen_rate, p.gen_rate_after)
                gen_sp = rng.uniform(kg, tuple(v.shape)) < rate * (dt / 1000.0)
                rows.append(torch.where(p.is_gen, gen_sp, spiked))
                v_s.copy_(v)
                u_s.copy_(u)
        # The exchange: the global spike bitmap on every distinct device.
        gathered = {d: torch.cat([r.to(d) for r in rows]) for d in mesh.distinct}
        for k, (p, _, _, ring) in enumerate(shards):
            with device_context(devices[k]):
                spikes = gathered[devices[k]]
                contrib = spikes[p.idx].to(f32) * p.w.to(f32)  # [n_local, fanin]
                dslot = (t + p.delay) % ring_len
                cols = torch.arange(contrib.shape[0], device=ring.device)
                # One synapse per row at a time, in fan-in order, each add
                # rounded to the ring's dtype, as the reference's scatter-add
                # rounds: within one column the (slot, row) pairs are
                # distinct, so a read, an add in the ring's dtype and a
                # write per column (no atomics, no f32 accumulation).
                for j in range(contrib.shape[1]):
                    at = (dslot[:, j], cols)
                    ring[at] = ring[at] + contrib[:, j].to(ring.dtype)
        return t + 1, key, gathered[first]

    return step


@dataclasses.dataclass
class ShardedSNN:
    """A neuron-sharded network over ``mesh``'s ``axis``: ``params`` and
    ``state`` hold the global tensors (the mesh's first device), as the
    reference's global arrays; :meth:`run` places each shard on its mesh
    device, ticks, and gathers the final state back."""

    mesh: DeviceMesh
    axis: str
    n: int  # global neuron count (padded to a shard multiple)
    fanin: int
    ring_len: int
    dt: float
    params: ShardedParams
    state: ShardedState

    def step_fn(self):
        return make_step(self.mesh, self.axis, self.ring_len, self.dt)

    def run(self, n_steps: int) -> tuple[ShardedState, torch.Tensor]:
        """``n_steps`` ticks; returns ``(state', counts)``, ``counts`` the
        int32 ``[T]`` spike count of every tick (on the first device)."""
        step = self.step_fn()
        k = self.mesh.shape[self.axis]
        n_local = self.n // k
        st = self.state
        shards = []
        for s, dev in enumerate(self.mesh.devices):
            p = _shard(self.params, s, n_local, dev)
            v, u = (x.narrow(0, s * n_local, n_local).to(dev).clone() for x in (st.v, st.u))
            ring = st.ring.narrow(1, s * n_local, n_local).to(dev).contiguous().clone()
            shards.append((p, v, u, ring))
        first = self.mesh.devices[0]
        counts = torch.empty((n_steps,), dtype=torch.int32, device=first)
        t, key = st.t, st.key
        for i in range(n_steps):
            t, key, spikes = step(shards, t, key)
            counts[i] = spikes.sum(dtype=torch.int32)
        final = ShardedState(
            t=t, key=key,
            v=torch.cat([s[1].to(first) for s in shards]),
            u=torch.cat([s[2].to(first) for s in shards]),
            ring=torch.cat([s[3].to(first) for s in shards], dim=1))
        return final, counts


def build_sharded(
    mesh: DeviceMesh,
    axis: str,
    *,
    n_neurons: int,
    fanin: int,
    max_delay: int,
    seed: int = 0,
    exc_frac: float = 0.8,
    w_exc: float = 1.0,
    w_inh: float = -2.0,
    weight_dtype=torch.float16,
    state_dtype=torch.float16,
    stim_frac: float = 0.05,
    stim_rate_hz: float = 300.0,
    stim_ms: float = 15.0,
) -> ShardedSNN:
    """A random balanced network (synfire-like statistics), the
    reference's: the same numpy draws from ``default_rng(seed)`` give the
    same connectivity, and the key is ``seed``'s."""
    k = mesh.shape[axis]
    n = ((n_neurons + k - 1) // k) * k  # pad to a shard multiple
    ring_len = max_delay + 1
    dev = mesh.devices[0]
    r = np.random.default_rng(seed)

    def tensor(x, dtype):
        return torch.from_numpy(np.asarray(x)).to(dtype).to(dev)

    idx = tensor(r.integers(0, n, size=(n, fanin)), torch.int32)
    sign = r.random((n, fanin)) < exc_frac
    w = tensor(np.where(sign, w_exc, w_inh).astype(np.float32), weight_dtype)
    delay = tensor(r.integers(1, max_delay + 1, size=(n, fanin)), torch.int32)
    gen_mask = np.zeros((n,), bool)
    gen_mask[: int(n * stim_frac)] = True
    is_gen = tensor(gen_mask, torch.bool)
    # RS for the exc-ish population, FS for the rest (statistics only)
    fs = r.random((n,)) > exc_frac
    a = tensor(np.where(fs, 0.1, 0.02).astype(np.float32), f32)
    b = torch.full((n,), 0.2, dtype=f32, device=dev)
    c = torch.full((n,), -65.0, dtype=f32, device=dev)
    d = tensor(np.where(fs, 2.0, 8.0).astype(np.float32), f32)
    gr = tensor(np.where(gen_mask, stim_rate_hz, 0.0).astype(np.float32), f32)
    gu = torch.full((n,), stim_ms, dtype=f32, device=dev)
    ga = torch.zeros((n,), dtype=f32, device=dev)
    key = rng.key(seed, dev)
    v = torch.full((n,), -65.0, dtype=state_dtype, device=dev)
    u = (torch.full((n,), -65.0, dtype=f32, device=dev) * 0.2).to(state_dtype)
    ring = torch.zeros((ring_len, n), dtype=state_dtype, device=dev)

    params = ShardedParams(a=a, b=b, c=c, d=d, is_gen=is_gen, gen_rate=gr, gen_until=gu,
                           gen_rate_after=ga, idx=idx, w=w, delay=delay)
    state = ShardedState(t=0, key=key, v=v, u=u, ring=ring)
    return ShardedSNN(mesh=mesh, axis=axis, n=n, fanin=fanin, ring_len=ring_len, dt=1.0,
                      params=params, state=state)
