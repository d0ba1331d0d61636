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
import contextvars
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import rng

__all__ = ["DeviceMesh", "device_grid", "lane_mesh", "core_mesh", "device_context", "on_entry",
           "current_entry", "COLLECTIVES", "GATHERED", "reset_collectives", "note_collective",
           "note_gathered", "recording_collectives", "replay_collectives", "ShardedParams",
           "ShardedState", "ShardedSNN", "make_step", "build_sharded"]

f32 = torch.float32


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """An N-D mesh of torch devices (repeats allowed): ``devices`` a numpy
    object array with one dimension per name of ``axis_names``, as the
    reference's ``Mesh``; ``shape[axis]`` is an axis's size, so code
    written against ``mesh.shape[mesh_axis]`` reads the same. A 1-D mesh
    (``lane_mesh``, ``core_mesh``) also names its one axis ``axis``; the
    LM's 2-D and 3-D meshes are :func:`repro_torch.launch.mesh.make_host_mesh`'s."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self) -> None:
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def axis(self) -> str:
        """The one axis of a 1-D mesh."""
        if len(self.axis_names) != 1:
            raise ValueError(f"a mesh over {self.axis_names} has more than one axis")
        return self.axis_names[0]

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """The mesh's devices, each once, in first-seen (row-major) order."""
        return tuple(dict.fromkeys(self.devices.flat))


def device_grid(devices, shape: tuple[int, ...]) -> np.ndarray:
    """``devices`` (torch devices or names) as a numpy object array of
    ``shape``, row-major."""
    flat = np.empty((len(devices),), dtype=object)
    flat[:] = [torch.device(d) for d in devices]
    return flat.reshape(shape)


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
    return DeviceMesh(device_grid(pool[:n], (n,)), (axis,))


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


_ENTRY: contextvars.ContextVar[tuple[int, ...] | None] = contextvars.ContextVar(
    "mesh_entry", default=None)

# Per collective kind over a device-list mesh: the calls, and the bytes
# that the mesh entry taking in the most has taken in from other entries
# over all of them (a device's share; ``_RECEIVED`` keeps every entry's).
COLLECTIVES: dict[str, dict[str, int]] = {}
_RECEIVED: dict[str, dict[tuple, int]] = {}
# Per mesh entry, the bytes of parameters (and batch or cache rows) that
# the LM lowering assembled on it for its compute since the last reset:
# its own block and what it took in, held through the step.
GATHERED: dict[tuple, int] = {}


def reset_collectives() -> None:
    COLLECTIVES.clear()
    _RECEIVED.clear()
    GATHERED.clear()


def note_gathered(entry: tuple, nbytes: int) -> None:
    """Count ``nbytes`` that ``entry`` assembled for its compute."""
    GATHERED[entry] = GATHERED.get(entry, 0) + int(nbytes)


_RECORDS: list = []


@contextlib.contextmanager
def recording_collectives(log: list):
    """Append every collective counted inside to ``log`` as ``(kind,
    received)`` as well (:func:`replay_collectives` counts them again)."""
    _RECORDS.append(log)
    try:
        yield log
    finally:
        _RECORDS.remove(log)


def replay_collectives(log: list, move) -> None:
    """Count the collectives of ``log`` again, each entry moved by
    ``move(entry)``: a dry-run's data index counting what the computing
    one's model group did."""
    for kind, received in log:
        note_collective(kind, {move(e): b for e, b in received.items()})


def note_collective(kind: str, received: dict[tuple, int]) -> None:
    """Count one collective of ``kind`` that brings ``received[entry]``
    bytes into each receiving entry from the others."""
    for log in _RECORDS:
        log.append((kind, dict(received)))
    per = _RECEIVED.setdefault(kind, {})
    for entry, nbytes in received.items():
        per[entry] = per.get(entry, 0) + int(nbytes)
    ent = COLLECTIVES.setdefault(kind, {"count": 0, "bytes": 0})
    ent["count"] += 1
    ent["bytes"] = max(per.values(), default=0)


def current_entry() -> tuple[int, ...] | None:
    """The mesh index whose work runs now (:func:`on_entry`), or None."""
    return _ENTRY.get()


@contextlib.contextmanager
def on_entry(mesh: DeviceMesh, index: tuple[int, ...]):
    """Run the enclosed work as mesh entry ``index``'s: its device's
    context (:func:`device_context`), and :func:`current_entry` names it
    (the dry-run's op counter charges the entry's device)."""
    token = _ENTRY.set(tuple(index))
    try:
        with device_context(mesh.devices[tuple(index)]):
            yield
    finally:
        _ENTRY.reset(token)


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
            with on_entry(mesh, (k,)):
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
        row_bytes = [r.numel() * r.element_size() for r in rows]
        note_collective("all-gather", {(k,): sum(row_bytes) - b for k, b in enumerate(row_bytes)})
        for k, (p, _, _, ring) in enumerate(shards):
            with on_entry(mesh, (k,)):
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
    as_specs: bool = False,
) -> ShardedSNN:
    """A random balanced network (synfire-like statistics), the
    reference's: the same numpy draws from ``default_rng(seed)`` give the
    same connectivity, and the key is ``seed``'s. With ``as_specs`` every
    tensor is an empty one of its shape and dtype on the ``meta`` device
    (nothing drawn or allocated), the dry-run's network of 1M+ neurons."""
    k = mesh.shape[axis]
    n = ((n_neurons + k - 1) // k) * k  # pad to a shard multiple
    ring_len = max_delay + 1
    if as_specs:
        def spec(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        params = ShardedParams(
            *(spec((n,), f32) for _ in range(4)), is_gen=spec((n,), torch.bool),
            gen_rate=spec((n,), f32), gen_until=spec((n,), f32),
            gen_rate_after=spec((n,), f32), idx=spec((n, fanin), torch.int32),
            w=spec((n, fanin), weight_dtype), delay=spec((n, fanin), torch.int32))
        state = ShardedState(t=0, key=spec((2,), torch.int32), v=spec((n,), state_dtype),
                             u=spec((n,), state_dtype), ring=spec((ring_len, n), state_dtype))
        return ShardedSNN(mesh=mesh, axis=axis, n=n, fanin=fanin, ring_len=ring_len, dt=1.0,
                          params=params, state=state)
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
