"""The fused tick's payload and launcher (``csrc/fused_tick.cu``).

Replaces the Pallas kernel ``repro/kernels/fused_tick.py:fused_tick`` and
its payload builder ``assemble_kernel``. :func:`assemble_kernel` lays out,
once per run, the operands the CUDA kernel reads, in this card's layout
(no lane padding):

* ``desc``: one int32 row per bucket, in plan order: kind (0 dense, 1
  CSR), pre start, post start, P, Q, F, delay position, offset;
* ``wd``: the dense buckets' f32 ``[P, Q]`` images, concatenated;
* ``wc``/``ic``: the CSR buckets' f32 weight rows and int32 *global* pre
  indices (local index + pre start), concatenated; padding entries keep
  index ``pre_start`` and weight ``+0.0``, so they add exact zeros.

The same payload carries the per-bucket ``dense``/``csr`` lists the plain
version (:func:`repro_torch.kernels.ref.fused_tick_ref`) takes.

:class:`TickLauncher` checks a run's fixed tensors and fills the kernel's
plan (a C struct) once; each tick then passes only the tick and its row
pointers through ctypes. Call it through
:class:`repro_torch.kernels.ops.FusedTickRun`, which checks the tensors and
counts launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

__all__ = ["KernelPayload", "assemble_kernel", "TickLauncher", "MAX_N",
           "MAX_DELAYS", "MAX_BUCKETS", "STORAGE_DTYPES"]

# Limits of the one-CTA kernel (csrc/fused_tick.cu): the spike row and the
# bucket descriptors fit the default 48 KB of shared memory.
MAX_DELAYS = 4
MAX_BUCKETS = 64
_DESC_INTS = 8
MAX_N = 48 * 1024 - MAX_BUCKETS * _DESC_INTS * 4
_ENTRY = {torch.float32: "fused_tick_f32", torch.float16: "fused_tick_f16"}
STORAGE_DTYPES = tuple(_ENTRY)

_P = ctypes.c_void_p


class _Plan(ctypes.Structure):
    """``TickPlan`` of ``csrc/fused_tick.cu``, field for field."""

    _fields_ = [(name, _P) for name in (
        "v", "u", "ring", "is_gen", "a", "b", "c", "d",
        "desc", "wd", "wc", "ic", "stream")] + [
        ("delays", ctypes.c_int * MAX_DELAYS), ("n", ctypes.c_int),
        ("ring_len", ctypes.c_int), ("n_buckets", ctypes.c_int),
        ("n_delays", ctypes.c_int), ("substeps", ctypes.c_int),
        ("h", ctypes.c_float)]


_TICK_SIGNATURE = [ctypes.POINTER(_Plan), ctypes.c_int, _P, _P, _P, _P]
_SIGNATURES = {"fused_tick_f32": _TICK_SIGNATURE, "fused_tick_f16": _TICK_SIGNATURE,
               "fused_tick_limits": [ctypes.POINTER(ctypes.c_int)]}


class KernelPayload(NamedTuple):
    """Loop-invariant operands of the fused tick, built once per run."""

    delays: tuple[int, ...]  # ascending distinct delays
    # (pre_start, post_start, delay_ms, W [P, Q] f32), dense buckets in plan order
    dense: tuple[tuple[int, int, int, torch.Tensor], ...]
    # (post_start, delay_ms, idx [Q, F] int32 global, w [Q, F] f32)
    csr: tuple[tuple[int, int, torch.Tensor, torch.Tensor], ...]
    desc: torch.Tensor  # [n_buckets, 8] int32
    wd: torch.Tensor  # f32, dense images concatenated
    wc: torch.Tensor  # f32, CSR weight rows concatenated
    ic: torch.Tensor  # int32, CSR global indices concatenated


def assemble_kernel(static, params, packed) -> KernelPayload:
    """The fused tick's payload from the assembled bucket payloads
    (:func:`repro_torch.core.backend.assemble_packed`). Every bucket must
    have contiguous pre and post spans (``FusedPlan.kernel_ok``)."""
    delays = static.fused.delays
    kpos = {d: k for k, d in enumerate(delays)}
    dev = params.gen_rate.device
    dense, csr, rows = [], [], []
    wd_off = wc_off = 0
    for bi, b in enumerate(static.buckets):
        if b.pre_start < 0 or b.post_start < 0:
            raise ValueError(f"bucket {bi} gathers or scatters: the fused kernel "
                             "takes contiguous spans only (FusedPlan.kernel_ok)")
        if b.kind == "dense":
            dense.append((b.pre_start, b.post_start, b.delay_ms, packed[bi]))
            rows.append((0, b.pre_start, b.post_start, b.p, b.q, 0,
                         kpos[b.delay_ms], wd_off))
            wd_off += b.p * b.q
        else:
            idx = params.bucket_csr_idx[bi].to(torch.int32) + b.pre_start
            csr.append((b.post_start, b.delay_ms, idx.contiguous(), packed[bi]))
            f = idx.shape[1]
            rows.append((1, b.pre_start, b.post_start, b.p, b.q, f,
                         kpos[b.delay_ms], wc_off))
            wc_off += b.q * f

    def cat(parts, dtype):
        flat = [x.reshape(-1) for x in parts]
        return torch.cat(flat) if flat else torch.zeros((0,), dtype=dtype, device=dev)

    desc = torch.tensor(rows, dtype=torch.int32).reshape(-1, _DESC_INTS).to(dev)
    return KernelPayload(
        delays=delays, dense=tuple(dense), csr=tuple(csr),
        desc=desc, wd=cat([w for *_, w in dense], torch.float32),
        wc=cat([w for *_, w in csr], torch.float32),
        ic=cat([i for _, _, i, _ in csr], torch.int32))


class TickLauncher:
    """One run's fused-tick launches. Checks the fixed tensors and fills
    the kernel's plan once; :meth:`__call__` launches one tick on the
    current stream. ``v``, ``u`` ``[N]`` and ``ring`` ``[L, N]`` are
    updated in place."""

    def __init__(self, payload: KernelPayload, v, u, ring, is_gen, a, b, c, d,
                 *, dt: float, substeps: int):
        n = v.shape[0]
        ring_len = ring.shape[0]
        if n > MAX_N:
            raise ValueError(f"fused_tick: N = {n} neurons exceed the kernel's "
                             f"{MAX_N} (the spike row lives in shared memory)")
        if len(payload.delays) > MAX_DELAYS:
            raise ValueError(f"fused_tick: {len(payload.delays)} distinct delays "
                             f"exceed the kernel's {MAX_DELAYS}")
        if payload.desc.shape[0] > MAX_BUCKETS:
            raise ValueError(f"fused_tick: {payload.desc.shape[0]} buckets exceed "
                             f"the kernel's {MAX_BUCKETS}")
        if any(not 0 < dly < ring_len for dly in payload.delays):
            raise ValueError(f"fused_tick: delays {payload.delays} must lie in "
                             f"[1, {ring_len})")
        self._lib = _build.load("fused_tick", _SIGNATURES)
        limits = (ctypes.c_int * 4)()
        self._lib.fused_tick_limits(limits)
        if tuple(limits) != (MAX_N, MAX_DELAYS, MAX_BUCKETS, ctypes.sizeof(_Plan)):
            raise RuntimeError(f"fused_tick: the library's limits and plan size "
                               f"{tuple(limits)} differ from the launcher's")
        # Keep every tensor the plan points at alive for the launcher's life.
        self._keep = (payload, v, u, ring, is_gen, a, b, c, d)
        plan = _Plan()
        for name, tensor in (("v", v), ("u", u), ("ring", ring), ("is_gen", is_gen),
                             ("a", a), ("b", b), ("c", c), ("d", d),
                             ("desc", payload.desc), ("wd", payload.wd),
                             ("wc", payload.wc), ("ic", payload.ic)):
            setattr(plan, name, tensor.data_ptr())
        plan.stream = torch.cuda.current_stream(v.device).cuda_stream
        plan.delays[:len(payload.delays)] = list(payload.delays)
        plan.n, plan.ring_len = n, ring_len
        plan.n_buckets, plan.n_delays = payload.desc.shape[0], len(payload.delays)
        plan.substeps, plan.h = substeps, dt / substeps
        self._plan = plan
        self._plan_ref = ctypes.byref(plan)
        self._ring_len = ring_len
        self._fn = getattr(self._lib, _ENTRY[v.dtype])

    def __call__(self, t: int, gen_row: int, spikes: int, v_rec: int = 0,
                 isyn_rec: int = 0) -> None:
        """Launch tick ``t``; the row arguments are device pointers
        (``v_rec``/``isyn_rec`` 0 for none)."""
        err = self._fn(self._plan_ref, t % self._ring_len, gen_row, spikes,
                       v_rec or None, isyn_rec or None)
        if err:
            _build.check(self._lib, err, "fused_tick")
