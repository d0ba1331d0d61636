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
version (:func:`repro_torch.kernels.ref.fused_tick_ref`) takes. Built on
per-lane weights (a leading ``[B]`` on the bucket payloads), ``wd`` and
``wc`` are ``[B, ...]``, one row per lane (the kernel's lane stride), and
``dense``/``csr`` hold ``[B, ...]`` weights; the index tables are shared.

:class:`TickLauncher` checks a run's fixed tensors (:func:`check_limits`),
picks the kernel's grid (:func:`plan_grid`), allocates its scratch (the
spike bitmask and the CSR row drives) and fills the kernel's plan (a C
struct) once; each tick then passes only the tick and its row pointers
through ctypes. Call it through
:class:`repro_torch.kernels.ops.FusedTickRun`, which checks the tensors and
counts launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

__all__ = ["KernelPayload", "assemble_kernel", "pack_payload", "TickLauncher", "check_limits",
           "plan_grid", "lane_group", "MAX_N", "MAX_DELAYS", "MAX_BUCKETS", "THREADS",
           "WORDS_BYTES",
           "CSR_ROWS_PER_CTA",
           "STORAGE_DTYPES"]

# Limits of the kernel (csrc/fused_tick.cu): the spike bitmask (one bit per
# neuron) fits 32 KB of shared memory; at most 4 distinct delays and 64
# buckets. Synfire4x100 (N = 120,000) needs 15 KB, 2 delays, 13 buckets.
# Lanes stage their bitmasks in groups that fit WORDS_BYTES.
WORDS_BYTES = 32 * 1024
MAX_N = 262_144
MAX_DELAYS = 4
MAX_BUCKETS = 64
THREADS = 256  # per CTA
CSR_ROWS_PER_CTA = 16  # two CSR rows (one pair in flight) per warp
_DESC_INTS = 8
_ENTRY = {torch.float32: "fused_tick_f32", torch.float16: "fused_tick_f16",
          torch.bfloat16: "fused_tick_bf16"}
STORAGE_DTYPES = tuple(_ENTRY)

_P = ctypes.c_void_p


class _Plan(ctypes.Structure):
    """``TickPlan`` of ``csrc/fused_tick.cu``, field for field."""

    _fields_ = [(name, _P) for name in (
        "v", "u", "ring", "is_gen", "a", "b", "c", "d",
        "desc", "wd", "wc", "ic", "words", "cdrive", "stream", "t0")] + [
        ("wd_lane", ctypes.c_longlong), ("wc_lane", ctypes.c_longlong),
        ("row_stride", ctypes.c_longlong),
        ("delays", ctypes.c_int * MAX_DELAYS), ("n", ctypes.c_int),
        ("ring_len", ctypes.c_int), ("n_buckets", ctypes.c_int),
        ("n_delays", ctypes.c_int), ("substeps", ctypes.c_int),
        ("h", ctypes.c_float), ("grid", ctypes.c_int), ("lanes", ctypes.c_int),
        ("group", ctypes.c_int), ("tel_count", _P), ("tel_rate", _P),
        ("tel_alpha", ctypes.c_float), ("tel_inst", ctypes.c_float),
        ("w_count", _P), ("w_silent", _P), ("w_bad", _P)]


_TICK_SIGNATURE = [ctypes.POINTER(_Plan), ctypes.c_int, ctypes.c_int, _P, _P, _P, _P]
_INTS = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {**{name: _TICK_SIGNATURE for name in _ENTRY.values()},
               "fused_tick_limits": [_INTS],
               "fused_tick_occupancy": [ctypes.c_int, ctypes.c_int, ctypes.c_int, _INTS],
               "fused_tick_barrier_probe": [ctypes.c_int, ctypes.c_int, _P]}


class KernelPayload(NamedTuple):
    """Loop-invariant operands of the fused tick, built once per run."""

    delays: tuple[int, ...]  # ascending distinct delays
    # (pre_start, post_start, delay_ms, W [P, Q] f32), dense buckets in plan order
    dense: tuple[tuple[int, int, int, torch.Tensor], ...]
    # (post_start, delay_ms, idx [Q, F] int32 global, w [Q, F] f32)
    csr: tuple[tuple[int, int, torch.Tensor, torch.Tensor], ...]
    desc: torch.Tensor  # [n_buckets, 8] int32
    wd: torch.Tensor  # f32, dense images concatenated ([B, ...]: one row per lane)
    wc: torch.Tensor  # f32, CSR weight rows concatenated ([B, ...]: one row per lane)
    ic: torch.Tensor  # int32, CSR global indices concatenated


def assemble_kernel(static, params, packed) -> KernelPayload:
    """The fused tick's payload from the assembled bucket payloads
    (:func:`repro_torch.core.backend.assemble_packed`). Every bucket must
    have contiguous pre and post spans (``FusedPlan.kernel_ok``)."""
    buckets = []
    for bi, b in enumerate(static.buckets):
        if b.pre_start < 0 or b.post_start < 0:
            raise ValueError(f"bucket {bi} gathers or scatters: the fused kernel "
                             "takes contiguous spans only (FusedPlan.kernel_ok)")
        if b.kind == "dense":
            buckets.append(("dense", b.pre_start, b.post_start, b.delay_ms, packed[bi]))
        else:
            idx = params.bucket_csr_idx[bi].to(torch.int32) + b.pre_start
            buckets.append(("csr", b.pre_start, b.p, b.post_start, b.delay_ms,
                            idx.contiguous(), packed[bi]))
    return pack_payload(static.fused.delays, buckets, params.gen_rate.device)


def pack_payload(delays, buckets, device) -> KernelPayload:
    """The payload of ``buckets``, in plan order: ``("dense", pre_start,
    post_start, delay, W [P, Q] f32)`` or ``("csr", pre_start, pre_size,
    post_start, delay, idx [Q, F] int32 global, w [Q, F] f32)``, with
    ``delays`` the ascending distinct delays."""
    kpos = {d: k for k, d in enumerate(delays)}
    dense, csr, rows = [], [], []
    wd_off = wc_off = 0
    lead = ()
    for b in buckets:
        if b[0] == "dense":
            _, ps, qs, dly, w = b
            dense.append((ps, qs, dly, w))
            rows.append((0, ps, qs, w.shape[-2], w.shape[-1], 0, kpos[dly], wd_off))
            wd_off += w.shape[-2] * w.shape[-1]
        else:
            _, ps, pn, qs, dly, idx, w = b
            csr.append((qs, dly, idx, w))
            rows.append((1, ps, qs, pn, idx.shape[0], idx.shape[1], kpos[dly], wc_off))
            wc_off += idx.numel()
        lead = tuple(b[-1].shape[:-2])

    def cat(parts, dtype):
        flat = [x.reshape(*lead, -1) for x in parts]
        return (torch.cat(flat, dim=-1) if flat
                else torch.zeros((*lead, 0), dtype=dtype, device=device))

    desc = torch.tensor(rows, dtype=torch.int32).reshape(-1, _DESC_INTS).to(device)
    return KernelPayload(
        delays=tuple(delays), dense=tuple(dense), csr=tuple(csr),
        desc=desc, wd=cat([w for *_, w in dense], torch.float32),
        wc=cat([w for *_, w in csr], torch.float32),
        ic=torch.cat([i.reshape(-1) for _, _, i, _ in csr]) if csr
        else torch.zeros((0,), dtype=torch.int32, device=device))


def check_limits(n: int, delays, n_buckets: int, ring_len: int) -> None:
    """Raise unless the kernel takes a net of ``n`` neurons with these
    distinct ``delays``, ``n_buckets`` buckets and a ring of ``ring_len``
    slots."""
    if n > MAX_N:
        raise ValueError(f"fused_tick: N = {n} neurons exceed the kernel's "
                         f"{MAX_N} (the spike bitmask lives in shared memory)")
    if len(delays) > MAX_DELAYS:
        raise ValueError(f"fused_tick: {len(delays)} distinct delays "
                         f"exceed the kernel's {MAX_DELAYS}")
    if n_buckets > MAX_BUCKETS:
        raise ValueError(f"fused_tick: {n_buckets} buckets exceed "
                         f"the kernel's {MAX_BUCKETS}")
    if any(not 0 < dly < ring_len for dly in delays):
        raise ValueError(f"fused_tick: delays {tuple(delays)} must lie in "
                         f"[1, {ring_len})")


def lane_group(n: int, lanes: int) -> int:
    """How many lanes' bitmasks the kernel stages in shared memory at once:
    as many as fit :data:`WORDS_BYTES`, at least one."""
    return max(1, min(lanes, WORDS_BYTES // (4 * -(-n // 32))))


def plan_grid(n: int, csr_rows: int, per_sm: int, sms: int, cooperative: bool = True,
              grid: int | None = None) -> int:
    """The kernel's CTAs for ``n`` neurons and ``csr_rows`` CSR rows (over
    B lanes: ``B·N`` and B times the rows): one per ``THREADS`` neurons or
    per ``CSR_ROWS_PER_CTA`` rows, whichever needs more, capped at what the
    card holds resident (``per_sm`` CTAs on each of ``sms`` SMs), since a
    grid-wide barrier needs every CTA resident; or ``grid`` where given,
    which must lie in [1, resident].
    Raises where the card takes no cooperative launch or holds no CTA of
    the kernel."""
    if not cooperative:
        raise RuntimeError("fused_tick: the device takes no cooperative launch")
    resident = per_sm * sms
    if resident < 1:
        raise RuntimeError(f"fused_tick: no CTA of the kernel fits an SM "
                           f"({per_sm} per SM on {sms} SMs)")
    if grid is None:
        return min(max(-(-n // THREADS), -(-csr_rows // CSR_ROWS_PER_CTA)), resident)
    if not 1 <= grid <= resident:
        raise ValueError(f"fused_tick: a grid of {grid} CTAs is not in [1, {resident}] "
                         "(the CTAs the card holds resident)")
    return grid


class TickLauncher:
    """One run's fused-tick launches. Checks the fixed tensors, picks the
    grid (:attr:`grid` CTAs), allocates the kernel's scratch and fills its
    plan once; :meth:`__call__` launches one tick on the stream current at
    construction. ``v``, ``u`` ``[N]`` and ``ring`` ``[L, N]`` are updated
    in place. ``grid`` overrides the grid (:func:`plan_grid`).

    Over lanes, ``t0`` (each lane's first tick, B Python ints) is given,
    ``v``, ``u`` are ``[B, N]``, ``ring`` ``[B, L, N]``, the rows lie
    ``row_stride`` entries apart from lane to lane, and the payload's
    weights are shared (one-dimensional ``wd``/``wc``) or one row per lane;
    a tick then takes the shift ``i % L`` of every lane's slot.

    ``tel_count`` (``[(B,) N]`` int32) and ``tel_rate`` (``[(B,) N]`` f32),
    where given, are a SpikeCount's and a GroupRate's accumulators,
    counted up and filtered (``rate``: the GroupRate's ``(alpha, inst)``)
    in the neuron phase of the same launch, as are the in-run watches'
    slots ``w_count`` (``[(B,) N]`` int32), ``w_silent`` and ``w_bad``
    (``[(B,) 4]`` int32; :func:`repro_torch.obs.watch.kernel_words`)."""

    def __init__(self, payload: KernelPayload, v, u, ring, is_gen, a, b, c, d,
                 *, dt: float, substeps: int, grid: int | None = None,
                 t0: tuple[int, ...] | None = None, row_stride: int = 0, tel_count=None,
                 tel_rate=None, rate: tuple[float, float] = (0.0, 0.0), w_count=None,
                 w_silent=None, w_bad=None):
        n = v.shape[-1]
        ring_len = ring.shape[-2]
        lanes = 1 if t0 is None else len(t0)
        check_limits(n, payload.delays, payload.desc.shape[0], ring_len)
        if lanes * n >= 2**31:
            raise ValueError(f"fused_tick: {lanes} lanes of {n} neurons exceed the kernel's "
                             "int32 item indices")
        self._lib = _build.load("fused_tick", _SIGNATURES)
        limits = (ctypes.c_int * 6)()
        self._lib.fused_tick_limits(limits)
        if tuple(limits) != (MAX_N, MAX_DELAYS, MAX_BUCKETS, ctypes.sizeof(_Plan),
                             THREADS, WORDS_BYTES):
            raise RuntimeError(f"fused_tick: the library's limits and plan size "
                               f"{tuple(limits)} differ from the launcher's")
        group = lane_group(n, lanes)
        occ = (ctypes.c_int * 3)()
        _build.check(self._lib, self._lib.fused_tick_occupancy(
            _build.STORAGE_CODE[v.dtype], n, group, occ), "fused_tick occupancy")
        csr_rows = sum(w.shape[-2] for *_, w in payload.csr)
        self.grid = plan_grid(lanes * n, lanes * csr_rows, occ[0], occ[1], bool(occ[2]), grid)
        self.resident = occ[0] * occ[1]
        words = torch.empty((lanes, -(-n // 32)), dtype=torch.int32, device=v.device)
        cdrive = torch.empty((lanes, csr_rows), dtype=torch.float32, device=v.device)
        slot0 = (None if t0 is None else
                 torch.tensor([t % ring_len for t in t0], dtype=torch.int32, device=v.device))
        # Keep every tensor the plan points at alive for the launcher's life.
        self._keep = (payload, v, u, ring, is_gen, a, b, c, d, words, cdrive, slot0,
                      tel_count, tel_rate, w_count, w_silent, w_bad)
        plan = _Plan()
        for name, tensor in (("v", v), ("u", u), ("ring", ring), ("is_gen", is_gen),
                             ("a", a), ("b", b), ("c", c), ("d", d),
                             ("desc", payload.desc), ("wd", payload.wd),
                             ("wc", payload.wc), ("ic", payload.ic),
                             ("words", words), ("cdrive", cdrive)):
            setattr(plan, name, tensor.data_ptr())
        plan.t0 = None if slot0 is None else slot0.data_ptr()
        plan.wd_lane = payload.wd.shape[-1] if payload.wd.dim() == 2 else 0
        plan.wc_lane = payload.wc.shape[-1] if payload.wc.dim() == 2 else 0
        plan.row_stride = row_stride
        plan.stream = torch.cuda.current_stream(v.device).cuda_stream
        plan.delays[:len(payload.delays)] = list(payload.delays)
        plan.n, plan.ring_len = n, ring_len
        plan.n_buckets, plan.n_delays = payload.desc.shape[0], len(payload.delays)
        plan.substeps, plan.h = substeps, dt / substeps
        plan.grid, plan.lanes, plan.group = self.grid, lanes, group
        plan.tel_count = None if tel_count is None else tel_count.data_ptr()
        plan.tel_rate = None if tel_rate is None else tel_rate.data_ptr()
        plan.tel_alpha, plan.tel_inst = rate
        for name, t in (("w_count", w_count), ("w_silent", w_silent), ("w_bad", w_bad)):
            setattr(plan, name, None if t is None else t.data_ptr())
        self._plan = plan
        self._plan_ref = ctypes.byref(plan)
        self._ring_len = ring_len
        self._fn = getattr(self._lib, _ENTRY[v.dtype])

    def __call__(self, t: int, gen_row: int, spikes: int, v_rec: int = 0,
                 isyn_rec: int = 0, step: int = 0) -> None:
        """Launch tick ``t`` (over lanes: run tick ``t``, each lane at its
        own slot), ``step`` its local index in the run (the watches' tick);
        the row arguments are (lane 0's) device pointers (``v_rec``/
        ``isyn_rec`` 0 for none)."""
        err = self._fn(self._plan_ref, t % self._ring_len, step, gen_row, spikes,
                       v_rec or None, isyn_rec or None)
        if err:
            _build.check(self._lib, err, "fused_tick")

    def barrier_probe(self, reps: int) -> None:
        """Launch a kernel of :attr:`grid` CTAs that runs ``reps``
        grid-wide barriers and nothing else (to time the barrier)."""
        _build.check(self._lib, self._lib.fused_tick_barrier_probe(
            self.grid, reps, self._plan.stream), "fused_tick barrier probe")
