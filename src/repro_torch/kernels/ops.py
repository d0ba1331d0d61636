"""One wrapper per kernel: checks, output allocation, dispatch, launch count.

A wrapper takes the kernel's plain PyTorch version (:mod:`.ref`) when its
tensors lie on the CPU, and launches the CUDA kernel when they lie on a
card; a kernel that fails to build or launch raises there, it never falls
back. :data:`LAUNCHES` counts, per kernel, the launches made; a CPU call
counts nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attn as _flash
from repro_torch.kernels import fused_tick as _fused
from repro_torch.kernels import izh_update as _izh
from repro_torch.kernels import plastic_drive as _drive
from repro_torch.kernels import ref
from repro_torch.kernels import stdp_gather as _stdp_gather
from repro_torch.kernels import stdp_update as _stdp_update
from repro_torch.kernels import syn_gather as _gather
from repro_torch.kernels import syn_matmul as _matmul

__all__ = ["LAUNCHES", "reset_launches", "izh4_update", "NeuronRun", "syn_matmul",
           "MatmulRun", "syn_gather", "GatherRun", "FusedTickRun", "stdp_update",
           "stdp_gather", "StdpGatherRun", "StdpUpdateRun", "DriveRun", "attention",
           "flash_attention"]

f32 = torch.float32

LAUNCHES: dict[str, int] = {"izh4_update": 0, "syn_matmul": 0, "syn_gather": 0,
                            "fused_tick": 0, "stdp_update": 0, "stdp_gather": 0,
                            "plastic_drive": 0, "flash_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (all contiguous, on the current card), False
    for CPU tensors; raises on anything else. The kernels launch on the
    current card's context, so tensors on another card raise instead of
    launching there."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on different devices "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {dev} while cuda:"
                         f"{torch.cuda.current_device()} is current; call it "
                         f"under torch.cuda.device({dev.index})")
    return True


def _check_watch_slots(name: str, shape, w_count, w_silent, w_bad) -> None:
    """The in-run watches' kernel slots of a neuron launch over ``shape``
    (``[(B,) N]``): ``w_count`` int32 of that shape, ``w_silent`` and
    ``w_bad`` int32 ``[(B,) 4]``."""
    words = (*shape[:-1], 4)
    if (w_count is not None and (w_count.shape != shape or w_count.dtype != torch.int32)) or any(
            x is not None and (x.shape != words or x.dtype != torch.int32)
            for x in (w_silent, w_bad)):
        raise ValueError(f"{name}: w_count must be int32 {tuple(shape)} and w_silent, w_bad "
                         f"int32 {words}")


def _check_lanes(name: str, lanes: int | None) -> None:
    if lanes is not None and lanes < 1:
        raise ValueError(f"{name}: lanes must be >= 1, got {lanes}")


def izh4_update(v, u, i_syn, a, b, c, d, *, dt: float = 1.0, substeps: int = 2):
    """Fused IZH4 tick over flat ``[N]`` tensors: returns ``(v', u',
    spiked)`` with v', u' in v's storage dtype (fp16 or f32) and a bool
    spike row. ``i_syn``, ``a``, ``b``, ``c``, ``d`` are f32."""
    n = v.shape[0]
    tensors = (v, u, i_syn, a, b, c, d)
    if any(t.shape != (n,) for t in tensors):
        raise ValueError(f"izh4_update: every operand must be [{n}]")
    if v.dtype not in _izh.STORAGE_DTYPES or u.dtype != v.dtype:
        raise ValueError(f"izh4_update: v/u must share a storage dtype in "
                         f"{_izh.STORAGE_DTYPES}, got {v.dtype}/{u.dtype}")
    if any(t.dtype != f32 for t in tensors[2:]):
        raise ValueError("izh4_update: i_syn, a, b, c, d must be float32")
    if not _on_card("izh4_update", *tensors):
        return ref.izh4_ref(v, u, i_syn, a, b, c, d, dt=dt, substeps=substeps)
    v_out = torch.empty_like(v)
    u_out = torch.empty_like(u)
    spiked = torch.empty((n,), dtype=torch.bool, device=v.device)
    if n:
        _izh.launch(v, u, i_syn, a, b, c, d, v_out, u_out, spiked,
                    h=dt / substeps, substeps=substeps)
        LAUNCHES["izh4_update"] += 1
    return v_out, u_out, spiked


class NeuronRun:
    """One run's neuron phase of an IZH4-only Euler net, tick by tick
    (:func:`repro_torch.kernels.ref.neuron_run_ref`): on the run's own
    copies of ``v``, ``u`` (``[N]``, one storage dtype) and ``refrac``
    (``[N]`` int16), made here, so the caller's tensors are left as they
    were, and on ``ring`` (``[L, N, C]``, the storage dtype) in place. A
    current-based net has one ring channel; a conductance-based (COBA) one
    two, and passes its four conductances ``cond`` (``[N]``, the storage
    dtype; the run's copies, ``cond`` afterwards, are made here) and their
    coefficients ``coba``
    (:class:`repro_torch.kernels.izh_update.CobaCoeffs`).
    ``is_gen`` ``[N]`` bool; ``a``..``d`` ``[N]`` f32. ``gen_spk`` ``[T',
    n_gen]`` bool holds the generator spikes of the run's first T' ticks
    (T' divides T; all T of them unless later ones come through ``rows``) and
    ``gen_cols`` ``[N]`` each neuron's column in it (-1 for the others);
    ``i_ext`` ``[T, N]``,
    converted to f32 once, here. ``raster`` ``[T, N]`` bool, ``v_rows`` and
    ``i_rows`` ``[T, N]`` f32 and ``counts`` ``[N]`` int32, where given,
    take each tick's spike row, v and i_syn, and its spikes added.

    ``run(i, t)`` is the run's ``i``-th tick, tick ``t`` (ring slot ``t %
    L``); afterwards ``spikes`` ``[N]`` f32 holds its spike row (0.0/1.0)
    until the next call, and ``v``, ``u``, ``refrac`` (and ``cond``) the
    state. ``spikes`` is the caller's buffer where one is given (a
    partition core's ``[lo, hi)`` view of the global spike row), else the
    run's own. ``rows(gen_spk, start)`` hands it another ``[T', n_gen]``
    generator buffer, whose row 0 is tick ``i = start`` (a run whose
    generator spikes are made segment by segment). On the card
    the tensors are checked and the plan is filled once (``launcher``, a
    :class:`repro_torch.kernels.izh_update.NeuronLauncher`), and a tick is
    one launch on the stream current at construction; on the CPU
    ``launcher`` is None and a tick runs the plain version.

    Lanes: with ``t0`` (a tuple of B Python ints, each lane's first tick)
    the run covers B independent lanes that share ``is_gen``, ``a``..``d``
    and ``gen_cols``: ``v``, ``u``, ``refrac``, each of ``cond`` and
    ``spikes`` are ``[B, N]``, ``ring`` ``[B, L, N, C]``, ``gen_spk``
    ``[B, T', n_gen]`` and ``raster``, ``v_rows``, ``i_rows`` ``[B, T,
    N]``; ``run(i)`` is tick ``t0[b] + i`` of every lane b (ring slot
    ``(t0[b] + i) % L``), one launch for all of them on the card
    (:func:`repro_torch.kernels.ref.neuron_lanes_ref` on the CPU);
    ``counts`` is ``[B, N]``. ``i_ext`` is one lane's only.

    In-run monitors: ``tel_count`` (``[(B,) N]`` int32, a SpikeCount's
    accumulator) takes each tick's spikes added and ``tel_rate`` (``[(B,)
    N]`` f32, a GroupRate's filter level) its fold with ``rate`` (the
    GroupRate's ``(alpha, inst)``,
    :func:`repro_torch.kernels.ref.rate_fold_ref`), in place, in the same
    launch.

    In-run watches: ``w_count`` (``[(B,) N]`` int32, a RateBand's counts)
    takes each tick's spikes added, and ``w_silent`` and ``w_bad`` (``[(B,)
    4]`` int32, a Silent's and a NonFinite's words,
    :func:`repro_torch.obs.watch.kernel_words`) the tick's whole-net
    reductions at its local step ``i``, on the stored membrane
    (:func:`repro_torch.kernels.ref.watch_fold_ref`), in place, in the same
    launch."""

    def __init__(self, v, u, refrac, ring, is_gen, a, b, c, d, *, gen_spk=None,
                 gen_cols=None, i_ext=None, raster=None, v_rows=None, i_rows=None,
                 counts=None, cond=None, coba=None, dt: float = 1.0, substeps: int = 2,
                 t0: tuple[int, ...] | None = None, tel_count=None, tel_rate=None,
                 rate: tuple[float, float] = (0.0, 0.0), w_count=None, w_silent=None,
                 w_bad=None, spikes=None):
        n = v.shape[-1]
        if t0 is not None and not t0:
            raise ValueError("izh4_update: t0 must name at least one lane")
        lead = () if t0 is None else (len(t0),)
        channels = 2 if cond is not None else 1

        def dims(*names) -> str:
            return "[" + ", ".join(("B",) * len(lead) + names) + "]"

        if (v.shape != (*lead, n) or ring.dim() != 3 + len(lead)
                or ring.shape[:len(lead)] != lead or ring.shape[-2:] != (n, channels)):
            raise ValueError(f"izh4_update: v {tuple(v.shape)} and ring "
                             f"{tuple(ring.shape)} must be {dims('N')} and "
                             f"{dims('L', 'N', str(channels))} "
                             f"({'COBA, with cond' if cond is not None else 'CUBA'})")
        if lead and i_ext is not None:
            raise ValueError("izh4_update: i_ext takes one lane")
        if cond is not None and (len(cond) != 4 or coba is None or any(
                g.shape != v.shape or g.dtype != v.dtype for g in cond)):
            raise ValueError(f"izh4_update: cond must be four {tuple(v.shape)} tensors of "
                             "v's dtype, with coba given")
        if any(x.shape != v.shape for x in (u, refrac)) or any(
                x.shape != (n,) for x in (is_gen, a, b, c, d)):
            raise ValueError(f"izh4_update: u, refrac must be {tuple(v.shape)} and is_gen, "
                             f"a, b, c, d [{n}]")
        if (v.dtype not in _izh.STORAGE_DTYPES or u.dtype != v.dtype
                or ring.dtype != v.dtype):
            raise ValueError(f"izh4_update: v/u/ring must share a storage dtype in "
                             f"{_izh.STORAGE_DTYPES}, got {v.dtype}/{u.dtype}/{ring.dtype}")
        if (refrac.dtype != torch.int16 or is_gen.dtype != torch.bool
                or any(x.dtype != f32 for x in (a, b, c, d))):
            raise ValueError("izh4_update: refrac must be int16, is_gen bool and a, b, "
                             "c, d float32")
        rows = [x for x in (gen_spk, i_ext, raster, v_rows, i_rows) if x is not None]
        ndim = 2 + len(lead)
        ticks = {x.shape[-2] for x in rows[int(gen_spk is not None):] if x.dim() == ndim}
        seg = None if gen_spk is None else gen_spk.shape[-2]
        if any(x.dim() != ndim or x.shape[:len(lead)] != lead for x in rows) or len(
                ticks) > 1 or any(x is not None and x.shape[-1] != n
                                  for x in (i_ext, raster, v_rows, i_rows)) or (
                seg is not None and any(seg != t and (seg == 0 or t % seg) for t in ticks)):
            t_seg = "T'"
            raise ValueError(f"izh4_update: gen_spk must be {dims(t_seg, 'n_gen')}, T' "
                             f"dividing T, and i_ext, raster, v_rows, i_rows "
                             f"{dims('T', str(n))}, for one T")
        if (raster is not None and raster.dtype != torch.bool) or any(
                x is not None and x.dtype != f32 for x in (v_rows, i_rows)):
            raise ValueError("izh4_update: raster must be bool and v_rows, i_rows float32")
        if counts is not None and (counts.shape != v.shape or counts.dtype != torch.int32):
            raise ValueError(f"izh4_update: counts must be int32 {dims('N')}")
        if (tel_count is not None and (tel_count.shape != v.shape
                                       or tel_count.dtype != torch.int32)) or (
                tel_rate is not None and (tel_rate.shape != v.shape or tel_rate.dtype != f32)):
            raise ValueError(f"izh4_update: tel_count must be int32 and tel_rate float32 "
                             f"{dims('N')}")
        _check_watch_slots("izh4_update", v.shape, w_count, w_silent, w_bad)
        if gen_spk is None:
            gen_cols = torch.full((n,), -1, dtype=torch.int64, device=v.device)
        elif (gen_spk.dtype != torch.bool or gen_cols is None or gen_cols.shape != (n,)
              or gen_cols.dtype not in (torch.int32, torch.int64)
              or (n and int(gen_cols.max()) >= gen_spk.shape[-1])):
            raise ValueError(f"izh4_update: gen_spk must be bool [.., T, n_gen] with "
                             f"gen_cols int [{n}] below n_gen")
        self.v, self.u, self.refrac = v.clone(), u.clone(), refrac.clone()
        self.cond = None if cond is None else tuple(g.clone() for g in cond)
        self._coba = coba
        if spikes is not None and (spikes.shape != v.shape or spikes.dtype != f32
                                   or not spikes.is_contiguous()):
            raise ValueError(f"izh4_update: spikes must be a contiguous float32 "
                             f"{dims('N')} buffer")
        self.spikes = (torch.zeros(v.shape, dtype=f32, device=v.device) if spikes is None
                       else spikes)
        if i_ext is not None:
            i_ext = i_ext.to(f32).contiguous()
        self._args = (ring, is_gen, a, b, c, d, gen_cols.long(), counts)
        self._tel = dict(tel_count=tel_count, tel_rate=tel_rate, rate=rate, w_count=w_count,
                         w_silent=w_silent, w_bad=w_bad)
        self._ring_len, self._dt, self._substeps = ring.shape[-3], dt, substeps
        self._t0 = t0
        self.launcher = None
        card = _on_card("izh4_update", self.v, self.u, self.refrac, ring, is_gen, a, b,
                        c, d, gen_cols, self.spikes, *rows, *(self.cond or ()),
                        *(x for x in (counts, tel_count, tel_rate, w_count, w_silent, w_bad)
                          if x is not None))
        if card and n:
            cols = gen_cols.to(torch.int32)
            self._keep = [cols]
            lanes = {}
            if t0 is not None:
                slot0 = torch.tensor([t % self._ring_len for t in t0], dtype=torch.int32,
                                     device=v.device)
                self._keep.append(slot0)
                lanes = dict(t0=slot0, gen_stride=0 if gen_spk is None else gen_spk[0].numel(),
                             row_stride=max((x[0].numel() for x in rows[int(
                                 gen_spk is not None):]), default=0))
            self.launcher = _izh.NeuronLauncher(
                self.v, self.u, self.refrac, ring, is_gen, a, b, c, d, cols, self.spikes,
                counts, dt=dt, substeps=substeps, cond=self.cond, coba=coba, **lanes,
                **self._tel)
        self._card = card
        self._rows = (gen_spk, i_ext, raster, v_rows, i_rows)
        self._gen_start = 0
        # Per row: (base pointer, bytes per tick), base 0 for none.
        self._steps = tuple((0, 0) if x is None or not card else
                            (x.data_ptr(), x.shape[-1] * x.element_size())
                            for x in self._rows)

    def rows(self, gen_spk: torch.Tensor, start: int) -> None:
        """Read the generator spikes from ``gen_spk`` ``[T', n_gen]`` bool
        (over lanes ``[B, T', n_gen]``; the first buffer's ``n_gen``, lanes
        and device, contiguous) from here on, its row 0 being tick ``i =
        start``; the other rows keep their buffers. The caller keeps
        ``gen_spk`` alive while it is read."""
        old = self._rows[0]
        if (old is None or gen_spk.dtype != torch.bool or gen_spk.dim() != old.dim()
                or gen_spk.shape[:-2] != old.shape[:-2]
                or gen_spk.shape[-1] != old.shape[-1] or gen_spk.device != old.device
                or not gen_spk.is_contiguous()):
            raise ValueError("izh4_update: gen_spk must be a contiguous bool [.., T, n_gen] "
                             "buffer like the run's first")
        self._rows = (gen_spk, *self._rows[1:])
        self._gen_start = start
        if self._card:
            self._steps = ((gen_spk.data_ptr(), self._steps[0][1]), *self._steps[1:])
            if self._t0 is not None and self.launcher is not None:
                self.launcher.set_gen_stride(gen_spk[0].numel())

    def __call__(self, i: int, t: int | None = None) -> None:
        at = (i - self._gen_start, i, i, i, i)
        if self.launcher is not None:
            slot = i % self._ring_len if self._t0 is not None else t % self._ring_len
            self.launcher(slot, i, *(p and p + k * step
                                     for (p, step), k in zip(self._steps, at)))
            LAUNCHES["izh4_update"] += 1
            return
        if self._card:  # N = 0: nothing to compute
            return
        ring, is_gen, a, b, c, d, cols, counts = self._args
        if self._t0 is not None:
            gen_spk, _, raster, v_rows, i_rows = (None if x is None else x[:, k]
                                                  for x, k in zip(self._rows, at))
            ref.neuron_lanes_ref(self.v, self.u, self.refrac, ring,
                                 [(t0 + i) % self._ring_len for t0 in self._t0], is_gen,
                                 a, b, c, d, cols, self.spikes, gen_rows=gen_spk,
                                 raster_rows=raster, v_rows=v_rows, i_rows=i_rows,
                                 cond=self.cond, counts=counts, coba=self._coba, dt=self._dt,
                                 substeps=self._substeps, step=i, **self._tel)
            return
        gen_spk, i_ext, raster, v_rows, i_rows = (None if x is None else x[k]
                                                  for x, k in zip(self._rows, at))
        ref.neuron_run_ref(self.v, self.u, self.refrac, ring, t % self._ring_len, is_gen,
                           a, b, c, d, cols, self.spikes, gen_row=gen_spk,
                           i_ext_row=i_ext, raster_row=raster, v_row=v_rows,
                           i_row=i_rows, counts=counts, cond=self.cond, coba=self._coba,
                           dt=self._dt, substeps=self._substeps, step=i, **self._tel)


def syn_matmul(x, w):
    """``x [M, K] @ w [K, N] -> [M, N]`` f32, with x f32 and w in f32,
    fp16 or bf16 (decoded to f32 in the tile)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"syn_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != f32:
        raise ValueError(f"syn_matmul: x must be float32, got {x.dtype}")
    if w.dtype not in _matmul.WEIGHT_DTYPES:
        raise ValueError(f"syn_matmul: w dtype {w.dtype} not in "
                         f"{_matmul.WEIGHT_DTYPES}")
    if not _on_card("syn_matmul", x, w):
        return ref.syn_matmul_ref(x, w)
    out = torch.empty((x.shape[0], w.shape[1]), dtype=f32, device=x.device)
    if out.numel():
        _matmul.launch(x, w, out)
        LAUNCHES["syn_matmul"] += 1
    return out


class MatmulRun:
    """The M = 1 ``syn_matmul`` products of one run: ``images`` holds, per
    bucket, its ``[K, N]`` weight image (f32, fp16 or bf16), or None for a
    bucket that is not a product. The images are checked once, here, and
    must stay as they are for the launcher's life.

    ``run(i, x)`` is ``x [K] @ images[i] -> [N]`` f32
    (:func:`repro_torch.kernels.ref.syn_matmul_ref`). On the card it is
    one launch into an output buffer held for the run, which the next
    call for the same bucket overwrites; ``x`` must be a contiguous f32
    row of length K on the images' card, and is not checked per call. On
    the CPU it runs the plain version.

    Over ``lanes`` B: ``run(i, x)`` takes ``x`` ``[B, K]`` (rows of stride
    ``x.stride(0)``, each contiguous: a column slice of the tick's ``[B,
    N]`` spike rows will do) against ``images[i]``, ``[K, N]`` shared by
    the lanes or ``[B, K, N]`` one per lane, and returns ``[B, N]``; one
    launch for every lane, each lane summed as the one-lane launch sums
    (:func:`repro_torch.kernels.ref.syn_matmul_lanes_ref` on the CPU)."""

    def __init__(self, images, lanes: int | None = None):
        _check_lanes("syn_matmul", lanes)
        self._images = tuple(images)
        mats = [w for w in self._images if w is not None]
        for w in mats:
            if w.dim() != 2 and (lanes is None or w.dim() != 3 or w.shape[0] != lanes):
                raise ValueError(f"syn_matmul: weight image {tuple(w.shape)} must be [K, N]"
                                 + ("" if lanes is None else f" or [{lanes}, K, N]"))
            if w.dtype not in _matmul.WEIGHT_DTYPES:
                raise ValueError(f"syn_matmul: w dtype {w.dtype} not in "
                                 f"{_matmul.WEIGHT_DTYPES}")
        self._lanes = lanes
        self._gemv = None
        if mats and _on_card("syn_matmul", *mats):
            self._gemv = _matmul.GemvRun(self._images, mats[0].device, lanes)
            self._counts = tuple(w is not None and w.shape[-1] > 0 for w in self._images)

    def __call__(self, i: int, x: torch.Tensor) -> torch.Tensor:
        if self._gemv is None:
            if self._lanes is not None:
                return ref.syn_matmul_lanes_ref(x, self._images[i])
            return ref.syn_matmul_ref(x[None, :], self._images[i])[0]
        out = self._gemv(i, x.data_ptr(), x.stride(0) if self._lanes is not None else 0)
        if self._counts[i]:
            LAUNCHES["syn_matmul"] += 1
        return out


def syn_gather(spikes, idx, w):
    """CSR fan-in drive ``out[q] = Σ_k spikes[idx[q, k]] * w[q, k]``:
    spikes ``[P]`` f32, idx ``[Q, F]`` int16/int32, w ``[Q, F]`` in f32,
    fp16 or bf16 → ``[Q]`` f32. Rows shorter than F are padded with
    index 0 and weight +0.0. Any ``P``.

    Out-of-range indices follow the reference's ``jnp.take``, on the CPU
    and on the card: an index in ``[-P, -1]`` counts from the end of the
    row, and any other index outside ``[0, P)`` makes its row's output
    NaN. On the card it is the kernel of :class:`GatherRun` over this one
    table, one launch."""
    if spikes.dim() != 1 or idx.dim() != 2 or w.shape != idx.shape:
        raise ValueError(f"syn_gather: shapes spikes {tuple(spikes.shape)}, "
                         f"idx {tuple(idx.shape)}, w {tuple(w.shape)}")
    if spikes.dtype != f32:
        raise ValueError(f"syn_gather: spikes must be float32, got {spikes.dtype}")
    if idx.dtype not in _gather.INDEX_DTYPES:
        raise ValueError(f"syn_gather: idx dtype {idx.dtype} not in "
                         f"{_gather.INDEX_DTYPES}")
    if w.dtype not in _gather.WEIGHT_DTYPES:
        raise ValueError(f"syn_gather: w dtype {w.dtype} not in "
                         f"{_gather.WEIGHT_DTYPES}")
    if not _on_card("syn_gather", spikes, idx, w):
        return ref.syn_gather_ref(spikes, idx, w)
    out = torch.empty((idx.shape[0],), dtype=f32, device=spikes.device)
    if out.numel():
        _gather.launch(spikes, idx, w, out)
        LAUNCHES["syn_gather"] += 1
    return out


class GatherRun:
    """The CSR gathers of one run's sparse buckets, over the tick's whole
    ``[N]`` f32 spike row: ``buckets`` is the run's plan in plan order
    (:class:`repro_torch.kernels.syn_gather.Bucket`, dense buckets
    included, whose columns decide the launch groups), built into a
    :class:`repro_torch.kernels.syn_gather.GatherPlan` (``plan``) once,
    here, with its tables checked: they must stay as they are for the
    launcher's life.

    ``rows`` ``[len(keys), N]`` f32 holds one accumulator row per (delay,
    channel) key of the plan (``channels`` ring channels, each delay of a
    sparse bucket with each channel; delay k's ``[N, C]`` accumulator is
    ``rows[k·C:(k+1)·C].T``). ``run(0, spikes)`` writes every entry of it:
    each (key, column) entry the sum of group 0's bucket drives there, in
    plan order, starting at +0.0, and 0.0 where group 0 has none (with two
    channels, COBA, each bucket's drive enters as its absolute value);
    ``run(g, spikes)`` for g > 0 adds group g's drives into the entries it
    covers. Group 0 runs before the plan's first bucket, group g where
    bucket ``starts[g]`` stands, so each entry keeps the per-bucket path's
    sum bit for bit (``ops.syn_gather`` per bucket, added in plan order).
    Each row sum is the kernel's and ``ops.syn_gather``'s. On the card a
    group is one launch through ``launcher`` (a
    :class:`repro_torch.kernels.syn_gather.GatherLauncher`), on the
    stream current at construction; ``spikes`` must be a contiguous f32
    row of length N on the tables' card and is not checked per call. On
    the CPU ``launcher`` is None and each group runs the plain version
    (:func:`repro_torch.kernels.ref.gather_run_ref`). Every compiled plan
    is one group: one launch per tick.

    Over ``lanes`` B: ``rows`` is ``[B, len(keys), N]``, ``run(g, spikes)``
    takes ``spikes`` ``[B, N]`` (contiguous), and each table's weights are
    ``[Q, F]``, shared by the lanes, or ``[B, Q, F]``, one table per lane;
    the index plan is shared and one launch covers every lane, each lane
    summed as the one-lane launch sums
    (:func:`repro_torch.kernels.ref.gather_lanes_ref` on the CPU).

    ``n_pre`` (None: ``N``) is the spike row's length where it is not the
    accumulators' ``N``: a partition core's import row
    (:mod:`repro_torch.core.partition`), whose entries the buckets' pre ids
    index."""

    def __init__(self, n: int, buckets, device, channels: int = 1,
                 lanes: int | None = None, n_pre: int | None = None):
        _check_lanes("syn_gather", lanes)
        buckets = list(buckets)
        tables = [b.table for b in buckets if b.table is not None]
        for _, idx, w in tables:
            if idx.dim() != 2 or w.shape[-2:] != idx.shape or w.dim() != 2 and (
                    lanes is None or w.shape != (lanes, *idx.shape)):
                raise ValueError(f"syn_gather: idx {tuple(idx.shape)} and w "
                                 f"{tuple(w.shape)} must share one [Q, F] shape"
                                 + ("" if lanes is None else f" (w may be [{lanes}, Q, F])"))
            if idx.dtype not in _gather.INDEX_DTYPES or w.dtype not in _gather.WEIGHT_DTYPES:
                raise ValueError(f"syn_gather: idx/w dtypes {idx.dtype}/{w.dtype} not in "
                                 f"{_gather.INDEX_DTYPES}/{_gather.WEIGHT_DTYPES}")
        self.plan = _gather.GatherPlan(n, buckets, channels, n_pre)
        self.delays, self.keys, self.starts = self.plan.delays, self.plan.keys, self.plan.starts
        self.lanes = lanes
        device = torch.device(device)
        self.launcher = None
        if device.type == "cuda" and self.plan.groups:
            with torch.cuda.device(device):
                self.launcher = _gather.GatherLauncher(self.plan, device, lanes=lanes)
            self.rows = self.launcher.rows
        else:
            lead = () if lanes is None else (lanes,)
            self.rows = torch.zeros((*lead, len(self.keys), n), dtype=f32, device=device)

    def __call__(self, g: int, spikes: torch.Tensor) -> None:
        if self.launcher is None:
            if self.lanes is not None:
                ref.gather_lanes_ref(spikes, self.rows, self.plan.plain[g], first=g == 0,
                                     absolute=self.plan.absolute)
                return
            ref.gather_run_ref(spikes, self.rows, self.plan.plain[g], first=g == 0,
                               absolute=self.plan.absolute)
            return
        self.launcher(g, spikes.data_ptr())
        if self.launcher.items[g]:
            LAUNCHES["syn_gather"] += 1

    def set_lane(self, lane: int) -> None:
        """Re-read lane ``lane``'s weights from the ``[B, Q, F]`` tables the
        run was built on, which the caller has rewritten in place (a lane
        admitted or restored with weights of its own)."""
        self.plan.set_lane(lane)
        if self.launcher is not None and self.launcher.w.data_ptr() != self.plan.w.data_ptr():
            self.launcher.w[lane].copy_(self.plan.w[lane])


def _check_stdp_vectors(name: str, n_pre: int, n_post: int, pre_trace, post_trace,
                        pre_spikes, post_spikes) -> None:
    if any(t.shape != (n_pre,) for t in (pre_trace, pre_spikes)) or any(
            t.shape != (n_post,) for t in (post_trace, post_spikes)):
        raise ValueError(f"{name}: pre_trace/pre_spikes must be [{n_pre}] and "
                         f"post_trace/post_spikes [{n_post}]")
    if any(t.dtype != f32 for t in (pre_trace, post_trace, pre_spikes, post_spikes)):
        raise ValueError(f"{name}: traces and spikes must be float32")


def stdp_update(w, mask, pre_trace, post_trace, pre_spikes, post_spikes, *,
                a_plus: float, a_minus: float, w_min: float, w_max: float):
    """Dense pair-based STDP: ``w [P, Q]`` (fp16 or f32 storage) and its
    bool ``mask`` → the updated weights in w's dtype
    (:func:`repro_torch.kernels.ref.stdp_update_ref`); traces and spikes
    ``[P]``/``[Q]`` f32, spikes as 0.0/1.0. The clip keeps a NaN, as the
    reference's ``jnp.clip`` does, on the CPU and on the card: a NaN weight
    stays NaN inside the mask and becomes +0.0 outside it. On the card it
    is one launch of the single-call kernel."""
    if w.dim() != 2 or mask.shape != w.shape or mask.dtype != torch.bool:
        raise ValueError(f"stdp_update: w {tuple(w.shape)} must be [P, Q] with a "
                         f"bool mask of its shape, got {mask.dtype} {tuple(mask.shape)}")
    if w.dtype not in _stdp_update.STORAGE_DTYPES:
        raise ValueError(f"stdp_update: w dtype {w.dtype} not in "
                         f"{_stdp_update.STORAGE_DTYPES}")
    _check_stdp_vectors("stdp_update", *w.shape, pre_trace, post_trace, pre_spikes,
                        post_spikes)
    kw = dict(a_plus=a_plus, a_minus=a_minus, w_min=w_min, w_max=w_max)
    if not _on_card("stdp_update", w, mask, pre_trace, post_trace, pre_spikes,
                    post_spikes):
        return ref.stdp_update_ref(w, mask, pre_trace, post_trace, pre_spikes,
                                   post_spikes, **kw)
    out = torch.empty_like(w)
    if out.numel():
        _stdp_update.launch(w, mask, pre_trace, post_trace, pre_spikes, post_spikes,
                            out, **kw)
        LAUNCHES["stdp_update"] += 1
    return out


def stdp_gather(w, idx, valid, pre_trace, post_trace, pre_spikes, post_spikes, *,
                a_plus: float, a_minus: float, w_min: float, w_max: float):
    """Pair-based STDP on CSR fan-in rows: ``w``, ``idx`` (int16/int32) and
    ``valid`` (bool) ``[Q, F]`` → the updated rows in w's dtype
    (:func:`repro_torch.kernels.ref.stdp_gather_ref`); pre traces and
    spikes ``[P]``, post ones ``[Q]``, f32.

    Out-of-range indices follow the reference's ``jnp.take``, on the CPU
    and on the card: an index in ``[-P, -1]`` counts from the end of the
    pre row, and any other index outside ``[0, P)`` makes its cell NaN
    where ``valid`` (+0.0 where not). On the card it is the kernel of
    :class:`StdpGatherRun` on one table, one launch."""
    if w.dim() != 2 or idx.shape != w.shape or valid.shape != w.shape:
        raise ValueError(f"stdp_gather: w {tuple(w.shape)}, idx {tuple(idx.shape)} "
                         f"and valid {tuple(valid.shape)} must share one [Q, F] shape")
    if w.dtype not in _stdp_gather.STORAGE_DTYPES:
        raise ValueError(f"stdp_gather: w dtype {w.dtype} not in "
                         f"{_stdp_gather.STORAGE_DTYPES}")
    if idx.dtype not in _stdp_gather.INDEX_DTYPES or valid.dtype != torch.bool:
        raise ValueError(f"stdp_gather: idx must be int16/int32 and valid bool, got "
                         f"{idx.dtype}/{valid.dtype}")
    _check_stdp_vectors("stdp_gather", pre_trace.shape[0], w.shape[0], pre_trace,
                        post_trace, pre_spikes, post_spikes)
    kw = dict(a_plus=a_plus, a_minus=a_minus, w_min=w_min, w_max=w_max)
    if not _on_card("stdp_gather", w, idx, valid, pre_trace, post_trace, pre_spikes,
                    post_spikes):
        return ref.stdp_gather_ref(w, idx, valid, pre_trace, post_trace, pre_spikes,
                                   post_spikes, **kw)
    out = torch.empty_like(w)
    if out.numel():
        _stdp_gather.launch(w, idx, valid, pre_trace, post_trace, pre_spikes,
                            post_spikes, out, **kw)
        LAUNCHES["stdp_gather"] += 1
    return out


class _StdpRun:
    """What :class:`StdpGatherRun` and :class:`StdpUpdateRun` share: one
    run's pair-STDP projections (NamedTuples on the run's own buffers,
    weights ``w`` updated in place, traces in ping-pong pairs ``pre_tr`` and
    ``post_tr``), labelled by ``keys`` (the caller's projection ids;
    ``range(len(projs))`` when None) and checked against an ``[n]`` f32
    spike row. ``run(spikes)`` steps every projection's traces and updates
    its weights, the traces read from buffer ``parity`` and written to the
    other, then flips ``parity``; the current traces of projection ``k``
    are ``traces(k)``. On the card it is one launch per call over every
    projection (``launcher``, on the stream current at construction);
    ``spikes`` must be a contiguous f32 row of length ``n`` on the
    projections' card and is not checked per call. On the CPU ``launcher``
    is None and a call runs the plain version.

    Over ``lanes`` B: every projection's weights and traces carry a
    leading ``[B]`` (each lane its own), ``spikes`` is ``[B, n]``, and one
    launch covers every projection of every lane, each lane updated as the
    one-lane launch updates it (the ``*_lanes_ref`` plain versions on the
    CPU)."""

    _name: str  # the kernel, as LAUNCHES counts it

    def __init__(self, n: int, projs, keys, tables, lanes: int | None = None):
        _check_lanes(self._name, lanes)
        self.projs = tuple(projs)
        self.keys = tuple(range(len(self.projs)) if keys is None else keys)
        self.lanes = lanes
        lead = () if lanes is None else (lanes,)
        tensors = []
        for p, table in zip(self.projs, tables):  # table: the weight-side tensors
            n_pre, n_post = p.pre_tr[0].shape[-1], p.post_tr[0].shape[-1]
            if (len(p.pre_tr) != 2 or len(p.post_tr) != 2
                    or any(t.shape != (*lead, n_pre) or t.dtype != f32 for t in p.pre_tr)
                    or any(t.shape != (*lead, n_post) or t.dtype != f32 for t in p.post_tr)):
                raise ValueError(f"{self._name}: pre_tr/post_tr must be two float32 "
                                 f"{list(lead) + ['P']} and two {list(lead) + ['Q']} buffers")
            if not (0 <= p.pre_start <= n - n_pre and 0 <= p.post_start <= n - n_post):
                raise ValueError(f"{self._name}: pre [{p.pre_start}, +{n_pre}) or post "
                                 f"[{p.post_start}, +{n_post}) outside the [{n}] spike row")
            tensors += [*table, *p.pre_tr, *p.post_tr]
        self.parity = 0
        self.launcher = None
        if tensors and _on_card(self._name, *tensors):
            self.launcher = self._launcher(self.projs, tensors[0].device, lanes, n)

    def __call__(self, spikes: torch.Tensor) -> None:
        if self.launcher is None:
            plain = self._plain if self.lanes is None else self._plain_lanes
            plain(spikes, self.projs, self.parity)
        elif self.launcher.items:
            self.launcher(spikes.data_ptr(), self.parity)
            LAUNCHES[self._name] += 1
        self.parity ^= 1

    def traces(self, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Projection ``k``'s current (pre, post) traces."""
        p = self.projs[k]
        return p.pre_tr[self.parity], p.post_tr[self.parity]

    def adopt(self, weights) -> tuple:
        """``weights`` (indexed by the keys) with this run's weight buffers
        in its projections' places; a buffer first takes the values of the
        tensor it replaces where that is another tensor (homeostasis makes
        new ones): a copy into the buffer, lane by lane in place over lanes,
        never a rebinding."""
        out = list(weights)
        for p, j in zip(self.projs, self.keys):
            if out[j] is not p.w:
                p.w.copy_(out[j])
                out[j] = p.w
        return tuple(out)


def _lead(name: str, w: torch.Tensor, lanes: int | None) -> tuple:
    lead = () if lanes is None else (lanes,)
    if w.dim() != 2 + len(lead) or w.shape[:len(lead)] != lead:
        raise ValueError(f"{name}: w {tuple(w.shape)} must be "
                         f"{list(lead) + ['rows', 'cols']}")
    return lead


class StdpGatherRun(_StdpRun):
    """Pair-based STDP of one run's plastic CSR projections, one tick at a
    time (:func:`repro_torch.kernels.ref.stdp_gather_run_ref`): ``projs``
    are :class:`repro_torch.kernels.stdp_gather.Projection` s, run as
    :class:`_StdpRun` says (over ``lanes``, weights ``[B, Q, F]``,
    :func:`repro_torch.kernels.ref.stdp_gather_lanes_ref`). On the card
    ``launcher`` is a
    :class:`repro_torch.kernels.stdp_gather.StdpLauncher`."""

    _name = "stdp_gather"
    _plain = staticmethod(ref.stdp_gather_run_ref)
    _plain_lanes = staticmethod(ref.stdp_gather_lanes_ref)
    _launcher = _stdp_gather.StdpLauncher

    def __init__(self, n: int, projs, keys=None, lanes: int | None = None):
        projs = tuple(projs)
        for p in projs:
            _lead("stdp_gather", p.w, lanes)
            if p.idx.dim() != 2 or p.idx.shape != p.w.shape[-2:] or p.valid.shape != p.idx.shape:
                raise ValueError(f"stdp_gather: w {tuple(p.w.shape)}, idx "
                                 f"{tuple(p.idx.shape)} and valid {tuple(p.valid.shape)} "
                                 "must share one [Q, F] shape")
            if (p.w.dtype not in _stdp_gather.STORAGE_DTYPES
                    or p.idx.dtype not in _stdp_gather.INDEX_DTYPES
                    or p.valid.dtype != torch.bool):
                raise ValueError(f"stdp_gather: w/idx/valid dtypes {p.w.dtype}/"
                                 f"{p.idx.dtype}/{p.valid.dtype}")
            if p.post_tr[0].shape[-1] != p.w.shape[-2]:
                raise ValueError(f"stdp_gather: post_tr must be two float32 "
                                 f"[{p.w.shape[-2]}] buffers")
        super().__init__(n, projs, keys, [(p.w, p.idx, p.valid) for p in projs], lanes)


class StdpUpdateRun(_StdpRun):
    """Pair-based STDP of one run's dense-stored projections, one tick at a
    time (:func:`repro_torch.kernels.ref.stdp_update_run_ref`): ``projs``
    are :class:`repro_torch.kernels.stdp_update.DenseProjection` s
    (``[P, Q]`` weights and bool mask), run as :class:`_StdpRun` says (over
    ``lanes``, weights ``[B, P, Q]``,
    :func:`repro_torch.kernels.ref.stdp_update_lanes_ref`). On the card
    ``launcher`` is a
    :class:`repro_torch.kernels.stdp_update.StdpUpdateLauncher`: one launch
    per tick over every projection, whatever their number, shapes and
    storage dtypes. A projection's ``padded`` buffer, where given, must
    hold its weights as its first P·Q entries (``w`` a view of it; over
    lanes ``padded`` is ``[B, P·Q + 1]`` and lane b's weights start its
    row b)."""

    _name = "stdp_update"
    _plain = staticmethod(ref.stdp_update_run_ref)
    _plain_lanes = staticmethod(ref.stdp_update_lanes_ref)
    _launcher = _stdp_update.StdpUpdateLauncher

    def __init__(self, n: int, projs, keys=None, lanes: int | None = None):
        projs = tuple(projs)
        for p in projs:
            lead = _lead("stdp_update", p.w, lanes)
            if p.mask.shape != p.w.shape[-2:] or p.mask.dtype != torch.bool:
                raise ValueError(f"stdp_update: w {tuple(p.w.shape)} must be [P, Q] with a "
                                 f"bool mask of its shape, got {p.mask.dtype} "
                                 f"{tuple(p.mask.shape)}")
            if p.w.dtype not in _stdp_update.STORAGE_DTYPES:
                raise ValueError(f"stdp_update: w dtype {p.w.dtype} not in "
                                 f"{_stdp_update.STORAGE_DTYPES}")
            if (p.pre_tr[0].shape[-1], p.post_tr[0].shape[-1]) != tuple(p.w.shape[-2:]):
                raise ValueError(f"stdp_update: pre_tr/post_tr must be two float32 "
                                 f"[{p.w.shape[-2]}] and two [{p.w.shape[-1]}] buffers")
            cells = p.w.shape[-2] * p.w.shape[-1]
            if p.padded is not None and (
                    p.padded.shape != (*lead, cells + 1) or p.padded.dtype != p.w.dtype
                    or p.padded.data_ptr() != p.w.data_ptr()
                    or p.w.stride()[len(lead):] != (p.w.shape[-1], 1)
                    or (lead and lead[0] > 1 and p.w.stride(0) != p.padded.stride(0))):
                raise ValueError(f"stdp_update: padded must be the flat "
                                 f"{list(lead) + [cells + 1]} buffer that w is the start of")
            if p.padded is None and not p.w.is_contiguous():
                raise ValueError("stdp_update: w must be contiguous")
        super().__init__(n, projs, keys, [(p.w if p.padded is None else p.padded, p.mask)
                                          for p in projs], lanes)

    @property
    def padded(self) -> dict:
        """Projection id → its ``padded`` buffer, where it has one."""
        return {j: p.padded for p, j in zip(self.projs, self.keys)
                if p.padded is not None}


class DriveRun:
    """The fan-in drive of one run's plastic and STP projections, one tick
    at a time (:func:`repro_torch.kernels.ref.drive_run_ref`): ``projs``
    are :class:`repro_torch.kernels.plastic_drive.DriveProjection` s, whose
    drives add into their accumulator entries ``out`` in order (``|drive|``
    when ``coba``), each row summed in the reference's XLA CPU order
    (:func:`repro_torch.kernels.ref.xla_cpu_row_sum`) on both devices.
    ``run(spikes, weights, stp)`` takes the tick's f32 spike rows ``[(B,)
    n]`` (contiguous; not checked per call) and, aligned with ``projs``,
    each projection's weights (``[(B,) P, Q]`` dense, rows row-major, or
    its zero-ended ``[(B,) P·Q + 1]`` buffer; ``[(B,) Q, F]`` CSR) and STP
    state ``(u, x)`` ``[(B,) n_pre]`` (None for a plastic projection),
    lanes contiguous. On the card it is one launch for every projection and
    every lane (``launcher``, a
    :class:`repro_torch.kernels.plastic_drive.DriveLauncher`, on the stream
    current at construction); on the CPU ``launcher`` is None and a call
    runs the plain version."""

    def __init__(self, n: int, projs, *, lanes: int | None = None, coba: bool = False):
        _check_lanes("plastic_drive", lanes)
        self.projs = tuple(projs)
        lead = () if lanes is None else (lanes,)
        tensors = []
        for p in self.projs:
            q = p.pre.shape[0]
            if p.pre.dim() != 2 or (p.rows is not None and p.rows.shape != p.pre.shape):
                raise ValueError(f"plastic_drive: pre {tuple(p.pre.shape)} and rows must "
                                 "share one [Q, F] shape")
            if p.out.shape != (*lead, q) or p.out.dtype != f32:
                raise ValueError(f"plastic_drive: out {tuple(p.out.shape)} must be float32 "
                                 f"{list(lead) + [q]}")
            if p.w_dtype not in _drive._TYPE or p.stp_dtype not in _drive._TYPE:
                raise ValueError(f"plastic_drive: storage dtypes {p.w_dtype}/{p.stp_dtype}")
            if p.rows is not None and p.sentinel < 0:
                raise ValueError("plastic_drive: a dense projection needs its sentinel P·Q")
            tensors += [p.pre, p.out] + ([] if p.rows is None else [p.rows])
        if len({t.device for t in tensors}) > 1:
            raise ValueError(f"plastic_drive: tensors on different devices "
                             f"{sorted({str(t.device) for t in tensors})}")
        self.n, self.lanes, self.coba = n, lanes, coba
        self.launcher = None
        if tensors and tensors[0].device.type == "cuda":
            self.launcher = _drive.DriveLauncher(self.projs, tensors[0].device, lanes, n, coba)

    def __call__(self, spikes: torch.Tensor, weights, stp) -> None:
        if self.launcher is None:
            ref.drive_run_ref(spikes, self.projs, weights, stp, coba=self.coba)
        elif self.launcher.items:
            self.launcher(spikes.data_ptr(), weights, stp)
            LAUNCHES["plastic_drive"] += 1


class FusedTickRun:
    """A run's ticks through the fused tick
    (:func:`repro_torch.kernels.ref.fused_tick_ref`), in place on the run's
    own buffers: ``v``, ``u`` ``[N]`` and ``ring`` ``[L, N]``, in one
    storage dtype, advance tick by tick; ``rows`` ``[T, N]`` bool holds each
    tick's generator spikes on entry (read where ``is_gen``, ``[N]`` bool)
    and its spike row on exit; ``v_rows`` and ``i_rows`` ``[T, N]`` f32,
    where given, record v' and i_syn. ``a``..``d`` are ``[N]`` f32 and
    ``payload`` comes from :func:`repro_torch.kernels.fused_tick.assemble_kernel`.

    On the card the tensors are checked and the kernel's plan is built
    once (``launcher``, a :class:`repro_torch.kernels.fused_tick.TickLauncher`,
    whose ``grid`` is the CTAs each tick runs on; ``grid`` overrides its
    choice), and :meth:`tick` is one launch; on the CPU ``launcher`` is None and :meth:`tick` runs the plain
    version. On the card N is at most ``fused_tick.MAX_N``.

    Lanes: with ``t0`` (B Python ints, each lane's first tick) the run
    covers B independent lanes: ``v``, ``u`` ``[B, N]``, ``ring`` ``[B, L,
    N]``, ``rows``, ``v_rows``, ``i_rows`` ``[B, T, N]``, and the payload's
    weights shared or each lane's own (``assemble_kernel`` on ``[B, ...]``
    bucket payloads); ``tick(i)`` is tick ``t0[b] + i`` of every lane b, one
    launch for all of them on the card
    (:func:`repro_torch.kernels.ref.fused_tick_lanes_ref` on the CPU).

    Contract on non-finite weights: the kernel adds only the weights of
    pres that spiked, so a non-finite weight on a silent pre adds nothing
    on the card, where the plain version and the reference's
    ``fused_tick_ref`` multiply it by 0.0 and give NaN (``chip_smoke.py``
    records both). With finite weights the two agree, as silent pres add
    exact zeros. A CSR index follows the reference's ``jnp.take`` on both
    devices: one in ``[-N, -1]`` counts from the end of the spike row, any
    other outside ``[0, N)`` makes its row's drive NaN.

    In-run monitors: ``tel_count`` (``v``'s shape, int32, a SpikeCount's
    accumulator) and ``tel_rate`` (f32, a GroupRate's filter level, ``rate``
    its ``(alpha, inst)``) take each tick's spikes in place in the same
    launch, as :class:`NeuronRun`'s do, and so do the in-run watches'
    ``w_count``, ``w_silent`` and ``w_bad`` at the tick's local step
    ``i``."""

    def __init__(self, payload: _fused.KernelPayload, v, u, ring, is_gen, a, b,
                 c, d, rows, v_rows=None, i_rows=None, *, dt: float = 1.0,
                 substeps: int = 2, grid: int | None = None,
                 t0: tuple[int, ...] | None = None, tel_count=None, tel_rate=None,
                 rate: tuple[float, float] = (0.0, 0.0), w_count=None, w_silent=None,
                 w_bad=None):
        n = v.shape[-1]
        if t0 is not None and not t0:
            raise ValueError("fused_tick: t0 must name at least one lane")
        lead = () if t0 is None else (len(t0),)
        if v.shape != (*lead, n) or ring.dim() != 2 + len(lead) or ring.shape[:len(lead)] != lead \
                or ring.shape[-1] != n:
            dims = "B, " if lead else ""
            raise ValueError(f"fused_tick: v {tuple(v.shape)} and ring "
                             f"{tuple(ring.shape)} must be [{dims}N] and [{dims}L, N]")
        if u.shape != v.shape or any(x.shape != (n,) for x in (is_gen, a, b, c, d)):
            raise ValueError(f"fused_tick: u must be {tuple(v.shape)} and is_gen, a, b, c, d "
                             f"[{n}]")
        if (v.dtype not in _fused.STORAGE_DTYPES or u.dtype != v.dtype
                or ring.dtype != v.dtype):
            raise ValueError(f"fused_tick: v/u/ring must share a storage dtype in "
                             f"{_fused.STORAGE_DTYPES}, got {v.dtype}/{u.dtype}/"
                             f"{ring.dtype}")
        if is_gen.dtype != torch.bool or any(x.dtype != f32 for x in (a, b, c, d)):
            raise ValueError("fused_tick: is_gen must be bool and a, b, c, d float32")
        recs = [x for x in (v_rows, i_rows) if x is not None]
        if (rows.dim() != 2 + len(lead) or rows.shape[:len(lead)] != lead
                or rows.shape[-1] != n or rows.dtype != torch.bool):
            raise ValueError(f"fused_tick: rows must be {list(lead) + ['T', n]} bool")
        if any(x.shape != rows.shape or x.dtype != f32 for x in recs):
            raise ValueError(f"fused_tick: v_rows/i_rows must be float32 {tuple(rows.shape)}")
        if (tel_count is not None and (tel_count.shape != v.shape
                                       or tel_count.dtype != torch.int32)) or (
                tel_rate is not None and (tel_rate.shape != v.shape or tel_rate.dtype != f32)):
            raise ValueError(f"fused_tick: tel_count must be int32 and tel_rate float32 "
                             f"{tuple(v.shape)}")
        _check_watch_slots("fused_tick", v.shape, w_count, w_silent, w_bad)
        tel = [x for x in (tel_count, tel_rate, w_count, w_silent, w_bad) if x is not None]
        self._card = _on_card("fused_tick", v, u, ring, is_gen, a, b, c, d, rows,
                              payload.desc, payload.wd, payload.wc, payload.ic, *recs, *tel)
        self._args = (payload, v, u, ring, is_gen, a, b, c, d, rows, v_rows, i_rows)
        self._tel = dict(tel_count=tel_count, tel_rate=tel_rate, rate=rate, w_count=w_count,
                         w_silent=w_silent, w_bad=w_bad)
        self._dt, self._substeps, self._t0 = dt, substeps, t0
        if self._card and n:
            self.launcher = _fused.TickLauncher(
                payload, v, u, ring, is_gen, a, b, c, d, dt=dt, substeps=substeps, grid=grid,
                t0=t0, row_stride=rows.shape[-2] * n if lead else 0, **self._tel)
            self._rows = (rows.data_ptr(), n)
            self._v_rows = 0 if v_rows is None else v_rows.data_ptr()
            self._i_rows = 0 if i_rows is None else i_rows.data_ptr()
            self._row_bytes = n * 4
        else:
            self.launcher = None

    def tick(self, i: int, t: int | None = None) -> None:
        """Tick ``t`` of the run, its ``i``-th: reads and writes row ``i``
        (over lanes, ``tick(i)``: every lane's tick ``t0[b] + i``)."""
        if self.launcher is not None:
            rows, n = self._rows
            row = rows + i * n
            self.launcher(i if self._t0 is not None else t, row, row,
                          self._v_rows and self._v_rows + i * self._row_bytes,
                          self._i_rows and self._i_rows + i * self._row_bytes, step=i)
            LAUNCHES["fused_tick"] += 1
            return
        if self._card:  # N = 0: nothing to compute
            return
        payload, v, u, ring, is_gen, a, b, c, d, rows, v_rows, i_rows = self._args
        kw = dict(dense=payload.dense, csr=payload.csr, ring_len=ring.shape[-2], dt=self._dt,
                  substeps=self._substeps, step=i, **self._tel)
        if self._t0 is None:
            v2, u2, spikes, ring2, i_syn = ref.fused_tick_ref(
                v, u, ring, rows[i], is_gen, a, b, c, d, t, **kw)
        else:
            v2, u2, spikes, ring2, i_syn = ref.fused_tick_lanes_ref(
                v, u, ring, rows[:, i], is_gen, a, b, c, d, [t0 + i for t0 in self._t0], **kw)
        v.copy_(v2)
        u.copy_(u2)
        ring.copy_(ring2)
        rows[..., i, :] = spikes
        if v_rows is not None:
            v_rows[..., i, :] = v2
        if i_rows is not None:
            i_rows[..., i, :] = i_syn


def attention(q, k, v, qpos, kpos, *, causal: bool = True, window: int = -1):
    """GQA online-softmax attention in the model's layout
    (:func:`repro_torch.kernels.ref.chunked_attention_ref`): q ``[B, Sq,
    Hq, D]`` f32, k/v ``[B, Sk, Hkv, D]`` in f32, fp16 or bf16 with ``Hq %
    Hkv == 0``, qpos int32 ``[B, Sq]``, kpos int32 ``[Sk]`` (``< 0`` marks
    an invalid slot) → ``[B, Sq, Hq, D]`` f32. A row with no allowed key
    gets the reference's ``chunked_attention`` value, ``Σ_{j<Sk} v_j / (Sk
    + pad)`` with ``pad = -Sk mod min(1024, Sk)``; with ``Sk = 0`` every row
    is 0. On the card it is one launch of the split-K decode path or the
    tensor-core prefill path, chosen from the shapes
    (:func:`repro_torch.kernels.flash_attn.plan`); D is at most
    ``MAX_HEAD_DIM`` (256) there, and above it raises."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention: q {tuple(q.shape)} must be [B, Sq, Hq, D] and "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} one [B, Sk, Hkv, D]")
    b, sq, hq, d = q.shape
    _, sk, hkv, dk = k.shape
    if k.shape[0] != b or dk != d or hkv < 1 or hq % hkv:
        raise ValueError(f"attention: q {tuple(q.shape)} and k {tuple(k.shape)} need one "
                         "batch and head dim, and Hq a multiple of Hkv")
    if qpos.shape != (b, sq) or kpos.shape != (sk,):
        raise ValueError(f"attention: qpos {tuple(qpos.shape)} must be [{b}, {sq}] and "
                         f"kpos {tuple(kpos.shape)} [{sk}]")
    if q.dtype != f32 or k.dtype not in _flash.KV_DTYPES or v.dtype != k.dtype:
        raise ValueError(f"attention: q must be float32 and k/v share a dtype in "
                         f"{_flash.KV_DTYPES}, got {q.dtype}/{k.dtype}/{v.dtype}")
    if qpos.dtype != torch.int32 or kpos.dtype != torch.int32:
        raise ValueError("attention: qpos and kpos must be int32")
    if not _on_card("flash_attention", q, k, v, qpos, kpos):
        return ref.chunked_attention_ref(q, k, v, qpos, kpos, causal=causal, window=window)
    if d > _flash.MAX_HEAD_DIM:
        raise ValueError(f"attention: head dim {d} above the kernel's limit "
                         f"{_flash.MAX_HEAD_DIM}")
    if sk == 0:
        return torch.zeros_like(q)
    out = torch.empty_like(q)
    if out.numel():
        _flash.launch(q, k, v, qpos, kpos, out, causal=causal, window=window)
        LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = -1):
    """The Pallas kernel's signature (``repro/kernels/flash_attn.py``): q
    ``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Sk, D]``, queries aligned to the end
    of KV → ``[B, Hq, Sq, D]`` in q's dtype; one :func:`attention` call on
    :func:`repro_torch.kernels.ref.model_layout`'s operands. A row that
    sees no key (a causal call with Sq > Sk: the first Sq - Sk queries)
    gets the Pallas kernel's value there, ``Σ_{j<Sk} v_j / ceil_to(Sk,
    128)`` (:func:`repro_torch.kernels.ref.pallas_no_key_rows`), on both
    devices; :func:`attention` keeps ``chunked_attention``'s, which the
    model computes."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "must be [B, H, S, D]")
    out = attention(*ref.model_layout(q, k, v), causal=causal, window=window)
    out = out.transpose(1, 2)
    ref.pallas_no_key_rows(out, v, causal=causal)
    return out.to(q.dtype)
