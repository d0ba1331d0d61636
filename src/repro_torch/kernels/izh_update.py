"""Launchers of the CUDA IZH4 kernel (``csrc/izh_update.cu``).

Replaces the Pallas kernel ``repro/kernels/izh_update.py:izh4_update``.
:func:`launch` is the single call (through
:func:`repro_torch.kernels.ops.izh4_update`, which checks the tensors,
allocates the outputs and counts launches). :class:`NeuronLauncher` is one
run's neuron phase on the card: its plan (a C struct pointing at the run's
state) filled once, so that a tick's neuron phase is one ctypes call
carrying the tick's ring slot and row pointers (through
:class:`repro_torch.kernels.ops.NeuronRun`), for a current-based ring
(one channel) or a conductance-based one (two channels, the four
conductances on the run's copies, :class:`CobaCoeffs` in the plan), for
one lane or for B lanes at their own ticks in one launch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

__all__ = ["STORAGE_DTYPES", "CobaCoeffs", "launch", "NeuronLauncher"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = [_P] * 10 + [_I, ctypes.c_float, _I, _P]
_ENTRY = {torch.float32: "izh4_update_f32", torch.float16: "izh4_update_f16"}
_RUN_ENTRY = {torch.float32: "izh4_run_f32", torch.float16: "izh4_run_f16"}
STORAGE_DTYPES = tuple(_ENTRY)


class CobaCoeffs(NamedTuple):
    """The f32 coefficients of a COBA neuron phase, each an f32 value held
    as a Python float: the AMPA, NMDA, GABAa and GABAb ``decay`` factors
    per tick, their delivery fractions ``frac`` (``1 − nmda_frac``,
    ``nmda_frac``, ``1 − gabab_frac``, ``gabab_frac``) and the reversal
    potentials."""

    decay: tuple[float, float, float, float]
    frac: tuple[float, float, float, float]
    e_exc: float
    e_gabaa: float
    e_gabab: float


_F = ctypes.c_float


class _Plan(ctypes.Structure):
    """``NeuronPlan`` of ``csrc/izh_update.cu``, field for field."""

    _fields_ = [(name, _P) for name in (
        "v", "u", "refrac", "ring", "a", "b", "c", "d", "is_gen", "gen_col", "spikes",
        "counts", "stream")] + [
        ("g", _P * 4), ("t0", _P), ("n", _I), ("substeps", _I), ("channels", _I),
        ("lanes", _I), ("ring_len", _I), ("h", _F), ("decay", _F * 4), ("frac", _F * 4),
        ("e_exc", _F), ("e_gabaa", _F), ("e_gabab", _F), ("gen_stride", ctypes.c_longlong),
        ("row_stride", ctypes.c_longlong), ("tel_count", _P), ("tel_rate", _P),
        ("tel_alpha", _F), ("tel_inst", _F), ("w_count", _P), ("w_silent", _P),
        ("w_bad", _P)]


_RUN_SIGNATURE = [ctypes.POINTER(_Plan), _I, _I, _P, _P, _P, _P, _P]
_SIGNATURES = {**{name: _SIGNATURE for name in _ENTRY.values()},
               **{name: _RUN_SIGNATURE for name in _RUN_ENTRY.values()},
               "izh4_run_plan_size": []}


def _lib() -> ctypes.CDLL:
    return _build.load("izh_update", _SIGNATURES)


def launch(v, u, i_syn, a, b, c, d, v_out, u_out, spiked, *, h: float,
           substeps: int) -> None:
    lib = _lib()
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = getattr(lib, _ENTRY[v.dtype])(
        *(t.data_ptr() for t in (v, u, i_syn, a, b, c, d, v_out, u_out, spiked)),
        v.shape[0], h, substeps, stream)
    _build.check(lib, err, "izh4_update")


class NeuronLauncher:
    """One run's neuron phase on the card: ``v``, ``u`` ``[N]`` (storage
    dtype), ``refrac`` ``[N]`` int16 and ``ring`` ``[L, N, C]`` updated in
    place, ``spikes`` ``[N]`` f32 written every tick, ``counts`` ``[N]``
    int32 (or None) counted up; for a two-channel ring, the conductances
    ``cond`` (four ``[N]`` storage-dtype tensors) updated in place under
    ``coba`` (:class:`CobaCoeffs`); launching on the stream current at
    construction. The caller keeps every tensor alive and checked.

    Over lanes, ``t0`` (int32 ``[B]`` on the card: each lane's first tick
    mod L) is given and every per-lane tensor carries a leading ``[B]``
    (``v``, ``u``, ``refrac``, ``spikes``, ``counts``, ``cond``: ``[B, N]``;
    ``ring``: ``[B, L, N, C]``); ``gen_stride`` and ``row_stride`` are the
    lane strides of the generator rows and of the i_ext, raster and record
    rows, in entries.

    ``tel_count`` (``[(B,) N]`` int32) and ``tel_rate`` (``[(B,) N]`` f32),
    where given, are a SpikeCount's and a GroupRate's accumulators,
    counted up and filtered (``rate``: the GroupRate's ``(alpha, inst)``)
    in the same launch.

    ``w_count`` (``[(B,) N]`` int32), ``w_silent`` and ``w_bad`` (``[(B,)
    4]`` int32), where given, are the in-run watches' slots: a RateBand's
    counts, a Silent's and a NonFinite's words
    (:func:`repro_torch.obs.watch.kernel_words`), folded in the same
    launch at the tick's local step."""

    def __init__(self, v, u, refrac, ring, is_gen, a, b, c, d, gen_col, spikes,
                 counts, *, dt: float, substeps: int, cond=None, coba=None, t0=None,
                 gen_stride: int = 0, row_stride: int = 0, tel_count=None, tel_rate=None,
                 rate: tuple[float, float] = (0.0, 0.0), w_count=None, w_silent=None,
                 w_bad=None):
        lib = _lib()
        if lib.izh4_run_plan_size() != ctypes.sizeof(_Plan):
            raise RuntimeError("izh4_update: the library's NeuronPlan size differs "
                               "from the launcher's")
        plan = _Plan()
        for name, t in (("v", v), ("u", u), ("refrac", refrac), ("ring", ring), ("a", a),
                        ("b", b), ("c", c), ("d", d), ("is_gen", is_gen),
                        ("gen_col", gen_col), ("spikes", spikes)):
            setattr(plan, name, t.data_ptr())
        plan.counts = None if counts is None else counts.data_ptr()
        plan.stream = torch.cuda.current_stream(v.device).cuda_stream
        plan.n, plan.substeps, plan.h = v.shape[-1], substeps, dt / substeps
        plan.channels, plan.ring_len = ring.shape[-1], ring.shape[-3]
        plan.lanes = 1 if t0 is None else t0.shape[0]
        plan.t0 = None if t0 is None else t0.data_ptr()
        plan.gen_stride, plan.row_stride = gen_stride, row_stride
        plan.tel_count = None if tel_count is None else tel_count.data_ptr()
        plan.tel_rate = None if tel_rate is None else tel_rate.data_ptr()
        plan.tel_alpha, plan.tel_inst = rate
        for name, t in (("w_count", w_count), ("w_silent", w_silent), ("w_bad", w_bad)):
            setattr(plan, name, None if t is None else t.data_ptr())
        if cond is not None:
            for k, g in enumerate(cond):
                plan.g[k] = g.data_ptr()
            plan.decay[:] = coba.decay
            plan.frac[:] = coba.frac
            plan.e_exc, plan.e_gabaa, plan.e_gabab = coba.e_exc, coba.e_gabaa, coba.e_gabab
        self._plan = plan
        self._ref = ctypes.byref(plan)
        self._lib, self._fn = lib, getattr(lib, _RUN_ENTRY[v.dtype])

    def set_gen_stride(self, entries: int) -> None:
        """The generator rows' lane stride from the next tick on (a new
        buffer of another length)."""
        self._plan.gen_stride = entries

    def __call__(self, slot: int, step: int, gen_row: int, i_ext: int, raster: int,
                 v_rec: int, i_rec: int) -> None:
        """One tick on ring slot ``slot`` (over lanes: the shift ``i % L``
        of every lane's slot), ``step`` its local index in the run (the
        watches' tick); the rows are lane 0's device pointers, 0 for
        none."""
        err = self._fn(self._ref, slot, step, gen_row or None, i_ext or None,
                       raster or None, v_rec or None, i_rec or None)
        if err:
            _build.check(self._lib, err, "izh4_update")
