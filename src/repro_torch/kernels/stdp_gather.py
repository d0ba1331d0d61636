"""Launchers of the CUDA CSR-row STDP update (``csrc/stdp_gather.cu``).

Replaces the Pallas kernel ``repro/kernels/stdp_gather.py:stdp_gather``.
:func:`launch` is one checked call over one table (through
:func:`repro_torch.kernels.ops.stdp_gather`, which checks the tensors,
allocates the output and counts launches). :class:`StdpLauncher` is a
run's plastic CSR projections (:class:`Projection`) on the card: their
descriptors copied to the device once, so that a tick's updates of every
projection, trace steps included, are one ctypes call carrying the spike
row's pointer (through :class:`repro_torch.kernels.ops.StdpGatherRun`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

__all__ = ["INDEX_DTYPES", "STORAGE_DTYPES", "launch", "Projection", "StdpLauncher"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURE = [_P] * 8 + [_I, _I, _I, _F, _F, _F, _F, _P]
_IDX = {torch.int16: "i16", torch.int32: "i32"}
_W = {torch.float32: "f32", torch.float16: "f16", torch.bfloat16: "bf16"}
_ITYPE = {torch.int16: 0, torch.int32: 1}
INDEX_DTYPES = tuple(_IDX)
STORAGE_DTYPES = tuple(_W)


class _Proj(ctypes.Structure):
    """``StdpProj`` of ``csrc/stdp_gather.cu``, field for field."""

    _fields_ = [("w", _P), ("idx", _P), ("valid", _P), ("pre_tr", _P * 2),
                ("post_tr", _P * 2), ("w_lane", ctypes.c_longlong),
                ("begin", ctypes.c_longlong)] + [
        (name, _I) for name in ("P", "Q", "F", "pre_start", "post_start", "itype",
                                "wtype")] + [
        (name, _F) for name in ("a_plus", "a_minus", "w_min", "w_max", "decay_pre",
                                "decay_post")]


class _Plan(ctypes.Structure):
    """``StdpPlan`` of ``csrc/stdp_gather.cu``, field for field."""

    _fields_ = [("projs", _P), ("stream", _P), ("n_items", ctypes.c_longlong),
                ("n_projs", _I), ("lanes", _I), ("n", _I)]


_SIGNATURES = {**{f"stdp_gather_{i}_{w}": _SIGNATURE
                  for i in _IDX.values() for w in _W.values()},
               "stdp_gather_run": [ctypes.POINTER(_Plan), _P, _I],
               "stdp_gather_run_sizes": [ctypes.POINTER(_I)]}


def _lib() -> ctypes.CDLL:
    return _build.load("stdp_gather", _SIGNATURES)


def launch(w, idx, valid, pre_t, post_t, pre_s, post_s, out, *, a_plus: float,
           a_minus: float, w_min: float, w_max: float) -> None:
    lib = _lib()
    (q, f), p = w.shape, pre_t.shape[0]
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = getattr(lib, f"stdp_gather_{_IDX[idx.dtype]}_{_W[w.dtype]}")(
        *(t.data_ptr() for t in (w, idx, valid, pre_t, post_t, pre_s, post_s, out)),
        p, q, f, a_plus, a_minus, w_min, w_max, stream)
    _build.check(lib, err, "stdp_gather")


class Projection(NamedTuple):
    """One plastic CSR projection of a run, on the run's own buffers: its
    ``[Q, F]`` weights ``w`` (f32, fp16 or bf16, updated in place), indices
    ``idx`` (int16/int32, local to the pre group) and validity rows
    ``valid``; its traces as ping-pong pairs ``pre_tr`` (two ``[P]`` f32)
    and ``post_tr`` (two ``[Q]`` f32); where its pre and post groups start
    in the tick's ``[N]`` spike row; the update's constants and the trace
    decays ``exp(-dt/tau+)`` (pre) and ``exp(-dt/tau-)`` (post) as Python
    floats, applied as f32. Over B lanes (a batched run), ``w`` is ``[B, Q,
    F]`` and the traces are pairs of ``[B, P]`` and ``[B, Q]``; ``idx`` and
    ``valid`` are shared."""

    w: torch.Tensor
    idx: torch.Tensor
    valid: torch.Tensor
    pre_tr: tuple[torch.Tensor, torch.Tensor]
    post_tr: tuple[torch.Tensor, torch.Tensor]
    pre_start: int
    post_start: int
    a_plus: float
    a_minus: float
    w_min: float
    w_max: float
    decay_pre: float
    decay_post: float


class StdpLauncher:
    """The :class:`Projection` s of one run on the card ``device``: their
    descriptors laid out once, in order, in device memory, launching on the
    stream current at construction. Each projection's items are its cells,
    then one per pre and one per post neuron (the trace steps). Over
    ``lanes`` B (``n`` the spike row's length) the grid takes a second
    dimension, one lane each."""

    def __init__(self, projs, device, lanes: int | None = None, n: int = 0):
        lib = _lib()
        sizes = (_I * 2)()
        lib.stdp_gather_run_sizes(sizes)
        if tuple(sizes) != (ctypes.sizeof(_Proj), ctypes.sizeof(_Plan)):
            raise RuntimeError(f"stdp_gather: the library's descriptor sizes "
                               f"{tuple(sizes)} differ from the launcher's")
        table = (_Proj * len(projs))()
        begin = 0
        for d, p in zip(table, projs):
            q, f = p.w.shape[-2:]
            n_pre = p.pre_tr[0].shape[-1]
            d.w, d.idx, d.valid = p.w.data_ptr(), p.idx.data_ptr(), p.valid.data_ptr()
            d.pre_tr[:] = [t.data_ptr() for t in p.pre_tr]
            d.post_tr[:] = [t.data_ptr() for t in p.post_tr]
            d.w_lane = p.w.stride(0) if lanes is not None else 0
            d.begin, d.P, d.Q, d.F = begin, n_pre, q, f
            d.pre_start, d.post_start = p.pre_start, p.post_start
            d.itype, d.wtype = _ITYPE[p.idx.dtype], _build.STORAGE_CODE[p.w.dtype]
            d.a_plus, d.a_minus, d.w_min, d.w_max = p.a_plus, p.a_minus, p.w_min, p.w_max
            d.decay_pre, d.decay_post = p.decay_pre, p.decay_post
            begin += q * f + n_pre + q
        raw = torch.frombuffer(bytearray(bytes(table)), dtype=torch.uint8)
        # Keep every tensor a descriptor points at alive for the launcher's life.
        self._keep = (tuple(projs), raw.to(device))
        self.items = begin
        self._plan = _Plan(projs=self._keep[1].data_ptr(),
                           stream=torch.cuda.current_stream(device).cuda_stream,
                           n_items=begin, n_projs=len(projs),
                           lanes=1 if lanes is None else lanes, n=n)
        self._ref = ctypes.byref(self._plan)
        self._lib, self._fn = lib, lib.stdp_gather_run

    def __call__(self, spikes_ptr: int, parity: int) -> None:
        """One tick on the f32 spike row at device pointer ``spikes_ptr``,
        the traces read from buffer ``parity`` and written to the other."""
        err = self._fn(self._ref, spikes_ptr, parity)
        if err:
            _build.check(self._lib, err, "stdp_gather")
