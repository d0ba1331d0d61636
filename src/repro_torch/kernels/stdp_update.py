"""Launchers of the CUDA dense STDP update (``csrc/stdp_update.cu``).

Replaces the Pallas kernel ``repro/kernels/stdp_update.py:stdp_update``.
:func:`launch` is one checked call over one block (through
:func:`repro_torch.kernels.ops.stdp_update`, which checks the tensors,
allocates the output and counts launches). :class:`StdpUpdateLauncher` is
a run's dense pair-STDP projections (:class:`DenseProjection`) on the
card: their descriptors copied to the device once, so that a tick's
updates of every projection, trace steps included, are one ctypes call
carrying the spike row's pointer (through
:class:`repro_torch.kernels.ops.StdpUpdateRun`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

__all__ = ["STORAGE_DTYPES", "launch", "DenseProjection", "StdpUpdateLauncher"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURE = [_P] * 7 + [_I, _I, _F, _F, _F, _F, _P]
_ENTRY = {torch.float32: "stdp_update_f32", torch.float16: "stdp_update_f16",
          torch.bfloat16: "stdp_update_bf16"}
STORAGE_DTYPES = tuple(_ENTRY)


class _Proj(ctypes.Structure):
    """``StdpDenseProj`` of ``csrc/stdp_update.cu``, field for field."""

    _fields_ = [("w", _P), ("mask", _P), ("pre_tr", _P * 2), ("post_tr", _P * 2),
                ("w_lane", ctypes.c_longlong)] + [
        (name, _I) for name in ("begin", "P", "Q", "col_tiles", "pre_start", "post_start",
                                "wtype")] + [
        (name, _F) for name in ("a_plus", "a_minus", "w_min", "w_max", "decay_pre",
                                "decay_post")]


class _Plan(ctypes.Structure):
    """``StdpDensePlan`` of ``csrc/stdp_update.cu``, field for field."""

    _fields_ = [("projs", _P), ("begins", _P), ("stream", _P), ("n_tiles", _I),
                ("n_projs", _I), ("lanes", _I), ("n", _I)]


_SIGNATURES = {**{name: _SIGNATURE for name in _ENTRY.values()},
               "stdp_update_run": [ctypes.POINTER(_Plan), _P, _I],
               "stdp_update_run_sizes": [ctypes.POINTER(_I)]}


def _lib() -> ctypes.CDLL:
    return _build.load("stdp_update", _SIGNATURES)


def launch(w, mask, pre_t, post_t, pre_s, post_s, out, *, a_plus: float,
           a_minus: float, w_min: float, w_max: float) -> None:
    lib = _lib()
    p, q = w.shape
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = getattr(lib, _ENTRY[w.dtype])(
        *(t.data_ptr() for t in (w, mask, pre_t, post_t, pre_s, post_s, out)),
        p, q, a_plus, a_minus, w_min, w_max, stream)
    _build.check(lib, err, "stdp_update")


class DenseProjection(NamedTuple):
    """One dense-stored pair-STDP projection of a run, on the run's own
    buffers: its ``[P, Q]`` weights ``w`` (f32, fp16 or bf16, contiguous, updated
    in place) and bool ``mask``; its traces as ping-pong pairs ``pre_tr``
    (two ``[P]`` f32) and ``post_tr`` (two ``[Q]`` f32); where its pre and
    post groups start in the tick's ``[N]`` spike row; the update's
    constants and the trace decays ``exp(-dt/tau+)`` (pre) and
    ``exp(-dt/tau-)`` (post) as Python floats, applied as f32. ``padded``,
    where given, is the flat ``[P·Q + 1]`` buffer whose first P·Q entries
    are ``w`` and whose last is +0.0: the fan-in drive gathers its rows
    from it (the plain fan-in drive, ``ref.plastic_drive_ref``).

    Over B lanes (a batched run), ``w`` is ``[B, P, Q]`` (each lane the
    start of its own row of ``padded`` ``[B, P·Q + 1]``, or contiguous
    without it), the traces are pairs of ``[B, P]`` and ``[B, Q]`` and the
    mask is shared."""

    w: torch.Tensor
    mask: torch.Tensor
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
    padded: torch.Tensor | None = None


class StdpUpdateLauncher:
    """The :class:`DenseProjection` s of one run on the card ``device``:
    their descriptors laid out once, in order, in device memory, launching
    on the stream current at construction. Each projection is tiles of
    ``rows`` rows by ``cols`` columns (the kernel's), one CTA each, at least
    one per projection; ``items`` is the launch's CTA count (0: nothing to
    launch). Over ``lanes`` B (``n`` the spike row's length) the grid
    takes a second dimension, one lane each."""

    def __init__(self, projs, device, lanes: int | None = None, n: int = 0):
        lib = _lib()
        sizes = (_I * 4)()
        lib.stdp_update_run_sizes(sizes)
        if tuple(sizes[:2]) != (ctypes.sizeof(_Proj), ctypes.sizeof(_Plan)):
            raise RuntimeError(f"stdp_update: the library's descriptor sizes "
                               f"{tuple(sizes[:2])} differ from the launcher's")
        self.rows, self.cols = sizes[2], sizes[3]
        table = (_Proj * len(projs))()
        begins = []
        tiles = 0
        for d, p in zip(table, projs):
            n_pre, n_post = p.w.shape[-2:]
            col_tiles = max(1, -(-n_post // self.cols))
            d.w, d.mask = p.w.data_ptr(), p.mask.data_ptr()
            d.pre_tr[:] = [t.data_ptr() for t in p.pre_tr]
            d.post_tr[:] = [t.data_ptr() for t in p.post_tr]
            d.w_lane = p.w.stride(0) if lanes is not None else 0
            d.begin, d.P, d.Q, d.col_tiles = tiles, n_pre, n_post, col_tiles
            d.pre_start, d.post_start = p.pre_start, p.post_start
            d.wtype = _build.STORAGE_CODE[p.w.dtype]
            d.a_plus, d.a_minus, d.w_min, d.w_max = p.a_plus, p.a_minus, p.w_min, p.w_max
            d.decay_pre, d.decay_post = p.decay_pre, p.decay_post
            begins.append(tiles)
            tiles += max(1, -(-n_pre // self.rows)) * col_tiles
        if tiles > 0x7FFFFFFF:
            raise ValueError(f"stdp_update: {tiles} tiles exceed one launch's grid")
        raw = torch.frombuffer(bytearray(bytes(table)), dtype=torch.uint8)
        starts = torch.tensor(begins, dtype=torch.int32)
        # Keep every tensor a descriptor points at alive for the launcher's life.
        self._keep = (tuple(projs), raw.to(device), starts.to(device))
        self.items = tiles
        self._plan = _Plan(projs=self._keep[1].data_ptr(), begins=self._keep[2].data_ptr(),
                           stream=torch.cuda.current_stream(device).cuda_stream,
                           n_tiles=self.items, n_projs=len(projs),
                           lanes=1 if lanes is None else lanes, n=n)
        self._ref = ctypes.byref(self._plan)
        self._lib, self._fn = lib, lib.stdp_update_run

    def __call__(self, spikes_ptr: int, parity: int) -> None:
        """One tick on the f32 spike row(s) at device pointer ``spikes_ptr``,
        the traces read from buffer ``parity`` and written to the other."""
        err = self._fn(self._ref, spikes_ptr, parity)
        if err:
            _build.check(self._lib, err, "stdp_update")
