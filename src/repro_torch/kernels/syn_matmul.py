"""Launchers of the CUDA storage-type matmul (``csrc/syn_matmul.cu``).

Replaces the Pallas kernel ``repro/kernels/syn_matmul.py:syn_matmul``.
:func:`launch` is one checked call (through
:func:`repro_torch.kernels.ops.syn_matmul`, which checks the tensors,
allocates the output and counts launches); :class:`GemvRun` holds the
M = 1 products of one run, one :class:`GemvPlan` per weight image filled
once, so that each call is one ctypes call carrying the row's pointer
(through :class:`repro_torch.kernels.ops.MatmulRun`), for one lane or for
B lanes in one launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = [_P, _P, _P, _I, _I, _I, _P]
_ENTRY = {torch.float32: "syn_matmul_f32", torch.float16: "syn_matmul_f16",
          torch.bfloat16: "syn_matmul_bf16"}
WEIGHT_DTYPES = tuple(_ENTRY)


class GemvPlan(ctypes.Structure):
    """``GemvPlan`` of ``csrc/syn_matmul.cu``, field for field."""

    _fields_ = [("w", _P), ("out", _P), ("stream", _P), ("K", _I), ("N", _I),
                ("wtype", _I)]


class LanesPlan(ctypes.Structure):
    """``LanesPlan`` of ``csrc/syn_matmul.cu``, field for field."""

    _fields_ = [("w", _P), ("out", _P), ("stream", _P), ("w_stride", ctypes.c_longlong),
                ("K", _I), ("N", _I), ("wtype", _I), ("lanes", _I)]


_SIGNATURES = {**{name: _SIGNATURE for name in _ENTRY.values()},
               "syn_matmul_run": [ctypes.POINTER(GemvPlan), _P],
               "syn_matmul_plan_size": [],
               "syn_matmul_lanes": [ctypes.POINTER(LanesPlan), _P, ctypes.c_longlong],
               "syn_matmul_lanes_plan_size": []}


def _lib() -> ctypes.CDLL:
    return _build.load("syn_matmul", _SIGNATURES)


def launch(x, w, out) -> None:
    lib = _lib()
    (m, k), n = x.shape, w.shape[1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, _ENTRY[w.dtype])(x.data_ptr(), w.data_ptr(),
                                        out.data_ptr(), m, k, n, stream)
    _build.check(lib, err, "syn_matmul")


class GemvRun:
    """``out_i = x @ images[i]`` for a run's weight images (``[K, N]`` on
    one card, checked by the caller; None where there is no product); each
    image's ``[N]`` f32 output buffer is allocated here once and
    overwritten by every call. Launches on the stream current at
    construction.

    Over ``lanes`` B (None: one lane), ``x`` is B rows and the output
    ``[B, N]``; an image ``[K, N]`` is shared by the lanes, one ``[B, K,
    N]`` holds each lane's own, and each lane sums in the one-lane order."""

    def __init__(self, images, device, lanes: int | None = None):
        lib = _lib()
        plan_type, size = ((GemvPlan, lib.syn_matmul_plan_size()) if lanes is None else
                           (LanesPlan, lib.syn_matmul_lanes_plan_size()))
        if size != ctypes.sizeof(plan_type):
            raise RuntimeError(f"syn_matmul: the library's {plan_type.__name__} size "
                               "differs from the launcher's")
        self._lib, self._lanes = lib, lanes is not None
        self._fn = lib.syn_matmul_lanes if self._lanes else lib.syn_matmul_run
        self._keep = tuple(images)  # the plans point at these tensors
        stream = torch.cuda.current_stream(device).cuda_stream
        self.outs, self._plans = [], []
        for w in images:
            if w is None:
                self.outs.append(None)
                self._plans.append(None)
                continue
            k, n = w.shape[-2:]
            kw = dict(w=w.data_ptr(), stream=stream, K=k, N=n,
                      wtype=_build.STORAGE_CODE[w.dtype])
            if lanes is None:
                out = torch.empty((n,), dtype=torch.float32, device=device)
                plan = GemvPlan(out=out.data_ptr(), **kw)
            else:
                out = torch.empty((lanes, n), dtype=torch.float32, device=device)
                plan = LanesPlan(out=out.data_ptr(), lanes=lanes,
                                 w_stride=k * n if w.dim() == 3 else 0, **kw)
            self.outs.append(out)
            self._plans.append((ctypes.byref(plan), plan))

    def __call__(self, i: int, x_ptr: int, x_stride: int = 0) -> torch.Tensor:
        """Launch image ``i``'s product with the f32 row at device pointer
        ``x_ptr`` (``K`` contiguous values; over lanes, lane b's at ``x_ptr
        + 4 · b · x_stride``); returns its output buffer."""
        args = (x_ptr, x_stride) if self._lanes else (x_ptr,)
        err = self._fn(self._plans[i][0], *args)
        if err:
            _build.check(self._lib, err, "syn_matmul")
        return self.outs[i]
