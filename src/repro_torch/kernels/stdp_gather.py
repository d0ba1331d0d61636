"""Launcher of the CUDA CSR-row STDP update (``csrc/stdp_gather.cu``).

Replaces the Pallas kernel ``repro/kernels/stdp_gather.py:stdp_gather``.
Call it through :func:`repro_torch.kernels.ops.stdp_gather`, which checks
the tensors, allocates the output and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURE = [_P] * 8 + [_I, _I, _I, _F, _F, _F, _F, _P]
_IDX = {torch.int16: "i16", torch.int32: "i32"}
_W = {torch.float32: "f32", torch.float16: "f16"}
_SIGNATURES = {f"stdp_gather_{i}_{w}": _SIGNATURE
               for i in _IDX.values() for w in _W.values()}
INDEX_DTYPES = tuple(_IDX)
STORAGE_DTYPES = tuple(_W)


def launch(w, idx, valid, pre_t, post_t, pre_s, post_s, out, *, a_plus: float,
           a_minus: float, w_min: float, w_max: float) -> None:
    lib = _build.load("stdp_gather", _SIGNATURES)
    (q, f), p = w.shape, pre_t.shape[0]
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = getattr(lib, f"stdp_gather_{_IDX[idx.dtype]}_{_W[w.dtype]}")(
        *(t.data_ptr() for t in (w, idx, valid, pre_t, post_t, pre_s, post_s, out)),
        p, q, f, a_plus, a_minus, w_min, w_max, stream)
    _build.check(lib, err, "stdp_gather")
