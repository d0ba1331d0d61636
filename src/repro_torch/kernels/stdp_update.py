"""Launcher of the CUDA dense STDP update (``csrc/stdp_update.cu``).

Replaces the Pallas kernel ``repro/kernels/stdp_update.py:stdp_update``.
Call it through :func:`repro_torch.kernels.ops.stdp_update`, which checks
the tensors, allocates the output and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURE = [_P] * 7 + [_I, _I, _F, _F, _F, _F, _P]
_ENTRY = {torch.float32: "stdp_update_f32", torch.float16: "stdp_update_f16"}
_SIGNATURES = {name: _SIGNATURE for name in _ENTRY.values()}
STORAGE_DTYPES = tuple(_ENTRY)


def launch(w, mask, pre_t, post_t, pre_s, post_s, out, *, a_plus: float,
           a_minus: float, w_min: float, w_max: float) -> None:
    lib = _build.load("stdp_update", _SIGNATURES)
    p, q = w.shape
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = getattr(lib, _ENTRY[w.dtype])(
        *(t.data_ptr() for t in (w, mask, pre_t, post_t, pre_s, post_s, out)),
        p, q, a_plus, a_minus, w_min, w_max, stream)
    _build.check(lib, err, "stdp_update")
