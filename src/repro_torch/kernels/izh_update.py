"""Launcher of the CUDA IZH4 kernel (``csrc/izh_update.cu``).

Replaces the Pallas kernel ``repro/kernels/izh_update.py:izh4_update``.
Call it through :func:`repro_torch.kernels.ops.izh4_update`, which checks
the tensors, allocates the outputs and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_SIGNATURE = [_P] * 10 + [ctypes.c_int, ctypes.c_float, ctypes.c_int, _P]
_SIGNATURES = {"izh4_update_f32": _SIGNATURE, "izh4_update_f16": _SIGNATURE}
_ENTRY = {torch.float32: "izh4_update_f32", torch.float16: "izh4_update_f16"}
STORAGE_DTYPES = tuple(_ENTRY)


def launch(v, u, i_syn, a, b, c, d, v_out, u_out, spiked, *, h: float,
           substeps: int) -> None:
    lib = _build.load("izh_update", _SIGNATURES)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = getattr(lib, _ENTRY[v.dtype])(
        *(t.data_ptr() for t in (v, u, i_syn, a, b, c, d, v_out, u_out, spiked)),
        v.shape[0], h, substeps, stream)
    _build.check(lib, err, "izh4_update")
