"""Launcher of the CUDA storage-type matmul (``csrc/syn_matmul.cu``).

Replaces the Pallas kernel ``repro/kernels/syn_matmul.py:syn_matmul``.
Call it through :func:`repro_torch.kernels.ops.syn_matmul`, which checks
the tensors, allocates the output and counts launches.
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
_SIGNATURES = {name: _SIGNATURE for name in _ENTRY.values()}
WEIGHT_DTYPES = tuple(_ENTRY)


def launch(x, w, out) -> None:
    lib = _build.load("syn_matmul", _SIGNATURES)
    (m, k), n = x.shape, w.shape[1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, _ENTRY[w.dtype])(x.data_ptr(), w.data_ptr(),
                                        out.data_ptr(), m, k, n, stream)
    _build.check(lib, err, "syn_matmul")
