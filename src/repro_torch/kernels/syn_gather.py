"""Launcher of the CUDA CSR fan-in gather (``csrc/syn_gather.cu``).

Replaces the Pallas kernel ``repro/kernels/syn_gather.py:syn_gather``.
Call it through :func:`repro_torch.kernels.ops.syn_gather`, which checks
the tensors, allocates the output and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = [_P, _P, _P, _P, _I, _I, _I, _P]
_IDX = {torch.int16: "i16", torch.int32: "i32"}
_W = {torch.float32: "f32", torch.float16: "f16", torch.bfloat16: "bf16"}
_SIGNATURES = {f"syn_gather_{i}_{w}": _SIGNATURE
               for i in _IDX.values() for w in _W.values()}
INDEX_DTYPES = tuple(_IDX)
WEIGHT_DTYPES = tuple(_W)
# The spike row is staged in the default 48 KB of shared memory per block.
MAX_PRE = 48 * 1024 // 4


def launch(spikes, idx, w, out) -> None:
    lib = _build.load("syn_gather", _SIGNATURES)
    (q, f), p = idx.shape, spikes.shape[0]
    stream = torch.cuda.current_stream(spikes.device).cuda_stream
    err = getattr(lib, f"syn_gather_{_IDX[idx.dtype]}_{_W[w.dtype]}")(
        spikes.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
        p, q, f, stream)
    _build.check(lib, err, "syn_gather")
