"""Launcher of the CUDA GQA attention (``csrc/flash_attn.cu``).

Replaces the Pallas kernel ``repro/kernels/flash_attn.py:flash_attention``.
Call it through :func:`repro_torch.kernels.ops.attention` (the model's
signature) or :func:`repro_torch.kernels.ops.flash_attention` (the Pallas
signature), which check the tensors, allocate the output and count
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = [_P] * 6 + [_I] * 8 + [ctypes.c_float, _P]
_ENTRY = {torch.float32: "flash_attn_f32", torch.float16: "flash_attn_f16",
          torch.bfloat16: "flash_attn_bf16"}
_SIGNATURES = {name: _SIGNATURE for name in _ENTRY.values()}
KV_DTYPES = tuple(_ENTRY)
MAX_HEAD_DIM = 256  # eight output columns a lane


def launch(q, k, v, qpos, kpos, out, *, causal: bool, window: int) -> None:
    lib = _build.load("flash_attn", _SIGNATURES)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, _ENTRY[k.dtype])(
        *(t.data_ptr() for t in (q, k, v, qpos, kpos, out)),
        b, sq, sk, hq, hkv, d, int(causal), window, 1.0 / d ** 0.5, stream)
    _build.check(lib, err, "flash_attention")
