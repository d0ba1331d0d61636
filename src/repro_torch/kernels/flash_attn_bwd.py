"""Launcher of the CUDA attention backward (``csrc/flash_attn_bwd.cu``).

Replaces no TPU kernel: the reference differentiates
``repro/models/attention.py:chunked_attention`` through XLA. Call it
through :func:`repro_torch.kernels.ops.attention_bwd` (or the autograd
binding ``ops.AttentionFn``), which checks the tensors, allocates the
gradients and counts launches. One call is three kernels on the current
stream: the rows' ``rowsum(dO * O)``, dK/dV per key tile and KV head, dQ
per query tile and head; no float atomics, so two calls give the same
bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import pad_den

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {"flash_attn_bwd_f32": [_P] * 12 + [_I] * 8 + [_F, _F] + [_P]}


def launch(q, k, v, out, dout, lse, qpos, kpos, dq, dk, dv, *, causal: bool,
           window: int) -> None:
    """One call: ``dq``, ``dk``, ``dv`` (f32, q's and k's shapes) from the
    forward's operands, its ``out`` and ``lse`` and the cotangent ``dout``."""
    lib = _build.load("flash_attn_bwd", _SIGNATURES)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attn_bwd_f32(
        *(t.data_ptr() for t in (q, k, v, out, dout, lse, qpos, kpos, delta, dq, dk, dv)),
        b, sq, sk, hq, hkv, d, int(causal), window, 1.0 / d ** 0.5, pad_den(sk), stream)
    _build.check(lib, err, "flash_attention_bwd")
