"""Launcher of the CUDA GQA attention (``csrc/flash_attn.cu``).

Replaces the Pallas kernel ``repro/kernels/flash_attn.py:flash_attention``.
Call it through :func:`repro_torch.kernels.ops.attention` (the model's
signature) or :func:`repro_torch.kernels.ops.flash_attention` (the Pallas
signature), which check the tensors, allocate the output and count
launches. :func:`plan` chooses the kernel's path from the shapes: the
split-K decode path for at most ``DECODE_ROWS`` query rows per KV head,
with its split count, or the tensor-core prefill path (always, when the training
forward asks for the rows' log-sum-exp). The decode path's
partials and tickets live in scratch held here per card and stream.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURE = [_P] * 9 + [_I] * 8 + [_F, _F] + [_I] * 3 + [_P]
_ENTRY = {torch.float32: "flash_attn_f32", torch.float16: "flash_attn_f16",
          torch.bfloat16: "flash_attn_bf16"}
_SIGNATURES = {name: _SIGNATURE for name in _ENTRY.values()}
KV_DTYPES = tuple(_ENTRY)
MAX_HEAD_DIM = 256
DECODE_ROWS = 16  # query rows per decode CTA (Sq x the GQA group)
DECODE_OUTPUTS = 16 * 128  # outputs per decode CTA: 16 a thread
TILE = 32  # decode keys per tile; a split holds whole tiles
MAX_SPLIT = 32 * TILE  # decode keys per split: one liveness pass of the kernel
CTAS_PER_SM = 4  # decode grids aim at this many CTAs per SM
BLOCK_K = 1024  # the reference's KV block, which pads a row with no allowed key

_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}
_SMS: dict[int, int] = {}


def plan(b: int, sq: int, sk: int, hq: int, hkv: int, d: int, n_sm: int) -> tuple[int, int]:
    """``(splits, keys per split)`` of the decode path, or ``(0, 0)`` for
    the prefill path: decode when the GQA group's query rows (``Sq * Hq /
    Hkv``) fit one CTA, with splits of whole 32-key tiles chosen so that
    the ``B * Hkv`` (batch row, KV head) pairs make about four CTAs per SM,
    one split per tile at short caches, and more splits where a split
    would pass ``MAX_SPLIT`` keys."""
    rows = sq * (hq // hkv)
    if rows > DECODE_ROWS or rows * d > DECODE_OUTPUTS:
        return 0, 0
    want = max(1, -(-CTAS_PER_SM * n_sm // (b * hkv)))
    kps = min(MAX_SPLIT, TILE * max(1, -(-sk // (want * TILE))))
    return -(-sk // kps), kps


def pad_den(sk: int) -> float:
    """``Sk + pad``, the reference's divisor of a row with no allowed key."""
    bk = min(BLOCK_K, sk)
    return float(sk + (-sk % bk))


def _scratch(dev: torch.device, stream: int, floats: int, pairs: int):
    key = (dev.index, stream)
    part, tickets = _SCRATCH.get(key, (None, None))
    if part is None or part.numel() < floats or tickets.numel() < pairs:
        part = torch.empty((max(floats, 1),), dtype=torch.float32, device=dev)
        tickets = torch.zeros((max(pairs, 1),), dtype=torch.int32, device=dev)
        _SCRATCH[key] = (part, tickets)
    return part, tickets


def launch(q, k, v, qpos, kpos, out, *, causal: bool, window: int,
           splits: int | None = None, lse: torch.Tensor | None = None) -> None:
    """One launch; ``splits`` overrides :func:`plan`'s decode split count
    (a decode-shaped call only; for tests of the split combine). With
    ``lse`` (f32 ``[B, Hq, Sq]``, the training forward) the prefill path
    also writes each row's log-sum-exp, whatever the shapes."""
    lib = _build.load("flash_attn", _SIGNATURES)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dev = q.device
    n_sm = _SMS.get(dev.index)
    if n_sm is None:
        n_sm = _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, kps = (0, 0) if lse is not None else plan(b, sq, sk, hq, hkv, d, n_sm)
    if splits is not None and n_split:
        kps = min(MAX_SPLIT, TILE * max(1, -(-sk // (splits * TILE))))
        n_split = -(-sk // kps)
    stream = torch.cuda.current_stream(dev).cuda_stream
    pairs, stride = b * hkv, -(-(d + 2) // 4) * 4  # a partial row: m, l, acc[D]
    part, tickets = _scratch(dev, stream, pairs * n_split * sq * (hq // hkv) * stride, pairs)
    vec = int((d * k.element_size()) % 16 == 0 and k.data_ptr() % 16 == 0
              and v.data_ptr() % 16 == 0)
    err = getattr(lib, _ENTRY[k.dtype])(
        *(t.data_ptr() for t in (q, k, v, qpos, kpos, out)),
        None if lse is None else lse.data_ptr(), part.data_ptr(), tickets.data_ptr(),
        b, sq, sk, hq, hkv, d, int(causal), window, 1.0 / d ** 0.5, pad_den(sk),
        n_split, kps, vec, stream)
    _build.check(lib, err, "flash_attention")
