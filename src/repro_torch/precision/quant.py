"""Beyond the paper: int8 storage with per-slice f32 scales.

The paper stops at fp16 (its weights, |w| in [1, 3.5], sit well inside
fp16's range). For a further 2x capacity step, a tensor is stored as
symmetric int8 with an f32 scale per slice along one axis: int8 at rest,
f32 math, the same storage/compute split. ``data`` and ``scale`` equal the
reference's bit for bit: ``torch.round`` rounds half to even as
``jnp.round`` does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["QTensor", "quantize_int8", "dequantize"]


class QTensor(NamedTuple):
    """Symmetric int8 quantized tensor: ``value ~ data * scale``.

    ``scale`` has ``data``'s rank with the quantized axis reduced to size
    1, so it broadcasts on dequantize.
    """

    data: torch.Tensor  # int8
    scale: torch.Tensor  # f32, broadcastable against data

    @property
    def shape(self):
        return self.data.shape

    @property
    def nbytes(self) -> int:
        return self.data.numel() + self.scale.numel() * 4


def quantize_int8(x: torch.Tensor, *, axis: int = -1) -> QTensor:
    """Symmetric per-slice int8 quantization along ``axis``: the scale is
    ``amax / 127`` in f32 (1.0 for an all-zero slice), the data
    ``round(x / scale)`` clipped to +-127."""
    x = torch.as_tensor(x).to(torch.float32)
    amax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, 1.0).to(torch.float32)
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return QTensor(data=q, scale=scale)


def dequantize(q: QTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.data.to(torch.float32) * q.scale).to(dtype)
