"""The reference's counter-based generator stream: threefry2x32 keys.

The reference draws its generator uniforms with ``jax.random`` under the
default ``threefry2x32`` implementation with ``jax_threefry_partitionable``
on (jax 0.9.0's defaults). This module computes the same bits with torch
integer ops, so the same seed gives the same raster in both packages, on
the CPU and on the card alike:

* a key is the two 32-bit key words, stored as an int32 ``[2]`` tensor of
  their bit patterns (8 bytes, as the reference's key data); a stack of
  keys ``[..., 2]`` draws for each key at once, as ``vmap`` over keys
  does;
* :func:`key` makes one from an integer seed as ``jax.random.key`` does
  with 64-bit types off: the words are ``(0, seed mod 2**32)``;
* :func:`split`, :func:`fold_in` and :func:`uniform` follow
  ``jax._src.prng``'s partitionable threefry: element ``i`` of a shape
  hashes the 64-bit counter ``i`` as its two words ``(i >> 32, i mod
  2**32)``, split keeps both output words, random bits are their xor, and
  ``fold_in(key, x)`` hashes the single pair ``(0, x)``;
* ``uniform`` turns 32 bits into a float32 in ``[0, 1)`` as ``jax.random``
  does: the top 23 bits become the mantissa of a number in ``[1, 2)``,
  minus one.

Arithmetic is int64 masked to 32 bits, which gives the same bits on every
device.
"""
from __future__ import annotations

import math

import torch

__all__ = ["key", "split", "fold_in", "uniform", "random_bits", "threefry2x32"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000  # 1.0f


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or int64 values) as int64 in [0, 2**32)."""
    return x.to(torch.int64) & _MASK


def _as_key(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) back to int32 bit patterns."""
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: int | torch.Tensor, k2: int | torch.Tensor,
                 x1: torch.Tensor, x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds on int64 words in ``[0, 2**32)``:
    key ``(k1, k2)``, counters ``(x1, x2)`` of one shape; returns the two
    output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def _hash_counters(k: torch.Tensor, shape: tuple[int, ...]):
    """Both output words of every counter ``0 .. prod(shape)-1`` under each
    key of ``k`` ``[..., 2]``, shaped ``[..., *shape]``."""
    words = _u32(k)
    n = math.prod(shape)
    ctr = torch.arange(n, dtype=torch.int64, device=k.device)
    y1, y2 = threefry2x32(words[..., 0:1], words[..., 1:2], ctr >> 32, ctr & _MASK)
    lead = tuple(k.shape[:-1])
    return y1.reshape(lead + tuple(shape)), y2.reshape(lead + tuple(shape))


def key(seed: int, device: str | torch.device | None = None) -> torch.Tensor:
    """The key of an integer seed: int32 ``[2]`` words ``(0, seed mod 2**32)``."""
    return _as_key(torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                                device=device))


def split(k: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``n`` new keys from ``k``, as an int32 ``[n, 2]`` tensor (from each
    key of a stack ``[..., 2]``: ``[..., n, 2]``)."""
    y1, y2 = _hash_counters(k, (n,))
    return _as_key(torch.stack([y1, y2], dim=-1))


def fold_in(k: torch.Tensor, data: int | torch.Tensor) -> torch.Tensor:
    """The key ``k`` with the 32-bit integer ``data`` folded in; for an
    integer tensor ``data``, one key per entry, ``[*data.shape, 2]`` (the
    reference's ``vmap`` of ``fold_in`` over the entries). A stack of keys
    ``[..., 2]`` folds each key into the entries of ``data`` that share its
    leading indices (``data`` ``[..., *rest]``)."""
    words = _u32(k)
    x2 = torch.as_tensor(data, device=k.device).to(torch.int64) & _MASK
    lead = (1,) * (x2.dim() - (words.dim() - 1))
    k1, k2 = (words[..., i].reshape(words.shape[:-1] + lead) for i in (0, 1))
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(x2), x2)
    return _as_key(torch.stack([y1, y2], dim=-1))


def random_bits(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element of ``shape`` (under each key of a stack
    ``[..., 2]``: ``[..., *shape]``), as int64 in ``[0, 2**32)``."""
    y1, y2 = _hash_counters(k, tuple(shape))
    return y1 ^ y2


def uniform(k: torch.Tensor, shape: tuple[int, ...], *, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in ``[minval, maxval)`` of ``shape``, drawn from
    ``k`` (from each key of a stack ``[..., 2]``: ``[..., *shape]``). As
    ``jax.random.uniform``: ``u`` in ``[0, 1)``, then ``max(minval, u *
    (maxval - minval) + minval)`` in float32, the mul-add rounded once, as
    XLA CPU's fused multiply-add rounds it (the exact f32 product plus
    ``minval`` in f64, then to f32)."""
    bits = (random_bits(k, shape) >> 9) | _ONE_F32_BITS
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return u
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    out = (u.double() * span.double() + lo.double()).float()
    return torch.maximum(out, lo.to(out.device))
