"""The linear recurrence and the short causal convolution shared by the
Mamba and RG-LRU blocks, in the reference's evaluation order.

The reference runs ``h_t = a_t h_{t-1} + b_t`` with
``jax.lax.associative_scan`` and its depthwise K-tap convolutions as K
shifted products added in order; under ``jax.jit`` XLA CPU contracts each
``x * y + z`` of them into one fused multiply-add. :func:`associative_scan`
mirrors ``associative_scan``'s recursion (pairs of neighbours combined,
the odd half scanned, the even half filled in), which is also log-depth
on the card, and :func:`fma` rounds a multiply-add once, as the fused
operation does: in float64, where the product of two float32 values is
exact, then to the result's dtype. The sum is rounded twice, to float64
and then to float32, which can differ from one correctly rounded FMA where
the float64 sum lands on a float32 halfway point: rare, and seen in none
of the tests' samples, where the scan is bit for bit the reference's jitted
one and so is the prefill convolution. On the card the float64 operations
cost time that a later measurement may trade away.
"""
from __future__ import annotations

import torch

__all__ = ["fma", "associative_scan", "chunked_scan", "causal_conv"]


def fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``x * y + z`` in the dtype the three promote to, through float64
    (the product exact, the sum rounded to float64 and then to that dtype;
    see the module's note on double rounding)."""
    dtype = torch.promote_types(torch.promote_types(x.dtype, y.dtype), z.dtype)
    f64 = torch.float64
    return (x.to(f64) * y.to(f64) + z.to(f64)).to(dtype)


def _combine(a1, b1, a2, b2):
    """The reference's ``_combine``: ``(a1 a2, a2 b1 + b2)``, earlier
    element first."""
    return a1 * a2, fma(a2, b1, b2)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n) + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``(a, b)`` over dim 1 under :func:`_combine`:
    ``(prod a, h)`` with ``h_t = a_t h_{t-1} + b_t``, ``h_{-1} = 0``, in
    ``jax.lax.associative_scan``'s recursion."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = associative_scan(ra, rb)
    pa, pb = (oa[:, :-1], ob[:, :-1]) if n % 2 == 0 else (oa, ob)
    ea, eb = _combine(pa, pb, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def chunked_scan(a: torch.Tensor, b: torch.Tensor, chunk: int) -> torch.Tensor:
    """``h`` of :func:`associative_scan` over chunks of ``chunk`` steps
    (dim 1 a multiple of it): each chunk scanned on its own, then the
    carried state folded in (``a_cum h_in + b_cum``, one multiply-add), as
    the reference's ``SSM_CHUNK`` path does."""
    s = a.shape[1]
    h_in = torch.zeros((a.shape[0],) + tuple(a.shape[2:]), dtype=a.dtype, device=a.device)
    outs = []
    for i in range(0, s, chunk):
        a_cum, b_cum = associative_scan(a[:, i:i + chunk], b[:, i:i + chunk])
        h_c = fma(a_cum, h_in[:, None], b_cum)
        outs.append(h_c)
        h_in = h_c[:, -1]
    return torch.cat(outs, dim=1)


def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                hist: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal convolution: x ``[B, S, C]``, w ``[K, C]``, bias
    ``[C]`` (both cast to x's dtype); ``hist`` ``[B, K-1, C]`` prepends
    history, else zeros. The K shifted products are summed as XLA CPU
    fuses the reference's chain ``((x_0 w_0 + x_1 w_1) + x_2 w_2) + ...``:
    ``fma(x_0, w_0, x_1 w_1)``, then one multiply-add per further tap;
    the bias is added last."""
    k, s = w.shape[0], x.shape[1]
    w = w.to(x.dtype)
    if hist is None:
        xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([hist.to(x.dtype), x], dim=1)
    if k == 1:
        out = xp[:, :s] * w[0]
    else:
        out = fma(xp[:, 0:s], w[0], xp[:, 1:1 + s] * w[1])
        for i in range(2, k):
            out = fma(xp[:, i:i + s], w[i], out)
    return out + bias.to(x.dtype)
