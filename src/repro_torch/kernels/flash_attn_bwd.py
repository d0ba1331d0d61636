"""Launcher of the CUDA attention backward (``csrc/flash_attn_bwd.cu``).

Replaces no TPU kernel: the reference differentiates
``repro/models/attention.py:chunked_attention`` through XLA. Call it
through :func:`repro_torch.kernels.ops.attention_bwd` (or the autograd
binding ``ops.AttentionFn``), which checks the tensors, allocates the
gradients and counts launches. One call is up to five kernels on the
current stream: the rows' ``rowsum(dO * O)``; dK/dV per (32 keys, query
head, batch row, split), into a per-head workspace when the GQA group has
more than one head; the group's sum of that workspace in head and split
order; dQ per (32 query rows, query head, batch row, split); the splits'
sum of dQ where there are several. dQ and its sum run on a second stream
of the card, beside dK/dV (forked after delta, joined back before the call
returns). No float atomics, so two calls give the same bits. :func:`plan`
is the launch plan in numbers (instance, splits, grids, workspaces, shared
memory), computed as the C launcher computes it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import pad_den

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {"flash_attn_bwd_f32": [_P] * 15 + [_I] * 8 + [_F, _F] + [_I] * 3 + [_P] * 4}

INSTANCES = (32, 64, 128, 160, 256)  # padded head dims, one kernel pair each
COLS = 32  # columns of D per warp
FIX_ROWS = 32  # fixed rows per CTA: keys (dK/dV) or query rows (dQ)
TILE = 16  # streamed rows per tile
WINDOW = 512  # tiles one liveness pass covers
DELTA_THREADS = 128
REDUCE_THREADS = 256
MAX_REDUCE_BLOCKS = 65535
MAX_SPLITS = 4
SPLIT_CTAS_PER_SM = 2  # the dK/dV grid splits aim at this many CTAs an SM
H100_SMS = 132


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(dp: int) -> int:
    """Dynamic shared memory of one tile CTA of instance ``dp`` (the
    kernel's ``Cfg<DP>::kBytes``): the two-stage ring and the lo tile of 16
    padded rows of two matrices, each warp's score partials, each row
    group's split P and dS fragments, the no-key dv term, the stages'
    positions, lse and delta, the fixed positions, the live-tile list, its
    count and flags."""
    st, warps = dp + 4, 2 * dp // COLS
    slots = 4 * (TILE // 8)  # a lane's entries of a score fragment
    floats = (6 * TILE * st + warps * 2 * slots * 32 + 2 * 4 * slots * 32 + dp + 6 * TILE
              + FIX_ROWS + WINDOW + 4)
    return 4 * floats + WINDOW


@functools.lru_cache(maxsize=256)
def plan(b: int, sq: int, sk: int, hq: int, hkv: int, d: int, sms: int = H100_SMS) -> dict:
    """The launch plan of one call at q ``[b, sq, hq, d]``, k/v ``[b, sk,
    hkv, d]`` on a card of ``sms`` SMs: the instance ``dp`` (the smallest of
    :data:`INSTANCES` at or above ``d``), warps and threads of a tile CTA,
    ``splits`` (the CTAs that share one block of 32 fixed rows, each taking
    a slice of its live tiles: with a GQA group, as many as bring the dK/dV
    grid to :data:`SPLIT_CTAS_PER_SM` CTAs an SM, at most
    :data:`MAX_SPLITS`; with one query head per KV head, 1), each kernel's
    grid (``(x, y, z)``; a reduce grid is
    None where its workspace is), the workspaces' bytes (f32: per head and
    split dK and dV when ``hq > hkv``, per split dQ when ``splits > 1``) and
    a tile CTA's shared memory."""
    if d < 1 or d > INSTANCES[-1]:
        raise ValueError(f"flash_attn_bwd: head dim {d} outside 1..{INSTANCES[-1]}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attn_bwd: Hq {hq} is not a multiple of Hkv {hkv}")
    dp = next(x for x in INSTANCES if x >= d)
    warps = 2 * dp // COLS
    grouped = hq > hkv
    kv_ctas = _ceil(sk, FIX_ROWS) * hq * b
    splits = min(MAX_SPLITS, max(1, _ceil(SPLIT_CTAS_PER_SM * sms, kv_ctas))) if grouped else 1

    def red(n):
        return (min(_ceil(n, REDUCE_THREADS), MAX_REDUCE_BLOCKS), 1, 1)

    return {
        "dp": dp, "warps": warps, "threads": 32 * warps, "splits": splits,
        "delta_grid": (_ceil(b * sq * hq * 32, DELTA_THREADS), 1, 1),
        "dkv_grid": (_ceil(sk, FIX_ROWS) * splits, hq, b),
        "reduce_grid": red(b * sk * hkv * d) if grouped else None,
        "dq_grid": (_ceil(sq, FIX_ROWS) * splits, hq, b),
        "reduce_q_grid": red(b * sq * hq * d) if splits > 1 else None,
        "workspace_bytes": 4 * ((2 * splits * b * sk * hq * d if grouped else 0)
                                + (splits * b * sq * hq * d if splits > 1 else 0)),
        "smem_bytes": smem_bytes(dp),
    }


_SMS: dict[int, int] = {}
_SIDE: dict[int, tuple] = {}


def _sms(idx: int) -> int:
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _side(idx: int) -> tuple:
    """The raw handles of the card's second stream, on which dQ runs beside
    dK/dV, and of the two events that fork it from the caller's stream and
    join it back (recorded once here, so that they exist)."""
    if idx not in _SIDE:
        with torch.cuda.device(idx):
            side, fork, join = torch.cuda.Stream(), torch.cuda.Event(), torch.cuda.Event()
            fork.record(side)
            join.record(side)
            _SIDE[idx] = (side, fork, join,
                          (side.cuda_stream, fork.cuda_event, join.cuda_event))
    return _SIDE[idx][3]


def launch(q, k, v, out, dout, lse, qpos, kpos, dq, dk, dv, *, causal: bool,
           window: int) -> None:
    """One call: ``dq``, ``dk``, ``dv`` (f32, q's and k's shapes) from the
    forward's operands, its ``out`` and ``lse`` and the cotangent ``dout``."""
    lib = _build.load("flash_attn_bwd", _SIGNATURES)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    idx = q.device.index if q.device.index is not None else torch.cuda.current_device()
    p = plan(b, sq, sk, hq, hkv, d, _sms(idx))
    splits = p["splits"]
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    wk = wv = wq = None
    if hq > hkv:
        wk, wv = torch.empty((2, splits, b, sk, hq, d), dtype=torch.float32, device=q.device)
    if splits > 1:
        wq = torch.empty((splits, b, sq, hq, d), dtype=torch.float32, device=q.device)
    vec = int(d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (q, k, v, dout)))
    ptrs = [t.data_ptr() for t in (q, k, v, out, dout, lse, qpos, kpos, delta, dq, dk, dv)]
    ptrs += [None if w is None else w.data_ptr() for w in (wk, wv, wq)]
    # delta, then dK/dV on the caller's stream and dQ beside it on the
    # second one (the two share only inputs), joined back into the caller's
    # stream: whatever it runs next, the freeing of delta and the workspaces
    # included, comes after both.
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attn_bwd_f32(*ptrs, b, sq, sk, hq, hkv, d, int(causal), window,
                                 1.0 / d ** 0.5, pad_den(sk), p["dp"], vec, splits, stream,
                                 *_side(idx))
    _build.check(lib, err, "flash_attention_bwd")
