"""One wrapper per kernel: checks, output allocation, dispatch, launch count.

A wrapper takes the kernel's plain PyTorch version (:mod:`.ref`) when its
tensors lie on the CPU, and launches the CUDA kernel when they lie on a
card; a kernel that fails to build or launch raises there, it never falls
back. :data:`LAUNCHES` counts, per kernel, the launches made; a CPU call
counts nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import izh_update as _izh
from repro_torch.kernels import ref
from repro_torch.kernels import syn_gather as _gather
from repro_torch.kernels import syn_matmul as _matmul

__all__ = ["LAUNCHES", "reset_launches", "izh4_update", "syn_matmul",
           "syn_gather"]

f32 = torch.float32

LAUNCHES: dict[str, int] = {"izh4_update": 0, "syn_matmul": 0, "syn_gather": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (all contiguous, on the current card), False
    for CPU tensors; raises on anything else. The kernels launch on the
    current card's context, so tensors on another card raise instead of
    launching there."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on different devices "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {dev} while cuda:"
                         f"{torch.cuda.current_device()} is current; call it "
                         f"under torch.cuda.device({dev.index})")
    return True


def izh4_update(v, u, i_syn, a, b, c, d, *, dt: float = 1.0, substeps: int = 2):
    """Fused IZH4 tick over flat ``[N]`` tensors: returns ``(v', u',
    spiked)`` with v', u' in v's storage dtype (fp16 or f32) and a bool
    spike row. ``i_syn``, ``a``, ``b``, ``c``, ``d`` are f32."""
    n = v.shape[0]
    tensors = (v, u, i_syn, a, b, c, d)
    if any(t.shape != (n,) for t in tensors):
        raise ValueError(f"izh4_update: every operand must be [{n}]")
    if v.dtype not in _izh.STORAGE_DTYPES or u.dtype != v.dtype:
        raise ValueError(f"izh4_update: v/u must share a storage dtype in "
                         f"{_izh.STORAGE_DTYPES}, got {v.dtype}/{u.dtype}")
    if any(t.dtype != f32 for t in tensors[2:]):
        raise ValueError("izh4_update: i_syn, a, b, c, d must be float32")
    if not _on_card("izh4_update", *tensors):
        return ref.izh4_ref(v, u, i_syn, a, b, c, d, dt=dt, substeps=substeps)
    v_out = torch.empty_like(v)
    u_out = torch.empty_like(u)
    spiked = torch.empty((n,), dtype=torch.bool, device=v.device)
    if n:
        _izh.launch(v, u, i_syn, a, b, c, d, v_out, u_out, spiked,
                    h=dt / substeps, substeps=substeps)
        LAUNCHES["izh4_update"] += 1
    return v_out, u_out, spiked


def syn_matmul(x, w):
    """``x [M, K] @ w [K, N] -> [M, N]`` f32, with x f32 and w in f32,
    fp16 or bf16 (decoded to f32 in the tile)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"syn_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != f32:
        raise ValueError(f"syn_matmul: x must be float32, got {x.dtype}")
    if w.dtype not in _matmul.WEIGHT_DTYPES:
        raise ValueError(f"syn_matmul: w dtype {w.dtype} not in "
                         f"{_matmul.WEIGHT_DTYPES}")
    if not _on_card("syn_matmul", x, w):
        return ref.syn_matmul_ref(x, w)
    out = torch.empty((x.shape[0], w.shape[1]), dtype=f32, device=x.device)
    if out.numel():
        _matmul.launch(x, w, out)
        LAUNCHES["syn_matmul"] += 1
    return out


def syn_gather(spikes, idx, w):
    """CSR fan-in drive ``out[q] = Σ_k spikes[idx[q, k]] * w[q, k]``:
    spikes ``[P]`` f32, idx ``[Q, F]`` int16/int32, w ``[Q, F]`` in f32,
    fp16 or bf16 → ``[Q]`` f32. Rows shorter than F are padded with
    index 0 and weight +0.0.

    Every index must lie in ``[0, P)``; ``NetworkBuilder.compile`` builds
    its tables so. A table that breaks this raises ``IndexError`` on the
    CPU, while on the card, where a check would cost a device-to-host
    sync, each offending entry makes its row's output NaN. The card takes
    ``P`` up to ``MAX_PRE`` (12,288) and raises above it."""
    if spikes.dim() != 1 or idx.dim() != 2 or w.shape != idx.shape:
        raise ValueError(f"syn_gather: shapes spikes {tuple(spikes.shape)}, "
                         f"idx {tuple(idx.shape)}, w {tuple(w.shape)}")
    if spikes.dtype != f32:
        raise ValueError(f"syn_gather: spikes must be float32, got {spikes.dtype}")
    if idx.dtype not in _gather.INDEX_DTYPES:
        raise ValueError(f"syn_gather: idx dtype {idx.dtype} not in "
                         f"{_gather.INDEX_DTYPES}")
    if w.dtype not in _gather.WEIGHT_DTYPES:
        raise ValueError(f"syn_gather: w dtype {w.dtype} not in "
                         f"{_gather.WEIGHT_DTYPES}")
    if not _on_card("syn_gather", spikes, idx, w):
        return ref.syn_gather_ref(spikes, idx, w)
    if spikes.shape[0] > _gather.MAX_PRE:
        raise ValueError(f"syn_gather: a spike row of {spikes.shape[0]} does not "
                         f"fit the kernel's shared memory (at most {_gather.MAX_PRE})")
    out = torch.empty((idx.shape[0],), dtype=f32, device=spikes.device)
    if out.numel():
        _gather.launch(spikes, idx, w, out)
        LAUNCHES["syn_gather"] += 1
    return out
