"""One wrapper per kernel: checks, output allocation, dispatch, launch count.

A wrapper takes the kernel's plain PyTorch version (:mod:`.ref`) when its
tensors lie on the CPU, and launches the CUDA kernel when they lie on a
card; a kernel that fails to build or launch raises there, it never falls
back. :data:`LAUNCHES` counts, per kernel, the launches made; a CPU call
counts nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attn as _flash
from repro_torch.kernels import fused_tick as _fused
from repro_torch.kernels import izh_update as _izh
from repro_torch.kernels import ref
from repro_torch.kernels import stdp_gather as _stdp_gather
from repro_torch.kernels import stdp_update as _stdp_update
from repro_torch.kernels import syn_gather as _gather
from repro_torch.kernels import syn_matmul as _matmul

__all__ = ["LAUNCHES", "reset_launches", "izh4_update", "syn_matmul",
           "syn_gather", "FusedTickRun", "stdp_update", "stdp_gather", "attention",
           "flash_attention"]

f32 = torch.float32

LAUNCHES: dict[str, int] = {"izh4_update": 0, "syn_matmul": 0, "syn_gather": 0,
                            "fused_tick": 0, "stdp_update": 0, "stdp_gather": 0,
                            "flash_attention": 0}


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


def _check_stdp_vectors(name: str, n_pre: int, n_post: int, pre_trace, post_trace,
                        pre_spikes, post_spikes) -> None:
    if any(t.shape != (n_pre,) for t in (pre_trace, pre_spikes)) or any(
            t.shape != (n_post,) for t in (post_trace, post_spikes)):
        raise ValueError(f"{name}: pre_trace/pre_spikes must be [{n_pre}] and "
                         f"post_trace/post_spikes [{n_post}]")
    if any(t.dtype != f32 for t in (pre_trace, post_trace, pre_spikes, post_spikes)):
        raise ValueError(f"{name}: traces and spikes must be float32")


def stdp_update(w, mask, pre_trace, post_trace, pre_spikes, post_spikes, *,
                a_plus: float, a_minus: float, w_min: float, w_max: float):
    """Dense pair-based STDP: ``w [P, Q]`` (fp16 or f32 storage) and its
    bool ``mask`` → the updated weights in w's dtype
    (:func:`repro_torch.kernels.ref.stdp_update_ref`); traces and spikes
    ``[P]``/``[Q]`` f32, spikes as 0.0/1.0."""
    if w.dim() != 2 or mask.shape != w.shape or mask.dtype != torch.bool:
        raise ValueError(f"stdp_update: w {tuple(w.shape)} must be [P, Q] with a "
                         f"bool mask of its shape, got {mask.dtype} {tuple(mask.shape)}")
    if w.dtype not in _stdp_update.STORAGE_DTYPES:
        raise ValueError(f"stdp_update: w dtype {w.dtype} not in "
                         f"{_stdp_update.STORAGE_DTYPES}")
    _check_stdp_vectors("stdp_update", *w.shape, pre_trace, post_trace, pre_spikes,
                        post_spikes)
    kw = dict(a_plus=a_plus, a_minus=a_minus, w_min=w_min, w_max=w_max)
    if not _on_card("stdp_update", w, mask, pre_trace, post_trace, pre_spikes,
                    post_spikes):
        return ref.stdp_update_ref(w, mask, pre_trace, post_trace, pre_spikes,
                                   post_spikes, **kw)
    out = torch.empty_like(w)
    if out.numel():
        _stdp_update.launch(w, mask, pre_trace, post_trace, pre_spikes, post_spikes,
                            out, **kw)
        LAUNCHES["stdp_update"] += 1
    return out


def stdp_gather(w, idx, valid, pre_trace, post_trace, pre_spikes, post_spikes, *,
                a_plus: float, a_minus: float, w_min: float, w_max: float):
    """Pair-based STDP on CSR fan-in rows: ``w``, ``idx`` (int16/int32) and
    ``valid`` (bool) ``[Q, F]`` → the updated rows in w's dtype
    (:func:`repro_torch.kernels.ref.stdp_gather_ref`); pre traces and
    spikes ``[P]``, post ones ``[Q]``, f32.

    Every index must lie in ``[0, P)``: an index outside raises
    ``IndexError`` on the CPU and writes NaN into its cell on the card,
    where a check would cost a device-to-host sync."""
    if w.dim() != 2 or idx.shape != w.shape or valid.shape != w.shape:
        raise ValueError(f"stdp_gather: w {tuple(w.shape)}, idx {tuple(idx.shape)} "
                         f"and valid {tuple(valid.shape)} must share one [Q, F] shape")
    if w.dtype not in _stdp_gather.STORAGE_DTYPES:
        raise ValueError(f"stdp_gather: w dtype {w.dtype} not in "
                         f"{_stdp_gather.STORAGE_DTYPES}")
    if idx.dtype not in _stdp_gather.INDEX_DTYPES or valid.dtype != torch.bool:
        raise ValueError(f"stdp_gather: idx must be int16/int32 and valid bool, got "
                         f"{idx.dtype}/{valid.dtype}")
    _check_stdp_vectors("stdp_gather", pre_trace.shape[0], w.shape[0], pre_trace,
                        post_trace, pre_spikes, post_spikes)
    kw = dict(a_plus=a_plus, a_minus=a_minus, w_min=w_min, w_max=w_max)
    if not _on_card("stdp_gather", w, idx, valid, pre_trace, post_trace, pre_spikes,
                    post_spikes):
        return ref.stdp_gather_ref(w, idx, valid, pre_trace, post_trace, pre_spikes,
                                   post_spikes, **kw)
    out = torch.empty_like(w)
    if out.numel():
        _stdp_gather.launch(w, idx, valid, pre_trace, post_trace, pre_spikes,
                            post_spikes, out, **kw)
        LAUNCHES["stdp_gather"] += 1
    return out


class FusedTickRun:
    """A run's ticks through the fused tick
    (:func:`repro_torch.kernels.ref.fused_tick_ref`), in place on the run's
    own buffers: ``v``, ``u`` ``[N]`` and ``ring`` ``[L, N]``, in one
    storage dtype, advance tick by tick; ``rows`` ``[T, N]`` bool holds each
    tick's generator spikes on entry (read where ``is_gen``, ``[N]`` bool)
    and its spike row on exit; ``v_rows`` and ``i_rows`` ``[T, N]`` f32,
    where given, record v' and i_syn. ``a``..``d`` are ``[N]`` f32 and
    ``payload`` comes from :func:`repro_torch.kernels.fused_tick.assemble_kernel`.

    On the card the tensors are checked and the kernel's plan is built
    once, and :meth:`tick` is one launch; on the CPU :meth:`tick` runs the
    plain version. On the card N is at most ``fused_tick.MAX_N``."""

    def __init__(self, payload: _fused.KernelPayload, v, u, ring, is_gen, a, b,
                 c, d, rows, v_rows=None, i_rows=None, *, dt: float = 1.0,
                 substeps: int = 2):
        n = v.shape[0]
        if v.dim() != 1 or ring.dim() != 2 or ring.shape[1] != n:
            raise ValueError(f"fused_tick: v {tuple(v.shape)} and ring "
                             f"{tuple(ring.shape)} must be [N] and [L, N]")
        if any(x.shape != (n,) for x in (u, is_gen, a, b, c, d)):
            raise ValueError(f"fused_tick: u, is_gen, a, b, c, d must be [{n}]")
        if (v.dtype not in _fused.STORAGE_DTYPES or u.dtype != v.dtype
                or ring.dtype != v.dtype):
            raise ValueError(f"fused_tick: v/u/ring must share a storage dtype in "
                             f"{_fused.STORAGE_DTYPES}, got {v.dtype}/{u.dtype}/"
                             f"{ring.dtype}")
        if is_gen.dtype != torch.bool or any(x.dtype != f32 for x in (a, b, c, d)):
            raise ValueError("fused_tick: is_gen must be bool and a, b, c, d float32")
        recs = [x for x in (v_rows, i_rows) if x is not None]
        if rows.dim() != 2 or rows.shape[1] != n or rows.dtype != torch.bool:
            raise ValueError(f"fused_tick: rows must be [T, {n}] bool")
        if any(x.shape != rows.shape or x.dtype != f32 for x in recs):
            raise ValueError(f"fused_tick: v_rows/i_rows must be float32 {tuple(rows.shape)}")
        self._card = _on_card("fused_tick", v, u, ring, is_gen, a, b, c, d, rows,
                              payload.desc, payload.wd, payload.wc, payload.ic, *recs)
        self._args = (payload, v, u, ring, is_gen, a, b, c, d, rows, v_rows, i_rows)
        self._dt, self._substeps = dt, substeps
        if self._card and n:
            self._launch = _fused.TickLauncher(payload, v, u, ring, is_gen, a, b,
                                               c, d, dt=dt, substeps=substeps)
            self._rows = (rows.data_ptr(), n)
            self._v_rows = 0 if v_rows is None else v_rows.data_ptr()
            self._i_rows = 0 if i_rows is None else i_rows.data_ptr()
            self._row_bytes = n * 4
        else:
            self._launch = None

    def tick(self, i: int, t: int) -> None:
        """Tick ``t`` of the run, its ``i``-th: reads and writes row ``i``."""
        if self._launch is not None:
            rows, n = self._rows
            row = rows + i * n
            self._launch(t, row, row,
                         self._v_rows and self._v_rows + i * self._row_bytes,
                         self._i_rows and self._i_rows + i * self._row_bytes)
            LAUNCHES["fused_tick"] += 1
            return
        if self._card:  # N = 0: nothing to compute
            return
        payload, v, u, ring, is_gen, a, b, c, d, rows, v_rows, i_rows = self._args
        v2, u2, spikes, ring2, i_syn = ref.fused_tick_ref(
            v, u, ring, rows[i], is_gen, a, b, c, d, t, dense=payload.dense,
            csr=payload.csr, ring_len=ring.shape[0], dt=self._dt,
            substeps=self._substeps)
        v.copy_(v2)
        u.copy_(u2)
        ring.copy_(ring2)
        rows[i] = spikes
        if v_rows is not None:
            v_rows[i] = v2
        if i_rows is not None:
            i_rows[i] = i_syn


def attention(q, k, v, qpos, kpos, *, causal: bool = True, window: int = -1):
    """GQA online-softmax attention in the model's layout
    (:func:`repro_torch.kernels.ref.chunked_attention_ref`): q ``[B, Sq,
    Hq, D]`` f32, k/v ``[B, Sk, Hkv, D]`` in f32, fp16 or bf16 with ``Hq %
    Hkv == 0``, qpos int32 ``[B, Sq]``, kpos int32 ``[Sk]`` (``< 0`` marks
    an invalid slot) → ``[B, Sq, Hq, D]`` f32. A row with no allowed key
    is 0. The card takes D up to ``MAX_HEAD_DIM`` (256) and raises above."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention: q {tuple(q.shape)} must be [B, Sq, Hq, D] and "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} one [B, Sk, Hkv, D]")
    b, sq, hq, d = q.shape
    _, sk, hkv, dk = k.shape
    if k.shape[0] != b or dk != d or hkv < 1 or hq % hkv:
        raise ValueError(f"attention: q {tuple(q.shape)} and k {tuple(k.shape)} need one "
                         "batch and head dim, and Hq a multiple of Hkv")
    if qpos.shape != (b, sq) or kpos.shape != (sk,):
        raise ValueError(f"attention: qpos {tuple(qpos.shape)} must be [{b}, {sq}] and "
                         f"kpos {tuple(kpos.shape)} [{sk}]")
    if q.dtype != f32 or k.dtype not in _flash.KV_DTYPES or v.dtype != k.dtype:
        raise ValueError(f"attention: q must be float32 and k/v share a dtype in "
                         f"{_flash.KV_DTYPES}, got {q.dtype}/{k.dtype}/{v.dtype}")
    if qpos.dtype != torch.int32 or kpos.dtype != torch.int32:
        raise ValueError("attention: qpos and kpos must be int32")
    if not _on_card("flash_attention", q, k, v, qpos, kpos):
        return ref.chunked_attention_ref(q, k, v, qpos, kpos, causal=causal, window=window)
    if d > _flash.MAX_HEAD_DIM:
        raise ValueError(f"attention: head dim {d} above the kernel's limit "
                         f"{_flash.MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    if out.numel():
        _flash.launch(q, k, v, qpos, kpos, out, causal=causal, window=window)
        LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = -1):
    """The Pallas kernel's signature (``repro/kernels/flash_attn.py``): q
    ``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Sk, D]``, queries aligned to the end
    of KV → ``[B, Hq, Sq, D]`` in q's dtype; one :func:`attention` call on
    :func:`repro_torch.kernels.ref.model_layout`'s operands."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "must be [B, H, S, D]")
    out = attention(*ref.model_layout(q, k, v), causal=causal, window=window)
    return out.transpose(1, 2).to(q.dtype)
