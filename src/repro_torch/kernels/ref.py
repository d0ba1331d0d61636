"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel computes, with PyTorch ops in
the reference's term order. The wrappers in :mod:`repro_torch.kernels.ops`
take these for tensors on the CPU; ``chip_smoke.py`` holds each kernel
against its plain version on the card. Nothing on the card's path calls
them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["izh4_ref", "neuron_run_ref", "neuron_lanes_ref", "coba_current_ref",
           "syn_matmul_ref", "syn_matmul_lanes_ref", "syn_gather_ref", "gather_run_ref",
           "gather_lanes_ref", "fused_tick_ref", "fused_tick_lanes_ref", "stdp_update_ref",
           "stdp_gather_ref", "stdp_gather_run_ref", "stdp_update_run_ref",
           "stdp_gather_lanes_ref", "stdp_update_lanes_ref", "xla_cpu_row_sum",
           "rate_fold_ref", "watch_fold_ref",
           "plastic_drive_ref", "drive_run_ref",
           "chunked_attention_ref", "flash_attention_ref", "pallas_no_key_rows",
           "model_layout"]

f32 = torch.float32
NEG_INF = -1e30  # the reference's mask value (not -inf)


def izh4_ref(v, u, i_syn, a, b, c, d, *, dt: float = 1.0, substeps: int = 2):
    """IZH4 update + spike + reset; f32 math, storage dtype preserved.

    Each Euler substep takes (dv, du) from the same pre-step (v, u), with
    the reference's term order
    ``0.04*v*v + 5.0*v + 140.0 - u + i_syn``, ``a*(b*v - u)``, ``v + h*dv``.
    Eager PyTorch rounds every operation on its own (no FMA contraction).
    """
    out_dtype = v.dtype
    v = v.to(f32)
    u = u.to(f32)
    i_syn = i_syn.to(f32)
    h = dt / substeps
    for _ in range(substeps):
        dv = 0.04 * v * v + 5.0 * v + 140.0 - u + i_syn
        du = a * (b * v - u)
        v = v + h * dv
        u = u + h * du
    spiked = v >= 30.0
    v = torch.where(spiked, c, v)
    u = torch.where(spiked, u + d, u)
    return v.to(out_dtype), u.to(out_dtype), spiked


def rate_fold_ref(level, spikes, alpha: float, inst: float) -> None:
    """One GroupRate monitor step, in place on the f32 filter level
    ``level`` ``[(B,) N]``: ``level + alpha * (spikes * inst - level)``
    with ``spikes`` bool or f32 0/1, four ops each rounded on its own
    (``alpha``, ``inst``: f32 values held as Python floats)."""
    d = spikes.to(f32) * inst
    d = d - level
    d = d * alpha
    level += d


def watch_fold_ref(step: int, spikes, v, *, w_count=None, w_silent=None, w_bad=None) -> None:
    """One tick of the in-run watches' kernel slots, in place, as
    ``common.cuh``'s ``watch_fold`` and ``watch_mark`` and the kernels'
    count add compute them: ``spikes`` ``[(B,) N]`` (bool, or f32 0/1) and
    the stored membrane ``v`` ``[(B,) N]`` (storage dtype) of the run's
    local step ``step``. ``w_count`` (int32 ``[(B,) N]``, a RateBand's
    counts) takes the spikes added. ``w_silent`` (int32 ``[(B,) 4]``, a
    Silent's ``{last, gap, flag0, flag1}``) and ``w_bad`` (a NonFinite's
    ``{ticks, 0, flag0, flag1}``, :func:`repro_torch.obs.watch.kernel_words`)
    first fold the previous step's flag (a spike there closes the silent run
    since ``last``, a closing step 0 adding none of it, and becomes ``last``;
    a non-finite membrane counts a tick) and clear it, then set this step's
    flag where any neuron spiked (any stored membrane is not finite)."""
    if spikes.dtype != torch.bool:
        spikes = spikes != 0
    if w_count is not None:
        w_count += spikes
    prev, here = 2 + ((step - 1) & 1), 2 + (step & 1)
    if w_silent is not None:
        if step > 0:
            flag = w_silent[..., prev] != 0
            last, gap = w_silent[..., 0], w_silent[..., 1]
            if step > 1:
                gap.copy_(torch.where(flag, torch.maximum(gap, step - 2 - last), gap))
            last.copy_(torch.where(flag, step - 1, last))
            w_silent[..., prev] = 0
        w_silent[..., here] = spikes.any(dim=-1).to(torch.int32)
    if w_bad is not None:
        if step > 0:
            w_bad[..., 0] += w_bad[..., prev]
            w_bad[..., prev] = 0
        w_bad[..., here] = (~torch.isfinite(v).all(dim=-1)).to(torch.int32)


def neuron_run_ref(v, u, refrac, ring, slot: int, is_gen, a, b, c, d, gen_cols, spikes, *,
                   gen_row=None, i_ext_row=None, raster_row=None, v_row=None, i_row=None,
                   counts=None, cond=None, coba=None, dt: float = 1.0,
                   substeps: int = 2, tel_count=None, tel_rate=None,
                   rate: tuple[float, float] = (0.0, 0.0), step: int = 0, w_count=None,
                   w_silent=None, w_bad=None) -> None:
    """One tick's neuron phase of an IZH4-only Euler net, in place, as
    ``engine._neuron_phase`` and ``backend.update_neurons_dispatch``
    compute it op by op: read ring slot ``slot`` (``ring`` ``[L, N, C]``,
    storage dtype) as f32 and zero it; the current ``i_syn``: channel 0
    for a CUBA ring (C = 1), else (C = 2, COBA) the conductances ``cond``
    (AMPA, NMDA, GABAa, GABAb, ``[N]`` storage dtype) decayed, delivered
    channel 0 (excitatory) and 1 (inhibitory) magnitudes and stored back,
    and the current (:func:`coba_current_ref`) from the stored values and
    the v from before the update, ``coba`` holding the coefficients
    (:class:`repro_torch.kernels.izh_update.CobaCoeffs`); add the tick's
    ``i_ext_row`` (f32) where given; the IZH4 update (:func:`izh4_ref`);
    the spike masked by ``is_gen`` and a running refractory countdown;
    ``v = c`` and ``u = +0.0`` on generators, in the storage dtype;
    ``refrac = max(refrac - 1, 0)`` (int16); then each generator column's
    spike from ``gen_row`` (``[n_gen]`` bool) through ``gen_cols``
    (``[N]`` int64, -1 for other neurons). Writes v, u, refrac, the f32
    spike row ``spikes`` and, where given, the bool ``raster_row``, the
    f32 ``v_row`` and ``i_row`` (``i_syn``), ``counts += spike`` (int32)
    and the in-run monitors' accumulators: ``tel_count += spike`` (a
    SpikeCount's int32) and :func:`rate_fold_ref` on ``tel_rate`` (a
    GroupRate's f32 level, ``rate`` its ``(alpha, inst)``), and the in-run
    watches' slots ``w_count``, ``w_silent``, ``w_bad`` at the local step
    ``step`` (:func:`watch_fold_ref`, on the stored v)."""
    if cond is None:
        i_syn = ring[slot, :, 0].to(f32, copy=True)
    else:
        exc = ring[slot, :, 0].to(f32, copy=True)
        inh = ring[slot, :, 1].to(f32, copy=True)
    ring[slot].zero_()
    if cond is not None:
        for g, decay, frac, x in zip(cond, coba.decay, coba.frac, (exc, exc, inh, inh)):
            g.copy_((g.to(f32) * decay + frac * x).to(g.dtype))
        i_syn = coba_current_ref(cond, v, coba)
    if i_ext_row is not None:
        i_syn = i_syn + i_ext_row
    v2, u2, spiked = izh4_ref(v, u, i_syn, a, b, c, d, dt=dt, substeps=substeps)
    spiked = spiked & ~is_gen & ~(refrac > 0)
    v.copy_(torch.where(is_gen, c, v2.to(f32)).to(v.dtype))
    u.copy_(torch.where(is_gen, 0.0, u2.to(f32)).to(u.dtype))
    refrac.copy_(torch.clamp_min(refrac - 1, 0))
    if gen_row is not None:
        spiked = torch.where(gen_cols >= 0, gen_row[gen_cols.clamp_min(0)], spiked)
    spikes.copy_(spiked.to(f32))
    if raster_row is not None:
        raster_row.copy_(spiked)
    if v_row is not None:
        v_row.copy_(v)
    if i_row is not None:
        i_row.copy_(i_syn)
    if counts is not None:
        counts += spiked
    if tel_count is not None:
        tel_count += spiked
    if tel_rate is not None:
        rate_fold_ref(tel_rate, spiked, *rate)
    watch_fold_ref(step, spiked, v, w_count=w_count, w_silent=w_silent, w_bad=w_bad)


def neuron_lanes_ref(v, u, refrac, ring, slots, is_gen, a, b, c, d, gen_cols, spikes, *,
                     gen_rows=None, raster_rows=None, v_rows=None, i_rows=None, cond=None,
                     counts=None, coba=None, dt: float = 1.0, substeps: int = 2,
                     tel_count=None, tel_rate=None,
                     rate: tuple[float, float] = (0.0, 0.0), step: int = 0, w_count=None,
                     w_silent=None, w_bad=None) -> None:
    """One tick of B lanes' neuron phase, in place: lane ``k`` is
    :func:`neuron_run_ref` on ``v[k]``, ``u[k]``, ``refrac[k]`` and
    ``spikes[k]`` (``[B, N]``), ``ring[k]`` (``[B, L, N, C]``) at ring slot
    ``slots[k]``, the conductances ``cond`` (four ``[B, N]``), the rows
    ``gen_rows`` ``[B, n_gen]``, ``raster_rows``, ``v_rows`` and ``i_rows``
    ``[B, N]``, the spike ``counts``, the monitors' ``tel_count`` and
    ``tel_rate`` ``[B, N]`` and the watches' ``w_count`` ``[B, N]``,
    ``w_silent`` and ``w_bad`` ``[B, 4]`` where given; the parameters are
    shared. A loop over the lanes."""
    for k, slot in enumerate(slots):
        def lane(x):
            return None if x is None else x[k]

        neuron_run_ref(v[k], u[k], refrac[k], ring[k], slot, is_gen, a, b, c, d, gen_cols,
                       spikes[k], gen_row=lane(gen_rows), raster_row=lane(raster_rows),
                       v_row=lane(v_rows), i_row=lane(i_rows), counts=lane(counts),
                       cond=None if cond is None else tuple(g[k] for g in cond), coba=coba,
                       dt=dt, substeps=substeps, tel_count=lane(tel_count),
                       tel_rate=lane(tel_rate), rate=rate, step=step,
                       w_count=lane(w_count), w_silent=lane(w_silent), w_bad=lane(w_bad))


def coba_current_ref(cond, v, coba):
    """The COBA current ``[N]`` f32 of ``core/conductance.coba_current``,
    from the conductances ``cond`` (AMPA, NMDA, GABAa, GABAb, storage
    dtype) and the membrane potential ``v``, with the reversal potentials
    of ``coba`` (:class:`repro_torch.kernels.izh_update.CobaCoeffs`); the
    division divides by a tensor, as IEEE division, on either device."""
    ga, gn, g_a, g_b = (g.to(f32) for g in cond)
    v = v.to(f32)
    nv = (v + 80.0) / torch.full((), 60.0, dtype=f32, device=v.device)
    gate = nv * nv / (1.0 + nv * nv)
    return -(ga * (v - coba.e_exc) + gn * gate * (v - coba.e_exc)
             + g_a * (v - coba.e_gabaa) + g_b * (v - coba.e_gabab))


def syn_matmul_ref(x, w):
    """x [M, K] @ w [K, N], storage-dtype weights decoded to f32 (softfp)."""
    return torch.matmul(x.to(f32), w.to(f32))


def syn_matmul_lanes_ref(x, w):
    """B lanes' products ``x [B, K] @ w`` with ``w`` ``[K, N]`` shared by
    the lanes or ``[B, K, N]``, one per lane → ``[B, N]`` f32: a loop over
    the lanes of :func:`syn_matmul_ref`."""
    return torch.stack([syn_matmul_ref(x[k:k + 1], w if w.dim() == 2 else w[k])[0]
                        for k in range(x.shape[0])])


def _take(row, idx):
    """``row[idx]`` as the reference's ``jnp.take`` reads it (``row`` f32
    ``[P]``, any ``idx`` shape): an index in ``[-P, -1]`` counts from the
    end of the row, any other index outside ``[0, P)`` reads NaN."""
    p = row.shape[0]
    ii = idx.to(torch.int64)
    ii = torch.where(ii < 0, ii + p, ii)
    ii = torch.where((ii >= 0) & (ii < p), ii, p)  # p: the NaN appended below
    return torch.cat((row.to(f32), row.new_full((1,), float("nan"), dtype=f32)))[ii]


def syn_gather_ref(spikes, idx, w):
    """CSR fan-in drive: ``out[q] = Σ_k spikes[idx[q, k]] * w[q, k]``.

    Padded entries carry weight +0.0, so they contribute an exact +0.0.
    Out-of-range indices follow the reference's ``jnp.take``: an index in
    ``[-P, -1]`` counts from the end of the row, and any other index
    outside ``[0, P)`` reads NaN, which makes its row's sum NaN.
    """
    return (_take(spikes, idx) * w.to(f32)).sum(dim=1)


def gather_run_ref(spikes, rows, buckets, *, first: bool, absolute: bool = False) -> None:
    """One launch of a :class:`repro_torch.kernels.ops.GatherRun`, in place
    on ``rows`` ``[K, N]`` f32 (one row per (delay, channel) key): zeroed
    first when ``first``, then each bucket ``(row, posts, idx, w)`` of
    ``buckets``, in plan order, adds its :func:`syn_gather_ref` drive on
    the ``[N]`` f32 spike row (``idx`` ``[Q, F]`` global ids), its absolute
    value when ``absolute`` (COBA), at the post columns ``posts`` ``[Q]``
    int64 of row ``row``."""
    if first:
        rows.zero_()
    for k, posts, idx, w in buckets:
        drive = syn_gather_ref(spikes, idx, w)
        rows[k].index_add_(0, posts, drive.abs() if absolute else drive)


def gather_lanes_ref(spikes, rows, buckets, *, first: bool, absolute: bool = False) -> None:
    """One launch of a :class:`repro_torch.kernels.ops.GatherRun` over B
    lanes, in place on ``rows`` ``[B, K, N]``: lane ``k`` is
    :func:`gather_run_ref` on the spike row ``spikes[k]`` (``[B, N]``) and
    ``rows[k]``, each bucket's weights shared (``[Q, F]``) or the lane's own
    (``[B, Q, F]``). A loop over the lanes."""
    for k in range(spikes.shape[0]):
        lane = tuple((r, posts, idx, w if w.dim() == 2 else w[k])
                     for r, posts, idx, w in buckets)
        gather_run_ref(spikes[k], rows[k], lane, first=first, absolute=absolute)


def fused_tick_ref(v, u, ring, gen_row, is_gen, a, b, c, d, t: int, *,
                   dense=(), csr=(), ring_len: int, dt: float = 1.0,
                   substeps: int = 2, tel_count=None, tel_rate=None,
                   rate: tuple[float, float] = (0.0, 0.0), step: int = 0, w_count=None,
                   w_silent=None, w_bad=None):
    """One whole tick on unpadded operands, as the reference's
    ``kernels/ref.py:fused_tick_ref``: ring slot read and zero, IZH4,
    generator override, propagation, one ring commit per distinct delay.

    ``ring`` ``[L, N]`` single-channel storage-dtype ring; ``gen_row`` and
    ``is_gen`` ``[N]`` bool; ``dense`` iterates ``(pre_start, post_start,
    delay_ms, W [P, Q])``, ``csr`` ``(post_start, delay_ms, idx [Q, F]
    global ids, w [Q, F])``. Drives land per delay in an f32 accumulator,
    dense buckets first, then CSR ones, each in its list's order. Returns
    ``(v', u', spikes, ring', i_syn)``; ``ring`` is left as it was. The
    in-run monitors' ``tel_count`` (int32 ``[N]``) and ``tel_rate`` (f32
    ``[N]``, ``rate`` its ``(alpha, inst)``), where given, take the tick's
    spikes in place, as :func:`neuron_run_ref` folds them, and so do the
    watches' slots ``w_count``, ``w_silent``, ``w_bad`` at the local step
    ``step`` (:func:`watch_fold_ref`, on the stored v').
    """
    n = v.shape[0]
    slot = t % ring_len
    i_syn = ring[slot].to(f32)
    ring = ring.clone()
    ring[slot].zero_()
    v1, u1, spiked = izh4_ref(v, u, i_syn, a, b, c, d, dt=dt, substeps=substeps)
    v2 = torch.where(is_gen, c, v1.to(f32)).to(v.dtype)
    u2 = torch.where(is_gen, 0.0, u1.to(f32)).to(u.dtype)
    spikes = torch.where(is_gen, gen_row, spiked)
    if tel_count is not None:
        tel_count += spikes
    if tel_rate is not None:
        rate_fold_ref(tel_rate, spikes, *rate)
    watch_fold_ref(step, spikes, v2, w_count=w_count, w_silent=w_silent, w_bad=w_bad)
    sf = spikes.to(f32)
    acc: dict[int, torch.Tensor] = {}

    def add(dly, qs, drive):
        a_ = acc.get(dly)
        if a_ is None:
            a_ = acc[dly] = torch.zeros((n,), dtype=f32, device=v.device)
        a_[qs:qs + drive.shape[0]] += drive

    for ps, qs, dly, w in dense:
        add(dly, qs, syn_matmul_ref(sf[None, ps:ps + w.shape[0]], w)[0])
    for qs, dly, idx, w in csr:
        add(dly, qs, syn_gather_ref(sf, idx, w))
    for dly in sorted(acc):
        ring[(t + dly) % ring_len] += acc[dly].to(ring.dtype)
    return v2, u2, spikes, ring, i_syn


def fused_tick_lanes_ref(v, u, ring, gen_rows, is_gen, a, b, c, d, ticks, *,
                         dense=(), csr=(), ring_len: int, dt: float = 1.0,
                         substeps: int = 2, tel_count=None, tel_rate=None,
                         rate: tuple[float, float] = (0.0, 0.0), step: int = 0,
                         w_count=None, w_silent=None, w_bad=None):
    """One tick of B lanes through the fused tick: lane ``k`` is
    :func:`fused_tick_ref` on ``v[k]``, ``u[k]`` ``[B, N]``, ``ring[k]``
    ``[B, L, N]`` and ``gen_rows[k]`` ``[B, N]`` at its tick ``ticks[k]``,
    each bucket's weights shared (``[P, Q]``/``[Q, F]``) or the lane's own
    (a leading ``[B]``), and the monitors' ``tel_count``/``tel_rate`` ``[B,
    N]`` and the watches' ``w_count`` ``[B, N]``, ``w_silent``/``w_bad``
    ``[B, 4]`` where given. Returns the five results stacked over the lanes.
    A loop over the lanes."""
    def lane(w, k):
        return w if w.dim() == 2 else w[k]

    def own(x, k):
        return None if x is None else x[k]

    outs = [fused_tick_ref(v[k], u[k], ring[k], gen_rows[k], is_gen, a, b, c, d, t,
                           dense=[(ps, qs, dl, lane(w, k)) for ps, qs, dl, w in dense],
                           csr=[(qs, dl, idx, lane(w, k)) for qs, dl, idx, w in csr],
                           ring_len=ring_len, dt=dt, substeps=substeps,
                           tel_count=own(tel_count, k), tel_rate=own(tel_rate, k),
                           rate=rate, step=step, w_count=own(w_count, k),
                           w_silent=own(w_silent, k), w_bad=own(w_bad, k))
            for k, t in enumerate(ticks)]
    return tuple(torch.stack(x) for x in zip(*outs))


def stdp_update_ref(w, mask, pre_trace, post_trace, pre_spikes, post_spikes, *,
                    a_plus: float, a_minus: float, w_min: float, w_max: float):
    """Dense pair-based STDP on ``w [P, Q]`` (storage dtype): ``w + a⁺·(pre_t
    ⊗ post_s) − a⁻·(pre_s ⊗ post_t)``, clipped to ``[w_min, w_max]``
    (``torch.clamp``, which keeps a NaN, as the reference's ``jnp.clip``
    does), +0.0 outside ``mask``, cast back to w's dtype."""
    wf = w.to(f32)
    ltp = a_plus * torch.outer(pre_trace.to(f32), post_spikes.to(f32))
    ltd = a_minus * torch.outer(pre_spikes.to(f32), post_trace.to(f32))
    wf = torch.clamp(wf + ltp - ltd, w_min, w_max)
    return torch.where(mask, wf, 0.0).to(w.dtype)


def stdp_gather_ref(w, idx, valid, pre_trace, post_trace, pre_spikes,
                    post_spikes, *, a_plus: float, a_minus: float,
                    w_min: float, w_max: float):
    """Pair-based STDP on CSR fan-in rows (``w``/``idx``/``valid`` [Q, F]):
    ``dw[q, k] = a⁺·(pre_t[idx[q, k]]·post_s[q]) −
    a⁻·(pre_s[idx[q, k]]·post_t[q])``, clipped, +0.0 where not ``valid``,
    cast back. Indices are read as the reference's ``jnp.take`` reads
    them: one in ``[-P, -1]`` counts from the end of the pre row, any other
    outside ``[0, P)`` reads NaN, so its cell is NaN where ``valid`` and
    +0.0 where not (``torch.clamp`` keeps a NaN)."""
    post_s = post_spikes.to(f32)[:, None]
    ltp = a_plus * (_take(pre_trace, idx) * post_s)
    ltd = a_minus * (_take(pre_spikes, idx) * post_trace.to(f32)[:, None])
    wf = torch.clamp(w.to(f32) + ltp - ltd, w_min, w_max)
    return torch.where(valid, wf, 0.0).to(w.dtype)


def _step_traces(spikes, p, parity: int):
    """Projection ``p``'s pre and post spikes (the slices of the ``[N]`` f32
    row ``spikes`` at ``pre_start``/``post_start``), and its traces stepped
    as ``core/plasticity._trace_step`` steps them (``trace * decay +
    spike``) from buffer ``parity`` into buffer ``1 - parity``, which are
    returned."""
    pre_sp = spikes[p.pre_start:p.pre_start + p.pre_tr[0].shape[0]]
    post_sp = spikes[p.post_start:p.post_start + p.post_tr[0].shape[0]]
    pre_t = p.pre_tr[1 - parity]
    post_t = p.post_tr[1 - parity]
    pre_t.copy_(p.pre_tr[parity] * p.decay_pre + pre_sp.to(f32))
    post_t.copy_(p.post_tr[parity] * p.decay_post + post_sp.to(f32))
    return pre_sp, post_sp, pre_t, post_t


def stdp_gather_run_ref(spikes, projs, parity: int) -> None:
    """One launch of a :class:`repro_torch.kernels.ops.StdpGatherRun`, in
    place: for each projection of ``projs``
    (:class:`repro_torch.kernels.stdp_gather.Projection`), in order, its
    traces step (:func:`_step_traces`) and its weights take
    :func:`stdp_gather_ref` on the stepped traces."""
    for p in projs:
        pre_sp, post_sp, pre_t, post_t = _step_traces(spikes, p, parity)
        p.w.copy_(stdp_gather_ref(p.w, p.idx, p.valid, pre_t, post_t, pre_sp, post_sp,
                                  a_plus=p.a_plus, a_minus=p.a_minus, w_min=p.w_min,
                                  w_max=p.w_max))


def stdp_update_run_ref(spikes, projs, parity: int) -> None:
    """One launch of a :class:`repro_torch.kernels.ops.StdpUpdateRun`, in
    place: for each projection of ``projs``
    (:class:`repro_torch.kernels.stdp_update.DenseProjection`), in order,
    its traces step (:func:`_step_traces`) and its weights take
    :func:`stdp_update_ref` on the stepped traces."""
    for p in projs:
        pre_sp, post_sp, pre_t, post_t = _step_traces(spikes, p, parity)
        p.w.copy_(stdp_update_ref(p.w, p.mask, pre_t, post_t, pre_sp, post_sp,
                                  a_plus=p.a_plus, a_minus=p.a_minus, w_min=p.w_min,
                                  w_max=p.w_max))


def _lane_proj(p, k):
    """Lane ``k`` of a run projection over lanes (weights ``[B, ...]``,
    trace pairs ``[B, P]`` and ``[B, Q]``): views, so that the one-lane
    plain version updates the lane in place."""
    return p._replace(w=p.w[k], pre_tr=tuple(t[k] for t in p.pre_tr),
                      post_tr=tuple(t[k] for t in p.post_tr))


def stdp_gather_lanes_ref(spikes, projs, parity: int) -> None:
    """One launch of an :class:`repro_torch.kernels.ops.StdpGatherRun` over
    B lanes, in place: lane ``k`` is :func:`stdp_gather_run_ref` on the
    spike row ``spikes[k]`` (``[B, N]``) and every projection's lane ``k``
    (weights ``[B, Q, F]``, traces ``[B, P]``/``[B, Q]``; ``idx`` and
    ``valid`` shared). A loop over the lanes."""
    for k in range(spikes.shape[0]):
        stdp_gather_run_ref(spikes[k], [_lane_proj(p, k) for p in projs], parity)


def stdp_update_lanes_ref(spikes, projs, parity: int) -> None:
    """One launch of an :class:`repro_torch.kernels.ops.StdpUpdateRun` over
    B lanes, in place: lane ``k`` is :func:`stdp_update_run_ref` on the
    spike row ``spikes[k]`` (``[B, N]``) and every projection's lane ``k``
    (weights ``[B, P, Q]``, traces ``[B, P]``/``[B, Q]``; the mask shared).
    A loop over the lanes."""
    for k in range(spikes.shape[0]):
        stdp_update_run_ref(spikes[k], [_lane_proj(p, k) for p in projs], parity)


XLA_REDUCE_WINDOW = 32  # XLA CPU's tree reduction rewriter's window


def xla_cpu_row_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(dim=-1)`` for an f32 ``[..., F]`` ``x``, in the order the
    reference's compiled reduce takes on the CPU. XLA CPU's tree reduction
    rewriter cuts a reduced dimension longer than 32 into windows of 32,
    the row padded with ``pad // 2`` skipped slots in front (``pad = -F mod
    32``) and the rest behind; each window sums its elements left to right
    from +0.0, and the window sums are reduced the same way, until 32 or
    fewer remain, which sum left to right from +0.0. Padding adds +0.0 to
    a partial sum that cannot be -0.0, so it is added here instead of
    skipped. One add per window slot, whatever F: a few dozen ops. Leading
    dimensions (rows, lanes) are independent, each summed so."""
    while x.shape[-1] > XLA_REDUCE_WINDOW:
        f = x.shape[-1]
        n = -(-f // XLA_REDUCE_WINDOW)
        pad = n * XLA_REDUCE_WINDOW - f
        x = F.pad(x, (pad // 2, pad - pad // 2)).reshape(*x.shape[:-1], n, XLA_REDUCE_WINDOW)
        x = _sum_left_to_right(x)
    return _sum_left_to_right(x)


def _sum_left_to_right(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over its last dimension left to right from +0.0."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def plastic_drive_ref(w, pre, rows, pre_row, sentinel: int = -1):
    """One plastic or STP projection's fan-in drive ``[(B,) Q] = Σ_k
    pre_row[pre[q, k]] · w_row[q, k]`` (f32), as the reference's XLA
    gather, product and row reduce give it on the CPU (sum order
    :func:`xla_cpu_row_sum`). ``pre_row`` ``[(B,) M]`` f32 (the spike row
    with a zero appended, or an STP projection's scaled pre row); ``pre``
    ``[Q, F]`` int64 ids into it. ``rows`` None: ``w`` is the CSR fan-in
    weights ``[(B,) Q, F]``; else ``rows`` ``[Q, F]`` int64 flat ids into a
    dense ``[P, Q]`` weight whose id ``sentinel`` (``P·Q``) reads +0.0, and
    ``w`` is that weight ``[(B,) P, Q]`` or its zero-ended ``[(B,) P·Q +
    1]`` buffer."""
    g = pre_row[..., pre]
    if rows is None:
        wr = w.to(f32)
    else:
        flat = w.reshape(*pre_row.shape[:-1], -1)
        if flat.shape[-1] == sentinel:
            flat = torch.cat((flat, flat.new_zeros((*flat.shape[:-1], 1))), dim=-1)
        wr = flat[..., rows].to(f32)
    return xla_cpu_row_sum(g * wr)


def drive_run_ref(spikes, projs, weights, stp, *, coba: bool = False) -> None:
    """One launch of an :class:`repro_torch.kernels.ops.DriveRun`, in place
    on the projections' accumulator entries: for each projection of
    ``projs`` (:class:`repro_torch.kernels.plastic_drive.DriveProjection`),
    in order, its :func:`plastic_drive_ref` drive on the spike rows
    ``spikes`` ``[(B,) N]`` f32 (with a zero appended; an STP projection's
    pre group scaled by ``u · x`` from ``stp``) and its weights from
    ``weights`` is added into ``out``, its absolute value when ``coba``."""
    ext = F.pad(spikes, (0, 1))
    for p, w, s in zip(projs, weights, stp):
        pre_row = ext
        if p.stp:
            pre_row = spikes[..., p.pre_start:p.pre_start + p.n_pre] * (s[0] * s[1])
        d = plastic_drive_ref(w, p.pre, p.rows, pre_row, p.sentinel)
        p.out.add_(d.abs() if coba else d)


def chunked_attention_ref(q, k, v, qpos, kpos, *, causal: bool = True,
                          window: int = -1, block_k: int = 1024):
    """Online-softmax GQA attention blocked over KV, step for step as the
    reference's ``models/attention.py:chunked_attention``.

    q ``[B, Sq, Hq, D]`` f32; k, v ``[B, Sk, Hkv, D]`` (f32, fp16 or bf16,
    decoded to f32); qpos int32 ``[B, Sq]`` and kpos int32 ``[Sk]``
    absolute positions, ``kpos < 0`` an invalid slot. Query head ``h``
    reads KV head ``h // (Hq // Hkv)``. A key is allowed iff it is valid,
    ``kpos <= qpos`` when ``causal`` and ``kpos > qpos - window`` when
    ``window > 0``. Scores are masked with -1e30, ``p = exp(s - m)`` is
    taken over every key and the sum divided by ``where(l > 0, l, 1)``, as
    in the reference. A masked key's ``p`` is an exact 0 once the row has
    seen an allowed key; a row with no allowed key keeps ``m = -1e30``,
    so every key, padding included, gets ``p = 1`` and the row is
    ``Σ_{j<Sk} v_j / (Sk + pad)`` with ``pad = -Sk mod min(block_k, Sk)``,
    the reference's value, which the CUDA kernel gives too. Returns
    ``[B, Sq, Hq, D]`` f32.
    """
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    if sk == 0:
        return torch.zeros((b, sq, hq, d), dtype=f32, device=q.device)
    scale = 1.0 / (d ** 0.5)
    bk = min(block_k, sk)
    pad = -sk % bk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = torch.nn.functional.pad(kpos, (0, pad), value=-1)
    nblk = (sk + pad) // bk
    qf = (q.to(f32) * scale).reshape(b, sq, hkv, g, d)
    kb = k.reshape(b, nblk, bk, hkv, d)
    vb = v.reshape(b, nblk, bk, hkv, d)
    pb = kpos.reshape(nblk, bk)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=f32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=f32, device=q.device)
    for i in range(nblk):
        kc, vc, pc = kb[:, i], vb[:, i], pb[i]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc.to(f32))
        mask = (pc >= 0)[None, None, :].expand(b, sq, bk)
        if causal:
            mask = mask & (pc[None, None, :] <= qpos[:, :, None])
        if window > 0:
            mask = mask & (pc[None, None, :] > qpos[:, :, None] - window)
        mask = mask[:, None, None]  # [b, 1, 1, q, k]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vc.to(f32))
        m = m_new
    out = acc / torch.where(l > 0, l, 1.0)[..., None]
    return out.reshape(b, hkv * g, sq, d).transpose(1, 2).contiguous()


def model_layout(q, k, v):
    """The Pallas kernel's operands (q ``[B, Hq, Sq, D]``, k/v ``[B, Hkv,
    Sk, D]``) in the model's layout: ``(q f32 [B, Sq, Hq, D], k, v [B, Sk,
    Hkv, D], qpos, kpos)``, contiguous, with the queries aligned to the end
    of KV as the Pallas kernel aligns them: ``qpos = arange(Sq) + (Sk - Sq)``
    for every batch row, ``kpos = arange(Sk)``."""
    b, _, sq, _ = q.shape
    sk = k.shape[2]
    dev = q.device
    qpos = (torch.arange(sq, dtype=torch.int32, device=dev) + (sk - sq)).expand(b, sq)
    return (q.to(f32).transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), qpos.contiguous(),
            torch.arange(sk, dtype=torch.int32, device=dev))


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = -1):
    """The Pallas kernel's signature (``repro/kernels/flash_attn.py``): q
    ``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Sk, D]`` in a storage dtype, queries
    aligned to the end of KV; :func:`chunked_attention_ref` on
    :func:`model_layout`'s operands, with the Pallas kernel's value on rows
    that see no key (:func:`pallas_no_key_rows`). Returns ``[B, Hq, Sq,
    D]`` in q's dtype."""
    out = chunked_attention_ref(*model_layout(q, k, v), causal=causal, window=window)
    out = out.transpose(1, 2)
    pallas_no_key_rows(out, v, causal=causal)
    return out.to(q.dtype)


PALLAS_BLOCK_K = 128  # the Pallas kernel's default block_k


def pallas_no_key_rows(out, v, *, causal: bool) -> None:
    """The Pallas kernel's value on the rows that see no key, in place on
    ``out`` ``[B, Hq, Sq, D]`` f32 (v ``[B, Hkv, Sk, D]``, queries aligned
    to the end of KV). Only a causal call with ``Sq > Sk > 0`` has such
    rows: the first ``Sq - Sk`` queries. There the kernel keeps m = -1e30
    over every slot of its padded KV, so every slot gets p = 1 and the row
    is ``Σ_{j<Sk} v_j / ceil_to(Sk, 128)`` (padding slots hold v = 0; a
    sliding window removes no key from the other rows)."""
    _, hq, sq, _ = out.shape
    _, hkv, sk, _ = v.shape
    if not causal or sq <= sk or sk == 0:
        return
    den = torch.full((), float(-(-sk // PALLAS_BLOCK_K) * PALLAS_BLOCK_K), dtype=f32,
                     device=out.device)
    mean = v.to(f32).sum(dim=2) / den  # [B, Hkv, D]
    out[:, :, :sq - sk] = mean.repeat_interleave(hq // hkv, dim=1)[:, :, None]
