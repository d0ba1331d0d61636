"""Launchers of the CUDA CSR fan-in gather (``csrc/syn_gather.cu``).

Replaces the Pallas kernel ``repro/kernels/syn_gather.py:syn_gather``.
:func:`launch` is one checked call over one table (through
:func:`repro_torch.kernels.ops.syn_gather`, which checks the tensors,
allocates the output and counts launches). :class:`GatherPlan` is the
host plan of a run's sparse buckets, built once with numpy, and
:class:`GatherLauncher` its device copy: one ``GatherPlan`` structure per
launch, so that a tick's gathers are one ctypes call carrying the spike
row's pointer (through :class:`repro_torch.kernels.ops.GatherRun`), for
one lane or for B lanes in one launch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["INDEX_DTYPES", "WEIGHT_DTYPES", "launch", "Bucket", "GatherPlan",
           "GatherLauncher"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = [_P, _P, _P, _P, _I, _I, _I, _P]
_IDX = {torch.int16: "i16", torch.int32: "i32"}
_W = {torch.float32: "f32", torch.float16: "f16", torch.bfloat16: "bf16"}
_ITYPE = {torch.int16: 0, torch.int32: 1}
INDEX_DTYPES = tuple(_IDX)
WEIGHT_DTYPES = tuple(_W)
WARP = 32  # a zero-fill item writes up to one entry a lane


class RunPlan(ctypes.Structure):
    """``GatherPlan`` of ``csrc/syn_gather.cu``, field for field."""

    _fields_ = [("items", _P), ("contribs", _P), ("idx", _P), ("w", _P), ("rows", _P),
                ("stream", _P), ("n_items", _I), ("P", _I), ("F", _I), ("itype", _I),
                ("wtype", _I), ("accumulate", _I), ("staged", _I), ("absolute", _I),
                ("lanes", _I), ("w_stride", ctypes.c_longlong),
                ("rows_stride", ctypes.c_longlong)]


_SIGNATURES = {**{f"syn_gather_{i}_{w}": _SIGNATURE
                  for i in _IDX.values() for w in _W.values()},
               "syn_gather_run": [ctypes.POINTER(RunPlan), _P],
               "syn_gather_plan_size": []}


def _lib() -> ctypes.CDLL:
    return _build.load("syn_gather", _SIGNATURES)


def launch(spikes, idx, w, out) -> None:
    lib = _lib()
    (q, f), p = idx.shape, spikes.shape[0]
    stream = torch.cuda.current_stream(spikes.device).cuda_stream
    err = getattr(lib, f"syn_gather_{_IDX[idx.dtype]}_{_W[w.dtype]}")(
        spikes.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
        p, q, f, stream)
    _build.check(lib, err, "syn_gather")


class Bucket(NamedTuple):
    """One bucket of a propagation plan, as :class:`GatherPlan` reads it:
    its delay, its post columns ``posts`` ``[Q]`` (ids into the ``[N]``
    row), and for a sparse bucket ``table = (pre, idx, w)``: ``pre`` ``[P]``
    the global ids of its pre rows, ``idx`` ``[Q, F]`` int16/int32 indices
    into ``pre`` and ``w`` ``[Q, F]`` its weights (f32, fp16 or bf16), or
    ``[B, Q, F]``, one table per lane; a dense bucket's ``table`` is None.
    ``channel`` is its ring channel."""

    delay: int
    posts: np.ndarray
    table: tuple | None = None
    channel: int = 0


class GatherPlan:
    """The host plan of one run's CSR gathers over a spike row of ``n_pre``
    entries (``N`` when None; a partition core reads its import row, whose
    length is not its ``N``), into ``[N]`` accumulator rows of a ring of
    ``channels`` channels (1: CUBA, 2: COBA, where each bucket's drive
    lands as its absolute value, ``absolute``).

    ``buckets`` (:class:`Bucket`, the whole plan in plan order) are cut
    into launch groups. Group 0 launches before the plan's first bucket and
    writes every entry of ``rows`` ``[len(keys), N]``, one row per (delay,
    channel) key: each delay of a sparse bucket with each channel, row
    ``k·channels + c`` for ``delays[k]`` and channel ``c``, so that
    ``rows[k·C:(k+1)·C].T`` is delay k's ``[N, C]`` accumulator. Group g >
    0 launches where its first bucket stands and adds into the entries it
    covers. A sparse bucket joins the open
    group unless a dense bucket since that group's launch covers one of
    its (key, column) entries whose sum has three or more terms: moving
    a term across another reorders only sums of three or more (a + b is b
    + a in IEEE arithmetic, and +0.0 + x is x for every sum here), so
    every sum keeps the bits of the plan-order sum. Plans whose sparse
    buckets come first (every compiled plan) are one group.

    Per group, ``items[g]`` int32 ``[n, 3]``: ``(out, begin, end)``, the flat
    entry ``out`` of ``rows`` summing the contributions ``contribs[begin:
    end]`` in plan order; group 0 also has zero-fill items ``(out, -count,
    0)`` for the entries no bucket of it covers, ``count`` ≤ 32 entries
    from ``out`` on. ``contribs`` int32 ``[n, 2]``: ``(offset, F)``, a row of
    ``F`` entries at ``offset`` in ``idx`` (the buckets' rows composed
    through ``pre`` into global ids, int16 where N fits, else int32) and
    ``w`` (one dtype: the buckets', or f32 where they differ), concatenated
    in plan order: ``[E]``, or ``[B, E]`` where every table holds one set
    of weights per lane (``w_lanes`` is then B, else None). ``plain[g]``
    lists group g's buckets as :func:`repro_torch.kernels.ref.gather_run_ref`
    takes them. Raises on an index outside ``[0, P)``.
    """

    def __init__(self, n: int, buckets, channels: int = 1, n_pre: int | None = None):
        self.n, self.channels, self.absolute = n, channels, channels == 2
        self.n_pre = n if n_pre is None else n_pre
        buckets = list(buckets)
        if any(not 0 <= b.channel < channels for b in buckets):
            raise ValueError(f"syn_gather: bucket channels must lie in [0, {channels})")
        sparse = [i for i, b in enumerate(buckets) if b.table is not None]
        self.delays = tuple(sorted({buckets[i].delay for i in sparse}))
        self.keys = tuple((d, c) for d in self.delays for c in range(channels))
        row_of = {key: k for k, key in enumerate(self.keys)}
        terms = {key: np.zeros(n, np.int64) for key in self.keys}
        for b in buckets:
            if (b.delay, b.channel) in terms:
                np.add.at(terms[b.delay, b.channel], np.asarray(b.posts, np.int64), 1)
        groups, self.starts = [[]], [0]
        since = {key: np.zeros(n, bool) for key in self.keys}  # dense since the open launch
        for i, b in enumerate(buckets):
            posts = np.asarray(b.posts, np.int64)
            key = (b.delay, b.channel)
            if b.table is None:
                if key in since:
                    since[key][posts] = True
                continue
            if (since[key][posts] & (terms[key][posts] >= 3)).any():
                groups.append([])
                self.starts.append(i)
                since = {key: np.zeros(n, bool) for key in self.keys}
            groups[-1].append(i)
        if not sparse:
            groups, self.starts = [], []
        self.groups = tuple(tuple(g) for g in groups)

        tables = {i: buckets[i].table for i in sparse}
        leads = {tuple(t[2].shape[:-2]) for t in tables.values()}
        if len(leads) > 1 or any(len(lead) > 1 for lead in leads):
            raise ValueError("syn_gather: the tables' weights must all be [Q, F] or all "
                             "[B, Q, F] for one B")
        lead = leads.pop() if leads else ()
        self.w_lanes = lead[0] if lead else None
        wdts = {t[2].dtype for t in tables.values()}
        self.w_dtype = wdts.pop() if len(wdts) == 1 else torch.float32
        self.idx_dtype = (torch.int16 if self.n_pre <= np.iinfo(np.int16).max
                          else torch.int32)
        composed, ws, offsets, off = {}, [], {}, 0
        for i in sparse:
            pre, idx, w = tables[i]
            local = idx.cpu().numpy().astype(np.int64)
            if local.size and (local.min() < 0 or local.max() >= len(pre)):
                raise IndexError(f"syn_gather: bucket {i} has indices in "
                                 f"[{local.min()}, {local.max()}], outside [0, {len(pre)})")
            composed[i] = np.asarray(pre, np.int64)[local]
            ws.append(w.reshape(*lead, -1).to(self.w_dtype))
            offsets[i] = off
            off += local.size
        if off >= 2**31:
            raise ValueError(f"syn_gather: {off} table entries exceed int32 offsets")
        flat = [composed[i].reshape(-1) for i in sparse] or [np.zeros(0, np.int64)]
        self.idx = torch.from_numpy(np.concatenate(flat).astype(
            np.int16 if self.idx_dtype == torch.int16 else np.int32))
        self.w = torch.cat(ws, dim=-1) if ws else torch.zeros(0, dtype=self.w_dtype)
        self._tables_w = tuple(tables[i][2] for i in sparse)

        contribs, self.items, self.plain = [], [], []
        for g, members in enumerate(self.groups):
            keys, order = [], []
            plain = []
            for i in members:
                b = buckets[i]
                posts = np.asarray(b.posts, np.int64)
                q, f = tables[i][1].shape
                keys.append(row_of[b.delay, b.channel] * n + posts)
                order.append(np.stack([offsets[i] + np.arange(q, dtype=np.int64) * f,
                                       np.full(q, f, np.int64)], axis=1))
                plain.append((row_of[b.delay, b.channel], torch.from_numpy(posts),
                              torch.from_numpy(composed[i]), tables[i][2]))
            self.plain.append(tuple(plain))
            keys = np.concatenate(keys) if keys else np.zeros(0, np.int64)
            rows = np.concatenate(order) if order else np.zeros((0, 2), np.int64)
            perm = np.argsort(keys, kind="stable")  # plan order within an entry
            keys, rows = keys[perm], rows[perm]
            base = sum(len(c) for c in contribs)
            contribs.append(rows)
            cols, begin = np.unique(keys, return_index=True)
            end = np.append(begin[1:], keys.size)[:begin.size]
            items = np.stack([cols, base + begin, base + end], axis=1)
            if g == 0:
                items = np.concatenate([items, _zero_items(
                    np.setdiff1d(np.arange(len(self.keys) * n), cols))])
            self.items.append(torch.from_numpy(items.astype(np.int32)).reshape(-1, 3))
        self.contribs = torch.from_numpy(
            np.concatenate(contribs or [np.zeros((0, 2), np.int64)]).astype(np.int32))


    def set_lane(self, lane: int) -> None:
        """Re-read lane ``lane``'s entries of ``w`` from the ``[B, Q, F]``
        table weights the plan was built on, which the caller has rewritten
        in place."""
        if self.w_lanes is None:
            if self._tables_w:
                raise ValueError("syn_gather: the lanes share their tables")
            return
        self.w[lane].copy_(torch.cat([w[lane].reshape(-1).to(self.w_dtype)
                                      for w in self._tables_w]))


def _zero_items(flat: np.ndarray) -> np.ndarray:
    """Zero-fill items ``(out, -count, 0)`` over the sorted flat entries
    ``flat``: runs of consecutive entries cut every 32."""
    starts = np.flatnonzero(np.diff(flat, prepend=-2) != 1)  # each run's first position
    length = np.diff(np.append(starts, flat.size))
    run_start = np.repeat(starts, length)
    pos = np.arange(flat.size) - run_start
    first = pos % WARP == 0
    count = np.minimum(WARP, np.repeat(length, length) - pos)[first]
    out = np.zeros((int(first.sum()), 3), np.int64)
    out[:, 0], out[:, 1] = flat[first], -count
    return out


class GatherLauncher:
    """:class:`GatherPlan` ``plan`` on the card ``device``: its tables
    copied there, its ``rows`` buffer allocated, one ``RunPlan`` per group,
    launching on the stream current at construction. ``staged`` plans
    stage the whole spike row in shared memory in every CTA (for
    measurement; ``N`` f32 must fit the device's opt-in limit).

    Over ``lanes`` B (None: one lane), ``rows`` is ``[B, len(keys), N]``,
    a launch takes B spike rows ``[B, N]``, and the lanes share the plan's
    tables or each reads its own (``plan.w_lanes`` == B)."""

    def __init__(self, plan: GatherPlan, device, staged: bool = False,
                 lanes: int | None = None):
        lib = _lib()
        if lib.syn_gather_plan_size() != ctypes.sizeof(RunPlan):
            raise RuntimeError("syn_gather: the library's GatherPlan size differs "
                               "from the launcher's")
        self._lib, self._fn = lib, lib.syn_gather_run
        if plan.w_lanes is not None and plan.w_lanes != lanes:
            raise ValueError(f"syn_gather: {plan.w_lanes} lanes of weights for "
                             f"{lanes} lanes")
        self.rows = torch.zeros((*(() if lanes is None else (lanes,)), len(plan.keys),
                                 plan.n), dtype=torch.float32, device=device)
        self._keep = [plan.idx.to(device), plan.w.to(device), plan.contribs.to(device)]
        idx, w, contribs = self._keep
        self.w = w  # the plans point at it
        stream = torch.cuda.current_stream(device).cuda_stream
        self._plans = []
        for g, items in enumerate(plan.items):
            items = items.to(device)
            self._keep.append(items)
            rp = RunPlan(items=items.data_ptr(), contribs=contribs.data_ptr(),
                         idx=idx.data_ptr(), w=w.data_ptr(), rows=self.rows.data_ptr(),
                         stream=stream, n_items=items.shape[0], P=plan.n_pre, F=0,
                         itype=_ITYPE[plan.idx_dtype], wtype=_build.STORAGE_CODE[plan.w_dtype],
                         accumulate=int(g > 0), staged=int(staged),
                         absolute=int(plan.absolute), lanes=lanes or 1,
                         w_stride=0 if plan.w_lanes is None else w.shape[-1],
                         rows_stride=len(plan.keys) * plan.n)
            self._plans.append((ctypes.byref(rp), rp))
        self.items = tuple(rp.n_items for _, rp in self._plans)

    def __call__(self, g: int, spikes_ptr: int) -> None:
        """Launch group ``g`` on the f32 spike row at device pointer
        ``spikes_ptr`` (``plan.n_pre`` contiguous values; over lanes, B rows
        of them)."""
        err = self._fn(self._plans[g][0], spikes_ptr)
        if err:
            _build.check(self._lib, err, "syn_gather")
