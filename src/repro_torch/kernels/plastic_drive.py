"""Launcher of the CUDA plastic fan-in drive (``csrc/plastic_drive.cu``).

The port's own kernel: the reference computes this drive in XLA, not in a
Pallas kernel. :class:`DriveProjection` is one plastic or STP projection's
drive tables and the accumulator entries its drive lands in;
:class:`DriveLauncher` lays a run's projections out on the card once (the
descriptors, and one entry per accumulator column listing the (projection,
row) pairs that land there in projection order), so that a tick's drive of
every projection and every lane is one ctypes call carrying the spike
rows' pointer and the tick's weights (through
:class:`repro_torch.kernels.ops.DriveRun`).

The kernel runs one warp per accumulator entry and group of lanes: its
threads load a window of 32 fan-in entries at once, stage the products in
shared memory, sum up to 32 windows (of one lane's row or of several
lanes' rows) side by side and reduce each row's window sums over the
warp, every add in XLA CPU's order (:func:`xla_levels` gives the offsets
of each window level). See the source's note for what bounds it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["DriveProjection", "DriveLauncher", "MAX_PROJS", "xla_levels", "WINDOW",
           "kernel_resources"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
MAX_PROJS = 32
_MAX_LEVELS = 7
WINDOW = 32  # XLA CPU's tree reduction rewriter's window


class DriveProjection(NamedTuple):
    """One plastic or STP projection's fan-in drive ``drive[q] = Σ_k
    pre_row[pre[q, k]] · w_row[q, k]``: ``pre`` ``[Q, F]`` int ids into the
    tick's spike row (global ids, ``N`` the sentinel reading +0.0) or, for
    an STP projection (``stp``), local ids into its pre group
    ``[pre_start, pre_start + n_pre)`` scaled by ``u · x``; ``rows`` ``[Q,
    F]`` flat ids into a dense-stored ``[P, Q]`` weight, whose id
    ``sentinel`` (``P·Q``) reads +0.0, None for CSR-stored ``[Q, F]``
    weights; ``w_dtype`` the weights' storage dtype and ``stp_dtype`` the
    STP state's; ``out`` the f32 accumulator entries ``[(B,) Q]`` (a view,
    any column stride) the drive is added into."""

    pre: torch.Tensor
    rows: torch.Tensor | None
    out: torch.Tensor
    w_dtype: torch.dtype
    sentinel: int = -1
    stp: bool = False
    pre_start: int = 0
    n_pre: int = 0
    stp_dtype: torch.dtype = torch.float32


def xla_levels(f: int) -> list[int]:
    """Per window level of XLA CPU's row reduce over ``f`` entries, the
    skipped slots in front of its first window (``pad // 2``, ``pad = -n mod
    32`` for the level's ``n`` items); empty for ``f <= 32``."""
    offs = []
    while f > WINDOW:
        n = -(-f // WINDOW)
        offs.append((n * WINDOW - f) // 2)
        f = n
    return offs


class _Proj(ctypes.Structure):
    """``DriveProj`` of ``csrc/plastic_drive.cu``, field for field."""

    _fields_ = [("pre", _P), ("rows", _P)] + [(name, _I) for name in (
        "Q", "F", "stp", "pre_start", "n_pre", "wtype", "stype", "sentinel", "levels")] + [
        ("off", _I * _MAX_LEVELS)]


class _Target(ctypes.Structure):
    _fields_ = [("dst", _P), ("lane_stride", _L), ("begin", _I), ("end", _I)]


class _Plan(ctypes.Structure):
    _fields_ = [("projs", _P), ("targets", _P), ("entries", _P), ("stream", _P)] + [
        (name, _I) for name in ("n_targets", "n_projs", "lanes", "n", "coba", "group")]


class _Tick(ctypes.Structure):
    _fields_ = [("w", _P * MAX_PROJS), ("w_lane", _L * MAX_PROJS), ("u", _P * MAX_PROJS),
                ("x", _P * MAX_PROJS), ("stp_lane", _L * MAX_PROJS)]


_SIGNATURES = {"plastic_drive_run": [ctypes.POINTER(_Plan), _P, ctypes.POINTER(_Tick)],
               "plastic_drive_sizes": [ctypes.POINTER(_I)],
               "plastic_drive_attributes": [ctypes.POINTER(_I)]}


def kernel_resources() -> dict[str, int]:
    """``plastic_drive_kernel``'s registers a thread and local memory a
    thread in bytes (its stack frame, spills included), as the CUDA
    runtime reports them for the loaded library, built now or cached."""
    lib = _build.load("plastic_drive", _SIGNATURES)
    out = (_I * 2)()
    _build.check(lib, lib.plastic_drive_attributes(out), "plastic_drive_attributes")
    return {"registers": out[0], "local_bytes": out[1]}


class DriveLauncher:
    """The :class:`DriveProjection` s of one run on the card ``device``,
    over ``lanes`` lanes (None: one) of ``n``-neuron spike rows, landing
    ``|drive|`` when ``coba``: descriptors, accumulator entries and their
    (projection, row) lists laid out once in device memory, launching on
    the stream current at construction; ``items`` is the entries' count
    (0: nothing to launch), ``group`` the lanes one warp takes (as many as
    fit their rows' windows of 32 into one warp's 32 threads). The caller
    keeps every tensor alive."""

    def __init__(self, projs, device, lanes: int | None, n: int, coba: bool):
        lib = _build.load("plastic_drive", _SIGNATURES)
        sizes = (_I * 6)()
        lib.plastic_drive_sizes(sizes)
        want = (ctypes.sizeof(_Proj), ctypes.sizeof(_Target), ctypes.sizeof(_Plan),
                ctypes.sizeof(_Tick), MAX_PROJS, _MAX_LEVELS)
        if tuple(sizes) != want:
            raise RuntimeError(f"plastic_drive: the library's sizes {tuple(sizes)} differ "
                               f"from the launcher's {want}")
        if len(projs) > MAX_PROJS:
            raise ValueError(f"plastic_drive: {len(projs)} projections exceed the kernel's "
                             f"{MAX_PROJS}")
        table = (_Proj * len(projs))()
        keep, addrs = [], []
        for d, p in zip(table, projs):
            q, f = p.pre.shape
            levels = xla_levels(f)
            if len(levels) > _MAX_LEVELS:
                raise ValueError(f"plastic_drive: fan-in {f} exceeds the kernel's levels")
            pre = p.pre.to(torch.int32).contiguous()
            keep.append(pre)
            d.pre = pre.data_ptr()
            if p.rows is not None:
                rows = p.rows.to(torch.int32).contiguous()
                keep.append(rows)
                d.rows = rows.data_ptr()
            d.Q, d.F, d.stp, d.pre_start, d.n_pre = q, f, int(p.stp), p.pre_start, p.n_pre
            d.wtype, d.stype = _build.STORAGE_CODE[p.w_dtype], _build.STORAGE_CODE[p.stp_dtype]
            d.sentinel = p.sentinel
            d.levels = len(levels)
            d.off[:len(levels)] = levels
            col = p.out.stride(-1) * p.out.element_size()
            addrs.append(p.out.data_ptr() + np.arange(q, dtype=np.int64) * col)
        # One entry per accumulator column; its (projection, row) pairs in
        # projection order (a stable sort of the projection-ordered pairs).
        addr = np.concatenate(addrs) if addrs else np.zeros(0, np.int64)
        owner = np.concatenate([np.full(len(a), k, np.int32) for k, a in enumerate(addrs)]
                               or [np.zeros(0, np.int32)])
        row = np.concatenate([np.arange(len(a), dtype=np.int32) for a in addrs]
                             or [np.zeros(0, np.int32)])
        uniq, inverse = np.unique(addr, return_inverse=True)
        order = np.argsort(inverse, kind="stable")
        ends = np.cumsum(np.bincount(inverse, minlength=len(uniq)))
        targets = (_Target * len(uniq))()
        for i, t in enumerate(targets):
            first = int(ends[i - 1]) if i else 0
            out = projs[int(owner[order[first]])].out
            t.dst = int(uniq[i])
            t.lane_stride = out.stride(0) if lanes is not None else 0
            t.begin, t.end = first, int(ends[i])
        entries = np.stack([owner[order], row[order]], axis=1).astype(np.int32)
        raw = [torch.frombuffer(bytearray(bytes(x)), dtype=torch.uint8).to(device)
               for x in (table, targets)]
        ent = torch.from_numpy(np.ascontiguousarray(entries)).to(device)
        # Keep every tensor a descriptor points at alive for the launcher's life.
        self._keep = (tuple(projs), keep, raw, ent)
        self.items = len(uniq)
        # Lanes a warp takes: all their level-0 windows sum side by side
        # (group * n1 <= 32 on every row of at most 32 windows; one lane
        # where a row is deeper).
        n1 = max((-(-p.pre.shape[1] // WINDOW) for p in projs), default=1)
        self.group = 1 if lanes is None else max(1, min(lanes, WINDOW // max(n1, 1)))
        self._plan = _Plan(projs=raw[0].data_ptr(), targets=raw[1].data_ptr(),
                           entries=ent.data_ptr(),
                           stream=torch.cuda.current_stream(device).cuda_stream,
                           n_targets=self.items, n_projs=len(projs),
                           lanes=1 if lanes is None else lanes, n=n, coba=int(coba),
                           group=self.group)
        self._tick = _Tick()
        self._lanes = lanes
        self._ref, self._tick_ref = ctypes.byref(self._plan), ctypes.byref(self._tick)
        self._lib, self._fn = lib, lib.plastic_drive_run

    def __call__(self, spikes_ptr: int, weights, stp) -> None:
        """One tick on the f32 spike rows at device pointer ``spikes_ptr``,
        with each projection's weights (``weights``, aligned with the
        projections; a dense one's ``[(B,) P, Q]`` rows row-major, or its
        zero-ended ``[(B,) P·Q + 1]`` buffer) and STP state (``stp``: ``(u,
        x)`` ``[(B,) n_pre]`` or None)."""
        tk = self._tick
        lanes = self._lanes is not None
        for k, w in enumerate(weights):
            tk.w[k] = w.data_ptr()
            tk.w_lane[k] = w.stride(0) if lanes else 0
            s = stp[k]
            if s is not None:
                tk.u[k], tk.x[k] = s[0].data_ptr(), s[1].data_ptr()
                tk.stp_lane[k] = s[0].stride(0) if lanes else 0
        err = self._fn(self._ref, spikes_ptr, self._tick_ref)
        if err:
            _build.check(self._lib, err, "plastic_drive")
