"""Drive the PyTorch/CUDA port of the SNN simulator on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises, and the script exits non-zero, on any failure):

1. Build ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a (one nvcc per
   source, all at once) and print the compile times and ptxas reports.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes the Synfire4 paths give it, bit for bit where the arithmetic is
   exact and at a stated tolerance for random weights, and time kernel,
   plain version and (where one exists) a single PyTorch library call
   with CUDA events (per call, host enqueue included), and the kernel
   alone on the device with ``torch.profiler``. ``fused_tick`` is held
   on states taken from 50-tick runs of every Synfire path, twelve
   chained ticks each; ``stdp_update`` and ``stdp_gather`` bit for bit on
   random weights, traces and masks at the plastic chain's shapes
   (Synfire4 packed [200, 200] and an odd shape; the compiled Synfire4
   and x10 fan-in tables with int16 and int32 indices).
3. Run Synfire4 for 1,000 ticks on the card in fp16/fp32 x packed/sparse
   through ``build_synfire`` and ``run``, on the default backend and on
   ``backend="fused"``, with the launch counters reset just before each
   run; check the paper's spike statistics, the launch counts, and that
   every card raster equals the port's CPU raster for the same generator
   uniforms.
4. Synfire4-mini fp16 packed for 5,000 ticks on both backends, on the
   default generator stream (the reference's threefry draws, so the card
   raster equals the CPU raster) and with injected uniforms (the wave dies
   out in every run), and Synfire4x10 sparse fp16 for 1,000 ticks on both
   backends (raster against the CPU again); launch counts checked.
5. Plastic Synfire4 (``CHAIN_STDP`` on the exc->exc chain) for 1,000
   ticks in fp16/fp32 x packed/sparse: card raster and final plastic
   weights equal the CPU port's, packed and sparse weights equal at the
   twin cells, each tick launches ``stdp_update`` (packed) or
   ``stdp_gather`` (sparse) once per chain projection; the same with
   homeostasis every 100 ticks (fp16 sparse); plastic Synfire4x10 fp16
   sparse inside the 8.477 MB ledger (card equals CPU); and plastic nets
   on ``backend="fused"``, which launch no ``fused_tick`` and give the
   default backend's raster and weights.
6. LM serving on the dense decoder (``repro_torch.launch.serve``): (a) the
   attention kernel ``flash_attention`` against its plain version on the
   card, at rtol = atol = 1e-5, at smollm-360m's prefill and decode shapes,
   a local window, the Pallas signature, head dims 16/64/128/160, GQA
   groups 3 and 4 and rows with no allowed key, each timed beside its
   plain version and ``scaled_dot_product_attention``; (b) smollm-360m at
   full width (32 layers, random weights from a seed) serving batch 4,
   512-token prompts, 32 generated tokens, fp16, with exactly one
   attention launch per layer per prefill and decode step; (c) the card
   against the CPU port at full width cut to 2 layers, same weights, fp32
   and fp16 policies: logits and greedy tokens; (d) prefill against
   token-by-token decode at full depth on the card; (e) five decode
   steps under ``torch.profiler``.
7. Profile 100 Synfire4 fp16 ticks per propagation mode and backend, and
   of the plastic default-backend tick, with ``torch.profiler``: device
   busy time per tick, the device's idle share, device events per tick
   and device time by kernel name.

The last lines are a JSON object of per-kernel numbers, a JSON object of
per-path numbers, the card's name and power limit from nvidia-smi, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TICKS = 1000


def log(*args) -> None:
    print(*args, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 200, warmup: int = 20) -> float:
    """Mean milliseconds per call over ``reps`` back-to-back calls, timed
    with CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, name_part: str, reps: int = 100) -> float:
    """Mean device time (ms) of one launch of the kernel whose name
    contains ``name_part`` (one per call of ``fn``), from a
    ``torch.profiler`` trace of ``reps`` calls: the kernel alone, without
    the host's enqueue cost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and name_part in e.name]
    # The profiler may drop a few records of long kernels (it kept 44 of 50
    # 100-us launches once): average over the launches it recorded.
    require(reps // 2 <= len(spans) <= reps, f"profiler saw {len(spans)} launches of "
            f"{name_part!r} in {reps} calls")
    if len(spans) < reps:
        log(f"[profile] {name_part}: the profiler recorded {len(spans)} of {reps} launches")
    return sum(spans) / len(spans) / 1e3


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or float32
    operations over the peak rate, whichever is larger (ms)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def fused_bound(payload, spikes: torch.Tensor, n: int, state_bytes: int) -> tuple[float, str]:
    """The least work of one fused tick on this tick's spikes: v and u read
    and written, gen_row, is_gen and the spike row, a-d, i_syn, the ring
    rows the tick touches (its slot and one per delay, each read and
    written), the descriptors, the dense rows of the pres that spiked, the
    CSR index tables and the CSR weights of spiking pres; one f32 add per
    weight added, about 31 operations per neuron for IZH4."""
    sp = spikes.to(torch.int64).cpu()
    k = len(payload.delays)
    moved = (4 * n * state_bytes + 3 * n + 16 * n + 4 * n
             + 2 * (1 + k) * n * state_bytes + nbytes(payload.desc))
    adds = 0
    for ps, _, _, w in payload.dense:
        rows = int(sp[ps:ps + w.shape[0]].sum())
        moved += rows * w.shape[1] * 4
        adds += rows * w.shape[1]
    for _, _, idx, w in payload.csr:
        hits = int(sp[idx.long().cpu()].sum())
        moved += nbytes(idx) + hits * 4
        adds += hits
    return bound(moved, adds + 31 * n)


def phase_build() -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build()
    wall = time.perf_counter() - t0
    for name, r in report.items():
        log(f"[build] {name}.cu: {r['seconds']:.2f} s")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all kernels in {wall:.2f} s wall (parallel nvcc)")
    return {"nvcc_wall_s": wall,
            "nvcc_s": {k: v["seconds"] for k, v in report.items()}}


def _izh_inputs(n: int, dtype, dev, seed: int):
    g = torch.Generator(device="cpu").manual_seed(seed)
    v = (torch.rand(n, generator=g) * 115 - 80).to(dtype)
    u = (torch.rand(n, generator=g) * 10 - 15).to(dtype)
    i_syn = torch.rand(n, generator=g) * 25
    fs = torch.rand(n, generator=g) < 0.2  # fast-spiking share, as Synfire4's
    a = torch.where(fs, 0.1, 0.02)
    b = torch.full((n,), 0.2)
    c = torch.full((n,), -65.0)
    d = torch.where(fs, 2.0, 8.0)
    return [x.to(dev).contiguous() for x in (v, u, i_syn, a, b, c, d)]


def phase_kernels(dev) -> list[dict]:
    from repro_torch.configs.synfire4 import (SYNFIRE4, SYNFIRE4_MINI, SYNFIRE4_X10,
                                              build_synfire)
    from repro_torch.core.backend import assemble_packed
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []

    # izh4_update: bit for bit (pinned rounding on both sides).
    err = 0.0
    for n in (1200, 12000):
        for dtype in (torch.float16, torch.float32):
            args = _izh_inputs(n, dtype, dev, seed=n)
            got = ops.izh4_update(*args)
            want = ref.izh4_ref(*args)
            torch.cuda.synchronize()
            for g_, w_, what in zip(got, want, ("v", "u", "spiked")):
                require(g_.dtype == w_.dtype and torch.equal(g_, w_),
                        f"izh4_update {what} differs from its plain version "
                        f"(N={n}, {dtype}): max abs err {max_err(g_, w_)}")
            require(0 < int(got[2].sum()) < n, "izh4 test inputs never spiked")
            err = max(err, max_err(got[0], want[0]))
            log(f"[kernels] izh4_update N={n} {dtype}: bitwise equal")
    args = _izh_inputs(1200, torch.float16, dev, seed=1)
    b_ms, b_by = bound(nbytes(*args) + 1200 * (2 + 2 + 1), 1200 * 31)
    rows.append({
        "name": "izh4_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/izh_update.cu",
        "replaces": "src/repro/kernels/izh_update.py:50",
        "shape": "N=1200 fp16", "max_abs_err": err,
        "ms": cuda_ms(lambda: ops.izh4_update(*args)),
        "device_ms": device_ms(lambda: ops.izh4_update(*args), "izh4_kernel"),
        "plain_ms": cuda_ms(lambda: ref.izh4_ref(*args)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    # syn_matmul: exact on 0/1 spikes x Synfire4's weight table, stated
    # tolerance (summation order only) on random normal operands.
    g = torch.Generator(device="cpu").manual_seed(2)
    table = torch.tensor([0.0, 1.0, 3.5, -2.0])
    err = 0.0
    for m, k, n in ((1, 200, 250), (1, 50, 200), (64, 200, 250)):
        x = (torch.rand((m, k), generator=g) < 0.3).float().to(dev)
        w = table[torch.randint(0, 4, (k, n), generator=g)].to(dev)
        got, want = ops.syn_matmul(x, w), ref.syn_matmul_ref(x, w)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"syn_matmul [{m},{k}]x[{k},{n}] exact case: max abs err {max_err(got, want)}")
        for wdt in (torch.float32, torch.float16):
            xr = torch.randn((m, k), generator=g).to(dev)
            wr = torch.randn((k, n), generator=g).to(wdt).to(dev)
            got, want = ops.syn_matmul(xr, wr), ref.syn_matmul_ref(xr, wr)
            require(torch.allclose(got, want, rtol=1e-5, atol=1e-4),
                    f"syn_matmul [{m},{k}]x[{k},{n}] {wdt}: max abs err {max_err(got, want)}")
            err = max(err, max_err(got, want))
        log(f"[kernels] syn_matmul [{m},{k}]x[{k},{n}]: bitwise on spikes, "
            f"random within rtol=1e-5 atol=1e-4")
    # The mini's packed images: its fp16 weights (4, 14, -6.66796875) are
    # multiples of 1/256, so every sum of them is exact in f32.
    mini = build_synfire(SYNFIRE4_MINI, policy="fp16", device=dev)
    images = assemble_packed(mini.static, mini.state0.weights)
    for w in images:
        x = (torch.rand((1, w.shape[0]), generator=g) < 0.3).float().to(dev)
        got, want = ops.syn_matmul(x, w), ref.syn_matmul_ref(x, w)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"syn_matmul mini [1,{w.shape[0]}]x"
                f"{list(w.shape)}: max abs err {max_err(got, want)}")
    log(f"[kernels] syn_matmul Synfire4-mini packed images "
        f"{sorted({tuple(w.shape) for w in images})}: bitwise")
    x = (torch.rand((1, 200), generator=g) < 0.3).float().to(dev)
    w = table[torch.randint(0, 4, (200, 250), generator=g)].to(dev)
    b_ms, b_by = bound(nbytes(x, w) + 250 * 4, 2 * 200 * 250)
    rows.append({
        "name": "syn_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/syn_matmul.cu",
        "replaces": "src/repro/kernels/syn_matmul.py:40",
        "shape": "[1,200]x[200,250] f32", "max_abs_err": err,
        "ms": cuda_ms(lambda: ops.syn_matmul(x, w)),
        "device_ms": device_ms(lambda: ops.syn_matmul(x, w), "gemv_kernel"),
        "plain_ms": cuda_ms(lambda: ref.syn_matmul_ref(x, w)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.matmul(x, w))})

    # syn_gather: the compiled Synfire4 and x10 CSR tables, exact with their
    # weights, stated tolerance with random normal weights.
    err = 0.0
    timed = None
    for cfg in (SYNFIRE4, SYNFIRE4_X10):
        net = build_synfire(cfg, policy="fp16", propagation="sparse", budget=None,
                            monitor_ms_hint=0, device=dev)
        packed = assemble_packed(net.static, net.state0.weights)
        for bi, b in enumerate(net.static.buckets):
            idx = net.params.bucket_csr_idx[bi]
            spikes = (torch.rand(b.p, generator=g) < 0.3).float().to(dev)
            got, want = ops.syn_gather(spikes, idx, packed[bi]), ref.syn_gather_ref(
                spikes, idx, packed[bi])
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"syn_gather {cfg.name} bucket {bi}: max abs err {max_err(got, want)}")
            wr = torch.randn(tuple(idx.shape), generator=g).to(dev)
            got, want = ops.syn_gather(spikes, idx, wr), ref.syn_gather_ref(spikes, idx, wr)
            require(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                    f"syn_gather {cfg.name} bucket {bi} random: max abs err {max_err(got, want)}")
            err = max(err, max_err(got, want))
            if timed is None:
                timed = (spikes, idx, packed[bi])
        log(f"[kernels] syn_gather {cfg.name}: {len(net.static.buckets)} tables "
            f"(Q x F {sorted({tuple(t.shape) for t in net.params.bucket_csr_idx})}) "
            f"bitwise; random weights within rtol=1e-5 atol=1e-5")
    bad = torch.tensor([[0, 1], [2, 200]], dtype=torch.int16, device=dev)
    out = ops.syn_gather(torch.ones(200, device=dev), bad, torch.ones((2, 2), device=dev))
    require(float(out[0]) == 2.0 and bool(out[1].isnan()),
            f"syn_gather: an index outside [0, P) gave {out.tolist()}, want [2, nan]")
    log("[kernels] syn_gather: an index outside [0, P) yields NaN on the card")
    spikes, idx, w = timed
    q, f = idx.shape
    b_ms, b_by = bound(nbytes(spikes, idx, w) + q * 4, 2 * q * f)
    idx64 = idx.long()
    rows.append({
        "name": "syn_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/syn_gather.cu",
        "replaces": "src/repro/kernels/syn_gather.py:41",
        "shape": f"Synfire4 bucket 0: P={spikes.shape[0]} Q={q} F={f} int16/f32",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ops.syn_gather(spikes, idx, w)),
        "device_ms": device_ms(lambda: ops.syn_gather(spikes, idx, w), "gather_kernel"),
        "plain_ms": cuda_ms(lambda: ref.syn_gather_ref(spikes, idx, w)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.nn.functional.embedding_bag(
            idx64, spikes[:, None], per_sample_weights=w, mode="sum"))})
    rows.append(_check_fused_tick(dev, g))
    rows += _check_stdp(dev, g)
    for r in rows:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"
        log(f"[kernels] {r['name']} ({r['shape']}): {r['ms'] * 1e3:.2f} us per call "
            f"({r['device_ms'] * 1e3:.2f} us on the device), plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.4f} us "
            f"({r['bound_by']}), library {lib}")
    return rows


FUSED_STATES = (  # (config name, policy, propagation, build keywords)
    ("SYNFIRE4", "fp16", "packed", {}), ("SYNFIRE4", "fp32", "packed", {}),
    ("SYNFIRE4", "fp16", "sparse", {}), ("SYNFIRE4", "fp32", "sparse", {}),
    ("SYNFIRE4_MINI", "fp16", "packed", {}),
    ("SYNFIRE4_X10", "fp16", "sparse", {"budget": None, "monitor_ms_hint": 0}),
)
TICK_OUTPUTS = ("v", "u", "spikes", "ring", "i_syn")
# Chained ticks per state: more than the longest delay (10), so the random
# generator rows' drive arrives and neurons spike within the check.
CHAINED = 12


def _fused_state(cfg_name, policy, propagation, dev, build_kw, ticks=50):
    """A fused net and its state after ``ticks`` ticks on the card (the
    ring then holds currents and neurons spike), with the tick's operands."""
    from repro_torch.configs import synfire4
    from repro_torch.core.backend import assemble_fused
    from repro_torch.core.engine import run

    net = synfire4.build_synfire(getattr(synfire4, cfg_name), policy=policy,
                                 propagation=propagation, device=dev,
                                 backend="fused", **build_kw)
    state, _ = run(net.static, net.params, net.state0, ticks)
    payload = assemble_fused(net.static, state.weights, net.params).kernel
    p = net.params.neuron
    args = [state.neurons.v, state.neurons.u, state.ring[:, :, 0].contiguous(),
            None, p.model == 0, p.a, p.b, p.c, p.d]
    return net, state, payload, args


def _check_fused_tick(dev, g) -> dict:
    """fused_tick against fused_tick_ref on the card: bit for bit on every
    Synfire state (CHAINED chained ticks each), and on random normal weights
    v', u', spikes and i_syn bit for bit (they do not depend on the
    weights within a tick) with ring' at rtol=1e-5, atol=1e-4 (f32 sums
    in another order). Returns the kernel's row, timed at Synfire4 fp16
    packed."""
    from repro_torch.core.backend import assemble_packed
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_tick import assemble_kernel

    def kernel_tick(args, t, payload):
        """Tick ``t`` through the run wrapper on copies of ``args``:
        (v', u', spikes, ring', i_syn), the plain version's outputs."""
        v, u, ring = (x.clone() for x in args[:3])
        rows = args[3][None].clone()
        i_rows = torch.empty((1, v.shape[0]), dtype=torch.float32, device=v.device)
        ops.FusedTickRun(payload, v, u, ring, *args[4:], rows, i_rows=i_rows).tick(0, t)
        return v, u, rows[0], ring, i_rows[0]

    def both(args, t, payload):
        got = kernel_tick(args, t, payload)
        want = ref.fused_tick_ref(*args, t, dense=payload.dense, csr=payload.csr,
                                  ring_len=args[2].shape[0])
        torch.cuda.synchronize()
        return got, want

    err, timed = 0.0, None
    for cfg_name, policy, propagation, kw in FUSED_STATES:
        net, state, payload, args = _fused_state(cfg_name, policy, propagation, dev, kw)
        n = net.static.n
        require(float(args[2].float().abs().sum()) > 0, f"{cfg_name}: empty ring")
        spiked = 0
        for t in range(state.t, state.t + CHAINED):
            args[3] = (torch.rand(n, generator=g) < 0.3).to(dev)
            got, want = both(args, t, payload)
            for name, g_, w_ in zip(TICK_OUTPUTS, got, want):
                require(g_.dtype == w_.dtype and torch.equal(g_, w_),
                        f"fused_tick {cfg_name} {policy}/{propagation} tick {t}: "
                        f"{name} differs from the plain version, max abs err "
                        f"{max_err(g_, w_)}")
            spiked += int(got[2][~args[4]].sum())
            args[0], args[1], args[2] = got[0], got[1], got[3]
        require(spiked > 0, f"fused_tick {cfg_name}: no neuron spiked in {CHAINED} ticks")
        log(f"[kernels] fused_tick {cfg_name} {policy}/{propagation} (N={n}, "
            f"{len(payload.dense)} dense, {len(payload.csr)} CSR buckets): {CHAINED} "
            f"ticks bitwise, {spiked} neuron spikes")
        if cfg_name == "SYNFIRE4" and policy == "fp32":
            # Random normal weights in the same layout.
            packed = [torch.randn(tuple(w.shape), generator=g).to(dev)
                      for w in assemble_packed(net.static, state.weights)]
            rpay = assemble_kernel(net.static, net.params, packed)
            got, want = both(args, state.t + CHAINED, rpay)
            for name, g_, w_ in zip(TICK_OUTPUTS, got, want):
                if name == "ring":
                    require(torch.allclose(g_, w_, rtol=1e-5, atol=1e-4),
                            f"fused_tick random {propagation}: ring max abs err "
                            f"{max_err(g_, w_)}")
                    err = max(err, max_err(g_, w_))
                else:
                    require(torch.equal(g_, w_), f"fused_tick random {propagation}: "
                            f"{name} max abs err {max_err(g_, w_)}")
            log(f"[kernels] fused_tick random normal weights ({propagation}): ring "
                f"within rtol=1e-5 atol=1e-4 (max abs err {err:.3g}), the rest bitwise")
        if timed is None:
            timed = (net, payload, list(args))
    net, payload, args = timed
    n, t0 = net.static.n, 60
    got = kernel_tick(args, t0, payload)
    b_ms, b_by = fused_bound(payload, got[2], n, args[0].element_size())
    rows_buf = torch.zeros((230, n), dtype=torch.bool, device=dev)
    v, u, ring = args[0].clone(), args[1].clone(), args[2].clone()
    runner = ops.FusedTickRun(payload, v, u, ring, *args[4:], rows_buf,
                              dt=net.static.dt, substeps=net.static.substeps)
    counter = iter(range(10**9))

    def one_tick():
        i = next(counter)
        runner.tick(i % 230, t0 + i)

    return {
        "name": "fused_tick", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_tick.cu",
        "replaces": "src/repro/kernels/fused_tick.py:243",
        "shape": f"Synfire4 fp16 packed tick: N={n}, 8 dense buckets", "max_abs_err": err,
        "ms": cuda_ms(one_tick),
        "device_ms": device_ms(one_tick, "fused_tick_kernel"),
        "plain_ms": cuda_ms(lambda: ref.fused_tick_ref(
            *args, t0, dense=payload.dense, csr=payload.csr, ring_len=args[2].shape[0])),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


STDP_KW = dict(a_plus=0.004, a_minus=0.0033, w_min=0.0, w_max=4.0)  # CHAIN_STDP


def _stdp_vectors(g, p: int, q: int, dev):
    """Random pre/post traces in [0, 3) and 0/1 spikes (30 %), f32."""
    return [x.to(dev) for x in (torch.rand(p, generator=g) * 3, torch.rand(q, generator=g) * 3,
                                (torch.rand(p, generator=g) < 0.3).float(),
                                (torch.rand(q, generator=g) < 0.3).float())]


def _require_bitwise(got, want, what):
    require(got.dtype == want.dtype and torch.equal(got, want),
            f"{what} differs from its plain version: max abs err {max_err(got, want)}")


def _check_stdp(dev, g) -> list[dict]:
    """stdp_update and stdp_gather against their plain versions on the card,
    bit for bit (both pin their rounding and reduce nothing), and their rows
    timed at the plastic chain's shapes: Synfire4 packed [200, 200] fp16,
    and Synfire4 sparse's first chain table (int16, fp16)."""
    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, SYNFIRE4_X10, build_synfire
    from repro_torch.kernels import ops, ref

    timed = {}
    for p, q in ((200, 200), (37, 113)):
        for dtype in (torch.float16, torch.float32):
            mask = (torch.rand((p, q), generator=g) < 0.3).to(dev)
            w = torch.where(mask.cpu(), torch.rand((p, q), generator=g) * 4, 0.0).to(dtype).to(dev)
            args = [w, mask, *_stdp_vectors(g, p, q, dev)]
            got = ops.stdp_update(*args, **STDP_KW)
            want = ref.stdp_update_ref(*args, **STDP_KW)
            torch.cuda.synchronize()
            _require_bitwise(got, want, f"stdp_update [{p},{q}] {dtype}")
            require(not torch.equal(got, w), "stdp_update moved no weight")
            timed.setdefault("update", args)
            log(f"[kernels] stdp_update [{p},{q}] {dtype}: bitwise equal")
    for cfg in (SYNFIRE4, SYNFIRE4_X10):
        net = build_synfire(cfg, policy="fp16", propagation="sparse", stdp_chain=CHAIN_STDP,
                            monitor_ms_hint=0, device=dev)
        for j in net.static.plastic_csr:
            spec = net.static.projections[j]
            valid, idx16 = net.params.masks[j], net.params.proj_csr_idx[j]
            for idx in (idx16, idx16.to(torch.int32)):
                for dtype in (torch.float16, torch.float32):
                    w = torch.where(valid.cpu(), torch.rand(tuple(valid.shape), generator=g)
                                    * 4, 0.0).to(dtype).to(dev)
                    args = [w, idx, valid, *_stdp_vectors(g, spec.pre_size, spec.post_size,
                                                          dev)]
                    got = ops.stdp_gather(*args, **STDP_KW)
                    want = ref.stdp_gather_ref(*args, **STDP_KW)
                    torch.cuda.synchronize()
                    _require_bitwise(got, want, f"stdp_gather {cfg.name} proj {j} "
                                     f"{idx.dtype} {dtype}")
                    timed.setdefault("gather", args)
        log(f"[kernels] stdp_gather {cfg.name}: {len(net.static.plastic_csr)} chain "
            f"tables (Q x F {sorted({tuple(net.params.masks[j].shape) for j in net.static.plastic_csr})}) "
            "x int16/int32 x fp16/fp32 bitwise")
    bad = torch.tensor([[0, 1], [2, 200]], dtype=torch.int16, device=dev)
    out = ops.stdp_gather(torch.ones((2, 2), device=dev), bad,
                          torch.ones((2, 2), dtype=torch.bool, device=dev),
                          *_stdp_vectors(g, 200, 2, dev), **STDP_KW)
    require(bool(out[1, 1].isnan()) and not bool(out[:, 0].isnan().any()),
            f"stdp_gather: an index outside [0, P) gave {out.tolist()}, want NaN there only")
    log("[kernels] stdp_gather: an index outside [0, P) yields NaN on the card")

    rows = []
    args = timed["update"]
    p, q = args[0].shape
    b_ms, b_by = bound(nbytes(*args) + nbytes(args[0]), 7 * p * q)
    rows.append({
        "name": "stdp_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stdp_update.cu",
        "replaces": "src/repro/kernels/stdp_update.py:33",
        "shape": f"Synfire4 packed chain block [{p},{q}] fp16", "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: ops.stdp_update(*args, **STDP_KW)),
        "device_ms": device_ms(lambda: ops.stdp_update(*args, **STDP_KW),
                               "stdp_update_kernel"),
        "plain_ms": cuda_ms(lambda: ref.stdp_update_ref(*args, **STDP_KW)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    args = timed["gather"]
    q, f = args[0].shape
    b_ms, b_by = bound(nbytes(*args) + nbytes(args[0]), 7 * q * f)
    rows.append({
        "name": "stdp_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stdp_gather.cu",
        "replaces": "src/repro/kernels/stdp_gather.py:59",
        "shape": f"Synfire4 sparse chain table: P={args[3].shape[0]} Q={q} F={f} "
                 "int16/fp16", "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: ops.stdp_gather(*args, **STDP_KW)),
        "device_ms": device_ms(lambda: ops.stdp_gather(*args, **STDP_KW),
                               "stdp_gather_kernel"),
        "plain_ms": cuda_ms(lambda: ref.stdp_gather_ref(*args, **STDP_KW)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return rows


def _require_same_raster(card, cpu, what):
    if not torch.equal(card, cpu):
        first = int(torch.nonzero((card != cpu).any(dim=1))[0])
        raise AssertionError(f"{what}: card raster differs from the CPU raster "
                             f"first at tick {first}")


def _card_run(cfg, policy, propagation, gen_u, ticks, dev, backend=None, **build_kw):
    """The main path on the card for ``ticks`` ticks (timed, launch counts
    reset just before and read just after), on ``gen_u`` or, when it is
    None, the default generator stream."""
    from repro_torch.configs.synfire4 import build_synfire
    from repro_torch.core.engine import run
    from repro_torch.kernels import ops

    net = build_synfire(cfg, policy=policy, propagation=propagation, device=dev,
                        backend=backend, **build_kw)
    gu = None if gen_u is None else gen_u.to(dev)
    run(net.static, net.params, net.state0, 20,
        gen_u=None if gu is None else gu[:20])  # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    _, out = run(net.static, net.params, net.state0, ticks, gen_u=gu)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return net, out["spikes"].cpu(), dict(ops.LAUNCHES), seconds


def _cpu_raster(cfg, policy, propagation, gen_u, ticks, **build_kw):
    from repro_torch.configs.synfire4 import build_synfire
    from repro_torch.core.engine import run

    net = build_synfire(cfg, policy=policy, propagation=propagation, device="cpu",
                        **build_kw)
    _, out = run(net.static, net.params, net.state0, ticks, gen_u=gen_u)
    return out["spikes"]


def _card_and_cpu_rasters(cfg, policy, propagation, gen_u, dev, **build_kw):
    """The main path on the card on both backends for ``len(gen_u)`` ticks
    and the same network with the same uniforms on the CPU; raises unless
    every card raster equals the CPU raster. Returns per backend
    ``(net, raster, launches, seconds)``."""
    ticks = gen_u.shape[0]
    cpu = _cpu_raster(cfg, policy, propagation, gen_u, ticks, **build_kw)
    out = {}
    for backend in (None, "fused"):
        out[backend] = _card_run(cfg, policy, propagation, gen_u, ticks, dev,
                                 backend=backend, **build_kw)
        _require_same_raster(out[backend][1], cpu, f"{cfg.name} {policy}/"
                             f"{propagation} backend={backend}")
    return out


NOT_ON_PATH = {"stdp_update": 0, "stdp_gather": 0, "flash_attention": 0}  # of a static tick


def _fused_launches(ticks: int) -> dict:
    return {"izh4_update": 0, "syn_matmul": 0, "syn_gather": 0, "fused_tick": ticks,
            **NOT_ON_PATH}


def _add(totals: dict, launches: dict) -> None:
    for k, v in launches.items():
        totals[k] += v


def phase_synfire(dev, totals: dict) -> dict:
    from repro_torch.configs.synfire4 import SYNFIRE4

    g = torch.Generator(device="cpu").manual_seed(7)
    gen_u = torch.rand((TICKS, SYNFIRE4.n_stim), generator=g)
    paths, counts = {}, {}
    for propagation in ("packed", "sparse"):
        for policy in ("fp16", "fp32"):
            runs = _card_and_cpu_rasters(SYNFIRE4, policy, propagation, gen_u, dev)
            for backend, (net, sp, launches, seconds) in runs.items():
                _add(totals, launches)
                kinds = [b.kind for b in net.static.buckets]
                expect = _fused_launches(TICKS) if backend else {
                    "izh4_update": TICKS, "syn_matmul": kinds.count("dense") * TICKS,
                    "syn_gather": kinds.count("sparse") * TICKS, "fused_tick": 0,
                    **NOT_ON_PATH}
                require(launches == expect, f"launches {launches} != {expect}")
                require(kinds.count("dense" if propagation == "packed" else "sparse")
                        == (8 if propagation == "packed" else 13), f"plan {kinds}")
                total = int(sp.sum())
                rate = total / (net.n_neurons * TICKS) * 1000.0
                require(20_000 <= total <= 33_000, f"{total} spikes outside 20k-33k")
                require(17.0 <= rate <= 29.0, f"mean rate {rate:.2f} Hz outside 17-29")
                counts[(policy, propagation)] = total
                key = f"synfire4/{policy}/{propagation}" + ("/fused" if backend else "")
                paths[key] = {"us_per_tick": seconds / TICKS * 1e6, "spikes": total,
                              "rate_hz": rate, "launches": launches,
                              "raster_equals_cpu": True}
                log(f"[synfire4] {policy}/{propagation} backend={backend}: {total} "
                    f"spikes, {rate:.2f} Hz, {seconds / TICKS * 1e6:.1f} us/tick, "
                    f"launches {launches}, card raster == CPU raster")
        acc = (min(counts[("fp16", propagation)], counts[("fp32", propagation)])
               / max(counts[("fp16", propagation)], counts[("fp32", propagation)]))
        require(acc >= 0.97, f"fp16 spike-count accuracy {acc:.4f} < 0.97")
        paths[f"synfire4/fp16_accuracy/{propagation}"] = acc
    return paths


def phase_scale(dev, totals: dict) -> dict:
    from repro_torch.configs.synfire4 import SYNFIRE4_MINI, SYNFIRE4_X10

    paths = {}
    mini_ticks = 5000
    mini_launches = {"izh4_update": mini_ticks, "syn_matmul": 8 * mini_ticks,
                     "syn_gather": 0, "fused_tick": 0, **NOT_ON_PATH}

    def died_out(sp, what):
        total, tail = int(sp.sum()), int(sp[-1000:].sum())
        require(150 <= total <= 900 and tail == 0,
                f"mini {what}: {total} spikes, {tail} in the last second "
                f"(want 150-900, 0)")
        return total, tail

    def mini_path(key, backend, sp, launches, seconds, what):
        want = _fused_launches(mini_ticks) if backend else mini_launches
        require(launches == want, f"mini launches {launches} != {want}")
        _add(totals, launches)
        total, tail = died_out(sp, what)
        paths[key] = {"us_per_tick": seconds / mini_ticks * 1e6, "spikes": total,
                      "last_second_spikes": tail, "launches": launches,
                      "raster_equals_cpu": True}
        log(f"[mini] {mini_ticks} ticks, {what}, backend={backend}: {total} spikes, "
            f"silent last second, {seconds / mini_ticks * 1e6:.1f} us/tick, "
            f"launches {launches}, card raster == CPU raster")

    # The default generator stream (the reference's threefry draws), as
    # Engine.run draws it: the card's raster equals the CPU's.
    cpu = _cpu_raster(SYNFIRE4_MINI, "fp16", "packed", None, mini_ticks)
    for backend in (None, "fused"):
        _, sp, launches, seconds = _card_run(SYNFIRE4_MINI, "fp16", "packed", None,
                                             mini_ticks, dev, backend=backend)
        _require_same_raster(sp, cpu, f"mini default stream backend={backend}")
        mini_path("synfire4_mini/fp16/packed" + ("/fused" if backend else ""),
                  backend, sp, launches, seconds, "default stream")

    # Injected uniforms.
    g = torch.Generator(device="cpu").manual_seed(13)
    gen_u = torch.rand((mini_ticks, SYNFIRE4_MINI.n_stim), generator=g)
    for backend, (_, sp, launches, seconds) in _card_and_cpu_rasters(
            SYNFIRE4_MINI, "fp16", "packed", gen_u, dev).items():
        mini_path("synfire4_mini/fp16/packed/injected" + ("/fused" if backend else ""),
                  backend, sp, launches, seconds, "injected uniforms")

    g = torch.Generator(device="cpu").manual_seed(11)
    gen_u = torch.rand((TICKS, SYNFIRE4_X10.n_stim), generator=g)
    x10_launches = {"izh4_update": TICKS, "syn_matmul": 0, "syn_gather": 13 * TICKS,
                    "fused_tick": 0, **NOT_ON_PATH}
    for backend, (net, sp, launches, seconds) in _card_and_cpu_rasters(
            SYNFIRE4_X10, "fp16", "sparse", gen_u, dev, budget=None,
            monitor_ms_hint=0).items():
        _add(totals, launches)
        rate = int(sp.sum()) / (net.n_neurons * TICKS) * 1000.0
        require(17.0 <= rate <= 29.0, f"x10 mean rate {rate:.2f} Hz outside 17-29")
        want = _fused_launches(TICKS) if backend else x10_launches
        require(launches == want, f"x10 launches {launches} != {want}")
        paths["synfire4_x10/fp16/sparse" + ("/fused" if backend else "")] = {
            "us_per_tick": seconds / TICKS * 1e6, "spikes": int(sp.sum()),
            "rate_hz": rate, "synapse_bytes": net.ledger.synapse_bytes(),
            "launches": launches, "raster_equals_cpu": True}
        log(f"[x10] sparse fp16 backend={backend}: {int(sp.sum())} spikes, "
            f"{rate:.2f} Hz, {seconds / TICKS * 1e6:.1f} us/tick, synapse bytes "
            f"{net.ledger.synapse_bytes()}, launches {launches}, card raster == "
            f"CPU raster")
    return paths


HOMEO = dict(target_hz=10.0, tau_avg_ms=1000.0, beta=2.0)  # visible within 1 s


def _plastic_run(cfg, policy, propagation, gen_u, dev, backend=None, **build_kw):
    """Plastic Synfire (``CHAIN_STDP`` on the exc->exc chain) through
    ``build_synfire`` and ``run`` on ``dev`` for ``len(gen_u)`` ticks. On the
    card it is warmed up, then timed with the launch counts reset just
    before and read just after. Returns (net, raster, final state,
    launches or None, seconds)."""
    from repro_torch.configs.synfire4 import CHAIN_STDP, build_synfire
    from repro_torch.core.engine import run
    from repro_torch.kernels import ops

    net = build_synfire(cfg, policy=policy, propagation=propagation, device=dev,
                        backend=backend, stdp_chain=CHAIN_STDP, **build_kw)
    gu = gen_u.to(dev)
    card = dev.type == "cuda"
    if card:
        warm = net.static.homeo_period or 20
        run(net.static, net.params, net.state0, warm, gen_u=gu[:warm])
        torch.cuda.synchronize()
        ops.reset_launches()
    t0 = time.perf_counter()
    final, out = run(net.static, net.params, net.state0, gen_u.shape[0], gen_u=gu)
    if card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (net, out["spikes"].cpu(), final, dict(ops.LAUNCHES) if card else None,
            seconds)


def _chain(net) -> list[int]:
    return [j for j, c in enumerate(net.static.stdp) if c is not None]


def _require_same_plastic_state(card, cpu, what):
    """The card's final plastic weights, traces and homeostasis rates equal
    those of ``cpu`` (a CPU port run, or another card run) bit for bit."""
    net, final = card[0], card[2]
    cpu_final = cpu[2]
    for j in _chain(net):
        for name, a, b in [("weights", final.weights[j], cpu_final.weights[j])] + [
                (f"stdp.{f}", getattr(final.stdp[j], f), getattr(cpu_final.stdp[j], f))
                for f in final.stdp[j]._fields]:
            a, b = a.cpu(), b.cpu()
            require(torch.equal(a, b), f"{what}: card {name} of projection {j} "
                    f"differ from the CPU's, max abs err {max_err(a, b)}")
    for j, h in enumerate(final.homeo):
        if h is not None:
            require(torch.equal(h.cpu(), cpu_final.homeo[j].cpu()),
                    f"{what}: card homeostasis rates of projection {j} differ")


def _dense_chain(net, final) -> dict:
    """The chain's final weights as dense f32 images (CSR rows scattered)."""
    from repro_torch.core.synapses import CSRFanin, csr_to_dense

    out = {}
    for j in _chain(net):
        w = final.weights[j]
        if j in net.static.csr_projs:
            out[j] = csr_to_dense(CSRFanin(net.params.proj_csr_idx[j], w,
                                           net.params.masks[j]),
                                  net.static.projections[j].pre_size)
        else:
            out[j] = w.float().cpu().numpy()
    return out


def _plastic_launches(net, ticks: int) -> dict:
    kinds = [b.kind for b in net.static.buckets]
    chain = len(_chain(net))
    csr = sum(j in net.static.csr_projs for j in _chain(net))
    return {"izh4_update": ticks, "syn_matmul": kinds.count("dense") * ticks,
            "syn_gather": kinds.count("sparse") * ticks, "fused_tick": 0,
            "stdp_update": (chain - csr) * ticks, "stdp_gather": csr * ticks,
            "flash_attention": 0}


def phase_plastic(dev, totals: dict) -> dict:
    """Plastic Synfire4 on the card against the CPU port (see phase 5 of the
    module's docstring)."""
    import numpy as np

    from repro_torch.configs.synfire4 import SYNFIRE4, SYNFIRE4_X10
    from repro_torch.core.plasticity import HomeostasisConfig
    from repro_torch.memory import MCU_BUDGET_BYTES

    cpu_dev = torch.device("cpu")
    g = torch.Generator(device="cpu").manual_seed(17)
    gen_u = torch.rand((TICKS, SYNFIRE4.n_stim), generator=g)
    paths, images, card_runs = {}, {}, {}

    def record(key, card, cpu, extra=None):
        net, sp, final, launches, seconds = card
        _require_same_raster(sp, cpu[1], key)
        _require_same_plastic_state(card, cpu, key)
        want = _plastic_launches(net, sp.shape[0])
        require(launches == want, f"{key}: launches {launches} != {want}")
        _add(totals, launches)
        moved = sum(int((final.weights[j].cpu() != net.state0.weights[j].cpu()).sum())
                    for j in _chain(net))
        require(moved > 0, f"{key}: no plastic weight moved")
        total = int(sp.sum())
        rate = total / (net.n_neurons * sp.shape[0]) * 1000.0
        require(17.0 <= rate <= 29.0, f"{key}: mean rate {rate:.2f} Hz outside 17-29")
        paths[key] = {"us_per_tick": seconds / sp.shape[0] * 1e6, "spikes": total,
                      "rate_hz": rate, "plastic_weights_moved": moved,
                      "launches": launches, "raster_equals_cpu": True,
                      "weights_equal_cpu": True, "cpu_us_per_tick": cpu[4] / sp.shape[0] * 1e6,
                      **(extra or {})}
        log(f"[plastic] {key}: {total} spikes, {rate:.2f} Hz, {moved} plastic weights "
            f"moved, {seconds / sp.shape[0] * 1e6:.1f} us/tick (CPU port "
            f"{cpu[4] / sp.shape[0] * 1e6:.1f}), launches {launches}, card raster "
            "and weights == CPU")

    for propagation in ("packed", "sparse"):
        for policy in ("fp16", "fp32"):
            cpu = _plastic_run(SYNFIRE4, policy, propagation, gen_u, cpu_dev)
            card = _plastic_run(SYNFIRE4, policy, propagation, gen_u, dev)
            record(f"synfire4_plastic/{policy}/{propagation}", card, cpu)
            images[(policy, propagation)] = _dense_chain(card[0], card[2])
            card_runs[(policy, propagation)] = card
    for policy in ("fp16", "fp32"):
        for j, img in images[(policy, "packed")].items():
            require(np.array_equal(img, images[(policy, "sparse")][j]),
                    f"plastic {policy}: packed and sparse weights of projection {j} differ")
        require(torch.equal(card_runs[(policy, "packed")][1], card_runs[(policy, "sparse")][1]),
                f"plastic {policy}: packed and sparse rasters differ")
        log(f"[plastic] {policy}: packed and sparse rasters and chain weights bitwise equal")

    homeo = dict(homeo_chain=HomeostasisConfig(**HOMEO), homeostasis_period=100)
    cpu = _plastic_run(SYNFIRE4, "fp16", "sparse", gen_u, cpu_dev, **homeo)
    card = _plastic_run(SYNFIRE4, "fp16", "sparse", gen_u, dev, **homeo)
    record("synfire4_plastic_homeo/fp16/sparse", card, cpu)
    scaled = card_runs[("fp16", "sparse")][2]
    require(any(not torch.equal(card[2].weights[j], scaled.weights[j]) for j in _chain(card[0])),
            "homeostasis moved no weight beyond STDP")

    g = torch.Generator(device="cpu").manual_seed(19)
    gen_u10 = torch.rand((TICKS, SYNFIRE4_X10.n_stim), generator=g)
    x10 = dict(budget=MCU_BUDGET_BYTES, monitor_ms_hint=0)
    cpu = _plastic_run(SYNFIRE4_X10, "fp16", "sparse", gen_u10, cpu_dev, **x10)
    card = _plastic_run(SYNFIRE4_X10, "fp16", "sparse", gen_u10, dev, **x10)
    used = card[0].ledger.total_used
    require(used <= MCU_BUDGET_BYTES, f"plastic x10: ledger {used} > {MCU_BUDGET_BYTES}")
    record("synfire4_x10_plastic/fp16/sparse", card, cpu,
           {"ledger_bytes": used, "budget_bytes": MCU_BUDGET_BYTES})

    for propagation in ("packed", "sparse"):
        key = f"synfire4_plastic/fp16/{propagation}/fused"
        net, sp, final, launches, seconds = _plastic_run(SYNFIRE4, "fp16", propagation,
                                                          gen_u, dev, backend="fused")
        require(not net.static.fused_kernel, f"{key}: plastic net planned as one kernel")
        plain = card_runs[("fp16", propagation)]
        _require_same_raster(sp, plain[1], f"{key} vs the default backend")
        _require_same_plastic_state((net, sp, final), plain, f"{key} vs the default backend")
        want = _plastic_launches(net, TICKS)
        require(launches == want, f"{key}: launches {launches} != {want}")
        _add(totals, launches)
        paths[key] = {"us_per_tick": seconds / TICKS * 1e6, "spikes": int(sp.sum()),
                      "launches": launches, "raster_equals_default_backend": True}
        log(f"[plastic] {key}: no fused_tick launch, raster and weights == default "
            f"backend, {seconds / TICKS * 1e6:.1f} us/tick, launches {launches}")
    return paths


# -- LM serving ----------------------------------------------------------------------

SMOLLM = "smollm-360m"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 512, 32
# Full width, fp16 policy: the logits reach about |5|, where one fp16 ulp
# of a projection input moves a logit by up to about 3e-3 (ROADMAP queue C),
# so card and CPU are held at 4e-3 there and at 1e-4 under fp32.
CARD_VS_CPU_TOL = {"fp32": 1e-4, "fp16": 4e-3}
ATTN_TOL = 1e-5


def _attn_case(g, b, sq, sk, hq, hkv, d, kvdt, dev, invalid=0, shift=0):
    """q, k, v, qpos, kpos on the card in the model's layout: kpos =
    arange(Sk) with the last ``invalid`` slots empty, queries at the end of
    the valid keys moved by ``shift``."""
    q = torch.randn((b, sq, hq, d), generator=g)
    k = torch.randn((b, sk, hkv, d), generator=g).to(kvdt)
    v = torch.randn((b, sk, hkv, d), generator=g).to(kvdt)
    kpos = torch.arange(sk, dtype=torch.int32)
    if invalid:
        kpos[-invalid:] = -1
    qpos = (torch.arange(sq, dtype=torch.int32) + (sk - invalid - sq + shift)).expand(b, sq)
    return [x.contiguous().to(dev) for x in (q, k, v, qpos, kpos)]


def _allowed(qpos, kpos, causal: bool, window: int):
    """[B, Sq, Sk] bool: the keys each query may see."""
    kp, qp = kpos[None, None, :], qpos[:, :, None]
    mask = (kp >= 0).expand(qpos.shape[0], qpos.shape[1], kpos.shape[0])
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & (kp > qp - window)
    return mask


def _attn_row(name, args, causal, window, pallas=False):
    """Check and time one attention case: the kernel against its plain
    version (max abs error, rtol = atol = 1e-5), per-call and device-alone
    time, the plain version's time, one ``scaled_dot_product_attention``
    on the same f32 inputs with the same mask (None where a row sees no
    key: SDPA gives NaN there), and the bound: each input read once and
    the output written once at 3.35 TB/s, or 4 * Hq * D f32 operations per
    allowed (query, key) pair at 67 TFLOP/s, whichever is larger."""
    from repro_torch.kernels import ops, ref

    q, k, v, qpos, kpos = args
    if pallas:  # the Pallas signature: [B, H, S, D] operands
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        run = lambda: ops.flash_attention(qh, kh, vh, causal=causal, window=window)  # noqa: E731
        plain = lambda: ref.flash_attention_ref(qh, kh, vh, causal=causal, window=window)  # noqa: E731
        got, want = run().transpose(1, 2), plain().transpose(1, 2)
    else:
        run = lambda: ops.attention(q, k, v, qpos, kpos, causal=causal, window=window)  # noqa: E731
        plain = lambda: ref.chunked_attention_ref(q, k, v, qpos, kpos, causal=causal,  # noqa: E731
                                                  window=window)
        got, want = run(), plain()
    torch.cuda.synchronize()
    err = max_err(got, want)
    require(torch.allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL),
            f"flash_attention {name}: max abs err {err} against its plain version")
    allowed = _allowed(qpos, kpos, causal, window)
    empty = ~allowed.any(dim=-1)  # [B, Sq]
    if bool(empty.any()):
        require(bool((got[empty] == 0).all()), f"flash_attention {name}: a row with no "
                "allowed key is not 0")
    b, sq, hq, d = q.shape
    pairs = int(allowed.sum())
    b_ms, b_by = bound(nbytes(q, k, v, qpos, kpos) + nbytes(got), 4 * hq * d * pairs)
    library = None
    if not bool(empty.any()):
        qt, kt, vt = (x.float().transpose(1, 2).contiguous() for x in (q, k, v))
        mask = allowed[:, None]
        library = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), reps=50)
    row = {"case": name, "shape": f"q {list(q.shape)} kv {list(k.shape)} "
           f"{str(k.dtype).removeprefix('torch.')} causal={causal} window={window}"
           + (" (Pallas signature)" if pallas else ""),
           "max_abs_err": err, "allowed_pairs": pairs, "empty_rows": int(empty.sum()),
           "ms": cuda_ms(run, reps=50), "device_ms": device_ms(run, "flash_attn_kernel", reps=50),
           "plain_ms": cuda_ms(plain, reps=20, warmup=3), "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": library}
    lib = "-" if library is None else f"{library * 1e3:.2f} us"
    log(f"[lm] flash_attention {name} ({row['shape']}): max abs err {err:.3g}, "
        f"{row['ms'] * 1e3:.2f} us per call ({row['device_ms'] * 1e3:.2f} us on the device), "
        f"plain {row['plain_ms'] * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({b_by}), SDPA {lib}")
    return row


def _check_attention(dev) -> dict:
    """Phase 6a; returns the kernel's row (its numbers: the decode case,
    992 of the serve path's 1,024 launches) with every case under
    ``cases``."""
    g = torch.Generator(device="cpu").manual_seed(23)
    f16, f32, bf16 = torch.float16, torch.float32, torch.bfloat16
    cases = [
        ("smollm prefill", _attn_case(g, 4, 512, 512, 15, 5, 64, f32, dev), True, -1, False),
        ("smollm decode, 544-slot fp16 cache, 32 empty",
         _attn_case(g, 4, 1, 544, 15, 5, 64, f16, dev, invalid=32), True, -1, False),
        ("smollm prefill, window 64", _attn_case(g, 4, 512, 512, 15, 5, 64, f32, dev),
         True, 64, False),
        ("Pallas signature [1,4,256,64], fp16 KV",
         _attn_case(g, 1, 256, 256, 4, 2, 64, f16, dev), True, -1, True),
        ("D 128, group 4 (qwen2.5/minitron heads)",
         _attn_case(g, 2, 256, 256, 8, 2, 128, f16, dev), True, -1, False),
        ("D 160, group 4 (stablelm heads)", _attn_case(g, 2, 256, 256, 8, 2, 160, f32, dev),
         True, -1, False),
        ("D 16, group 4 (reduced)", _attn_case(g, 2, 64, 64, 4, 1, 16, bf16, dev),
         True, -1, False),
        ("rows with no allowed key", _attn_case(g, 2, 40, 40, 6, 2, 64, f32, dev, shift=-8),
         True, -1, False),
    ]
    rows = [_attn_row(name, args, causal, window, pallas)
            for name, args, causal, window, pallas in cases]
    main = rows[1]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/flash_attn.py:70",
            "shape": main["shape"], "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
            "cases": rows}


def _card_vs_cpu(dev, policy_name: str) -> dict:
    """Phase 6c: smollm-360m at full width cut to 2 layers, the same
    weights on the card and the CPU, a [2, 64] prompt and 8 greedy steps."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import tasks
    from repro_torch.models import transformer as tf
    from repro_torch.precision import get_policy

    cfg = dataclasses.replace(get_arch(SMOLLM), n_layers=2)
    policy = get_policy(policy_name)
    toks = torch.from_numpy(np.random.default_rng(29).integers(0, cfg.vocab_size, (2, 64)))
    errs, runs = [], []
    for where in (dev, torch.device("cpu")):
        model = tf.init_params(cfg, policy, seed=31, device=where)
        prefill = tasks.make_prefill_step(cfg, policy, collect_cache=True, cache_len=72)
        decode = tasks.make_decode_step(cfg, policy)
        with torch.inference_mode():
            out, cache = prefill(model, {"tokens": toks.to(where)})
            steps = [out.cpu()]
            for i in range(8):
                token = out.argmax(dim=-1)[:, None]
                out, cache = decode(model, cache, token, 64 + i)
                steps.append(out.cpu())
        runs.append(steps)
    tol = CARD_VS_CPU_TOL[policy_name]
    for i, (a, b) in enumerate(zip(*runs)):
        errs.append(max_err(a, b))
        require(torch.allclose(a, b, rtol=0, atol=tol) if policy_name == "fp16" else
                torch.allclose(a, b, rtol=tol, atol=tol),
                f"card vs CPU {policy_name} step {i}: max abs err {errs[-1]}")
        require(torch.equal(a.argmax(-1), b.argmax(-1)),
                f"card vs CPU {policy_name} step {i}: greedy tokens differ")
    log(f"[lm] card vs CPU port, {SMOLLM} full width 2 layers {policy_name}: prefill + 8 "
        f"decode steps, max abs logit err {max(errs):.3g} (tolerance {tol}), greedy tokens "
        f"equal")
    return {"max_abs_err_per_step": errs, "tolerance": tol, "tokens_equal": True}


def _profile_decode(model, cfg, policy, dev, steps: int = 5) -> dict:
    """Phase 6e: ``steps`` decode steps of the served batch under
    ``torch.profiler`` (after a 512-token prefill and two warm steps)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import tasks

    toks = torch.from_numpy(np.random.default_rng(37).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to(dev)
    prefill = tasks.make_prefill_step(cfg, policy, collect_cache=True,
                                      cache_len=LM_PROMPT + LM_GEN)
    decode = tasks.make_decode_step(cfg, policy)
    with torch.inference_mode():
        logits, cache = prefill(model, {"tokens": toks})
        pos = LM_PROMPT
        for _ in range(2):
            logits, cache = decode(model, cache, logits.argmax(-1)[:, None], pos)
            pos += 1
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = decode(model, cache, logits.argmax(-1)[:, None], pos)
                pos += 1
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end, by_name = 0.0, float("-inf"), {}
    for s0, s1, name in spans:
        busy += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
        name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
        name = name.split("(")[0][:100]
        by_name[name] = by_name.get(name, 0.0) + (s1 - s0)
    attn = sum(1 for sp in spans if "flash_attn_kernel" in sp[2])
    require(attn == steps * cfg.n_layers, f"profile: {attn} attention launches in {steps} "
            f"decode steps, want {steps * cfg.n_layers}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"device_events": len(spans), "device_events_per_step": len(spans) / steps,
           "device_busy_us_per_step": busy / steps, "host_us_per_step_profiled": wall_us / steps,
           "idle_share": 1.0 - busy / wall_us,
           "device_us_per_step_by_kernel": {n: t / steps for n, t in top}}
    log(f"[lm] profile {steps} decode steps: {len(spans) / steps:.0f} device events per step, "
        f"busy {busy / steps:.1f} us/step of {wall_us / steps:.1f} us/step wall (idle share "
        f"{1.0 - busy / wall_us:.3f}); largest: "
        + ", ".join(f"{n} {t / steps:.1f} us" for n, t in top[:5]))
    return out


def phase_lm(dev, totals: dict) -> tuple[dict, dict]:
    """Phase 6: the attention kernel's checks and row, smollm-360m served at
    full width (the main path: launches counted), card against CPU, prefill
    against decode at full depth, and a decode profile. Returns (the
    kernel's row, paths)."""
    import numpy as np

    from repro_torch.configs import count_params, get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import tasks
    from repro_torch.models import transformer as tf
    from repro_torch.precision import get_policy, tree_bytes

    log(f"[lm] torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"float32 matmul precision {torch.get_float32_matmul_precision()!r}")
    row = _check_attention(dev)
    paths = {}

    cfg, policy = get_arch(SMOLLM), get_policy("fp16")
    t0 = time.perf_counter()
    model = tf.init_params(cfg, policy, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = tree_bytes(list(model.parameters()))
    n_params = sum(p.numel() for p in model.parameters())
    kw = dict(batch=LM_BATCH, prompt_len=LM_PROMPT, reduced=False, params=model, device=dev)
    serve(SMOLLM, gen=4, **kw)  # warm-up (cuBLAS handles, allocator)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    out = serve(SMOLLM, gen=LM_GEN, **kw)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    want = {k: 0 for k in launches}
    want["flash_attention"] = cfg.n_layers * LM_GEN  # 1 prefill + 31 decode steps
    require(launches == want, f"serve launches {launches} != {want}")
    _add(totals, launches)
    tokens = out["tokens"]
    require(tokens.shape == (LM_BATCH, LM_GEN) and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.vocab_size, f"served tokens {tokens.shape}")
    cap = LM_PROMPT + LM_GEN
    kv_bytes = cfg.n_layers * 2 * LM_BATCH * cap * cfg.n_kv_heads * cfg.head_dim * 2
    pos_bytes = cfg.n_layers * cap * 4
    step_ms = out["decode_s"] / (LM_GEN - 1) * 1e3
    paths["lm/smollm-360m/serve/fp16"] = {
        "batch": LM_BATCH, "prompt_len": LM_PROMPT, "gen": LM_GEN,
        "prefill_ms": out["prefill_s"] * 1e3, "decode_ms_per_step": step_ms,
        "decode_tok_s": out["decode_tok_s"],
        "prefill_tok_s": LM_BATCH * LM_PROMPT / out["prefill_s"],
        "params": n_params, "count_params": count_params(cfg), "param_bytes": param_bytes,
        "kv_cache_bytes": kv_bytes, "kv_pos_bytes": pos_bytes, "peak_device_bytes": peak,
        "init_s": init_s, "launches": launches, "tokens_row0": tokens[0].tolist()}
    log(f"[lm] serve {SMOLLM} full width (32 layers) fp16, batch {LM_BATCH}, prompt "
        f"{LM_PROMPT}, gen {LM_GEN}: prefill {out['prefill_s'] * 1e3:.1f} ms, decode "
        f"{step_ms:.2f} ms/step, {out['decode_tok_s']:.1f} tok/s; {n_params} parameters "
        f"({count_params(cfg)} counted without the final norm) in {param_bytes} B, KV cache "
        f"{kv_bytes} B + pos {pos_bytes} B, peak device memory {peak} B; launches {launches}")

    for policy_name in ("fp32", "fp16"):
        paths[f"lm/smollm-360m-2l/card_vs_cpu/{policy_name}"] = _card_vs_cpu(dev, policy_name)

    # Prefill against decode at full depth (the reference's test_archs check).
    toks = torch.from_numpy(np.random.default_rng(41).integers(0, cfg.vocab_size, (1, 8))).to(dev)
    with torch.inference_mode():
        logits_p = tasks.make_prefill_step(cfg, policy)(model, {"tokens": toks})
        cache = tf.init_cache(cfg, 1, 16, policy.state_storage, dev)
        step = tasks.make_decode_step(cfg, policy)
        for pos in range(8):
            logits_d, cache = step(model, cache, toks[:, pos:pos + 1], pos)
    err = max_err(logits_p, logits_d)
    require(bool(torch.isfinite(logits_d).all()) and torch.allclose(
        logits_p, logits_d, rtol=5e-2, atol=5e-2),
            f"prefill vs decode at full depth: max abs err {err}")
    paths["lm/smollm-360m/prefill_vs_decode/fp16"] = {"max_abs_err": err, "tolerance": 5e-2}
    log(f"[lm] prefill vs token-by-token decode, {SMOLLM} 32 layers fp16: max abs logit "
        f"err {err:.3g} (tolerance 5e-2)")

    paths["profile/lm/smollm-360m/decode/fp16"] = _profile_decode(model, cfg, policy, dev)
    return row, paths


def phase_profile(dev) -> dict:
    """Device busy time per tick and idle share of the Synfire4 fp16 tick,
    from a ``torch.profiler`` trace of 100 ticks per propagation mode and
    backend: busy is the union of the device's activity intervals, idle
    share is 1 - busy / host wall time (the profiler's own host cost
    included, so idle reads high). On the fused path it also counts the
    device events from the first ``fused_tick`` launch to the last: one
    per tick."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, build_synfire
    from repro_torch.core.engine import run

    out = {}
    ticks = 100
    for propagation, backend, stdp in (
            ("packed", None, None), ("sparse", None, None), ("packed", "fused", None),
            ("sparse", "fused", None), ("packed", None, CHAIN_STDP),
            ("sparse", None, CHAIN_STDP)):
        net = build_synfire(SYNFIRE4, policy="fp16", propagation=propagation,
                            device=dev, backend=backend, stdp_chain=stdp)
        gu = torch.rand((ticks, SYNFIRE4.n_stim), device=dev)
        run(net.static, net.params, net.state0, 20, gen_u=gu[:20])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(net.static, net.params, net.state0, ticks, gen_u=gu)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events() if e.device_type == DeviceType.CUDA)
        busy, end, by_name = 0.0, float("-inf"), {}
        for s0, s1, name in spans:
            busy += max(0.0, s1 - max(s0, end))
            end = max(end, s1)
            name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0][:100]  # drop the signature
            by_name[name] = by_name.get(name, 0.0) + (s1 - s0)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        key = (f"profile/synfire4{'_plastic' if stdp else ''}/fp16/{propagation}"
               + ("/fused" if backend else ""))
        in_loop = None
        if backend:
            starts = [i for i, sp in enumerate(spans) if "fused_tick_kernel" in sp[2]]
            require(len(starts) == ticks, f"profile {key}: {len(starts)} fused_tick "
                    f"launches in {ticks} ticks")
            in_loop = (starts[-1] - starts[0] + 1) / ticks
            require(in_loop == 1.0, f"profile {key}: {in_loop} device events per tick "
                    "inside the loop, want 1")
        out[key] = {
            "device_events": len(spans),
            "device_events_per_tick_in_loop": in_loop,
            "device_busy_us_per_tick": busy / ticks if spans else None,
            "host_us_per_tick_profiled": wall_us / ticks,
            "idle_share": 1.0 - busy / wall_us if spans else None,
            "device_us_per_tick_by_kernel": {n: t / ticks for n, t in top},
        }
        log(f"[profile] {key}: {len(spans)} device events, busy "
            f"{busy / ticks:.1f} us/tick of {wall_us / ticks:.1f} us/tick wall "
            f"(idle share {1.0 - busy / wall_us:.3f})" if spans else
            f"[profile] {key}: the profiler recorded no "
            "device activity")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    build = phase_build()
    rows = phase_kernels(dev)
    totals = {k: 0 for k in ops.LAUNCHES}
    paths = phase_synfire(dev, totals)
    paths.update(phase_scale(dev, totals))
    paths.update(phase_plastic(dev, totals))
    lm_row, lm_paths = phase_lm(dev, totals)
    rows.append(lm_row)
    paths.update(lm_paths)
    paths.update(phase_profile(dev))
    for r in rows:
        r["launches"] = totals[r["name"]]
        require(r["launches"] > 0, f"{r['name']} never launched on the main path")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"paths": paths, "build": build, "card": smi}))
    log(smi.splitlines()[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
