"""Drive the PyTorch/CUDA port of the SNN simulator on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises, and the script exits non-zero, on any failure):

1. Build ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a (one nvcc per
   source, all at once) and print the compile times and ptxas reports.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes the Synfire4 path gives it, bit for bit where the arithmetic is
   exact and at a stated tolerance for random weights, and time kernel,
   plain version and (where one exists) a single PyTorch library call
   with CUDA events (per call, host enqueue included), and the kernel
   alone on the device with ``torch.profiler``.
3. Run Synfire4 for 1,000 ticks on the card in fp16/fp32 x packed/sparse
   through ``build_synfire`` and ``run``, with the launch counters reset
   just before; check the paper's spike statistics, the launch counts,
   and that the card's raster equals the port's CPU raster for the same
   generator uniforms.
4. Synfire4-mini fp16 packed for 5,000 ticks, once on the card's own
   generator stream and once with injected uniforms against the CPU
   raster (the wave dies out in both), and Synfire4x10 sparse fp16 for
   1,000 ticks (raster against the CPU again); launch counts checked.
5. Profile 100 Synfire4 fp16 ticks per propagation mode with
   ``torch.profiler``: device busy time per tick, the device's idle
   share, and device time by kernel name.

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
    """Mean device time (ms) of the kernels whose name contains
    ``name_part``, per call of ``fn``, from a ``torch.profiler`` trace of
    ``reps`` calls: the kernel alone, without the host's enqueue cost."""
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
    require(len(spans) == reps, f"profiler saw {len(spans)} launches of "
            f"{name_part!r} in {reps} calls")
    return sum(spans) / reps / 1e3


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or float32
    operations over the peak rate, whichever is larger (ms)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


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
    for r in rows:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"
        log(f"[kernels] {r['name']} ({r['shape']}): {r['ms'] * 1e3:.2f} us per call "
            f"({r['device_ms'] * 1e3:.2f} us on the device), plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.4f} us "
            f"({r['bound_by']}), library {lib}")
    return rows


def _card_and_cpu_rasters(cfg, policy, propagation, gen_u, dev, **build_kw):
    """The main path on the card for ``len(gen_u)`` ticks (timed, launch
    counts reset just before) and the same network with the same uniforms
    on the CPU; raises unless the two rasters are equal."""
    from repro_torch.configs.synfire4 import build_synfire
    from repro_torch.core.engine import run
    from repro_torch.kernels import ops

    net = build_synfire(cfg, policy=policy, propagation=propagation, device=dev,
                        **build_kw)
    gu = gen_u.to(dev)
    run(net.static, net.params, net.state0, 20, gen_u=gu[:20])  # warm-up
    torch.cuda.synchronize()
    ticks = gen_u.shape[0]
    ops.reset_launches()
    t0 = time.perf_counter()
    _, out = run(net.static, net.params, net.state0, ticks, gen_u=gu)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    card = out["spikes"].cpu()
    cpu_net = build_synfire(cfg, policy=policy, propagation=propagation,
                            device="cpu", **build_kw)
    _, cpu_out = run(cpu_net.static, cpu_net.params, cpu_net.state0, ticks,
                     gen_u=gen_u.cpu())
    if not torch.equal(card, cpu_out["spikes"]):
        first = int(torch.nonzero((card != cpu_out["spikes"]).any(dim=1))[0])
        raise AssertionError(f"{cfg.name} {policy}/{propagation}: card raster "
                             f"differs from the CPU raster first at tick {first}")
    return net, card, launches, seconds


def phase_synfire(dev, totals: dict) -> dict:
    from repro_torch.configs.synfire4 import SYNFIRE4

    g = torch.Generator(device="cpu").manual_seed(7)
    gen_u = torch.rand((TICKS, SYNFIRE4.n_stim), generator=g)
    paths, counts = {}, {}
    for propagation in ("packed", "sparse"):
        for policy in ("fp16", "fp32"):
            net, sp, launches, seconds = _card_and_cpu_rasters(
                SYNFIRE4, policy, propagation, gen_u, dev)
            for k, v in launches.items():
                totals[k] += v
            kinds = [b.kind for b in net.static.buckets]
            expect = {"izh4_update": TICKS,
                      "syn_matmul": kinds.count("dense") * TICKS,
                      "syn_gather": kinds.count("sparse") * TICKS}
            require(launches == expect, f"launches {launches} != {expect}")
            require(kinds.count("dense" if propagation == "packed" else "sparse")
                    == (8 if propagation == "packed" else 13), f"plan {kinds}")
            total = int(sp.sum())
            rate = total / (net.n_neurons * TICKS) * 1000.0
            require(20_000 <= total <= 33_000, f"{total} spikes outside 20k-33k")
            require(17.0 <= rate <= 29.0, f"mean rate {rate:.2f} Hz outside 17-29")
            counts[(policy, propagation)] = total
            key = f"synfire4/{policy}/{propagation}"
            paths[key] = {"us_per_tick": seconds / TICKS * 1e6, "spikes": total,
                          "rate_hz": rate, "launches": launches,
                          "raster_equals_cpu": True}
            log(f"[synfire4] {policy}/{propagation}: {total} spikes, {rate:.2f} Hz, "
                f"{seconds / TICKS * 1e6:.1f} us/tick, launches {launches}, "
                f"card raster == CPU raster")
        acc = (min(counts[("fp16", propagation)], counts[("fp32", propagation)])
               / max(counts[("fp16", propagation)], counts[("fp32", propagation)]))
        require(acc >= 0.97, f"fp16 spike-count accuracy {acc:.4f} < 0.97")
        paths[f"synfire4/fp16_accuracy/{propagation}"] = acc
    return paths


def phase_scale(dev, totals: dict) -> dict:
    from repro_torch.configs.synfire4 import SYNFIRE4_MINI, SYNFIRE4_X10, build_synfire
    from repro_torch.core.engine import run
    from repro_torch.kernels import ops

    paths = {}
    mini_ticks = 5000
    mini_launches = {"izh4_update": mini_ticks, "syn_matmul": 8 * mini_ticks,
                     "syn_gather": 0}

    def died_out(sp, what):
        total, tail = int(sp.sum()), int(sp[-1000:].sum())
        require(150 <= total <= 900 and tail == 0,
                f"mini {what}: {total} spikes, {tail} in the last second "
                f"(want 150-900, 0)")
        return total, tail

    # The card's own generator stream, as Engine.run draws it by default.
    mini = build_synfire(SYNFIRE4_MINI, policy="fp16", device=dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    _, out = run(mini.static, mini.params, mini.state0, mini_ticks)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    require(launches == mini_launches, f"mini launches {launches} != {mini_launches}")
    for k, v in launches.items():
        totals[k] += v
    total, tail = died_out(out["spikes"], "card stream")
    paths["synfire4_mini/fp16/packed"] = {
        "us_per_tick": seconds / mini_ticks * 1e6, "spikes": total,
        "last_second_spikes": tail, "launches": launches}
    log(f"[mini] {mini_ticks} ticks, card stream: {total} spikes, silent last "
        f"second, {seconds / mini_ticks * 1e6:.1f} us/tick, launches {launches}")

    # Injected uniforms: the card's raster against the CPU's.
    g = torch.Generator(device="cpu").manual_seed(13)
    gen_u = torch.rand((mini_ticks, SYNFIRE4_MINI.n_stim), generator=g)
    _, sp, launches, seconds = _card_and_cpu_rasters(
        SYNFIRE4_MINI, "fp16", "packed", gen_u, dev)
    require(launches == mini_launches, f"mini launches {launches} != {mini_launches}")
    for k, v in launches.items():
        totals[k] += v
    total, tail = died_out(sp, "injected uniforms")
    paths["synfire4_mini/fp16/packed/injected"] = {
        "us_per_tick": seconds / mini_ticks * 1e6, "spikes": total,
        "last_second_spikes": tail, "launches": launches, "raster_equals_cpu": True}
    log(f"[mini] {mini_ticks} ticks, injected uniforms: {total} spikes, silent "
        f"last second, {seconds / mini_ticks * 1e6:.1f} us/tick, launches "
        f"{launches}, card raster == CPU raster")

    g = torch.Generator(device="cpu").manual_seed(11)
    gen_u = torch.rand((TICKS, SYNFIRE4_X10.n_stim), generator=g)
    net, sp, launches, seconds = _card_and_cpu_rasters(
        SYNFIRE4_X10, "fp16", "sparse", gen_u, dev, budget=None, monitor_ms_hint=0)
    for k, v in launches.items():
        totals[k] += v
    rate = int(sp.sum()) / (net.n_neurons * TICKS) * 1000.0
    require(17.0 <= rate <= 29.0, f"x10 mean rate {rate:.2f} Hz outside 17-29")
    x10_launches = {"izh4_update": TICKS, "syn_matmul": 0, "syn_gather": 13 * TICKS}
    require(launches == x10_launches, f"x10 launches {launches} != {x10_launches}")
    paths["synfire4_x10/fp16/sparse"] = {
        "us_per_tick": seconds / TICKS * 1e6, "spikes": int(sp.sum()), "rate_hz": rate,
        "synapse_bytes": net.ledger.synapse_bytes(), "launches": launches,
        "raster_equals_cpu": True}
    log(f"[x10] sparse fp16: {int(sp.sum())} spikes, {rate:.2f} Hz, "
        f"{seconds / TICKS * 1e6:.1f} us/tick, synapse bytes "
        f"{net.ledger.synapse_bytes()}, card raster == CPU raster")
    return paths


def phase_profile(dev) -> dict:
    """Device busy time per tick and idle share of the Synfire4 fp16 tick,
    from a ``torch.profiler`` trace of 100 ticks: busy is the union of the
    device's activity intervals, idle share is 1 - busy / host wall time
    (the profiler's own host cost included, so idle reads high)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core.engine import run

    out = {}
    ticks = 100
    for propagation in ("packed", "sparse"):
        net = build_synfire(SYNFIRE4, policy="fp16", propagation=propagation,
                            device=dev)
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
        key = f"profile/synfire4/fp16/{propagation}"
        out[key] = {
            "device_events": len(spans),
            "device_busy_us_per_tick": busy / ticks if spans else None,
            "host_us_per_tick_profiled": wall_us / ticks,
            "idle_share": 1.0 - busy / wall_us if spans else None,
            "device_us_per_tick_by_kernel": {n: t / ticks for n, t in top},
        }
        log(f"[profile] {propagation}: {len(spans)} device events, busy "
            f"{busy / ticks:.1f} us/tick of {wall_us / ticks:.1f} us/tick wall "
            f"(idle share {1.0 - busy / wall_us:.3f})" if spans else
            f"[profile] {propagation}: the profiler recorded no device activity")
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
