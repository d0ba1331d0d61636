"""Plastic ``run_batch(1000, 64)`` on the card, for one checkout of the repo.

    python3 scripts/bench_plastic_run_batch.py [--root DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so that
two commits are compared in one call by running it on each in turn
(parent, change, change, parent), each building its kernels in its own
``DIR/build/``. On Synfire4 fp16 sparse (``budget=None``) it times, after
a warm-up, ``REPS`` runs of ``run_batch(1000, 64)`` with the plastic chain
(``CHAIN_STDP``) in turns with as many of the static net (the host's pace,
which the drive does not touch), wall µs per tick and lane-ticks per
second each; then a ``torch.profiler`` trace of a 20-tick plastic
``run_batch`` gives per tick the device time of every kernel and of
``plastic_drive_kernel``. Prints one JSON object as its last line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

LANES, TICKS, REPS, TRACE_TICKS = 64, 1000, 7, 20


def _rates(nets: dict, run_batch) -> dict[str, list[dict]]:
    """``REPS`` timed runs of each net in ``nets``, the nets in turns."""
    for net in nets.values():
        run_batch(net.static, net.params, net.state0, 20, LANES)  # warm-up
    torch.cuda.synchronize()
    out = {name: [] for name in nets}
    for _ in range(REPS):
        for name, net in nets.items():
            t0 = time.perf_counter()
            run_batch(net.static, net.params, net.state0, TICKS, LANES)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            out[name].append({"us_per_tick": seconds / TICKS * 1e6,
                              "lane_ticks_per_s": LANES * TICKS / seconds})
    return out


def _device_per_tick(net, run_batch) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    static, params, state0 = net.static, net.params, net.state0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_batch(static, params, state0, TRACE_TICKS, LANES)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    drive = [e.time_range.elapsed_us() for e in events if "plastic_drive_kernel" in e.name]
    return {"device_us_per_tick": sum(e.time_range.elapsed_us() for e in events) / TRACE_TICKS,
            "drive_us_per_tick": sum(drive) / TRACE_TICKS, "drive_launches": len(drive)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_plastic_run_batch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, build_synfire
    from repro_torch.core import run_batch

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    plastic = build_synfire(SYNFIRE4, policy="fp16", propagation="sparse", device=dev,
                            budget=None, stdp_chain=CHAIN_STDP)
    static = build_synfire(SYNFIRE4, policy="fp16", propagation="sparse", device=dev,
                           budget=None)
    res = {"label": args.label, "root": str(args.root), "card": smi,
           **_rates({"plastic": plastic, "static": static}, run_batch),
           **_device_per_tick(plastic, run_batch)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
