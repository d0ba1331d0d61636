"""SNN pod-scale dry-run: the paper's simulator at 1M+ neurons on 256 or 512
entries, counted on the meta device (``repro/launch/dryrun_snn.py``).

One tick of :func:`repro_torch.core.distributed.make_step` (fp16
synapses, the spike-row all-gather) on a mesh of ``meta`` entries over
:func:`~repro_torch.core.distributed.build_sharded`'s ``as_specs`` network:
FLOPs and bytes per entry by :class:`repro_torch.launch.dryrun.OpCounter`
(the busiest entry's), the exchange from the step's own collective count,
and argument bytes from the shards each entry holds. The roofline terms
divide by the card's datasheet figures (``H100_*``).

  python -m repro_torch.launch.dryrun_snn --neurons 1048576
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from repro_torch.core import distributed
from repro_torch.core.distributed import build_sharded, make_step
from repro_torch.launch.dryrun import METHOD, OpCounter
from repro_torch.launch.mesh import make_host_mesh

__all__ = ["run", "main", "H100_FP32_FLOPS", "H100_HBM_BYTES_PER_S", "H100_NVLINK_BYTES_PER_S"]

# Datasheet figures of the NVIDIA H100 80GB HBM3 (SXM; power limit 700 W):
# f32 outside the tensor cores, device memory, and NVLink per direction.
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12
H100_NVLINK_BYTES_PER_S = 450e9


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree if isinstance(t, torch.Tensor))


def run(n_neurons: int, fanin: int, mesh_shape, axes, out: str | None) -> dict:
    """Count one tick on a ``mesh_shape`` mesh of meta entries over ``axes``
    (the neurons shard over the last); write the record to ``out``."""
    mesh = make_host_mesh(mesh_shape, axes, devices=["meta"] * math.prod(mesh_shape))
    axis = axes[-1]
    snn = build_sharded(mesh, axis, n_neurons=n_neurons, fanin=fanin, max_delay=10,
                        as_specs=True)
    k = mesh.shape[axis]
    n_local = snn.n // k
    shards = []
    for s in range(k):
        p = distributed._shard(snn.params, s, n_local, torch.device("meta"))
        v, u = (x.narrow(0, s * n_local, n_local) for x in (snn.state.v, snn.state.u))
        ring = snn.state.ring.narrow(1, s * n_local, n_local).contiguous()
        shards.append((p, v.contiguous(), u.contiguous(), ring))
    key_bytes = _nbytes([snn.state.key])
    arg_bytes = max(_nbytes(p) + _nbytes([v, u, ring]) + key_bytes for p, v, u, ring in shards)
    step = make_step(mesh, axis, snn.ring_len, snn.dt)
    distributed.reset_collectives()
    counter = OpCounter()
    t0 = time.perf_counter()
    with counter:
        step(shards, 0, snn.state.key)
    seconds = time.perf_counter() - t0
    colls = {kind: dict(v) for kind, v in distributed.COLLECTIVES.items()}
    coll_bytes = sum(v["bytes"] for v in colls.values())
    busiest = max((e for e in counter.flops if e is not None), key=lambda e: counter.flops[e])
    flops, nbytes = float(counter.flops[busiest]), float(counter.bytes[busiest])
    rec = {
        "workload": "snn_tick",
        "neurons": snn.n,
        "synapses": snn.n * fanin,
        "mesh": "x".join(map(str, mesh_shape)),
        "devices": mesh.size,
        "method": METHOD,
        "count_s": seconds,
        "flops_per_device": flops,
        "bytes_per_device": nbytes,
        "collective_bytes_per_device": coll_bytes,
        "collectives": colls,
        "memory": {"argument_bytes": arg_bytes, "temp_bytes": None},
        # roofline terms per 1 ms tick, H100 datasheet figures
        "compute_s": flops / H100_FP32_FLOPS,
        "memory_s": nbytes / H100_HBM_BYTES_PER_S,
        "collective_s": coll_bytes / H100_NVLINK_BYTES_PER_S,
    }
    rec["realtime"] = max(rec["compute_s"], rec["memory_s"], rec["collective_s"]) <= 1e-3
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--neurons", type=int, default=1_048_576)
    ap.add_argument("--fanin", type=int, default=60)
    ap.add_argument("--out", default="results_torch/dryrun/snn_pod.json")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    shape = (512,) if args.multi_pod else (256,)
    rec = run(args.neurons, args.fanin, shape, ("model",), args.out)
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
