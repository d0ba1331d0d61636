"""Multi-pod dry-run: every (arch x shape x mesh) cell counted on the meta
device (``repro/launch/dryrun.py``).

The reference lowers and compiles each cell with XLA on 256 or 512 forced
host devices and reads ``memory_analysis()``, ``cost_analysis()`` and the
HLO's collectives. Nothing in PyTorch compiles to that. The port's stated
counterpart runs :func:`~repro_torch.models.tasks.build_task`'s step over
the mesh lowering on the production mesh (16 x 16 or 2 x 16 x 16 entries
on ``device="meta"``, where nothing is allocated): one data index
computes and every collective runs, for each data index, on shapes only.

* **FLOPs and bytes**, per mesh entry (the work the lowering runs as that
  entry, :func:`repro_torch.core.distributed.on_entry`), by
  :class:`OpCounter`, a ``TorchDispatchMode`` that sees every aten op of
  the forward, the backward and the recomputed forward: products and
  convolutions by ``torch.utils.flop_counter``'s formulas (2 per
  multiply-add), plus one per output element of an elementwise op or a
  reduction (a reduction's adds are thus counted by its outputs: a lower
  bound); bytes are each op's tensor inputs plus outputs, views excluded.
  ``flops`` and ``bytes_accessed`` are the busiest entry's (a compute
  entry). ``FlopCounterMode`` alone counts no elementwise op, so an SNN
  tick would read 0.
* **Attention on meta** runs the kernels' plain versions (``kernels/ops``
  routes meta tensors there, for counting only), as the reference's
  analysis twins count unchunked XLA attention.
* **Memory.** ``argument_bytes`` and ``output_bytes`` are the plan's: the
  blocks the fullest entry holds (``launch/mesh.held_bytes``; the decode
  position is a host int and holds none). ``activation_bytes`` are the
  tensors saved for the backward on the compute entry
  (``torch.autograd.graph.saved_tensors_hooks``; under remat a block's
  inputs), parameters and views of them not counted. XLA's
  ``temp_bytes`` has no counterpart in eager PyTorch: recorded as null.
  ``working_bytes`` adds the arguments, the saved activations and what the
  fullest compute entry assembles for its compute (``gathered_bytes``:
  ``core/distributed.GATHERED``): its ranges of the parameters (heads,
  ``d_ff``, vocab, experts or ``d_expert``, ``d_shared``, ``d_inner``, the
  RG-LRU's width; every step is split over ``model``, ``model_compute``
  ``"megatron"``), the replicated norms and router, its rows of the batch
  and, under decode, its KV heads' rows of the cache (or its channels of
  the recurrent states) summed over the layers, although each layer's copy
  is freed before the next (an upper bound); ``fits_hbm`` holds it
  against the card's 80 GB. With one data index computing, all of that
  index's model-rank entries compute. One backward call spans a model
  group's entries: :class:`_BackwardEntries` runs each autograd node's
  backward as the entry that made it, and a tensor saved outside any entry
  (remat's block inputs, the loss's chunks) is charged to the entry whose
  op made its storage.
* **Collectives** (``collectives``, ``collective_bytes``) are the
  lowering's own counters (``core/distributed.COLLECTIVES``): per kind the
  calls, and the bytes the entry taking in the most receives over them
  (per device); ``collective_bytes`` adds the kinds.

No analysis twins: counting op by op visits every layer
(``"method": "counted op by op on the meta device"``).

  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from collections import defaultdict

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch
from repro_torch.core import distributed
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharded as sh
from repro_torch.models import mamba as mambalib
from repro_torch.models.tasks import build_task
from repro_torch.precision import get_policy
from repro_torch.precision.policy import tree_leaves

__all__ = ["OpCounter", "run_cell", "count_step", "main", "METHOD", "HBM_BYTES"]

METHOD = "counted op by op on the meta device"
# The card's device memory: NVIDIA H100 80GB HBM3 (datasheet), 700 W.
HBM_BYTES = 80e9
TEMP_NOTE = "XLA's temp buffer has no counterpart in eager PyTorch"

_aten = torch.ops.aten
_REDUCTIONS = {
    _aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max, _aten.min, _aten.prod,
    _aten.logsumexp, _aten._softmax, _aten._log_softmax, _aten.var, _aten.std,
    _aten.linalg_vector_norm, _aten.norm, _aten.cumsum, _aten.cumprod, _aten.all, _aten.any,
    _aten.argmax, _aten.argmin, _aten.embedding_dense_backward,
    _aten._softmax_backward_data, _aten._log_softmax_backward_data,
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Per mesh entry (``distributed.current_entry()``; None outside any):
    ``flops`` by ``torch.utils.flop_counter``'s formulas for products and
    convolutions plus one per output element of elementwise ops and
    reductions, and ``bytes`` as every op's tensor inputs plus outputs,
    views excluded. ``owner`` maps each storage an op made to the entry
    it ran as."""

    def __init__(self):
        super().__init__()
        self.flops: dict = defaultdict(int)
        self.bytes: dict = defaultdict(int)
        self.owner: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        entry = distributed.current_entry()
        packet = func.overloadpacket
        outs = list(_tensors(out))
        if packet in flop_registry:
            self.flops[entry] += int(flop_registry[packet](*args, **kwargs, out_val=out))
        elif torch.Tag.pointwise in func.tags or packet in _REDUCTIONS:
            self.flops[entry] += sum(t.numel() for t in outs)
        if not func.is_view:
            ins = list(_tensors((args, kwargs)))
            self.bytes[entry] += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            read = {t.untyped_storage()._cdata for t in ins}
            for t in outs:
                key = t.untyped_storage()._cdata
                if key not in read:
                    self.owner[key] = entry
        return out


class _BackwardEntries(TorchFunctionMode):
    """Tags the autograd node of every op run as a mesh entry, and the
    untagged nodes behind it (views and casts made outside any entry), to
    run its backward as that entry (:func:`distributed.on_entry`), as its
    forward ran. The backward runs on the calling thread here (``meta``)."""

    def __init__(self, mesh):
        super().__init__()
        self.mesh = mesh

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        entry = distributed.current_entry()
        if entry is not None:
            self._tag([t.grad_fn for t in _tensors(out)], entry)
        return out

    def _tag(self, stack: list, entry: tuple) -> None:
        while stack:
            node = stack.pop()
            if node is None or "entry" in node.metadata or type(node).__name__ == "AccumulateGrad":
                continue
            node.metadata["entry"] = entry
            held: list = []

            def enter(_grads, held=held, entry=entry):
                held.append(distributed.on_entry(self.mesh, entry))
                held[-1].__enter__()

            def leave(_grads_in, _grads_out, held=held):
                held.pop().__exit__(None, None, None)

            node.register_prehook(enter)
            node.register_hook(leave)
            stack.extend(n for n, _ in node.next_functions)


class _Saved:
    """Bytes saved for the backward per entry, each storage once, the
    parameters' storages (autograd leaves) not counted; with ``owner``, a
    tensor saved outside any entry is charged to its storage's owner."""

    def __init__(self, owner: dict | None = None):
        self.bytes: dict = defaultdict(int)
        self._seen: set = set()
        self._owner = owner if owner is not None else {}

    def pack(self, t: torch.Tensor):
        key = t.untyped_storage()._cdata
        if key not in self._seen and not (t.is_leaf and t.requires_grad):
            self._seen.add(key)
            entry = distributed.current_entry()
            if entry is None:
                entry = self._owner.get(key)
            self.bytes[entry] += t.untyped_storage().nbytes()
        return t

    @staticmethod
    def unpack(t):
        return t


def _fullest(per_entry: dict) -> int:
    return max([v for k, v in per_entry.items() if k is not None], default=0)


def _outputs_held(out, mesh) -> dict:
    """Bytes per entry of a step's outputs: Sharded blocks, and plain
    tensors (replicated metrics) on every entry."""
    held = sh.held_bytes(out)
    plain = sum(_nbytes(t) for t in tree_leaves(out) if isinstance(t, torch.Tensor))
    return {e: held.get(e, 0) + plain for e in sh.entries(mesh)}


def count_step(task) -> dict:
    """Run ``task``'s step once on its meta arguments under the counters;
    returns the per-entry flops, bytes and saved bytes, the collectives and
    the plan's argument and output bytes."""
    mesh = tree_leaves(task.in_shardings)[0].mesh
    args = list(task.args)
    if task.kind == "decode":
        args[3] = 0  # the position: a host int
    placed = [a if isinstance(a, int) else sh.shard_tree(a, s)
              for a, s in zip(args, task.in_shardings)]
    arg_held = sh.held_bytes(placed)
    distributed.reset_collectives()
    counter = OpCounter()
    saved = _Saved(counter.owner)
    t0 = time.perf_counter()
    with _BackwardEntries(mesh), counter, torch.autograd.graph.saved_tensors_hooks(
            saved.pack, saved.unpack):
        out = task.fn(*placed)
    seconds = time.perf_counter() - t0
    colls = {k: dict(v) for k, v in distributed.COLLECTIVES.items()}
    busiest = max((k for k in counter.flops if k is not None), key=lambda k: counter.flops[k],
                  default=None)
    return {
        "count_s": seconds,
        "flops": float(counter.flops.get(busiest, 0)),
        "bytes_accessed": float(counter.bytes.get(busiest, 0)),
        "busiest_entry": list(busiest) if busiest is not None else None,
        "memory": {
            "argument_bytes": _fullest(arg_held),
            "output_bytes": _fullest(_outputs_held(out, mesh)),
            "activation_bytes": _fullest(saved.bytes),
            "temp_bytes": None,
            "temp_bytes_note": TEMP_NOTE,
        },
        "collectives": colls,
        "collective_bytes": sum(v["bytes"] for v in colls.values()),
        "gathered_bytes": max(distributed.GATHERED.values(), default=0),
    }


def _should_skip(cfg, shape) -> str | None:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("pure full-attention arch: 500k decode is quadratic-cost/"
                "full-KV; skipped per assignment (see DESIGN.md §5)")
    return None


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str, *,
             policy_name: str = "fp16", seq_shard: bool = True, microbatch: int = 1,
             force: bool = False, kv_layout: str = "headdim", ssm_chunk: int = 0,
             cfg=None, shape=None, mesh=None) -> dict:
    """Count one cell and write its record to ``out_dir``
    (``<arch>__<shape>__<mesh>.json``; an existing record is returned
    unless ``force``). ``cfg``, ``shape`` and ``mesh`` override the named
    ones (the tests' reduced cells on small meta meshes)."""
    meshlib.KV_CACHE_LAYOUT[0] = kv_layout
    mambalib.set_ssm_chunk(ssm_chunk)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = cfg or get_arch(arch)
    shape = shape or SHAPES[shape_name]
    record: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "policy": policy_name,
        "kind": shape.kind, "kv_layout": kv_layout, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch, "method": METHOD,
    }
    skip = _should_skip(cfg, shape)
    if skip:
        record["status"] = "skipped"
        record["reason"] = skip
        _write(path, record)
        return record
    mesh = mesh or meshlib.make_production_mesh(multi_pod=(mesh_kind == "multi"))
    try:
        task = build_task(cfg, shape, mesh, get_policy(policy_name), seq_shard=seq_shard,
                          microbatch=microbatch)
        prod = count_step(task)
        record["production"] = prod
        record["n_devices"] = mesh.size
        record["model_compute"] = task.model_compute
        record["seq_shard"] = seq_shard
        mem = prod["memory"]
        # What the compute entry holds at once: its blocks, what it gathers
        # (the storage-dtype params or their ranges, its rows of the batch
        # or the cache) and the saved activations.
        record["working_bytes"] = (mem["argument_bytes"] + mem["activation_bytes"]
                                   + prod["gathered_bytes"])
        record["fits_hbm"] = record["working_bytes"] <= HBM_BYTES
        record["status"] = "ok"
    except Exception as e:  # record the failure: these are bugs to fix
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    finally:
        meshlib.KV_CACHE_LAYOUT[0] = "headdim"
        mambalib.set_ssm_chunk(0)
    _write(path, record)
    return record


def _write(path: str, record: dict) -> None:
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all", help="arch id or 'all' (comma lists ok)")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results_torch/dryrun")
    ap.add_argument("--policy", default="fp16")
    ap.add_argument("--no-analysis", action="store_true",
                    help="accepted for the reference's command line; the count needs no twins")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--kv-layout", default="headdim", choices=["headdim", "seq"])
    ap.add_argument("--ssm-chunk", type=int, default=0)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    archs = list(ARCH_NAMES) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    t0 = time.time()
    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                rec = run_cell(arch, shape, mesh_kind, args.out, policy_name=args.policy,
                               seq_shard=not args.no_seq_shard, microbatch=args.microbatch,
                               kv_layout=args.kv_layout, ssm_chunk=args.ssm_chunk,
                               force=args.force)
                status = rec["status"]
                n_ok += status == "ok"
                n_skip += status == "skipped"
                n_err += status == "error"
                extra = ""
                if status == "ok":
                    mem = rec["production"]["memory"]
                    colls = " ".join(f"{k}={v['bytes'] / 2**30:.2f}GiB" for k, v in
                                     sorted(rec["production"]["collectives"].items()))
                    extra = (f"{rec['model_compute']} "
                             f"args={mem['argument_bytes'] / 2**30:.2f}GiB "
                             f"gathered={rec['production']['gathered_bytes'] / 2**30:.2f}GiB "
                             f"saved={mem['activation_bytes'] / 2**30:.2f}GiB "
                             f"working={rec['working_bytes'] / 1e9:.1f}GB "
                             f"flops={rec['production']['flops']:.3e} {colls} "
                             f"count={rec['production']['count_s']:.0f}s")
                elif status == "error":
                    extra = rec["error"][:120]
                print(f"[{time.time() - t0:7.0f}s] {arch:24s} {shape:12s} "
                      f"{mesh_kind:6s} {status:8s} {extra}", flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors in {time.time() - t0:.0f}s")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
