"""The dry-runs on the meta device (``repro_torch/launch/dryrun.py``,
``dryrun_snn.py``): one reduced cell per kind on a small meta mesh with
the reference's record keys; the op counter's product FLOPs against a
hand count; the argument and collective bytes against what the CPU
lowering holds and copies for the same cell (its counters); ``_should_skip``
against the reference on all 10 x 4 cells; ``dryrun_snn``'s per-device
argument bytes against the plan's."""
import json

import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, SHAPES as JSHAPES, get_arch as jget_arch
from repro_torch.configs import SHAPES, get_arch, reduce_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import distributed
from repro_torch.launch import dryrun, dryrun_snn
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharded as sh
from repro_torch.models import tasks
from repro_torch.models import transformer as tf
from repro_torch.precision import get_policy

CELLS = {"train": ShapeConfig("t", 32, 4, "train"), "prefill": ShapeConfig("p", 32, 4, "prefill"),
         "decode": ShapeConfig("d", 40, 4, "decode")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _reference_skip():
    import pathlib

    # The reference's dry-run sets XLA_FLAGS when imported; its _should_skip
    # is read from its source instead.
    src = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro" / "launch" / "dryrun.py"
    text = src.read_text()
    body = text[text.index("def _should_skip"):text.index("def _compile_stats")]
    scope: dict = {}
    exec(body, scope)
    return scope["_should_skip"]


def _tokens(g, cfg, shape):
    """int32 tokens, the dtype of the cells' inputs."""
    return torch.randint(0, cfg.vocab_size, shape, generator=g, dtype=torch.int32)


def test_should_skip_matches_reference():
    ref = _reference_skip()
    for arch in ARCH_NAMES:
        for name in JSHAPES:
            assert dryrun._should_skip(get_arch(arch), SHAPES[name]) == ref(
                jget_arch(arch), JSHAPES[name]), (arch, name)


def test_product_flops_hand_count():
    a, b = torch.empty((6, 8), device="meta"), torch.empty((8, 5), device="meta")
    x, w = torch.empty((3, 7, 8), device="meta"), torch.empty((4, 8), device="meta")
    c = torch.empty((2, 3, 10), device="meta")
    k = torch.empty((4, 3, 3), device="meta")
    counter = dryrun.OpCounter()
    with counter:
        y = a @ b  # 2 * 6 * 8 * 5
        torch.nn.functional.linear(x, w)  # 2 * 21 * 8 * 4
        torch.bmm(torch.empty((5, 2, 3), device="meta"), torch.empty((5, 3, 4), device="meta"))
        torch.nn.functional.conv1d(c, k)  # 2 * (2 * 4 * 8) * 3 * 3
        z = y + 1.0  # 30 elementwise
        z.sum()  # one output element
    want = 2 * 6 * 8 * 5 + 2 * 21 * 8 * 4 + 2 * 5 * 2 * 3 * 4 + 2 * 2 * 4 * 8 * 3 * 3 + 30 + 1
    assert counter.flops[None] == want


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m"])
def test_reduced_cell_matches_cpu_lowering(kind, arch, tmp_path):
    """The dry-run's record on a 2x2 meta mesh: the reference's keys; its
    argument bytes and collectives equal the CPU lowering's own counters
    for the same cell on ``["cpu"] * 4``."""
    cfg, shape = reduce_arch(get_arch(arch)), CELLS[kind]
    meta = meshlib.make_host_mesh((2, 2), devices=["meta"] * 4)
    rec = dryrun.run_cell(arch, shape.name, "tiny", str(tmp_path), cfg=cfg, shape=shape,
                          mesh=meta)
    assert rec["status"] == "ok", rec.get("traceback")
    assert json.loads((tmp_path / f"{arch}__{shape.name}__tiny.json").read_text()) == rec
    for key in ("arch", "shape", "mesh", "policy", "kind", "kv_layout", "seq_len",
                "global_batch", "status", "production", "n_devices"):
        assert key in rec
    prod = rec["production"]
    for key in ("flops", "bytes_accessed", "memory", "collectives", "collective_bytes"):
        assert key in prod
    for key in ("argument_bytes", "output_bytes", "temp_bytes"):
        assert key in prod["memory"]
    assert prod["memory"]["temp_bytes"] is None and rec["method"] == dryrun.METHOD
    assert prod["flops"] > 0 and prod["bytes_accessed"] > 0
    assert (prod["memory"]["activation_bytes"] > 0) == (kind == "train")

    # the same cell lowered on the CPU, with tensors
    cpu = meshlib.make_host_mesh((2, 2), devices=["cpu"] * 4)
    policy = get_policy("fp16")
    task = tasks.build_task(cfg, shape, cpu, policy)
    g = torch.Generator().manual_seed(0)
    if kind == "train":
        args = [tasks.init_train_state(cfg, policy, seed=0, device="cpu"),
                {"tokens": _tokens(g, cfg, (4, 32))}]
    else:
        params = tf.params_tree(tf.init_params(cfg, policy, device="cpu"))
        if kind == "prefill":
            args = [params, {"tokens": _tokens(g, cfg, (4, 32))}]
        else:
            cache = tf.init_cache(cfg, 4, 40, policy.state_storage, "cpu")
            args = [params, cache, _tokens(g, cfg, (4, 1)), 3]
    placed = [a if isinstance(a, int) else sh.shard_tree(a, s)
              for a, s in zip(args, task.in_shardings)]
    held = sh.held_bytes(placed)
    assert max(held.values()) == prod["memory"]["argument_bytes"]
    distributed.reset_collectives()
    task.fn(*placed)
    assert {k: dict(v) for k, v in distributed.COLLECTIVES.items()} == prod["collectives"]
    assert sum(v["bytes"] for v in distributed.COLLECTIVES.values()) == prod["collective_bytes"]


def test_snn_dryrun_argument_bytes_match_plan(tmp_path):
    """1,024 neurons, fan-in 8, on 8 meta entries: per device the shard's
    parameters, state and ring (128 neurons) plus the shared key; one
    all-gather of the other 7 shards' spike rows."""
    rec = dryrun_snn.run(1024, 8, (8,), ("model",), str(tmp_path / "snn.json"))
    n = 128
    per_neuron = 4 * 4 + 1 + 3 * 4 + 8 * (4 + 2 + 4) + 2 * 2 + 11 * 2
    assert rec["memory"]["argument_bytes"] == n * per_neuron + 8
    assert rec["collectives"] == {"all-gather": {"count": 1, "bytes": 7 * n}}
    assert rec["flops_per_device"] > 0 and rec["method"] == dryrun.METHOD
    assert rec["compute_s"] == rec["flops_per_device"] / 67e12
    assert json.loads((tmp_path / "snn.json").read_text())["neurons"] == 1024
    assert np.isclose(rec["collective_s"], 7 * n / 450e9)
