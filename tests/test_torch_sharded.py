"""The LM mesh lowering (A12d) on the CPU: a sharded train step over a
device-list mesh of ``["cpu"] * n`` against the port's single-device step
and the reference's, prefill and decode through ``build_task`` against
single-device serving, the elastic 4x2 -> save/restore -> reshard -> 2x2
run against 6 single-device steps, and ``ckpt.reshard`` 8 -> 4.

Every state starts from the reference's ``init_train_state``, carried over
with ``train_state_from_numpy``, and takes the same numpy tokens.
Tolerances (ROADMAP queue C, slice 19; measured values in the comments):

* sharded against single-device, one step: loss at rtol 1e-5 (the data
  indices' NLL sums added in another order); grad norm at 1e-5 under fp32
  and 1e-4 under fp16 (each data index's gradient rounds to fp16 on its own
  rows, where the single device rounds the whole batch's sum); first
  moments within 1e-4 (fp32) and 5e-3 (fp16) of each leaf's scale (slice
  17's), new masters within ``2 lr_t`` (Adam's sign-like first step).
* against the reference: slice 17's and 18's tolerances, but the fp16 loss
  at 2e-5: on this batch the port's own single-device step lies 1.28e-5
  from the reference (slice 17's cause; 3.3e-6 on slice 17's batch) and
  the sharded step 7e-8 from the port's single-device one.
* serving: prefill and decode are split over ``model`` for every arch
  (``launch/mesh.model_compute``): the prefill's logits and cache within
  2e-3 (its row- and vocab-parallel sums flip fp16 roundings of projection
  inputs, ROADMAP queue C slices 21 and 22; up to 1.42e-3 in
  ``tests/test_torch_tp.py``, 1.95e-3 in ``tests/test_torch_tp_layers.py``),
  the reduced fp16 bound of slice 4. The single-device decode starts from
  the sharded prefill's cache; the split decode steps (the same rank-order
  sums, slice 23) are held at that bound, the hybrid's at its fp16 serving
  bound 4e-3 (slice 18, ``tests/test_torch_archs.py``): 2.64e-3 measured
  here, where the single-device fp16 decode itself lies 2.95e-3 to
  4.02e-3 from an f32 decode of the same weights and the split one
  2.95e-3 to 4.09e-3. The fp32 unsplit batch keeps 1e-5 (fp32 sums move by
  ulps only).
"""
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduce_arch as jreduce
from repro.models import tasks as jtasks
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.precision import get_policy as jpolicy
from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import distributed
from repro_torch.core.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharded as sh
from repro_torch.launch.mesh import NamedSharding, P
from repro_torch.models import tasks
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.precision import get_policy
from repro_torch.precision.policy import tree_leaves

LR = AdamWConfig().lr  # build_task trains at the default, as the reference's cells
B, S, CHUNK = 4, 32, 32
LOSS_RTOL = {"fp32": 1e-5, "fp16": 1e-5}
GNORM_RTOL = {"fp32": 1e-5, "fp16": 1e-4}
MOMENT_TOL = {"fp32": 1e-4, "fp16": 5e-3}
# Against the reference: fp16 2e-5 (the docstring), the hybrid's 5e-5 (slice 18).
REF_LOSS_RTOL = {"fp32": 1e-5, "fp16": 2e-5, ("recurrentgemma-2b", "fp16"): 5e-5}
# The grad norm against the reference as against the port (GNORM_RTOL), but
# granite-moe fp16 on 2x2, split over the model axis: 1.12e-4 on this batch
# (the port's single-device step 2.1e-5 from the reference, the split 9.2e-5
# from that step: fp16 gradients rounded per rank and data index, and fp16
# roundings flipped by the rank-order sums; at most 5.5e-5 over seven other
# batches; ROADMAP queue C, slice 22).
REF_GNORM_RTOL = {("granite-moe-1b-a400m", "fp16"): 2e-4}
SPLIT_SERVE_TOL = 2e-3  # fp16 serving split over `model` (the docstring)
SPLIT_DECODE_TOL = {"recurrentgemma-2b": 4e-3}  # the hybrid's fp16 bound (the docstring)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def kv_layout():
    """Sets ``KV_CACHE_LAYOUT`` for a test and puts the default back."""
    yield lambda layout: meshlib.KV_CACHE_LAYOUT.__setitem__(0, layout)
    meshlib.KV_CACHE_LAYOUT[0] = "headdim"


def _cfgs(arch):
    return jreduce(jget_arch(arch)), configs.reduce_arch(configs.get_arch(arch))


def _mesh(shape, axes=("data", "model")):
    return meshlib.make_host_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _states(arch, pol, seed=0):
    jcfg, pcfg = _cfgs(arch)
    js = jtasks.init_train_state(jcfg, jpolicy(pol), seed=seed)
    return js, train_state_from_numpy(pcfg, jax.tree.map(np.asarray, js), "cpu", pol)


def _tokens(step, b=B, s=S):
    return TokenStream(512, s, b, seed=1).batch(step)["tokens"].numpy().astype(np.int32)


def _pb(tokens):
    return {"tokens": torch.from_numpy(tokens.astype(np.int64))}


def _np(x):
    x = train_state_to_numpy({"x": x})["x"] if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.asarray(x).astype(np.float32)


def _rel(a, b):
    return float(np.abs(_np(a) - _np(b)).max()) / max(float(np.abs(_np(b)).max()), 1e-30)


@functools.lru_cache(maxsize=None)
def _jstep(arch, pol):
    return jax.jit(jtasks.make_train_step(_cfgs(arch)[0], jpolicy(pol), opt_cfg=JAdamW(lr=LR),
                                          ce_chunk=CHUNK))


def _task(arch, pol, mesh, b=B, microbatch=None):
    return tasks.build_task(_cfgs(arch)[1], ShapeConfig("tiny", S, b, "train"), mesh, pol,
                            seq_shard=False, ce_chunk=CHUNK, microbatch=microbatch)


def _single(arch, pol, microbatch=1):
    return tasks.make_train_step(_cfgs(arch)[1], get_policy(pol), opt_cfg=AdamWConfig(lr=LR),
                                 ce_chunk=CHUNK, microbatch=microbatch)


def _check_layout(state, mesh):
    """Every block on its entry's device, of the shape its spec names."""
    specs = tree_leaves(tasks._state_pspecs(state, mesh))
    for x, spec in zip(tree_leaves(state), specs):
        assert isinstance(x, sh.Sharded) and x.spec == spec
        for e in sh.entries(mesh):
            blk = x.blocks[e]
            want = tuple(s.stop - s.start for s in sh.block_slices(x.shape, spec, mesh, e))
            assert blk.device == mesh.devices[e] and tuple(blk.shape) == want


def _compare_states(got, want, pol, what):
    lr_t = LR * 2 / 100  # AdamWConfig's warmup of 100 steps, at step 1
    for name in ("m", "v"):
        tol = MOMENT_TOL[pol] * (2 if name == "v" else 1)
        for a, b in zip(tree_leaves(getattr(got["opt"], name)),
                        tree_leaves(getattr(want["opt"], name))):
            assert _rel(a, b) <= tol, f"{what}: opt.{name} {_rel(a, b)} > {tol}"
    key = "master" if want["master"] is not None else "params"
    for a, b in zip(tree_leaves(got[key]), tree_leaves(want[key])):
        err = float(np.abs(_np(a) - _np(b)).max())
        assert err <= 2 * lr_t + 1e-6, f"{what}: a new master {err} from the other's"
    storage = get_policy(pol).param_storage
    for p, m in zip(tree_leaves(got["params"]), tree_leaves(got[key])):
        assert p.dtype == storage and torch.equal(p, m.to(storage))
    assert int(got["opt"].step) == int(want["opt"].step)
    assert float(got["scale"].scale) == float(want["scale"].scale)


CASES = [
    ("smollm-360m", "fp32", (2, 2)),
    ("smollm-360m", "fp16", (2, 2)),
    ("granite-moe-1b-a400m", "fp16", (2, 2)),  # 8 experts on a 2-way model axis: EP
    ("qwen2-moe-a2.7b", "fp16", (1, 3)),  # 8 experts on a 3-way model axis: TP, dims dropped
    ("recurrentgemma-2b", "fp16", (2, 2)),  # tuple layers
]


@pytest.mark.parametrize("arch,pol,shape", CASES, ids=[f"{a}-{p}-{s[0]}x{s[1]}"
                                                       for a, p, s in CASES])
def test_sharded_step_matches_single_device(arch, pol, shape):
    js, ps = _states(arch, pol)
    toks = _tokens(1)
    js2, jm = _jstep(arch, pol)(js, {"tokens": jnp.asarray(toks)})
    ps2, pm = _single(arch, pol)(ps, _pb(toks))
    mesh = _mesh(shape)
    distributed.reset_collectives()
    ns, sm = _task(arch, pol, mesh).sharded()(ps, _pb(toks))
    masters = ps["master"] if ps["master"] is not None else ps["params"]
    # One reduce-scatter per gradient leaf, and (seq_shard off) one in the
    # backward of each all-gather of the model group's forward: along E
    # before an EP combine, along the width before the RG-LRU's gates.
    cfg = _cfgs(arch)[1]
    ep = cfg.moe is not None and meshlib.expert_parallel(cfg, shape[1])
    gathers = sum(cfg.layer_kind(i) == "rglru" or ep for i in range(cfg.n_layers))
    assert distributed.COLLECTIVES["reduce-scatter"]["count"] == (len(tree_leaves(masters))
                                                                  + gathers * shape[0])
    _check_layout(ns, mesh)
    if arch == "qwen2-moe-a2.7b":
        spec = tasks._state_pspecs(ps, mesh)["master"]["layers"]["moe"]["w_gate"]
        assert spec == P(None, None, "data", None)  # TP's "model" on F (32 % 3) dropped
    if arch == "granite-moe-1b-a400m":
        spec = tasks._state_pspecs(ps, mesh)["master"]["layers"]["moe"]["w_gate"]
        assert spec == P(None, "model", "data", None)  # EP
    for k in ("loss", "grad_norm"):
        assert float(sm[k]) == pytest.approx(float(pm[k]), rel=(
            LOSS_RTOL if k == "loss" else GNORM_RTOL)[pol]), k
    assert float(sm["loss"]) == pytest.approx(
        float(jm["loss"]), rel=REF_LOSS_RTOL.get((arch, pol), REF_LOSS_RTOL[pol]))
    assert float(sm["grad_norm"]) == pytest.approx(
        float(jm["grad_norm"]), rel=REF_GNORM_RTOL.get((arch, pol), GNORM_RTOL[pol]))
    assert float(sm["skipped"]) == float(pm["skipped"]) == 0.0
    assert float(sm["loss_scale"]) == float(pm["loss_scale"])
    _compare_states(sh.gather_tree(ns), ps2, pol, "sharded vs single")


def test_sharded_microbatch_matches_single_device():
    """``microbatch=2`` on 2x2 against the single-device step with two
    microbatches (the same rows in each)."""
    js, ps = _states("smollm-360m", "fp16")
    toks = _tokens(2, b=8)
    ps2, pm = _single("smollm-360m", "fp16", microbatch=2)(ps, _pb(toks))
    ns, sm = _task("smollm-360m", "fp16", _mesh((2, 2)), b=8, microbatch=2).sharded()(
        ps, _pb(toks))
    assert float(sm["loss"]) == pytest.approx(float(pm["loss"]), rel=LOSS_RTOL["fp16"])
    assert float(sm["grad_norm"]) == pytest.approx(float(pm["grad_norm"]), rel=1e-4)
    _compare_states(sh.gather_tree(ns), ps2, "fp16", "microbatch 2")


def test_unsplit_batch_runs_on_one_data_index():
    """A batch of 3 rows on 2 data indices is one data index's (the fitted
    batch spec is whole), and equals the single-device step."""
    _, ps = _states("smollm-360m", "fp32")
    toks = _tokens(3, b=3)
    ps2, pm = _single("smollm-360m", "fp32")(ps, _pb(toks))
    ns, sm = _task("smollm-360m", "fp32", _mesh((2, 2)), b=3).sharded()(ps, _pb(toks))
    assert float(sm["loss"]) == pytest.approx(float(pm["loss"]), rel=1e-6)
    _compare_states(sh.gather_tree(ns), ps2, "fp32", "unsplit")


@pytest.mark.parametrize("layout", ["headdim", "seq"])
@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-2b"])
def test_sharded_prefill_and_decode_match_single_device(arch, layout, kv_layout):
    """Prefill (``build_task``'s prefill cell and the serving prefill with
    its cache) and three decode steps through ``build_task``'s decode cell
    on 2x2, against single-device serving, under both KV layouts."""
    kv_layout(layout)
    cfg, pol = _cfgs(arch)[1], get_policy("fp16")
    tol = SPLIT_SERVE_TOL
    model = tf.init_params(cfg, pol, seed=3, device="cpu")
    params = tf.params_tree(model)
    mesh = _mesh((2, 2))
    toks = torch.from_numpy(_tokens(4, s=16).astype(np.int64))
    prefill = tasks.build_task(cfg, ShapeConfig("p", 16, B, "prefill"), mesh, pol)
    got = sh.gather(prefill.sharded()(params, {"tokens": toks}))
    want = tasks.make_prefill_step(cfg, pol)(model, {"tokens": toks})
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    cap = 24
    single = tasks.make_prefill_step(cfg, pol, collect_cache=True, cache_len=cap)
    sharded = tasks.make_prefill_step(cfg, pol, mesh=mesh, collect_cache=True, cache_len=cap)
    logits, cache = single(model, {"tokens": toks})
    s_logits, s_cache = sharded(params, {"tokens": toks})
    torch.testing.assert_close(sh.gather(s_logits), logits, rtol=tol, atol=tol)
    for a, b in zip(tree_leaves(sh.gather_tree(s_cache)), tree_leaves(cache)):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    # Decode is split over `model` for every arch: single-device decode from
    # the same cache (the sharded prefill's, gathered).
    cache = sh.gather_tree(s_cache)
    decode_task = tasks.build_task(cfg, ShapeConfig("d", cap, B, "decode"), mesh, pol)
    step1 = tasks.make_decode_step(cfg, pol)
    run = decode_task.sharded()
    token = torch.argmax(logits, -1)[:, None]
    tol = SPLIT_DECODE_TOL.get(arch, SPLIT_SERVE_TOL)
    for i in range(3):
        logits, cache = step1(model, cache, token, 16 + i)
        s_logits, s_cache = run(params, s_cache, token, 16 + i)
        torch.testing.assert_close(sh.gather(s_logits), logits, rtol=tol, atol=tol)
        token = torch.argmax(logits, -1)[:, None]
    specs = tree_leaves(meshlib.tree_pspecs(cache, mesh, rule=meshlib.cache_pspec))
    assert [x.spec for x in tree_leaves(s_cache)] == specs


def test_unsplit_serving_batch_on_one_data_index():
    """Prefill and two decode steps of 3 rows on 2x2 (the data axes do not
    divide the batch: one data index serves it, its model ranks assembling
    their KV heads from the cache's model-sharded features) against
    single-device serving."""
    cfg, pol = _cfgs("smollm-360m")[1], get_policy("fp32")
    model = tf.init_params(cfg, pol, seed=4, device="cpu")
    params, mesh = tf.params_tree(model), _mesh((2, 2))
    toks = torch.from_numpy(_tokens(5, b=3, s=16).astype(np.int64))
    logits, cache = tasks.make_prefill_step(cfg, pol, collect_cache=True, cache_len=20)(
        model, {"tokens": toks})
    s_logits, s_cache = tasks.make_prefill_step(cfg, pol, mesh=mesh, collect_cache=True,
                                                cache_len=20)(params, {"tokens": toks})
    torch.testing.assert_close(sh.gather(s_logits), logits, rtol=1e-5, atol=1e-5)
    step, s_step = tasks.make_decode_step(cfg, pol), tasks.make_decode_step(cfg, pol, mesh=mesh)
    token = torch.argmax(logits, -1)[:, None]
    for i in range(2):
        logits, cache = step(model, cache, token, 16 + i)
        s_logits, s_cache = s_step(params, s_cache, token, 16 + i)
        torch.testing.assert_close(sh.gather(s_logits), logits, rtol=1e-5, atol=1e-5)
        token = torch.argmax(logits, -1)[:, None]
    k = s_cache["kv"]["k"]
    assert k.spec == P(None, None, None, None, "model") and k.shape[1] == 3


def test_elastic_train_8_to_4():
    """Train on a 4x2 mesh of 8 entries for 3 steps, save, restore, reshard
    onto a 2x2 mesh of 4 and train 3 more: the losses and the final state
    equal 6 single-device steps (losses at rtol 5e-5, 6.2e-6 measured;
    masters within the sum of the steps' 2 lr_t, 1.1e-5 of 1.6e-4
    measured)."""
    arch, pol = "smollm-360m", "fp16"
    _, ps = _states(arch, pol)
    single = _single(arch, pol)
    s1, losses1 = ps, []
    for i in range(6):
        s1, m = single(s1, _pb(_tokens(10 + i)))
        losses1.append(float(m["loss"]))
    task8 = _task(arch, pol, _mesh((4, 2)))
    state, losses = ps, []
    for i in range(3):
        state, m = task8.sharded()(state, _pb(_tokens(10 + i)))
        losses.append(float(m["loss"]))
    task4 = _task(arch, pol, _mesh((2, 2)))
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 3, state)
        restored = ckpt.restore(d, 3, _states(arch, pol, seed=7)[1])
    state4 = ckpt.reshard(restored, task4.in_shardings[0])
    assert all(x.mesh.size == 4 for x in tree_leaves(state4))
    for i in range(3, 6):
        state4, m = task4.sharded()(state4, _pb(_tokens(10 + i)))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, losses1, rtol=5e-5)  # 6.2e-6 measured
    got = sh.gather_tree(state4)
    budget = sum(2 * LR * min(1.0, (k + 1) / 100) for k in range(1, 7)) + 1e-6
    for a, b in zip(tree_leaves(got["master"]), tree_leaves(s1["master"])):
        assert float(np.abs(_np(a) - _np(b)).max()) <= budget
    assert int(got["opt"].step) == 6


def test_reshard_8_to_4():
    x = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    m8 = meshlib.make_host_mesh((8,), ("model",), devices=["cpu"] * 8)
    m4 = meshlib.make_host_mesh((4,), ("model",), devices=["cpu"] * 4)
    x8 = sh.shard(x, NamedSharding(m8, P("model", None)))
    x4 = ckpt.reshard(x8, NamedSharding(m4, P("model", None)))
    assert torch.equal(sh.gather(x4), x) and x4.blocks.shape == (4,)
    assert all(tuple(b.shape) == (16, 8) for b in x4.blocks.flat)
