"""Model-axis compute in the LM mesh lowering (A12e, part 1) on the CPU:
the Megatron splits of attention, the dense MLP and the vocabulary over a
mesh's ``model`` axis, in the train step and in prefill, over device-list
meshes of ``["cpu"] * n``.

Every state starts from the reference's ``init_train_state`` (carried over
with ``train_state_from_numpy``) and every batch from the same numpy rows.
The split step is held against the port's single-device step and against
the reference's jitted single-device step (the counterpart of the
reference's ``tests/test_distributed.py::test_dp_tp_lm_matches_single_device``,
2x2 with ``seq_shard=False``, loss within 1e-3 there). Tolerances (ROADMAP
queue C, slice 21; the largest measured value over the cases in the
comments): the row- and vocab-parallel sums and the data indices' sums run
in another order than one matmul and one device's batch, which moves f32
sums by ulps and, under fp16, flips the fp16 rounding of some projection
inputs. So, as slice 19's data-parallel step: loss at rtol 1e-5 (2.9e-6
measured), grad norm at 1e-5 under fp32 and 1e-4 under fp16 (6.2e-5),
first moments within 1e-4 (fp32, 1.2e-6) and 5e-3 (fp16, 1.2e-3) of each
leaf's scale, new masters within ``2 lr_t`` (Adam's sign-like first step);
against the reference the loss at 2e-5 (slice 19's; 7.0e-6 measured) and
the grad norm as against the port (4.2e-5).
Served logits within 1e-5 under fp32 (1.8e-6) and 2e-3 under fp16
(1.42e-3; slice 4's reduced fp16 bound). ``python tests/test_torch_tp.py``
prints these measured values. ``seq_shard`` True and False bit for bit;
a ``model`` axis of size 1 against the single-device step at the
data-parallel tolerances. The MoE, Mamba and RG-LRU splits are
``tests/test_torch_tp_layers.py``'s.
"""
import functools

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
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import distributed
from repro_torch.core.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharded as sh
from repro_torch.models import tasks
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.precision import get_policy
from repro_torch.precision.policy import tree_leaves

LR = AdamWConfig().lr  # build_task trains at the default, as the reference's cells
B, S, CHUNK = 4, 32, 16
LOSS_RTOL = 1e-5
GNORM_RTOL = {"fp32": 1e-5, "fp16": 1e-4}
MOMENT_TOL = {"fp32": 1e-4, "fp16": 5e-3}
REF_LOSS_RTOL = 2e-5
SERVE_TOL = {"fp32": 1e-5, "fp16": 2e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch):
    return jreduce(jget_arch(arch)), configs.reduce_arch(configs.get_arch(arch))


def _mesh(shape):
    return meshlib.make_host_mesh(shape, devices=["cpu"] * int(np.prod(shape)))


def _batch(cfg, b=B, seed=1):
    """Numpy tokens (and under the vision frontend bf16 patch embeddings and
    M-RoPE positions, as the reference's ``test_archs._batch``)."""
    rng = np.random.default_rng(seed)
    p = cfg.n_patches if cfg.frontend == "vision" else 0
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, S - p)).astype(np.int32)}
    if p:
        batch["patch_embeds"] = np.asarray(jnp.asarray(rng.normal(size=(b, p, cfg.d_model)),
                                                       jnp.bfloat16))
        pos = np.zeros((b, S, 3), np.int32)
        for i in range(p):
            pos[:, i] = (0, i // 4, i % 4)
        pos[:, p:] = np.arange(1, S - p + 1)[None, :, None] + 1
        batch["positions"] = pos
    return batch


def _pb(batch):
    out = {"tokens": torch.from_numpy(batch["tokens"].astype(np.int64))}
    if "patch_embeds" in batch:
        out["patch_embeds"] = torch.from_numpy(batch["patch_embeds"].astype(np.float32))
        out["positions"] = torch.from_numpy(batch["positions"])
    return out


def _np(x):
    x = train_state_to_numpy({"x": x})["x"] if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.asarray(x).astype(np.float32)


def _rel(a, b):
    return float(np.abs(_np(a) - _np(b)).max()) / max(float(np.abs(_np(b)).max()), 1e-30)


def _states(arch, pol):
    jcfg, pcfg = _cfgs(arch)
    js = jtasks.init_train_state(jcfg, jpolicy(pol), seed=0)
    return js, train_state_from_numpy(pcfg, jax.tree.map(np.asarray, js), "cpu", pol)


@functools.cache
def _singles(arch, pol):
    """(the reference's metrics, the port's new state and metrics) of one
    single-device step."""
    jcfg, pcfg = _cfgs(arch)
    js, ps = _states(arch, pol)
    batch = _batch(pcfg)
    jstep = jax.jit(jtasks.make_train_step(jcfg, jpolicy(pol), opt_cfg=JAdamW(lr=LR),
                                           ce_chunk=CHUNK))
    _, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
    ps2, pm = tasks.make_train_step(pcfg, get_policy(pol), ce_chunk=CHUNK)(ps, _pb(batch))
    return jm, ps2, pm


def _split_step(arch, pol, shape, seq_shard):
    cfg = _cfgs(arch)[1]
    task = tasks.build_task(cfg, ShapeConfig("tiny", S, B, "train"), _mesh(shape), pol,
                            seq_shard=seq_shard, ce_chunk=CHUNK)
    assert task.model_compute == "megatron"
    _, ps = _states(arch, pol)
    distributed.reset_collectives()
    return task.sharded()(ps, _pb(_batch(cfg)))


def _bitwise(a, b) -> list:
    """The key paths of the leaves where two trees differ."""
    return [k for (k, x), y in zip(meshlib.key_paths(a), tree_leaves(b)) if not torch.equal(x, y)]


CASES = [
    ("smollm-360m", "fp32", (2, 2)),
    ("smollm-360m", "fp16", (2, 2)),  # m = 2 > the reduced smollm's 1 KV head
    ("smollm-360m", "fp16", (1, 3)),  # uneven ranges of heads, d_ff and vocab
    ("qwen2.5-14b", "fp16", (2, 2)),  # QKV biases
    ("qwen2.5-14b", "fp16", (1, 3)),
    ("musicgen-large", "fp16", (2, 2)),  # MHA: whole KV groups; sinusoids, LayerNorm
    ("musicgen-large", "fp16", (1, 3)),  # 4 KV groups on 3 ranks: 2 + 1 + 1
    ("qwen2-vl-2b", "fp16", (2, 2)),  # patches and M-RoPE
    ("qwen2-vl-2b", "fp16", (1, 3)),
    ("minitron-8b", "fp16", (1, 3)),  # relu2
    ("stablelm-12b", "fp32", (1, 3)),  # partial rotary, LayerNorm biases
]


@pytest.mark.parametrize("arch,pol,shape", CASES,
                         ids=[f"{a}-{p}-{s[0]}x{s[1]}" for a, p, s in CASES])
def test_split_train_step_matches_single_device_and_reference(arch, pol, shape):
    jm, ps2, pm = _singles(arch, pol)
    ns, sm = _split_step(arch, pol, shape, seq_shard=True)
    assert distributed.COLLECTIVES["all-reduce"]["count"] > 0  # the model-group sums
    assert float(sm["loss"]) == pytest.approx(float(pm["loss"]), rel=LOSS_RTOL)
    assert float(sm["grad_norm"]) == pytest.approx(float(pm["grad_norm"]), rel=GNORM_RTOL[pol])
    assert float(sm["loss"]) == pytest.approx(float(jm["loss"]), rel=REF_LOSS_RTOL)
    assert float(sm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=GNORM_RTOL[pol])
    assert float(sm["skipped"]) == float(pm["skipped"]) == 0.0
    got = sh.gather_tree(ns)
    for a, b in zip(tree_leaves(got["opt"].m), tree_leaves(ps2["opt"].m)):
        assert _rel(a, b) <= MOMENT_TOL[pol]
    key = "master" if ps2["master"] is not None else "params"
    lr_t = LR * 2 / 100  # AdamWConfig's warm-up of 100 steps, at step 1
    for a, b in zip(tree_leaves(got[key]), tree_leaves(ps2[key])):
        assert float(np.abs(_np(a) - _np(b)).max()) <= 2 * lr_t + 1e-6
    # seq_shard is a layout: False gives the same bits.
    ns2, sm2 = _split_step(arch, pol, shape, seq_shard=False)
    assert _bitwise(sh.gather_tree(ns2), got) == []
    assert all(float(sm[k]) == float(sm2[k]) for k in sm)


@pytest.mark.parametrize("arch,pol", [("smollm-360m", "fp16"), ("qwen2-vl-2b", "fp16"),
                                      ("stablelm-12b", "fp32")])
@pytest.mark.parametrize("seq_shard", [True, False])
def test_model_axis_of_one_equals_the_data_parallel_lowering(arch, pol, seq_shard):
    """On 2x1 the split lowering runs each data index on one rank: what the
    data-parallel lowering was, held against the single-device step at its
    tolerances (``tests/test_torch_sharded.py``: the data indices' sums in
    another order than one device's batch), ``seq_shard`` changing no bit."""
    cfg = _cfgs(arch)[1]
    _, ps = _states(arch, pol)
    batch = _pb(_batch(cfg))
    mesh = _mesh((2, 1))
    a, am = tasks.make_train_step(cfg, pol, mesh=mesh, seq_shard=seq_shard, ce_chunk=CHUNK)(
        ps, batch)
    _, ps2, pm = _singles(arch, pol)
    assert float(am["loss"]) == pytest.approx(float(pm["loss"]), rel=LOSS_RTOL)
    assert float(am["grad_norm"]) == pytest.approx(float(pm["grad_norm"]), rel=GNORM_RTOL[pol])
    got = sh.gather_tree(a)
    for x, y in zip(tree_leaves(got["opt"].m), tree_leaves(ps2["opt"].m)):
        assert _rel(x, y) <= MOMENT_TOL[pol]
    b, bm = tasks.make_train_step(cfg, pol, mesh=mesh, seq_shard=not seq_shard,
                                  ce_chunk=CHUNK)(ps, batch)
    assert _bitwise(sh.gather_tree(b), got) == []
    assert all(float(am[k]) == float(bm[k]) for k in am)


def test_split_microbatch_matches_single_device():
    """``microbatch=2`` on 2x2 against the single-device step with two
    microbatches of the same rows."""
    cfg = _cfgs("smollm-360m")[1]
    _, ps = _states("smollm-360m", "fp16")
    batch = _pb(_batch(cfg, b=8, seed=2))
    ps2, pm = tasks.make_train_step(cfg, "fp16", ce_chunk=CHUNK, microbatch=2)(ps, batch)
    task = tasks.build_task(cfg, ShapeConfig("tiny", S, 8, "train"), _mesh((2, 2)), "fp16",
                            ce_chunk=CHUNK, microbatch=2)
    ns, sm = task.sharded()(ps, batch)
    assert float(sm["loss"]) == pytest.approx(float(pm["loss"]), rel=LOSS_RTOL)
    assert float(sm["grad_norm"]) == pytest.approx(float(pm["grad_norm"]), rel=GNORM_RTOL["fp16"])


SERVE = [("smollm-360m", "fp32", (2, 2)), ("smollm-360m", "fp16", (1, 3)),
         ("qwen2.5-14b", "fp16", (2, 2)), ("musicgen-large", "fp16", (1, 3)),
         ("stablelm-12b", "fp16", (2, 2)), ("minitron-8b", "fp32", (1, 3))]


@pytest.mark.parametrize("arch,pol,shape", SERVE,
                         ids=[f"{a}-{p}-{s[0]}x{s[1]}" for a, p, s in SERVE])
@pytest.mark.parametrize("seq_shard", [True, False])
def test_split_prefill_matches_single_device(arch, pol, shape, seq_shard):
    """``build_task``'s prefill cell, and the serving prefill with its cache
    and two split decode steps on it, against single-device serving; the
    logits laid out per ``P(data, "model")`` as fitted."""
    cfg, policy = _cfgs(arch)[1], get_policy(pol)
    model = tf.init_params(cfg, policy, seed=3, device="cpu")
    params, mesh = tf.params_tree(model), _mesh(shape)
    toks = torch.from_numpy(_batch(cfg, seed=4)["tokens"].astype(np.int64))[:, :16]
    tol = SERVE_TOL[pol]
    task = tasks.build_task(cfg, ShapeConfig("p", 16, B, "prefill"), mesh, policy,
                            seq_shard=seq_shard)
    assert task.model_compute == "megatron"
    got = task.sharded()(params, {"tokens": toks})
    assert got.spec == tasks._logits_spec(mesh, B, cfg.vocab_size)
    want = tasks.make_prefill_step(cfg, policy)(model, {"tokens": toks})
    torch.testing.assert_close(sh.gather(got), want, rtol=tol, atol=tol)
    cap = 20
    logits, cache = tasks.make_prefill_step(cfg, policy, collect_cache=True, cache_len=cap)(
        model, {"tokens": toks})
    s_logits, s_cache = tasks.make_prefill_step(cfg, policy, mesh=mesh, seq_shard=seq_shard,
                                                collect_cache=True, cache_len=cap)(
        params, {"tokens": toks})
    torch.testing.assert_close(sh.gather(s_logits), logits, rtol=tol, atol=tol)
    for a, b in zip(tree_leaves(sh.gather_tree(s_cache)), tree_leaves(cache)):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    step, s_step = tasks.make_decode_step(cfg, policy), tasks.make_decode_step(cfg, policy,
                                                                              mesh=mesh)
    token = torch.argmax(logits, -1)[:, None]
    for i in range(2):
        logits, cache = step(model, cache, token, 16 + i)
        s_logits, s_cache = s_step(params, s_cache, token, 16 + i)
        torch.testing.assert_close(sh.gather(s_logits), logits, rtol=tol, atol=tol)
        token = torch.argmax(logits, -1)[:, None]


def test_vlm_prefill_with_patches_matches_single_device():
    cfg, policy = _cfgs("qwen2-vl-2b")[1], get_policy("fp32")
    model = tf.init_params(cfg, policy, seed=5, device="cpu")
    batch = _pb(_batch(cfg, seed=6))
    got = tasks.make_prefill_step(cfg, policy, mesh=_mesh((2, 2)))(tf.params_tree(model), batch)
    want = tasks.make_prefill_step(cfg, policy)(model, batch)
    torch.testing.assert_close(sh.gather(got), want, rtol=1e-5, atol=1e-5)


# -- the compute plan ------------------------------------------------------------------


def test_compute_plan_splits():
    smol = configs.get_arch("smollm-360m")  # 15 query heads on 5 KV heads, groups of 3
    two = meshlib.compute_plan(smol, 2)
    assert [p.kv_heads for p in two] == [(0, 3), (3, 5)]  # 3 + 2 KV groups
    assert [p.q_heads for p in two] == [(0, 9), (9, 15)]
    eight = meshlib.compute_plan(smol, 8)  # m = 8 > 5: query heads, shared KV heads
    assert [p.q_heads for p in eight] == [(0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 12),
                                          (12, 14), (14, 15)]
    assert [p.kv_heads for p in eight] == [(0, 1), (0, 2), (1, 2), (2, 3), (2, 4), (3, 4),
                                           (4, 5), (4, 5)]
    assert eight[1].kv_runs(3) == [(0, 1, 0), (1, 2, 1)]
    assert [p.ff for p in two] == [(0, 1280), (1280, 2560)]
    assert sum(p.vocab[1] - p.vocab[0] for p in meshlib.compute_plan(smol, 3)) == 49152
    vl = meshlib.compute_plan(configs.get_arch("qwen2-vl-2b"), 16)  # 12 heads on 16 ranks
    assert [p.n_heads for p in vl] == [1] * 12 + [0] * 4
    qwen = meshlib.compute_plan(configs.get_arch("qwen2.5-14b"), 16)  # groups of 5 over 16
    assert qwen[1].q_heads == (3, 6) and qwen[1].kv_runs(5) == [(0, 2, 0), (2, 3, 1)]


def test_model_compute_by_arch():
    """Every arch trains, prefills and decodes split over the model axis."""
    mesh = _mesh((2, 2))
    for arch in configs.ARCH_NAMES:
        cfg = configs.get_arch(arch)
        assert meshlib.model_compute(cfg) == "megatron", arch
        cfg = configs.reduce_arch(cfg)
        for kind, want in (("train", "megatron"), ("prefill", "megatron"),
                           ("decode", "megatron")):
            task = tasks.build_task(cfg, ShapeConfig("t", S, 4, kind), mesh, "fp16")
            assert task.model_compute == want, (arch, kind)


def test_uneven_head_runs_attend_run_by_run():
    """A rank whose query heads split unevenly over its KV heads (qwen2.5
    on 16 ranks) attends run by run: the same output as whole heads."""
    cfg = configs.reduce_arch(configs.get_arch("smollm-360m"))
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, cfg.d_model), generator=g)
    hd, q_dim = cfg.head_dim, 3 * cfg.head_dim
    p = type("P", (), dict(n_heads=3, n_kv_heads=2, head_dim=hd, bq=None, bk=None, bv=None,
                           wq=torch.randn((cfg.d_model, q_dim), generator=g),
                           wk=torch.randn((cfg.d_model, 2 * hd), generator=g),
                           wv=torch.randn((cfg.d_model, 2 * hd), generator=g),
                           wo=torch.randn((q_dim, cfg.d_model), generator=g)))
    qpos = torch.arange(8, dtype=torch.int32).expand(2, 8).contiguous()
    from repro_torch.models.attention import attend
    got, _ = attend(p, x, qpos, None, kv_runs=[(0, 2, 0), (2, 3, 1)])
    k = torch.cat([p.wk[:, :hd], p.wk[:, :hd], p.wk[:, hd:]], 1)
    v = torch.cat([p.wv[:, :hd], p.wv[:, :hd], p.wv[:, hd:]], 1)
    mha = type("M", (), dict(vars(p), n_kv_heads=3, wk=k, wv=v))
    want, _ = attend(mha, x, qpos, None)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# -- meta-device counts ------------------------------------------------------------------


def _meta_count(arch, mesh_shape, kind="train", seq_shard=True):
    cfg = _cfgs(arch)[1]
    mesh = meshlib.DeviceMesh(meshlib.device_grid(["meta"] * int(np.prod(mesh_shape)),
                                                  mesh_shape), ("data", "model"))
    shape = ShapeConfig("tiny", S, 2 * mesh_shape[0], kind)
    task = tasks.build_task(cfg, shape, mesh, "fp16", seq_shard=seq_shard, ce_chunk=CHUNK)
    prod = dryrun.count_step(task)
    return cfg, mesh, prod, dict(distributed.GATHERED)


@pytest.mark.parametrize("arch", ["smollm-360m", "musicgen-large"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_compute_entry_gathers_only_its_ranges(arch, kind):
    """On a 2x4 meta mesh each compute entry gathers at most its ranges'
    share of the fp16 parameters plus the replicated leaves (and its rows
    of the batch); none holds the whole parameters."""
    cfg, mesh, prod, gathered = _meta_count(arch, (2, 4), kind)
    params = tf.params_tree(tf.init_params(cfg, get_policy("fp16"), device="meta"))
    whole = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    plan = meshlib.compute_plan(cfg, 4)
    rows = 2 * S * 8  # its two rows of int64 tokens
    for e, got in gathered.items():
        pl = plan[e[1]]
        share = 0
        for keys, x in meshlib.key_paths(params):
            for region in tasks._rank_regions(keys, tuple(x.shape), pl, cfg):
                share += int(np.prod([s.stop - s.start for s in region])) * x.element_size()
        assert got <= share + rows, (e, got, share)
        assert got < whole / 2, (e, got, whole)
    assert len(gathered) == 8  # every rank of every data index
    # the model-group sums: all-reduces in training, and the sequence's
    # reduce-scatters (embedding, and two a layer) beside the logits' write-back
    assert prod["collectives"]["reduce-scatter"]["count"] > 2 * cfg.n_layers
    if kind == "train":
        assert prod["collectives"]["all-reduce"]["count"] > 0
    assert prod["gathered_bytes"] == max(gathered.values())


def test_seq_shard_keeps_a_range_of_the_residual_stream():
    """Under remat the saved block inputs of the busiest entry shrink with
    ``seq_shard`` (each rank keeps its range, not the whole stream)."""
    _, _, on, _ = _meta_count("smollm-360m", (1, 4), seq_shard=True)
    _, _, off, _ = _meta_count("smollm-360m", (1, 4), seq_shard=False)
    assert on["memory"]["activation_bytes"] < off["memory"]["activation_bytes"]
    assert on["collectives"]["reduce-scatter"]["count"] > off["collectives"]["reduce-scatter"][
        "count"]


def test_data_parallel_archs_keep_their_lowering():
    """MoE, Mamba and the RG-LRU hybrid, once data-parallel, split over the
    model axis too: every rank of every data index gathers its ranges, none
    the whole parameters."""
    for arch in ("granite-moe-1b-a400m", "qwen2-moe-a2.7b", "falcon-mamba-7b",
                 "recurrentgemma-2b"):
        cfg, _, _, gathered = _meta_count(arch, (2, 2))
        assert sorted(gathered) == [(0, 0), (0, 1), (1, 0), (1, 1)], arch
        params = tf.params_tree(tf.init_params(cfg, get_policy("fp16"), device="meta"))
        whole = sum(x.numel() * x.element_size() for x in tree_leaves(params))
        assert max(gathered.values()) < whole, arch
        assert tasks.build_task(cfg, ShapeConfig("t", S, 4, "train"), _mesh((2, 2)),
                                "fp16").model_compute == "megatron"


def _measure() -> None:
    """The measured values the tolerances above cover: the largest
    differences over the train cases (split against the port's and the
    reference's single-device steps) and the serving cases (logits and
    cache against single-device serving)."""
    worst: dict = {}

    def note(key, value):
        worst[key] = max(worst.get(key, 0.0), value)

    for arch, pol, shape in CASES:
        jm, ps2, pm = _singles(arch, pol)
        ns, sm = _split_step(arch, pol, shape, seq_shard=True)
        got = sh.gather_tree(ns)
        for k in ("loss", "grad_norm"):
            note(f"{k} {pol} vs port", abs(float(sm[k]) / float(pm[k]) - 1))
            note(f"{k} {pol} vs reference", abs(float(sm[k]) / float(jm[k]) - 1))
        note(f"first moments {pol}", max(_rel(a, b) for a, b in zip(
            tree_leaves(got["opt"].m), tree_leaves(ps2["opt"].m))))
    for arch, pol, shape in SERVE:
        cfg, policy = _cfgs(arch)[1], get_policy(pol)
        model = tf.init_params(cfg, policy, seed=3, device="cpu")
        toks = torch.from_numpy(_batch(cfg, seed=4)["tokens"].astype(np.int64))[:, :16]
        logits, cache = tasks.make_prefill_step(cfg, policy, collect_cache=True, cache_len=20)(
            model, {"tokens": toks})
        s_logits, s_cache = tasks.make_prefill_step(cfg, policy, mesh=_mesh(shape),
                                                    collect_cache=True, cache_len=20)(
            tf.params_tree(model), {"tokens": toks})
        note(f"served logits {pol}", float((sh.gather(s_logits) - logits).abs().max()))
        note(f"served cache {pol}", max(float((a.float() - b.float()).abs().max()) for a, b in
                                        zip(tree_leaves(sh.gather_tree(s_cache)),
                                            tree_leaves(cache))))
    for key, value in sorted(worst.items()):
        print(f"{key}: {value:.3g}")


if __name__ == "__main__":  # PYTHONPATH=src python tests/test_torch_tp.py
    torch.set_num_threads(1)
    _measure()
