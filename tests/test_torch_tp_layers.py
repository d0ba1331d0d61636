"""Model-axis compute in the LM mesh lowering (A12e, part 2) on the CPU: the
MoE experts (EP where the expert count divides the ``model`` axis, else TP
inside each expert, with qwen2-moe's shared expert split like a dense MLP),
Mamba's ``d_inner`` channels and the RG-LRU's width channels split over a
mesh's ``model`` axis, in the train step and in prefill, over device-list
meshes of ``["cpu"] * n``.

Every train state starts from the reference's ``init_train_state`` (carried
over with ``train_state_from_numpy``) and every batch from the same numpy
rows. The split step is held against the port's single-device step and
against the reference's jitted single-device step. Tolerances (ROADMAP
queue C, slice 22; the largest measured value over the cases in the
comments): the expert TP sums, ``x_proj``'s all-reduce and every
``out_proj``/``w_down`` are rank-order sums, which move f32 sums by ulps and
under fp16 flip the fp16 rounding of some projection inputs, as slice 21's
splits do. So slice 21's tolerances hold: loss at rtol 1e-5 (6.0e-6
measured), grad norm at 1e-5 under fp32 (1.0e-7) and 1e-4 under fp16
(1.3e-5), first moments within 1e-4 (fp32, 5.8e-6) and 5e-3 (fp16, 1.7e-3)
of each leaf's scale, new masters within ``2 lr_t``; against the reference
the loss at 2e-5 (5.2e-6) and the grad norm as against the port (2.9e-5).
Served logits within 1e-5 under fp32 (2.2e-6) and 2e-3 under fp16
(1.6e-3), caches likewise (2.3e-6; 1.95e-3, one fp16 ulp of a KV value
between 2 and 4, inside ``assert_close``'s ``atol + rtol |want|``), the
bounds of ``tests/test_torch_tp.py``.
``python tests/test_torch_tp_layers.py`` prints these measured values.
``seq_shard`` True and False give the same bits; EP's routed output, and a
channel range's conv, scan and decode state, are the whole layer's bit for
bit.
"""
import functools
from types import SimpleNamespace

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
from repro_torch.models import mamba, moe, rglru, tasks
from repro_torch.models import transformer as tf
from repro_torch.models.layers import dense
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


def _tokens(cfg, b=B, s=S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _pb(tokens):
    return {"tokens": torch.from_numpy(tokens.astype(np.int64))}


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
    toks = _tokens(pcfg)
    jstep = jax.jit(jtasks.make_train_step(jcfg, jpolicy(pol), opt_cfg=JAdamW(lr=LR),
                                           ce_chunk=CHUNK))
    _, jm = jstep(js, {"tokens": jnp.asarray(toks)})
    ps2, pm = tasks.make_train_step(pcfg, get_policy(pol), ce_chunk=CHUNK)(ps, _pb(toks))
    return jm, ps2, pm


def _split_step(arch, pol, shape, seq_shard):
    cfg = _cfgs(arch)[1]
    task = tasks.build_task(cfg, ShapeConfig("tiny", S, B, "train"), _mesh(shape), pol,
                            seq_shard=seq_shard, ce_chunk=CHUNK)
    assert task.model_compute == "megatron"
    _, ps = _states(arch, pol)
    distributed.reset_collectives()
    out = task.sharded()(ps, _pb(_tokens(cfg)))
    return out, {k: dict(v) for k, v in distributed.COLLECTIVES.items()}


def _bitwise(a, b) -> list:
    """The key paths of the leaves where two trees differ."""
    return [k for (k, x), y in zip(meshlib.key_paths(a), tree_leaves(b)) if not torch.equal(x, y)]


CASES = [
    ("granite-moe-1b-a400m", "fp16", (2, 2)),  # 8 experts on 2 ranks: EP
    ("granite-moe-1b-a400m", "fp16", (1, 3)),  # 8 experts on 3 ranks: TP, d_expert 32 as 11+11+10
    ("qwen2-moe-a2.7b", "fp16", (1, 3)),  # TP and the shared expert's d_shared over 3
    ("qwen2-moe-a2.7b", "fp32", (2, 2)),  # EP beside the split shared expert
    ("falcon-mamba-7b", "fp16", (2, 2)),  # d_inner 128 as 64 + 64
    ("falcon-mamba-7b", "fp16", (1, 3)),  # 43 + 43 + 42 channels
    ("falcon-mamba-7b", "fp32", (2, 2)),
    ("recurrentgemma-2b", "fp16", (2, 2)),  # width 64 over 2; MQA's 4 heads on 1 KV head
    ("recurrentgemma-2b", "fp32", (1, 3)),
]


@pytest.mark.parametrize("arch,pol,shape", CASES,
                         ids=[f"{a}-{p}-{s[0]}x{s[1]}" for a, p, s in CASES])
def test_split_layers_train_step_matches_single_device_and_reference(arch, pol, shape):
    jm, ps2, pm = _singles(arch, pol)
    (ns, sm), colls = _split_step(arch, pol, shape, seq_shard=True)
    cfg = _cfgs(arch)[1]
    ep = cfg.moe is not None and meshlib.expert_parallel(cfg, shape[1])
    assert ("all-to-all" in colls) == ep  # the EP combine's exchange
    if ep:  # per layer and data index: the forward, remat's recompute and the backward
        assert colls["all-to-all"]["count"] == 3 * cfg.n_layers * shape[0]
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
    # seq_shard is a layout: False gives the same bits (an all-gather along
    # E in place of the all-to-all under EP).
    (ns2, sm2), colls2 = _split_step(arch, pol, shape, seq_shard=False)
    assert "all-to-all" not in colls2
    assert _bitwise(sh.gather_tree(ns2), got) == []
    assert all(float(sm[k]) == float(sm2[k]) for k in sm)


# -- the layers over a group ----------------------------------------------------------------


def _group(cfg, m, seq_shard, s=S):
    mesh = meshlib.make_host_mesh((1, m), devices=["cpu"] * m)
    return tf.GroupRun(grp=sh.Group(mesh, tuple((0, r) for r in range(m))),
                       plan=meshlib.compute_plan(cfg, m), seq=meshlib.balanced(s, m),
                       seq_shard=seq_shard, act_to=None, kv_runs=[None] * m)


def _layer(arch, pol, i=0):
    cfg = configs.reduce_arch(configs.get_arch(arch))
    return cfg, tf.init_params(cfg, get_policy(pol), seed=2, device="cpu").layers[i]


def _x(cfg, seed=0):
    return torch.randn((2, S, cfg.d_model), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("seq_shard", [True, False])
@pytest.mark.parametrize("pol", ["fp16", "fp32"])
def test_ep_moe_group_is_the_single_device_layer_bit_for_bit(m, seq_shard, pol):
    """granite's 8 experts on 2 and 4 ranks: each rank runs its experts,
    the combine runs in the reference's order, so the routed output (each
    rank's range under ``seq_shard``, else the whole on every rank) and the
    routing statistics are ``moe_apply``'s bits."""
    cfg, layer = _layer("granite-moe-1b-a400m", pol)
    p, x = layer.moe, _x(cfg)
    want, _ = moe.moe_apply(p, x, cfg)
    probs, eids, _ = moe.route(p, x, cfg)
    stats = torch.stack(moe._stats(probs, eids, cfg.moe.n_experts))
    run = _group(cfg, m, seq_shard)
    assert meshlib.expert_parallel(cfg, m)
    views = [SimpleNamespace(router=p.router, w_gate=p.w_gate[slice(*pl.experts)],
                             w_up=p.w_up[slice(*pl.experts)],
                             w_down=p.w_down[slice(*pl.experts)], shared=None)
             for pl in run.plan]
    distributed.reset_collectives()
    ys, got_stats = moe.moe_group(views, [x.clone() for _ in range(m)], cfg, run)
    assert torch.equal(got_stats, stats)
    for (lo, hi), y in zip(run.seq, ys):
        assert torch.equal(y, want[:, lo:hi] if seq_shard else want)
    assert ("all-to-all" in distributed.COLLECTIVES) == seq_shard


def test_tp_moe_group_sums_the_partial_experts():
    """granite's 8 experts on 3 ranks (TP: d_expert 32 as 11 + 11 + 10):
    the ranks' partial outputs summed in rank order, within f32 ulps of the
    single-device layer."""
    cfg, layer = _layer("granite-moe-1b-a400m", "fp32")
    p, x = layer.moe, _x(cfg, seed=1)
    want, _ = moe.moe_apply(p, x, cfg)
    run = _group(cfg, 3, True)
    assert not meshlib.expert_parallel(cfg, 3)
    views = [SimpleNamespace(router=p.router, w_gate=p.w_gate[..., slice(*pl.expert_ff)],
                             w_up=p.w_up[..., slice(*pl.expert_ff)],
                             w_down=p.w_down[:, slice(*pl.expert_ff)], shared=None)
             for pl in run.plan]
    ys, _ = moe.moe_group(views, [x.clone() for _ in range(3)], cfg, run)
    torch.testing.assert_close(torch.cat(ys, dim=1), want, rtol=1e-6, atol=1e-6)


def _mamba_view(p, lo, hi):
    di = p.in_proj.shape[-1] // 2
    return SimpleNamespace(
        in_proj=torch.cat([p.in_proj[:, lo:hi], p.in_proj[:, di + lo:di + hi]], dim=-1),
        conv_w=p.conv_w[:, lo:hi], conv_b=p.conv_b[lo:hi], x_proj=p.x_proj[lo:hi],
        dt_proj=p.dt_proj[:, lo:hi], dt_bias=p.dt_bias[lo:hi], A_log=p.A_log[lo:hi],
        D=p.D[lo:hi], out_proj=p.out_proj[lo:hi])


def _rglru_view(p, lo, hi):
    cols = ("in_proj", "gate_proj", "w_a", "w_x", "conv_w", "conv_b", "b_a", "b_x", "lam")
    return SimpleNamespace(out_proj=p.out_proj[lo:hi],
                           **{n: getattr(p, n)[..., lo:hi] for n in cols})


@pytest.mark.parametrize("pol", ["fp16", "fp32"])
@pytest.mark.parametrize("m", [2, 3])
def test_channel_range_conv_and_scan_are_the_whole_layers(pol, m):
    """Mamba and the RG-LRU on each rank's channel range, from the whole
    layer's inputs (``x_proj``'s output, the whole conv output): the conv
    outputs, the scan's decode states and the last conv inputs are the
    whole layer's on those channels, bit for bit."""
    cfg, layer = _layer("falcon-mamba-7b", pol)
    p, x = layer.ssm, _x(cfg, seed=2)
    raw, z, xin = mamba._mix_in(p, x, cfg, None, True)
    proj = dense(xin, p.x_proj)
    _, want = mamba._mix_out(p, raw, z, xin, proj, cfg, None, True)
    for lo, hi in meshlib.balanced(raw.shape[-1], m):
        v = _mamba_view(p, lo, hi)
        r_raw, r_z, r_xin = mamba._mix_in(v, x, cfg, None, True)
        assert torch.equal(r_xin, xin[..., lo:hi]) and torch.equal(r_z, z[..., lo:hi])
        _, st = mamba._mix_out(v, r_raw, r_z, r_xin, proj, cfg, None, True)
        assert torch.equal(st["ssm"], want["ssm"][:, lo:hi])
        assert torch.equal(st["conv"], want["conv"][..., lo:hi])
    cfg, layer = _layer("recurrentgemma-2b", pol)
    p = layer.rglru
    raw, gate, xc = rglru._mix_in(p, x, None, True)
    _, want = rglru.rglru_apply(p, x, cfg, return_state=True)
    for lo, hi in meshlib.balanced(raw.shape[-1], m):
        v = _rglru_view(p, lo, hi)
        r_raw, r_gate, r_xc = rglru._mix_in(v, x, None, True)
        assert torch.equal(r_xc, xc[..., lo:hi])
        a, gated_in = rglru._gates(v, xc, None, own=r_xc)
        _, st = rglru._mix_out(v, r_raw, r_gate, a, gated_in, None, True)
        assert torch.equal(st["h"], want["h"][:, lo:hi])
        assert torch.equal(st["conv"], want["conv"][..., lo:hi])


@pytest.mark.parametrize("m", [2, 3])
def test_rglru_xc_gather_feeds_the_gates_exactly(m):
    """The ranks' conv outputs all-gathered along the width are the whole
    layer's conv output, and each rank's gates on it are the whole layer's
    gates on its channels, bit for bit; the backward reduce-scatters."""
    cfg, layer = _layer("recurrentgemma-2b", "fp16")
    p, x = layer.rglru, _x(cfg, seed=3)
    _, _, xc = rglru._mix_in(p, x, None, False)
    a, gated_in = rglru._gates(p, xc, None)
    run = _group(cfg, m, True)
    views = [_rglru_view(p, *pl.lru) for pl in run.plan]
    mids = [rglru._mix_in(v, x, None, False) for v in views]
    whole = sh.seq_gather(run.grp, [t[2] for t in mids], [pl.lru for pl in run.plan], dim=-1)
    for v, pl, (_, _, own), xw in zip(views, run.plan, mids, whole):
        lo, hi = pl.lru
        assert torch.equal(xw, xc)
        ra, rg = rglru._gates(v, xw, None, own=own)
        assert torch.equal(ra, a[..., lo:hi]) and torch.equal(rg, gated_in[..., lo:hi])


def test_group_psum_sums_forward_and_backward_in_rank_order():
    """``x_proj``'s all-reduce: every rank takes the parts' sum, and each
    part the sum of every rank's cotangent (each rank goes on with its own
    channels)."""
    run = _group(configs.reduce_arch(configs.get_arch("falcon-mamba-7b")), 3, True)
    parts = [torch.full((2,), float(r + 1), requires_grad=True) for r in range(3)]
    outs = sh.group_psum(run.grp, parts)
    assert all(torch.equal(o, torch.full((2,), 6.0)) for o in outs)
    sum(o * (r + 1) for r, o in enumerate(outs)).sum().backward()
    assert all(torch.equal(p.grad, torch.full((2,), 6.0)) for p in parts)


def test_all_to_all_moves_each_piece_and_its_cotangent():
    run = _group(configs.reduce_arch(configs.get_arch("granite-moe-1b-a400m")), 2, True)
    pieces = [[torch.full((3,), 10.0 * r + j, requires_grad=True) for j in range(2)]
              for r in range(2)]
    distributed.reset_collectives()
    got = sh.all_to_all(run.grp, pieces)
    assert all(torch.equal(got[j][r], pieces[r][j]) for r in range(2) for j in range(2))
    sum((j + 1) * got[j][r].sum() for r in range(2) for j in range(2)).backward()
    assert all(torch.equal(pieces[r][j].grad, torch.full((3,), j + 1.0))
               for r in range(2) for j in range(2))
    assert distributed.COLLECTIVES["all-to-all"] == {"count": 2, "bytes": 2 * 12}


# -- prefill ------------------------------------------------------------------------------

SERVE = [("falcon-mamba-7b", "fp16", (2, 2)), ("falcon-mamba-7b", "fp32", (1, 3)),
         ("recurrentgemma-2b", "fp16", (1, 3)), ("recurrentgemma-2b", "fp32", (2, 2)),
         ("granite-moe-1b-a400m", "fp16", (2, 2)), ("qwen2-moe-a2.7b", "fp16", (1, 3))]


@pytest.mark.parametrize("arch,pol,shape", SERVE,
                         ids=[f"{a}-{p}-{s[0]}x{s[1]}" for a, p, s in SERVE])
@pytest.mark.parametrize("seq_shard", [True, False])
def test_split_layers_prefill_matches_single_device(arch, pol, shape, seq_shard):
    """``build_task``'s prefill cell and the serving prefill with its cache
    (the recurrent states assembled from the ranks' channels, the KV heads
    from the ranks' heads) against single-device prefill, then a
    split decode step from the assembled cache."""
    cfg, policy = _cfgs(arch)[1], get_policy(pol)
    model = tf.init_params(cfg, policy, seed=3, device="cpu")
    params, mesh = tf.params_tree(model), _mesh(shape)
    toks = _pb(_tokens(cfg, s=16, seed=4))["tokens"]
    tol = SERVE_TOL[pol]
    task = tasks.build_task(cfg, ShapeConfig("p", 16, B, "prefill"), mesh, policy,
                            seq_shard=seq_shard)
    assert task.model_compute == "megatron"
    want = tasks.make_prefill_step(cfg, policy)(model, {"tokens": toks})
    torch.testing.assert_close(sh.gather(task.sharded()(params, {"tokens": toks})), want,
                               rtol=tol, atol=tol)
    cap = 20
    logits, cache = tasks.make_prefill_step(cfg, policy, collect_cache=True, cache_len=cap)(
        model, {"tokens": toks})
    s_logits, s_cache = tasks.make_prefill_step(cfg, policy, mesh=mesh, seq_shard=seq_shard,
                                                collect_cache=True, cache_len=cap)(
        params, {"tokens": toks})
    torch.testing.assert_close(sh.gather(s_logits), logits, rtol=tol, atol=tol)
    specs = tree_leaves(meshlib.tree_pspecs(cache, mesh, rule=meshlib.cache_pspec))
    assert [x.spec for x in tree_leaves(s_cache)] == specs
    for a, b in zip(tree_leaves(sh.gather_tree(s_cache)), tree_leaves(cache)):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    token = torch.argmax(logits, -1)[:, None]
    step = tasks.make_decode_step(cfg, policy)
    one, _ = step(model, sh.gather_tree(s_cache), token, 16)
    got, _ = tasks.make_decode_step(cfg, policy, mesh=mesh)(params, s_cache, token, 16)
    torch.testing.assert_close(sh.gather(got), one, rtol=tol, atol=tol)


# -- meta-device counts -------------------------------------------------------------------


def _meta_count(arch, mesh_shape, kind="train", seq_shard=True):
    cfg = _cfgs(arch)[1]
    mesh = meshlib.DeviceMesh(meshlib.device_grid(["meta"] * int(np.prod(mesh_shape)),
                                                  mesh_shape), ("data", "model"))
    shape = ShapeConfig("tiny", S, 2 * mesh_shape[0], kind)
    task = tasks.build_task(cfg, shape, mesh, "fp16", seq_shard=seq_shard, ce_chunk=CHUNK)
    distributed.GATHERED.clear()
    prod = dryrun.count_step(task)
    return cfg, prod, dict(distributed.GATHERED)


META = [("granite-moe-1b-a400m", (2, 4)), ("granite-moe-1b-a400m", (2, 3)),
        ("qwen2-moe-a2.7b", (2, 3)), ("falcon-mamba-7b", (2, 4)),
        ("recurrentgemma-2b", (2, 4))]


@pytest.mark.parametrize("arch,mesh_shape", META,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in META])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_split_layers_entry_gathers_only_its_ranges(arch, mesh_shape, kind):
    """On a meta mesh each compute entry gathers at most its ranges' share of
    the fp16 parameters plus the replicated leaves (norms, the router) and
    its rows of the batch; none holds the whole parameters; every rank of
    every data index computes; the EP combine's all-to-all is counted."""
    cfg, prod, gathered = _meta_count(arch, mesh_shape, kind)
    m = mesh_shape[1]
    params = tf.params_tree(tf.init_params(cfg, get_policy("fp16"), device="meta"))
    whole = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    plan = meshlib.compute_plan(cfg, m)
    rows = 2 * S * 8  # its two rows of int64 tokens
    for e, got in gathered.items():
        share = 0
        for keys, x in meshlib.key_paths(params):
            for region in tasks._rank_regions(keys, tuple(x.shape), plan[e[1]], cfg):
                share += int(np.prod([s.stop - s.start for s in region])) * x.element_size()
        assert got <= share + rows, (e, got, share)
        assert got < whole * 0.6, (e, got, whole)
    assert len(gathered) == int(np.prod(mesh_shape))
    ep = cfg.moe is not None and meshlib.expert_parallel(cfg, m)
    assert ("all-to-all" in prod["collectives"]) == ep
    assert prod["gathered_bytes"] == max(gathered.values())


def test_mamba_in_proj_is_gathered_as_two_regions():
    """A rank's ``in_proj`` is its channels of the x half and of the z half."""
    cfg = configs.get_arch("falcon-mamba-7b")
    pl = meshlib.compute_plan(cfg, 16)[3]
    regions = tasks._rank_regions(("layers", "ssm", "in_proj"), (64, 4096, 16384), pl, cfg)
    assert pl.inner == (1536, 2048)
    assert [r[-1] for r in regions] == [slice(1536, 2048), slice(9728, 10240)]
    assert tasks._rank_regions(("layers", "ssm", "A_log"), (64, 8192, 16), pl, cfg)[0][1] == \
        slice(1536, 2048)


def test_compute_plan_of_the_layer_kinds():
    granite, qwen = configs.get_arch("granite-moe-1b-a400m"), configs.get_arch("qwen2-moe-a2.7b")
    ep = meshlib.compute_plan(granite, 16)  # 32 experts on 16: EP, two each
    assert [p.experts for p in ep[:2]] == [(0, 2), (2, 4)] and ep[0].expert_ff == (0, 512)
    tp = meshlib.compute_plan(qwen, 16)  # 60 experts on 16: TP, d_expert 1408 as 88 each
    assert tp[1].experts == (0, 60) and tp[1].expert_ff == (88, 176)
    assert tp[15].shared == (5280, 5632)  # d_shared 5632 over 16
    assert meshlib.compute_plan(configs.get_arch("recurrentgemma-2b"), 16)[0].lru == (0, 160)
    assert meshlib.compute_plan(configs.get_arch("falcon-mamba-7b"), 3)[0].inner == (0, 2731)


def _measure() -> None:
    """The measured values the tolerances above cover: the largest
    differences over the train cases (split against the port's and the
    reference's single-device steps) and the serving cases."""
    worst: dict = {}

    def note(key, value):
        worst[key] = max(worst.get(key, 0.0), value)

    for arch, pol, shape in CASES:
        jm, ps2, pm = _singles(arch, pol)
        (ns, sm), _ = _split_step(arch, pol, shape, seq_shard=True)
        got = sh.gather_tree(ns)
        for k in ("loss", "grad_norm"):
            note(f"{k} {pol} vs port", abs(float(sm[k]) / float(pm[k]) - 1))
            note(f"{k} {pol} vs reference ({arch})", abs(float(sm[k]) / float(jm[k]) - 1))
        note(f"first moments {pol}", max(_rel(a, b) for a, b in zip(
            tree_leaves(got["opt"].m), tree_leaves(ps2["opt"].m))))
    for arch, pol, shape in SERVE:
        cfg, policy = _cfgs(arch)[1], get_policy(pol)
        model = tf.init_params(cfg, policy, seed=3, device="cpu")
        toks = _pb(_tokens(cfg, s=16, seed=4))["tokens"]
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


if __name__ == "__main__":  # PYTHONPATH=src python tests/test_torch_tp_layers.py
    torch.set_num_threads(1)
    _measure()
