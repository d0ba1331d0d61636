"""The port's training (A12b) on the CPU against the reference: chunked
CE, the train step under every policy and on every dense arch, 20-step
trajectories, microbatching, the non-finite skip, loss descent, resume
bit for bit, checkpoints across the two packages and the driver.

Both packages start from the reference's ``init_train_state`` (carried
over with ``train_state_from_numpy``) and take the same numpy tokens.
Tolerances (ROADMAP queue C; measured values in the comments):

* loss: rtol 1e-5 under fp32 and fp16 (sum orders); 2e-4 under bf16 and
  5e-4 under ``fp16_opt``, whose bf16 rounding of projection inputs or
  activations flips a bf16 ulp now and then. ``grad_norm``: the same, but
  1e-4 under fp16 (4.3e-5 measured on qwen2.5).
* gradients, through the moments ``m`` (0.1 g) and ``v`` (0.05 g², twice
  the tolerance) after one step: max abs difference within ``GRAD_TOL`` of
  the leaf's largest entry. Under fp16 each gradient is rounded to fp16 on
  its way back through a cast, at other points than XLA rounds it.
* new masters: within ``2 lr_t`` (plus 1e-6) of the reference's. Adam's
  first step moves every entry by about ``lr_t sign(g)``, so a gradient
  entry that is rounding noise in both packages can land on the other
  side of zero and move its master ``2 lr_t`` the other way.
* params: exactly the port's new masters in the storage dtype.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_arch as jget_arch, reduce_arch as jreduce
from repro.configs import base as jbase
from repro.models import tasks as jtasks
from repro.models import transformer as jtf
from repro.models.layers import dense as jdense
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.precision import get_policy as jpolicy
from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base
from repro_torch.core.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch import train as train_mod
from repro_torch.models import tasks
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.precision import get_policy
from repro_torch.precision.policy import tree_leaves

DENSE = ("smollm-360m", "qwen2.5-14b", "minitron-8b", "stablelm-12b")
POLICIES = ("fp32", "fp16", "bf16", "fp16_opt", "fp16_sr")
LR = 3e-3
LOSS_RTOL = {"fp32": 1e-5, "fp16": 1e-5, "fp16_sr": 1e-5, "bf16": 2e-4, "fp16_opt": 5e-4}
GNORM_RTOL = dict(LOSS_RTOL, fp16=1e-4, fp16_sr=1e-4)
GRAD_TOL = {"fp32": 2e-5, "fp16": 5e-3, "fp16_sr": 5e-3, "bf16": 2e-2, "fp16_opt": 2e-2}
B, S, CHUNK = 4, 64, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch):
    return jreduce(jget_arch(arch)), configs.reduce_arch(configs.get_arch(arch))


@functools.lru_cache(maxsize=None)
def _jstep(arch, pol, microbatch=1, lr=LR):
    cfg = _cfgs(arch)[0]
    return jax.jit(jtasks.make_train_step(cfg, jpolicy(pol), opt_cfg=JAdamW(lr=lr),
                                          microbatch=microbatch, ce_chunk=CHUNK))


def _pstep(arch, pol, microbatch=1, lr=LR):
    return tasks.make_train_step(_cfgs(arch)[1], get_policy(pol), opt_cfg=AdamWConfig(lr=lr),
                                 microbatch=microbatch, ce_chunk=CHUNK)


def _states(arch, pol, seed=0):
    jcfg, pcfg = _cfgs(arch)
    js = jtasks.init_train_state(jcfg, jpolicy(pol), seed=seed)
    return js, train_state_from_numpy(pcfg, jax.tree.map(np.asarray, js), "cpu", pol)


def _tokens(step, b=B, s=S, vocab=512):
    """Batch ``step`` of a Zipf token stream (learnable, as text), numpy int32."""
    return TokenStream(vocab, s, b, seed=1).batch(step)["tokens"].numpy().astype(np.int32)


def _jb(tokens):
    return {"tokens": jnp.asarray(tokens)}


def _pb(tokens):
    return {"tokens": torch.from_numpy(tokens.astype(np.int64))}


def _np(x):
    if isinstance(x, torch.Tensor):
        x = train_state_to_numpy({"x": x})["x"]
    x = np.asarray(x)
    if x.dtype.kind == "V":  # bf16 bits
        return (x.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return x.astype(np.float32)


def _leaves(tree):
    """The leaves of a port tree or a reference tree, in the reference's
    order, as f32 numpy arrays."""
    return [_np(x) for x in tree_leaves(tree)]


def _close_rel(a, b, tol, what):
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(a - b).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of the leaf's scale > {tol}"


# -- configs -----------------------------------------------------------------


def test_shapes_and_active_params():
    assert {k: dataclasses.astuple(v) for k, v in base.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}
    for name in base.SHAPES:
        assert dataclasses.astuple(configs.get_shape(name)) == dataclasses.astuple(
            jbase.SHAPES[name])
    for arch in DENSE:
        ours, theirs = configs.get_arch(arch), jget_arch(arch)
        assert base.count_active_params(ours) == jbase.count_active_params(theirs)
        assert base.count_params(ours) == jbase.count_params(theirs)


# -- chunked CE -------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [8, 12, 32])
def test_chunked_ce_matches_reference(chunk):
    jcfg, pcfg = _cfgs("smollm-360m")
    params = jtf.init_params(jcfg, jax.random.key(0), jpolicy("fp16"))
    r = np.random.default_rng(0)
    h = r.normal(size=(2, 32, jcfg.d_model)).astype(np.float32)
    t = r.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    m = np.ones((2, 32), np.float32)
    m[1, 20:] = 0.0
    ref = float(jtasks.chunked_ce(params, jcfg, jnp.asarray(h), jnp.asarray(t),
                                  jnp.asarray(m), chunk=chunk))
    view = tf.params_view(pcfg, jax.tree.map(lambda x: torch.from_numpy(np.array(x)),
                                             params))
    ours = float(tasks.chunked_ce(view, pcfg, torch.from_numpy(h),
                                  torch.from_numpy(t.astype(np.int64)), torch.from_numpy(m),
                                  chunk=chunk))
    np.testing.assert_allclose(ours, ref, rtol=1e-6)
    # the full softmax CE of the reference's test
    w = params["embed"].T
    logits = jdense(jnp.asarray(h), w)
    full = jnp.sum((jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
        logits, jnp.asarray(t)[..., None], -1)[..., 0]) * m) / m.sum()
    np.testing.assert_allclose(ours, float(full), rtol=1e-5)


def test_chunked_ce_mask_excludes_positions():
    pcfg = _cfgs("smollm-360m")[1]
    view = tf.params_view(pcfg, tf.params_tree(tf.init_params(pcfg, get_policy("fp16"),
                                                              device="cpu")))
    h = torch.ones((1, 16, pcfg.d_model))
    t = torch.zeros((1, 16), dtype=torch.int64)
    m0 = torch.ones((1, 16))
    m0[0, 8:] = 0.0
    l0 = tasks.chunked_ce(view, pcfg, h, t, m0, chunk=4)
    l1 = tasks.chunked_ce(view, pcfg, h[:, :8], t[:, :8], torch.ones((1, 8)), chunk=4)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)


# -- one step -------------------------------------------------------------------------


def _check_step(arch, pol):
    js, ps = _states(arch, pol)
    toks = _tokens(1)
    js2, jm = _jstep(arch, pol)(js, _jb(toks))
    ps2, pm = _pstep(arch, pol)(ps, _pb(toks))
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL[pol])
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GNORM_RTOL[pol])
    for k in ("loss_scale", "skipped"):
        assert float(pm[k]) == float(jm[k]), k
    assert float(ps2["scale"].scale) == float(js2["scale"].scale)
    assert int(ps2["scale"].good_steps) == int(js2["scale"].good_steps)
    assert int(ps2["opt"].step) == int(js2["opt"].step) == 1
    for name, tol in (("m", GRAD_TOL[pol]), ("v", 2 * GRAD_TOL[pol])):
        for a, b in zip(_leaves(dict(getattr(ps2["opt"], name))),
                        _leaves(getattr(js2["opt"], name))):
            _close_rel(a, b, tol, f"opt.{name}")
    lr_t = LR * min(1.0, 2 / 100)  # AdamWConfig's warmup of 100 steps, at step 1
    new_p = ps2["master"] if ps2["master"] is not None else ps2["params"]
    ref_p = js2["master"] if js2["master"] is not None else js2["params"]
    for a, b in zip(_leaves(new_p), _leaves(ref_p)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr_t + 1e-6)
    storage = get_policy(pol).param_storage
    for p, m in zip(tree_leaves(ps2["params"]), tree_leaves(new_p)):
        assert p.dtype == storage and torch.equal(p, m.to(storage))
    return pm, jm


@pytest.mark.parametrize("pol", POLICIES)
def test_train_step_every_policy(pol):
    """Reduced smollm-360m, one step under each of the five policies;
    ``fp16_sr`` trains as ``fp16`` (the reference's step casts with
    ``astype`` and never rounds stochastically)."""
    _check_step("smollm-360m", pol)


@pytest.mark.parametrize("arch", DENSE[1:])
def test_train_step_other_dense_archs(arch):
    pm, _ = _check_step(arch, "fp16")
    assert np.isfinite(float(pm["loss"])) and float(pm["loss"]) > 0


@pytest.mark.parametrize("pol", ["fp32", "fp16"])
def test_twenty_step_losses(pol):
    """20 steps from the same state and tokens: losses within rtol 1e-4
    (fp32) and 2e-4 (fp16, where each new param rounds to fp16 and a
    flipped ulp compounds)."""
    js, ps = _states("smollm-360m", pol)
    jstep, pstep = _jstep("smollm-360m", pol), _pstep("smollm-360m", pol)
    jl, pl = [], []
    for i in range(20):
        toks = _tokens(100 + i)
        js, jm = jstep(js, _jb(toks))
        ps, pm = pstep(ps, _pb(toks))
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
    np.testing.assert_allclose(pl, jl, rtol={"fp32": 1e-4, "fp16": 2e-4}[pol])
    assert np.mean(pl[-5:]) < np.mean(pl[:5])


def test_microbatch_matches_reference_and_full_batch():
    js, ps = _states("smollm-360m", "fp16")
    toks = _tokens(2, b=4, s=32)
    _, jm = _jstep("smollm-360m", "fp16", microbatch=2)(js, _jb(toks))
    _, pm2 = _pstep("smollm-360m", "fp16", microbatch=2)(ps, _pb(toks))
    _, pm1 = _pstep("smollm-360m", "fp16", microbatch=1)(ps, _pb(toks))
    np.testing.assert_allclose(float(pm2["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(pm2["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(pm2["loss"]), float(pm1["loss"]), rtol=1e-4)


def test_nonfinite_grads_skip_update():
    _, ps = _states("smollm-360m", "fp16")
    ps["master"]["embed"][0, 0] = float("nan")
    before = {k: v.clone() for k, v in ps["master"]["final_norm"].items()}
    step_before = int(ps["opt"].step)
    new, metrics = _pstep("smollm-360m", "fp16")(ps, {"tokens": torch.zeros((4, 32),
                                                                              dtype=torch.int64)})
    assert float(metrics["skipped"]) == 1.0
    assert torch.equal(new["master"]["final_norm"]["scale"], before["scale"])
    assert int(new["opt"].step) == step_before
    assert float(new["scale"].scale) == 2048.0
    assert float(metrics["loss_scale"]) == 2048.0


def test_loss_descends_fp16_opt():
    """``fp16_opt`` (bf16 activations) trains: 15 steps of the reference's
    ``test_fp16_opt_trains`` on the port alone."""
    _, ps = _states("smollm-360m", "fp16_opt")
    step = _pstep("smollm-360m", "fp16_opt")
    losses = []
    for i in range(15):
        ps, m = step(ps, _pb(_tokens(200 + i)))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and np.mean(losses[-5:]) < np.mean(losses[:5])


def test_remat_changes_nothing():
    _, ps = _states("smollm-360m", "fp16")
    toks = _pb(_tokens(3))
    cfg = _cfgs("smollm-360m")[1]
    a = tasks.make_train_step(cfg, get_policy("fp16"), remat=True, ce_chunk=CHUNK)(ps, toks)
    b = tasks.make_train_step(cfg, get_policy("fp16"), remat=False, ce_chunk=CHUNK)(ps, toks)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


# -- checkpoints -------------------------------------------------------------------------


def test_resume_bitwise_identical(tmp_path):
    _, s = _states("smollm-360m", "fp16", seed=5)
    step = _pstep("smollm-360m", "fp16", lr=1e-3)
    for i in range(4):
        s, m_straight = step(s, _pb(_tokens(300 + i)))
    _, s2 = _states("smollm-360m", "fp16", seed=5)
    for i in range(2):
        s2, _ = step(s2, _pb(_tokens(300 + i)))
    ckpt.save(str(tmp_path), 2, s2)
    _, like = _states("smollm-360m", "fp16", seed=9)
    restored = ckpt.restore(str(tmp_path), 2, like)
    for i in range(2, 4):
        restored, m_resumed = step(restored, _pb(_tokens(300 + i)))
    for x, y in zip(tree_leaves((restored, m_resumed)), tree_leaves((s, m_straight))):
        assert torch.equal(x, y)


@pytest.mark.parametrize("pol", ["fp16", "fp32"])
def test_checkpoints_cross_packages(tmp_path, pol):
    """A port checkpoint of a train state holds the reference's leaf names,
    shapes and dtypes: the reference restores it, and the port restores
    the reference's."""
    js, ps = _states("smollm-360m", pol, seed=3)
    ps, _ = _pstep("smollm-360m", pol)(ps, _pb(_tokens(4)))
    ckpt.save(str(tmp_path / "port"), 1, ps)
    with np.load(str(tmp_path / "port" / "step_0000000001.npz")) as ours:
        jckpt.save(str(tmp_path / "ref"), 1, js)
        with np.load(str(tmp_path / "ref" / "step_0000000001.npz")) as theirs:
            assert sorted(ours.files) == sorted(theirs.files)
            for k in ours.files:
                assert ours[k].shape == theirs[k].shape and ours[k].dtype == theirs[k].dtype, k
    back = jckpt.restore(str(tmp_path / "port"), 1, jax.eval_shape(lambda: js))
    for a, b in zip(_leaves(back), _leaves(ps)):
        np.testing.assert_array_equal(a, b)
    mine = ckpt.restore(str(tmp_path / "ref"), 1, ps)
    for a, b in zip(_leaves(mine), _leaves(js)):
        np.testing.assert_array_equal(a, b)


def test_bf16_state_round_trips_through_the_port(tmp_path):
    """bf16 leaves are written as their raw bits (``|V2``), which the
    reference's own restore refuses (ROADMAP queue C); the port reads its
    file and the reference's back bit for bit."""
    js, ps = _states("smollm-360m", "bf16", seed=2)
    ckpt.save(str(tmp_path / "port"), 1, ps)
    jckpt.save(str(tmp_path / "ref"), 1, js)
    for d in ("port", "ref"):
        back = ckpt.restore(str(tmp_path / d), 1, ps)
        for x, y in zip(tree_leaves(back), tree_leaves(ps)):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_train_state_conversion_round_trip():
    js, ps = _states("qwen2.5-14b", "fp16", seed=1)
    back = train_state_to_numpy(ps)
    assert back["opt"]._fields == ("m", "v", "step")
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, js)), tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="masters"):
        train_state_from_numpy(_cfgs("qwen2.5-14b")[1], jax.tree.map(np.asarray, js), "cpu",
                               "fp32")


def test_init_train_state_layout():
    """The port's own initial state has the reference's leaves, in its
    order, shapes and dtypes (its weights are the port's draws)."""
    jcfg, pcfg = _cfgs("stablelm-12b")
    js = jtasks.init_train_state(jcfg, jpolicy("fp16"), seed=0)
    ps = tasks.init_train_state(pcfg, get_policy("fp16"), seed=0, device="cpu")
    jl, pl = jax.tree.leaves(js), tree_leaves(ps)
    assert len(jl) == len(pl)
    for a, b in zip(pl, jl):
        assert tuple(a.shape) == tuple(b.shape) and str(a.dtype) == f"torch.{b.dtype}"
    assert tasks.init_train_state(pcfg, get_policy("fp32"), device="cpu")["master"] is None


# -- driver -----------------------------------------------------------------------------------


def test_train_driver_on_cpu_and_resume(tmp_path, capsys):
    d = str(tmp_path / "ck")
    out = train_mod.train("smollm-360m", steps=6, global_batch=2, seq_len=32, lr=3e-3,
                          ckpt_dir=d, ckpt_interval=3, log_every=2, device="cpu")
    assert len(out["losses"]) == 6 and np.isfinite(out["losses"]).all()
    assert ckpt.latest_step(d) == 6
    again = train_mod.train("smollm-360m", steps=8, global_batch=2, seq_len=32, lr=3e-3,
                            ckpt_dir=d, ckpt_interval=3, device="cpu")
    assert "resumed from step 6" in capsys.readouterr().out
    assert len(again["losses"]) == 2
    straight = train_mod.train("smollm-360m", steps=8, global_batch=2, seq_len=32, lr=3e-3,
                               device="cpu")
    assert again["losses"] == straight["losses"][6:]


def test_train_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.train("smollm-360m", steps=1, global_batch=1, seq_len=8)
