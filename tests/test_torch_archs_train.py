"""Training the five families beyond the dense decoders on the CPU
against the reference: one train step per arch under fp32 and fp16 from
the reference's ``init_train_state`` (carried over with
``train_state_from_numpy``) and the same numpy batch, train states
carried across, and checkpoints across the two packages.

Tolerances (ROADMAP queue C), as the dense archs'
(``tests/test_torch_training.py``): loss at rtol 1e-5, grad norm at 1e-5
(fp32) and 1e-4 (fp16), the first moments within ``GRAD_TOL`` of each
leaf's scale, new masters within ``2 lr_t`` (Adam's first step is
sign-like). The hybrid's fp16 loss is held at 5e-5 (2.2e-5 measured):
its gates carry an f32 ulp of XLA's fused sigmoid and exp into the scan,
which an fp16 projection input then rounds a whole ulp apart.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_arch as jget_arch, reduce_arch as jreduce
from repro.models import tasks as jtasks
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.precision import get_policy as jpolicy
from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.core.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.launch import train as train_mod
from repro_torch.models import tasks
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.precision import get_policy
from repro_torch.precision.policy import tree_leaves

NEW = ("granite-moe-1b-a400m", "qwen2-moe-a2.7b", "falcon-mamba-7b", "recurrentgemma-2b",
       "musicgen-large", "qwen2-vl-2b")
LR, B, S, CHUNK = 3e-3, 2, 32, 16
LOSS_RTOL = {"fp32": 1e-5, "fp16": 1e-5}
GNORM_RTOL = {"fp32": 1e-5, "fp16": 1e-4}
GRAD_TOL = {"fp32": 2e-5, "fp16": 5e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch):
    return jreduce(jget_arch(arch)), configs.reduce_arch(configs.get_arch(arch))


def _batch(cfg, seed=1):
    """Tokens (and under the vision frontend bf16 patch embeddings and
    M-RoPE positions, as the reference's ``test_archs._batch``) in numpy."""
    rng = np.random.default_rng(seed)
    p = cfg.n_patches if cfg.frontend == "vision" else 0
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S - p)).astype(np.int32)}
    if p:
        batch["patch_embeds"] = np.asarray(jnp.asarray(rng.normal(size=(B, p, cfg.d_model)),
                                                       jnp.bfloat16))
        pos = np.zeros((B, S, 3), np.int32)
        for i in range(p):
            pos[:, i] = (0, i // 4, i % 4)
        pos[:, p:] = np.arange(1, S - p + 1)[None, :, None] + 1
        batch["positions"] = pos
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pb(batch):
    out = {"tokens": torch.from_numpy(batch["tokens"].astype(np.int64))}
    if "patch_embeds" in batch:
        out["patch_embeds"] = torch.from_numpy(batch["patch_embeds"].astype(np.float32))
        out["positions"] = torch.from_numpy(batch["positions"])
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        x = train_state_to_numpy({"x": x})["x"]
    return np.asarray(x).astype(np.float32)


def _states(arch, pol, seed=0):
    jcfg, pcfg = _cfgs(arch)
    js = jtasks.init_train_state(jcfg, jpolicy(pol), seed=seed)
    return js, train_state_from_numpy(pcfg, jax.tree.map(np.asarray, js), "cpu", pol)


@functools.cache
def _steps(arch, pol):
    """(reference state after one step, its metrics, port's, port's)."""
    jcfg, pcfg = _cfgs(arch)
    js, ps = _states(arch, pol)
    batch = _batch(pcfg)
    jstep = jax.jit(jtasks.make_train_step(jcfg, jpolicy(pol), opt_cfg=JAdamW(lr=LR),
                                           ce_chunk=CHUNK))
    pstep = tasks.make_train_step(pcfg, get_policy(pol), opt_cfg=AdamWConfig(lr=LR),
                                  ce_chunk=CHUNK)
    js2, jm = jstep(js, _jb(batch))
    ps2, pm = pstep(ps, _pb(batch))
    return js2, jm, ps2, pm


CELLS = [(a, p) for a in NEW for p in ("fp32", "fp16")]
IDS = [f"{a}-{p}" for a, p in CELLS]


@pytest.mark.parametrize("arch,pol", CELLS, ids=IDS)
def test_train_step_matches_reference(arch, pol):
    js2, jm, ps2, pm = _steps(arch, pol)
    loss_rtol = 5e-5 if (arch, pol) == ("recurrentgemma-2b", "fp16") else LOSS_RTOL[pol]
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=loss_rtol)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GNORM_RTOL[pol])
    for k in ("loss_scale", "skipped"):
        assert float(pm[k]) == float(jm[k]) == (0.0 if k == "skipped" else float(pm[k])), k
    assert int(ps2["opt"].step) == int(js2["opt"].step) == 1
    for a, b in zip(tree_leaves(dict(ps2["opt"].m)), jax.tree.leaves(js2["opt"].m)):
        a, b = _np(a), _np(b)
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) / scale <= GRAD_TOL[pol]
    lr_t = LR * 2 / 100
    new_p = ps2["master"] if ps2["master"] is not None else ps2["params"]
    ref_p = js2["master"] if js2["master"] is not None else js2["params"]
    for a, b in zip(tree_leaves(new_p), jax.tree.leaves(ref_p)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=2 * lr_t + 1e-6)
    storage = get_policy(pol).param_storage
    for p, m in zip(tree_leaves(ps2["params"]), tree_leaves(new_p)):
        assert p.dtype == storage and torch.equal(p, m.to(storage))


@pytest.mark.parametrize("arch", NEW)
def test_init_train_state_layout(arch):
    """The port's own initial state has the reference's leaves, in its
    order, shapes and dtypes; the hybrid's ``layers`` is a tuple."""
    jcfg, pcfg = _cfgs(arch)
    js = jax.eval_shape(lambda: jtasks.init_train_state(jcfg, jpolicy("fp16"), seed=0))
    ps = tasks.init_train_state(pcfg, get_policy("fp16"), seed=0, device="cpu")
    jl, pl = jax.tree.leaves(js), tree_leaves(ps)
    assert len(jl) == len(pl)
    for a, b in zip(pl, jl):
        assert tuple(a.shape) == tuple(b.shape) and str(a.dtype) == f"torch.{b.dtype}"
    assert isinstance(ps["params"]["layers"], tuple) == (not pcfg.homogeneous)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen2-moe-a2.7b", "falcon-mamba-7b"])
def test_train_state_round_trip_and_checkpoints(tmp_path, arch):
    """A state carries across and back leaf for leaf; the port's checkpoint
    of a trained state holds the reference's leaf names, shapes and dtypes,
    the reference restores it, and the port restores the reference's."""
    js, ps = _states(arch, "fp16", seed=3)
    back = train_state_to_numpy(ps)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, js)), tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    _, _, ps2, _ = _steps(arch, "fp16")
    ckpt.save(str(tmp_path / "port"), 1, ps2)
    jckpt.save(str(tmp_path / "ref"), 1, js)
    with np.load(str(tmp_path / "port" / "step_0000000001.npz")) as ours, \
            np.load(str(tmp_path / "ref" / "step_0000000001.npz")) as theirs:
        assert sorted(ours.files) == sorted(theirs.files)
        if arch == "recurrentgemma-2b":
            assert any(k.startswith("['master']||['layers']||[2]") for k in ours.files)
        for k in ours.files:
            assert ours[k].shape == theirs[k].shape and ours[k].dtype == theirs[k].dtype, k
    restored = jckpt.restore(str(tmp_path / "port"), 1, jax.eval_shape(lambda: js))
    for a, b in zip(jax.tree.leaves(restored), tree_leaves(ps2)):
        np.testing.assert_array_equal(_np(a), _np(b))
    mine = ckpt.restore(str(tmp_path / "ref"), 1, ps2)
    for a, b in zip(tree_leaves(mine), jax.tree.leaves(js)):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_vlm_loss_runs_over_text_only():
    """Under the vision frontend the patch positions take no loss: the loss
    equals the CE of the text positions' logits alone (the reference's
    ``h[:, n_patches:]``)."""
    _, pcfg = _cfgs("qwen2-vl-2b")
    _, ps = _states("qwen2-vl-2b", "fp32")
    _, _, _, pm = _steps("qwen2-vl-2b", "fp32")
    from repro_torch.models import transformer as tf
    batch = _pb(_batch(pcfg))
    with torch.no_grad():
        model = tf.params_view(pcfg, ps["params"])
        h, aux = tf.forward(model, batch)
        logits = tf.lm_logits(model, h[:, pcfg.n_patches:])
        toks = batch["tokens"]
        nll = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                                                toks[:, 1:].reshape(-1))
    np.testing.assert_allclose(float(pm["loss"]), float(nll), rtol=1e-5)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b", "granite-moe-1b-a400m"])
def test_launch_train_learns(arch):
    """``launch.train`` trains each recurrent and MoE family on the CPU: finite
    losses, no skipped step."""
    out = train_mod.train(arch, steps=3, global_batch=2, seq_len=32, lr=3e-3, log_every=10,
                          device="cpu")
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert int(out["state"]["opt"].step) == 3
