"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's
``repro.optim.adamw``. The update, the moments, the step, warmup, skip and
the loss-scale state are held bit for bit against the reference evaluated
op by op (``jax.disable_jit()``: its jit may contract a mul+add into an
FMA, ROADMAP queue C's common cause) where the gradients' global norm
stays under the clip. ``global_norm`` sums per-leaf sums in the
reference's leaf order, but each leaf's f32 sum runs in PyTorch's order,
so it is held at rtol 1e-6; where it clips, every gradient is divided by
it, and the update is held at rtol 2e-5 (a second moment squares the
gradient's few-ulp difference)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadam
from repro_torch.optim import adamw

SHAPES = {"embed": (17, 8), "layers": {"attn": {"wq": (2, 8, 8)}, "norm1": {"scale": (2, 8)}},
          "final_norm": {"scale": (8,)}}


def _tree(r, scale, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(r, scale, v) for k, v in shapes.items()}
    return (r.normal(size=shapes) * scale).astype(np.float32)


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(jax.tree.map(
        lambda x: x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x), tree))]


@pytest.mark.parametrize("gscale", [1e-3, 1.0])
@pytest.mark.parametrize("step0", [0, 7, 150])
@pytest.mark.parametrize("skip", [None, False, True])
def test_adamw_update_bitwise(gscale, step0, skip):
    r = np.random.default_rng(step0)
    g, m, p = _tree(r, gscale), _tree(r, 1e-3), _tree(r, 1.0)
    v = jax.tree.map(np.abs, _tree(r, 1e-6))
    cfg = jadam.AdamWConfig(lr=2e-3, warmup_steps=10)
    with jax.disable_jit():
        jp, jo, jn = jadam.adamw_update(
            cfg, _j(g), jadam.OptState(_j(m), _j(v), jnp.int32(step0)), _j(p),
            skip=None if skip is None else jnp.asarray(skip))
    tp, to, tn = adamw.adamw_update(
        adamw.AdamWConfig(*cfg), _t(g), adamw.OptState(_t(m), _t(v), torch.tensor(
            step0, dtype=torch.int32)), _t(p), skip=None if skip is None else torch.tensor(skip))
    clipped = float(jn) > cfg.clip_norm
    for a, b in zip(_leaves((jp, jo.m, jo.v)), _leaves((tp, to.m, to.v))):
        if clipped:
            np.testing.assert_allclose(b, a, rtol=2e-5, atol=0)
        else:
            np.testing.assert_array_equal(a, b)
    assert clipped == (gscale == 1.0)
    assert int(to.step) == int(jo.step)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    if skip:
        for a, b in zip(_leaves(p), _leaves(tp)):
            np.testing.assert_array_equal(a, b)


def test_global_norm_and_leaf_order():
    r = np.random.default_rng(1)
    g = _tree(r, 0.1)
    np.testing.assert_allclose(float(adamw.global_norm(_t(g))),
                               float(jadam.global_norm(_j(g))), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 8, 9, 10, 500])
def test_warmup_lr_bitwise(step):
    cfg = jadam.AdamWConfig(lr=3e-3, warmup_steps=10)
    with jax.disable_jit():
        ref = np.float32(jadam._lr_at(cfg, jnp.int32(step)))
    ours = adamw._lr_at(adamw.AdamWConfig(*cfg), torch.tensor(step, dtype=torch.int32))
    assert ours.dtype == torch.float32
    assert np.float32(ours.item()) == ref


@pytest.mark.parametrize("finite", [True, False])
@pytest.mark.parametrize("good", [0, 1998, 1999])
@pytest.mark.parametrize("scale", [1.0, 4096.0, 2.0**24])
def test_scale_update_bitwise(finite, good, scale):
    js = jadam.scale_update(jadam.ScaleState(jnp.float32(scale), jnp.int32(good)),
                            jnp.asarray(finite))
    ts = adamw.scale_update(adamw.ScaleState(torch.tensor(scale, dtype=torch.float32),
                                             torch.tensor(good, dtype=torch.int32)),
                            torch.tensor(finite))
    assert float(ts.scale) == float(js.scale) and int(ts.good_steps) == int(js.good_steps)
    assert ts.scale.dtype == torch.float32 and ts.good_steps.dtype == torch.int32


def test_init_states():
    r = np.random.default_rng(2)
    p = _t(_tree(r, 1.0))
    opt = adamw.adamw_init(p)
    assert int(opt.step) == 0 and opt.step.dtype == torch.int32
    assert all(float(x.abs().sum()) == 0.0 for x in jax.tree.leaves(dict(opt.m)))
    assert float(adamw.scale_init(None).scale) == 1.0
    assert float(adamw.scale_init(4096.0).scale) == 4096.0
    assert adamw.AdamWConfig()._fields == jadam.AdamWConfig()._fields
    assert tuple(adamw.AdamWConfig()) == tuple(jadam.AdamWConfig())
    assert adamw.OptState._fields == jadam.OptState._fields
    assert adamw.ScaleState._fields == jadam.ScaleState._fields
