"""The port's MoE layer (``repro_torch/models/moe.py``) against the
reference's ``repro/models/moe.py`` on the CPU, from the same numpy
inputs and weights.

Routes (the top-k experts of each token, ties to the lower index) and the
capacity dispatch (each assignment's slot, which assignments drop, the
``[B, E, C, D]`` buffer) must equal the reference's exactly; the layer's
output and aux loss are held at 1e-6 (f32 sum orders of the products and
the softmax; measured below 3e-7). Two calls give the same bits."""
import dataclasses
import functools
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduce_arch as jreduce
from repro.models import moe as jmoe
from repro.models.layers import dense as jdense
from repro_torch import configs
from repro_torch.models import moe

ARCHS = ("granite-moe-1b-a400m", "qwen2-moe-a2.7b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, cf=None):
    jcfg, cfg = jreduce(jget_arch(arch)), configs.reduce_arch(configs.get_arch(arch))
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return jcfg, cfg


@functools.cache
def _weights(arch, dtype):
    jcfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, jmoe.init_moe(jax.random.key(3), jcfg, jnp.dtype(dtype)))


def _port(w: dict):
    t = {k: torch.from_numpy(np.array(v)) for k, v in w.items() if k != "shared"}
    shared = None
    if "shared" in w:
        shared = SimpleNamespace(kind="swiglu", **{k: torch.from_numpy(np.array(v))
                                                   for k, v in w["shared"].items()})
    return SimpleNamespace(shared=shared, **t)


def _x(seed=0, b=2, s=24, d=64):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _ref_routes(w, x, cfg):
    logits = jdense(jnp.asarray(x), jnp.asarray(w["router"]))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    g, e = jax.lax.top_k(probs, cfg.moe.top_k)
    return np.asarray(probs), np.asarray(e), np.asarray(g / g.sum(-1, keepdims=True))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_routes_match_reference(arch, dtype):
    jcfg, cfg = _cfgs(arch)
    w, x = _weights(arch, dtype), _x(1)
    probs, eids, gates = _ref_routes(w, x, jcfg)
    p_probs, p_eids, p_gates = moe.route(_port(w), torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(p_eids.numpy(), eids)
    np.testing.assert_allclose(p_probs.numpy(), probs, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(p_gates.numpy(), gates, rtol=1e-6, atol=1e-7)


def test_top_k_ties_take_the_lower_index():
    """``jax.lax.top_k`` puts the lower index first on equal values; so does
    the port's stable descending sort."""
    _, cfg = _cfgs("granite-moe-1b-a400m")
    e = cfg.moe.n_experts
    w = {"router": np.zeros((64, e), np.float32)}
    w["router"][:, 3] = w["router"][:, 5] = 1.0  # experts 3 and 5 tie on every token
    x = np.abs(_x(2))
    ref = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(x @ w["router"]), -1),
                                   cfg.moe.top_k)[1])
    got = moe.route(SimpleNamespace(router=torch.from_numpy(w["router"])),
                    torch.from_numpy(x), cfg)[1]
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got[..., 0] == 3).all() and (got[..., 1] == 5).all()


@pytest.mark.parametrize("cap", [1, 3, 6, 12])
def test_dispatch_matches_reference(cap):
    """Random routes of 8 experts, top 2, at capacities that drop most,
    some and none of the assignments: the slots, the drops and the buffer
    equal the reference's ``_dispatch_group``."""
    rng = np.random.default_rng(cap)
    b, s, k, e, d = 3, 20, 2, 8, 4
    eids = np.stack([np.stack([rng.choice(e, k, replace=False) for _ in range(s)])
                     for _ in range(b)]).astype(np.int32)
    gates = rng.random((b, s, k)).astype(np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    buf, se, st, slot, wgt = jax.vmap(
        lambda xg, ei, ga: jmoe._dispatch_group(xg, ei, ga, e=e, cap=cap))(x, eids, gates)
    plan = moe.dispatch_plan(torch.from_numpy(eids.astype(np.int64)), e, cap)
    order = np.argsort(eids.reshape(b, -1), axis=-1, kind="stable")
    want_slot = np.empty((b, s * k), np.int64)
    np.put_along_axis(want_slot, order, np.minimum(np.asarray(slot), cap), axis=-1)
    got_slot = np.where(plan["keep"].numpy(), plan["slot"].numpy(), cap).reshape(b, -1)
    np.testing.assert_array_equal(got_slot, want_slot)
    tok = plan["token"].numpy()
    got_buf = np.where(plan["filled"].numpy()[..., None],
                       np.take_along_axis(x[:, None], tok[..., None], axis=2), 0.0)
    np.testing.assert_array_equal(got_buf, np.asarray(buf))
    assert int((~plan["keep"]).sum()) == int((np.asarray(wgt) == 0).sum())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("cf", [None, 0.5])
def test_moe_apply_matches_reference(arch, dtype, cf):
    """The whole layer (dispatch, the experts in the weights' dtype with f32
    accumulation, combine, shared experts) against the reference's jitted
    ``moe_apply``, at the default capacity and at half of it (drops)."""
    jcfg, cfg = _cfgs(arch, cf)
    w, x = _weights(arch, dtype), _x(4)
    want, waux = jax.jit(lambda w, x: jmoe.moe_apply(w, x, jcfg))(w, x)
    got, aux = moe.moe_apply(_port(w), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    if cf is not None:
        m, s = cfg.moe, x.shape[1]
        cap = math.ceil(s * m.top_k / m.n_experts * m.capacity_factor)
        eids = moe.route(_port(w), torch.from_numpy(x), cfg)[1]
        assert bool((~moe.dispatch_plan(eids, m.n_experts, cap)["keep"]).any())


def test_two_calls_give_the_same_bits_and_gradients_flow():
    _, cfg = _cfgs("qwen2-moe-a2.7b", 0.5)
    w = _port(_weights("qwen2-moe-a2.7b", "float32"))
    x = torch.from_numpy(_x(5))
    a, b = moe.moe_apply(w, x, cfg)[0], moe.moe_apply(w, x, cfg)[0]
    assert torch.equal(a, b)
    leaves = [w.w_gate, w.router]
    for t in leaves:
        t.requires_grad_()
    out, aux = moe.moe_apply(w, x, cfg)
    g_gate, g_router = torch.autograd.grad(out.square().sum() + aux, leaves)
    assert torch.isfinite(g_gate).all() and g_gate.abs().sum() > 0
    assert torch.isfinite(g_router).all() and g_router.abs().sum() > 0
