"""The port's RG-LRU block (``repro_torch/models/rglru.py``) against the
reference's ``repro/models/rglru.py`` on the CPU, from the same numpy
inputs and weights.

The recurrence and the K = 4 conv are bit for bit the reference's jitted
ones on the same inputs (``tests/test_torch_mamba.py`` holds the shared
scan and conv; here ``_conv4`` and the recurrence on the block's own
gates). The gates are not: XLA CPU fuses ``sigmoid``, ``exp`` and
``sqrt(1 - a^2)`` and rounds them its own way, so an f32 ulp of the gated
input (about 4 in 5 of them, up to 6.6e-7) reaches every later position
through the recurrence. The block, its state and its decode steps are
held at 1e-5 relative to their scale, and at 1e-4 under fp16 weights,
where a projection input one f32 ulp apart can round a whole fp16 ulp
apart (1.7e-5 measured; ROADMAP queue C)."""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduce_arch as jreduce
from repro.models import rglru as jrglru
from repro_torch import configs
from repro_torch.models import rglru, scan

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "float16": dict(rtol=1e-4, atol=1e-4)}


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@functools.cache
def _weights(dtype):
    cfg = jreduce(jget_arch("recurrentgemma-2b"))
    return cfg, jax.tree.map(np.asarray, jrglru.init_rglru(jax.random.key(6), cfg,
                                                           jnp.dtype(dtype)))


def _port(w):
    return SimpleNamespace(**{k: torch.from_numpy(np.array(v)) for k, v in w.items()})


def _close(got, want, tol):
    want = np.asarray(want).astype(np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.float().numpy() / scale, want / scale, **tol)


@pytest.mark.parametrize("hist", [False, True])
def test_conv4_is_the_references_bit_for_bit(hist):
    x, w, b = _rand(1, (2, 17, 64)), _rand(2, (4, 64)), _rand(3, 64)
    args = (x, w, b, _rand(4, (2, 3, 64))) if hist else (x, w, b)
    want = np.asarray(jax.jit(jrglru._conv4)(*args))
    np.testing.assert_array_equal(scan.causal_conv(*map(torch.from_numpy, args)).numpy(), want)


def test_recurrence_on_the_references_gates_is_bit_for_bit():
    """The reference's gates fed to the port's scan give the reference's h."""
    jcfg, w = _weights("float32")
    xc = _rand(5, (2, 40, 64))
    a, g = jax.jit(jrglru._gates)(w, xc)

    def combine(p, q):
        return p[0] * q[0], q[0] * p[1] + q[1]

    want = jax.jit(lambda a, g: jax.lax.associative_scan(combine, (a, g), axis=1)[1])(a, g)
    got = scan.associative_scan(torch.from_numpy(np.array(a)), torch.from_numpy(np.array(g)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want))


def test_gates_match_reference():
    """a within 1e-6; the gated input within 4e-6 (1.2e-6 measured): an ulp
    of a near 1 moves ``sqrt(1 - a^2)`` by far more than an ulp."""
    jcfg, w = _weights("float32")
    xc = _rand(6, (2, 40, 64))
    a, g = jax.jit(jrglru._gates)(w, xc)
    pa, pg = rglru._gates(_port(w), torch.from_numpy(xc), None)
    np.testing.assert_allclose(pa.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
    _close(pg, g, dict(rtol=0, atol=4e-6))


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_rglru_apply_and_decode_match_reference(dtype):
    """The block over 40 tokens (with its decode state), then 3 decode
    steps from that state, against the reference's jitted ones."""
    jcfg, w = _weights(dtype)
    cfg = configs.reduce_arch(configs.get_arch("recurrentgemma-2b"))
    x = _rand(7, (2, 40, 64))
    want, wst = jax.jit(lambda w, x: jrglru.rglru_apply(w, x, jcfg, return_state=True))(w, x)
    p = _port(w)
    got, st = rglru.rglru_apply(p, torch.from_numpy(x), cfg, return_state=True)
    _close(got, want, TOL[dtype])
    for k in ("h", "conv"):
        _close(st[k], wst[k], TOL[dtype])
    step = jax.jit(lambda w, x, c: jrglru.rglru_decode_step(w, x, c, jcfg))
    cache = {k: v.clone() for k, v in st.items()}
    for i in range(3):
        xi = _rand(10 + i, (2, 1, 64))
        want, wst = step(w, xi, wst)
        got = rglru.rglru_decode_step(p, torch.from_numpy(xi), cache, cfg)
        _close(got, want, TOL[dtype])
        for k in ("h", "conv"):
            _close(cache[k], wst[k], TOL[dtype])


def test_init_and_cache_layout():
    """The port's own draws in the reference's shapes and dtypes (``b_a``,
    ``b_x`` and ``lam`` f32 under fp16 storage), ``a`` within (0.9, 0.999)
    at r = 1, and a short prompt refused."""
    jcfg, w = _weights("float16")
    cfg = configs.reduce_arch(configs.get_arch("recurrentgemma-2b"))
    p = rglru.RGLRU(cfg, torch.Generator().manual_seed(0), torch.float16)
    for name, want in w.items():
        got = getattr(p, name)
        assert tuple(got.shape) == want.shape and str(got.dtype)[6:] == str(want.dtype), name
    a = torch.exp(-8.0 * torch.nn.functional.softplus(p.lam))
    assert bool(((a > 0.9) & (a < 0.999)).all())
    cache = rglru.init_rglru_cache(cfg, 2, torch.float16, "cpu")
    assert cache["h"].shape == (2, 64) and cache["conv"].shape == (2, 3, 64)
    with pytest.raises(ValueError, match="shorter than the conv"):
        rglru.rglru_apply(p, torch.randn(1, 2, 64), cfg, return_state=True)
