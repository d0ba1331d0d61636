"""The port's Mamba block (``repro_torch/models/mamba.py``) and its scan
and conv (``repro_torch/models/scan.py``) against the reference's
``repro/models/mamba.py`` on the CPU, from the same numpy inputs and
weights.

XLA CPU contracts the reference's ``a2 * b1 + b2`` and its conv's
shifted multiply-adds into fused multiply-adds under ``jax.jit``; the
port rounds them once too (``scan.fma``), in the reference's
``associative_scan`` recursion, so the scan (whole and chunked, the
``SSM_CHUNK`` lever) and the causal conv are bit for bit the reference's
jitted ones. The block around them (softplus, exp, silu and the
projections in other orders) is held at 1e-5 relative to its output's
scale, its decode steps and state likewise."""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduce_arch as jreduce
from repro.models import mamba as jmamba
from repro_torch import configs
from repro_torch.models import mamba, scan

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _reset_ssm_chunk():
    """Both packages' trace-time lever back to a single scan around each
    test (what the reference's own conftest does for its package)."""
    yield
    jmamba.set_ssm_chunk(0)
    mamba.set_ssm_chunk(0)


def _rand(seed, shape, lo=None):
    r = np.random.default_rng(seed)
    if lo is not None:
        return r.uniform(lo, 1.0, shape).astype(np.float32)
    return r.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("s", [1, 2, 5, 16, 37, 64])
def test_scan_is_the_references_bit_for_bit(s):
    a, b = _rand(s, (2, s, 6, 4), lo=0.5), _rand(s + 1, (2, s, 6, 4))
    want = np.asarray(jax.jit(jmamba._ssm_scan)(a, b))
    got = scan.associative_scan(torch.from_numpy(a), torch.from_numpy(b))[1]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_scan_is_the_references_bit_for_bit(chunk):
    a, b = _rand(3, (2, 32, 6, 4), lo=0.5), _rand(4, (2, 32, 6, 4))
    jmamba.set_ssm_chunk(chunk)  # a trace-time constant: a fresh function to trace
    want = np.asarray(jax.jit(lambda a, b: jmamba._ssm_scan(a, b))(a, b))
    mamba.set_ssm_chunk(chunk)
    got = mamba._ssm_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hist", [False, True])
@pytest.mark.parametrize("wdtype", [np.float32, np.float16])
def test_causal_conv_is_the_references_bit_for_bit(hist, wdtype):
    x, w, b = _rand(5, (2, 20, 16)), _rand(6, (4, 16)).astype(wdtype), _rand(7, 16).astype(wdtype)
    h = _rand(8, (2, 3, 16)) if hist else None
    args = (x, w, b) if h is None else (x, w, b, h)
    want = np.asarray(jax.jit(jmamba._causal_conv)(*args))
    got = scan.causal_conv(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(got.numpy(), want)


@functools.cache
def _weights(dtype):
    cfg = jreduce(jget_arch("falcon-mamba-7b"))
    return cfg, jax.tree.map(np.asarray, jmamba.init_mamba(jax.random.key(5), cfg,
                                                           jnp.dtype(dtype)))


def _port(w):
    return SimpleNamespace(**{k: torch.from_numpy(np.array(v)) for k, v in w.items()})


def _close(got, want):
    want = np.asarray(want).astype(np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.float().numpy() / scale, want / scale, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("chunk", [0, 8])
def test_mamba_apply_and_decode_match_reference(dtype, chunk):
    """The block over 24 tokens (with its decode state) and then 3 decode
    steps from that state, against the reference's jitted ones."""
    jcfg, w = _weights(dtype)
    cfg = configs.reduce_arch(configs.get_arch("falcon-mamba-7b"))
    jmamba.set_ssm_chunk(chunk)
    mamba.set_ssm_chunk(chunk)
    x = _rand(9, (2, 24, 64))
    want, wst = jax.jit(lambda w, x: jmamba.mamba_apply(w, x, jcfg, return_state=True))(w, x)
    p = _port(w)
    got, st = mamba.mamba_apply(p, torch.from_numpy(x), cfg, return_state=True)
    _close(got, want)
    for k in ("conv", "ssm"):
        _close(st[k], wst[k])
    step = jax.jit(lambda w, x, c: jmamba.mamba_decode_step(w, x, c, jcfg))
    cache = {k: v.clone() for k, v in st.items()}
    for i in range(3):
        xi = _rand(10 + i, (2, 1, 64))
        want, wst = step(w, xi, wst)
        got = mamba.mamba_decode_step(p, torch.from_numpy(xi), cache, cfg)
        _close(got, want)
        for k in ("conv", "ssm"):
            _close(cache[k], wst[k])


def test_decode_cache_keeps_its_dtype_and_a_short_prompt_raises():
    cfg = configs.reduce_arch(configs.get_arch("falcon-mamba-7b"))
    p = mamba.Mamba(cfg, torch.Generator().manual_seed(0), torch.float16)
    cache = mamba.init_mamba_cache(cfg, 2, torch.float16, "cpu")
    out = mamba.mamba_decode_step(p, torch.randn(2, 1, 64), cache, cfg)
    assert out.shape == (2, 1, 64) and cache["ssm"].dtype == torch.float16
    assert bool(cache["ssm"].abs().sum() > 0)
    with pytest.raises(ValueError, match="shorter than the conv"):
        mamba.mamba_apply(p, torch.randn(1, 2, 64), cfg, return_state=True)
