"""The port's precision policies and int8 storage (``repro_torch.precision``)
against the reference's on the CPU.

``store``, ``store_state``, ``load``, ``bytes_per_param``, ``store_tree``
and ``load_tree`` are bit for bit the reference's under all five policies
on the same numpy inputs (zeros, f32 subnormals, +-65,504 and beyond, NaN
and inf among them; NaNs compare by place, not by bits). Stochastic
rounding draws the reference's uniforms from the port's threefry key of
the same seed and reproduces XLA CPU's arithmetic (its exp2 at integer
exponents, its flush of f32 subnormals), so it is bitwise too.
``quantize_int8``/``dequantize`` are bitwise over both axes. The
reference's property tests (``tests/test_precision.py::TestFp16Storage``)
are mirrored with the same hypothesis strategies."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip(
    "hypothesis",
    reason="property tests need hypothesis (pip install -r requirements-dev.txt)",
)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.precision as jprec  # noqa: E402
from repro.precision.policy import _stochastic_round as j_sr  # noqa: E402
import repro_torch.precision as prec  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.precision import (  # noqa: E402
    dequantize, get_policy, quantize_int8, store_tree, tree_bytes,
)
from repro_torch.precision.policy import xla_exp2  # noqa: E402

POLICIES = ("fp32", "fp16", "bf16", "fp16_opt", "fp16_sr")
_TORCH = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}

floats = st.floats(min_value=-60000.0, max_value=60000.0,
                   allow_nan=False, allow_infinity=False, width=32)

EDGE = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, 3e-39, -5e-39, 1.1754944e-38, 2.5e-38,
                 1e-37, 1e-30, 1e-8, 5.9604645e-08, 6e-8, 6.1e-5, 1.0, -1.5, 3.1415927,
                 65504.0, -65504.0, 65519.0, 65520.0, -65520.0, 1e5, 3.389e38, -3.4e38,
                 np.inf, -np.inf, np.nan], np.float32)


def _inputs() -> np.ndarray:
    r = np.random.default_rng(0)
    return np.concatenate([
        EDGE, r.standard_normal(500).astype(np.float32),
        (r.standard_normal(500) * 10.0 ** r.integers(-40, 38, 500)).astype(np.float32),
        r.integers(0, 2**32, 2000, dtype=np.uint64).astype(np.uint32).view(np.float32)])


def _bits(x) -> tuple[np.ndarray, np.ndarray]:
    """(NaN mask, unsigned bit patterns with NaNs zeroed) of a port tensor
    or a reference array."""
    if isinstance(x, torch.Tensor):
        nan = x.isnan().numpy()
        width = {1: torch.int8, 2: torch.int16, 4: torch.int32}[x.element_size()]
        raw = x.view(width).numpy() if x.is_floating_point() else x.numpy()
    else:
        a = np.asarray(x)
        nan = np.isnan(a.astype(np.float32)) if a.dtype.kind in "fV" else np.zeros(a.shape, bool)
        raw = a.view({1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[a.dtype.itemsize])
    return nan, np.where(nan, 0, raw)


def assert_same_bits(got, want):
    assert str(got.dtype).split(".")[-1] == np.dtype(want.dtype).name, (got.dtype, want.dtype)
    assert tuple(got.shape) == tuple(np.shape(want))
    (gn, gb), (wn, wb) = _bits(got), _bits(want)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(gb, wb)


# -- the reference's property tests, on the port ---------------------------------------


class TestFp16Storage:
    @given(st.lists(floats, min_size=1, max_size=64))
    @settings(max_examples=50, deadline=None)
    def test_fp16_roundtrip_error_bounded(self, xs):
        """|fp16(x) - x| <= 2^-11 |x| + tiny: the paper's 'no loss of
        function' regime for Synfire weights (|w| in [1, 3.5])."""
        x = torch.tensor(xs, dtype=torch.float32)
        y = get_policy("fp16").store(x).to(torch.float32)
        err = (y - x).abs().numpy()
        bound = x.abs().numpy() * 2.0**-11 + 2.0**-24 + 1e-12
        assert np.all(err <= bound)

    @given(st.lists(floats, min_size=1, max_size=64))
    @settings(max_examples=50, deadline=None)
    def test_storage_halves_bytes(self, xs):
        x = torch.tensor(xs, dtype=torch.float32)
        assert tree_bytes(get_policy("fp16").store(x)) * 2 == tree_bytes(x)

    @given(st.floats(min_value=-1000.0, max_value=1000.0, allow_nan=False,
                     allow_infinity=False, width=32))
    @settings(max_examples=30, deadline=None)
    def test_stochastic_rounding_unbiased(self, v):
        x = torch.full((4096,), v, dtype=torch.float32)
        y = get_policy("fp16_sr").store(x, key=rng.key(0))
        mean = float(y.to(torch.float32).mean())
        # SR error of the mean shrinks ~ ulp/sqrt(n); allow 4 sigma-ish.
        ulp = max(abs(v), 2**-14) * 2.0**-10
        assert abs(mean - v) <= 4 * ulp / np.sqrt(4096) + 1e-7

    @given(st.lists(floats, min_size=2, max_size=128))
    @settings(max_examples=50, deadline=None)
    def test_int8_quant_error_bound(self, xs):
        x = torch.tensor(xs, dtype=torch.float32)[None, :]
        back = dequantize(quantize_int8(x))
        amax = float(x.abs().max())
        err = float((back - x).abs().max())
        assert err <= amax / 127.0 * 0.5 + 1e-9  # half-step of the grid

    def test_policy_load_passthrough_ints(self):
        idx = torch.arange(10, dtype=torch.int32)
        assert get_policy("fp16").load(idx).dtype == torch.int32


# -- policies against the reference ----------------------------------------------------


def test_exports_match_reference():
    assert prec.__all__ == jprec.__all__
    assert sorted(prec.POLICIES) == sorted(jprec.POLICIES)


@pytest.mark.parametrize("name", POLICIES)
def test_policy_fields_match_reference(name):
    p, j = get_policy(name), jprec.get_policy(name)
    for f in ("param_storage", "state_storage", "compute", "accum"):
        assert getattr(p, f) == _TORCH[jnp.dtype(getattr(j, f)).name], f
    assert (p.name, p.master_fp32, p.loss_scale, p.stochastic_round) == (
        j.name, j.master_fp32, j.loss_scale, j.stochastic_round)
    assert p.bytes_per_param == j.bytes_per_param


def test_unknown_policy_raises():
    with pytest.raises(KeyError, match="fp16_sr"):
        get_policy("fp8")


@pytest.mark.parametrize("method", ["store", "store_state"])
@pytest.mark.parametrize("name", POLICIES)
def test_store_bitwise(name, method):
    """Round-to-nearest downcasts (no key) of f32, f16 and bf16 inputs."""
    x = _inputs()
    p, j = get_policy(name), jprec.get_policy(name)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.float16, jnp.float16),
                    (torch.bfloat16, jnp.bfloat16)):
        jx = jnp.asarray(x).astype(jdt)
        tx = torch.from_numpy(x).to(dt)
        assert_same_bits(getattr(p, method)(tx), getattr(j, method)(jx))


@pytest.mark.parametrize("name", POLICIES)
def test_load_bitwise(name):
    x = _inputs()
    p, j = get_policy(name), jprec.get_policy(name)
    for dt, jdt in ((torch.float16, jnp.float16), (torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        assert_same_bits(p.load(torch.from_numpy(x).to(dt)), j.load(jnp.asarray(x).astype(jdt)))
    ints = np.arange(-5, 5, dtype=np.int32)
    assert_same_bits(p.load(torch.from_numpy(ints)), j.load(jnp.asarray(ints)))


def test_xla_exp2_matches_xla():
    """XLA CPU's exp2 at every integer exponent stochastic rounding can
    reach (and beyond): 244 of them are not 2**k, and k <= -126 gives 0."""
    k = np.arange(-170, 121, dtype=np.int32)
    want = np.asarray(jnp.exp2(jnp.asarray(k.astype(np.float32))))
    got = xla_exp2(torch.from_numpy(k))
    assert_same_bits(got, want)
    exact = np.ldexp(np.float64(1.0), k.astype(np.int64)).astype(np.float32)
    assert (want != exact).sum() > 200  # the reason for the table


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_stochastic_round_bitwise(dtype, seed):
    """The port's stochastic rounding equals the reference's bit for bit
    under the same seed, on edge values (f32 subnormals flush to zero; under
    bf16 a value whose ulp XLA's exp2 puts at 0 becomes NaN in both),
    normals over the whole f32 range and random bit patterns."""
    x = _inputs()
    want = j_sr(jnp.asarray(x), jnp.dtype(dtype), jax.random.key(seed))
    got = prec.policy._stochastic_round(torch.from_numpy(x), _TORCH[dtype], rng.key(seed))
    assert_same_bits(got, want)


@pytest.mark.parametrize("seed", [0, 11])
def test_fp16_sr_store_with_key_bitwise(seed):
    """``fp16_sr``'s store and store_state with a key round stochastically,
    and differ from round to nearest; without a key they round to nearest."""
    x = np.random.default_rng(seed).standard_normal((64, 33)).astype(np.float32) * 50
    p, j = get_policy("fp16_sr"), jprec.get_policy("fp16_sr")
    for method in ("store", "store_state"):
        got = getattr(p, method)(torch.from_numpy(x), key=rng.key(seed))
        assert_same_bits(got, getattr(j, method)(jnp.asarray(x), key=jax.random.key(seed)))
        assert not torch.equal(got, torch.from_numpy(x).half())
    assert_same_bits(p.store(torch.from_numpy(x)), j.store(jnp.asarray(x)))


def _tree(x: np.ndarray, lib):
    """A tree of dicts (unsorted keys), tuples, a NamedTuple and None."""
    as_arr = (lambda a: jnp.asarray(a)) if lib == "jax" else (lambda a: torch.from_numpy(a))
    return {"zeta": as_arr(x[:7]),
            "alpha": (as_arr(x[7:20]), None, as_arr(np.arange(4, dtype=np.int32))),
            "mid": jprec.QTensor(as_arr(x[20:26]), as_arr(x[26:40]))
            if lib == "jax" else prec.QTensor(as_arr(x[20:26]), as_arr(x[26:40]))}


def _leaves(tree) -> list:
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += _leaves(tree[k])
    elif isinstance(tree, tuple):
        for v in tree:
            out += _leaves(v)
    elif tree is not None:
        out.append(tree)
    return out


@pytest.mark.parametrize("key", [None, 5])
@pytest.mark.parametrize("name", POLICIES)
def test_store_tree_bitwise(name, key):
    """Leaf i draws from split key i in ``jax.tree.flatten``'s order (dict
    keys sorted, NamedTuple fields in order, None no leaf), so every leaf
    equals the reference's; the structure is kept, dicts rebuilt in sorted
    key order as ``jax.tree.unflatten`` rebuilds them."""
    x = np.random.default_rng(3).standard_normal(40).astype(np.float32) * 9
    jtree = jprec.store_tree(_tree(x, "jax"), jprec.get_policy(name),
                             key=None if key is None else jax.random.key(key))
    tree = store_tree(_tree(x, "torch"), get_policy(name),
                      key=None if key is None else rng.key(key))
    assert isinstance(tree["mid"], prec.QTensor) and tree["alpha"][1] is None
    assert list(tree) == list(jtree) == ["alpha", "mid", "zeta"]  # unflatten sorts, as jax
    for got, want in zip(_leaves(tree), jax.tree.leaves(jtree), strict=True):
        assert_same_bits(got, want)
    back = prec.load_tree(tree, get_policy(name))
    jback = jprec.load_tree(jtree, jprec.get_policy(name))
    for got, want in zip(_leaves(back), jax.tree.leaves(jback), strict=True):
        assert_same_bits(got, want)


# -- int8 storage ---------------------------------------------------------------------


@pytest.mark.parametrize("axis", [0, -1])
def test_quantize_int8_bitwise(axis):
    """``data`` and ``scale`` bit for bit, all-zero slices (scale 1.0) and
    exact halves (round half to even) included; dequantize too."""
    r = np.random.default_rng(axis + 2)
    x = (r.standard_normal((9, 13)) * r.uniform(0.01, 50, (9, 1))).astype(np.float32)
    x[2, :] = 0.0
    x[:, 4] = 0.0
    x[5, :3] = [127.0, 0.5, -1.5]  # halves of the grid at amax 127
    x[5, 3:] = 0.0
    q, jq = quantize_int8(torch.from_numpy(x), axis=axis), jprec.quantize_int8(jnp.asarray(x),
                                                                               axis=axis)
    assert_same_bits(q.data, jq.data)
    assert_same_bits(q.scale, jq.scale)
    assert q.shape == jq.shape and q.nbytes == jq.nbytes
    for dt, jdt in ((torch.float32, jnp.float32), (torch.float16, jnp.float16),
                    (torch.bfloat16, jnp.bfloat16)):
        assert_same_bits(dequantize(q, dt), jprec.dequantize(jq, jdt))


def test_int8_quarter_the_bytes():
    w = torch.ones((200, 200), dtype=torch.float32) * 1.5
    q = quantize_int8(w, axis=0)
    assert q.nbytes <= w.numel() * 4 / 4 + 4 * w.shape[1]
    assert q.data.dtype == torch.int8 and q.scale.shape == (1, 200)
