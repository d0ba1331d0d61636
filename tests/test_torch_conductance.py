"""The port's conductance-based synapses (``repro_torch.core.conductance``)
against the reference's (``repro.core.conductance``) on the CPU.

The decay factors are the f32 ``exp`` of the f32 ``-dt/τ``, bit for bit
with ``jnp.exp``. ``decay_and_deliver`` and ``coba_current`` are held bit
for bit against the reference evaluated op by op (``jax.disable_jit()``)
on 10^5 random inputs per storage dtype: eager PyTorch rounds every
operation on its own, as the op-by-op reference does (the reference's
default jit contracts mul+add, which the engine tests meet on whole runs).
The kernels' plain versions (``kernels/ref.py``) and coefficients
(``backend.coba_coeffs``) are held against the same functions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import conductance as rcond  # noqa: E402
from repro_torch.core import backend as be  # noqa: E402
from repro_torch.core import conductance as tcond  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TAUS = [2.0, 3.0, 5.0, 6.0, 7.5, 10.0, 20.0, 100.0, 150.0]
N = 100_000
STORAGE = {"fp16": (np.float16, torch.float16), "fp32": (np.float32, torch.float32)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype == np.float16 else np.uint32)


def random_inputs(policy: str, seed: int = 0):
    """Conductances in [0, 5) in the storage dtype, excitatory and
    inhibitory deliveries in [0, 3) f32 (a third of them zero, as a tick's
    silent rows are), and membrane potentials around rest in the storage
    dtype, some far above threshold and below reversal."""
    npdt, _ = STORAGE[policy]
    rng = np.random.default_rng(seed)
    g = [(rng.random(N) * 5).astype(npdt) for _ in range(4)]
    exc, inh = ((rng.random(N) * 3 * (rng.random(N) < 0.67)).astype(np.float32)
                for _ in range(2))
    v = rng.normal(-60.0, 25.0, N).astype(npdt)
    return g, exc, inh, v


@pytest.mark.parametrize("tau", TAUS)
def test_decay_factors_equal_jnp_exp(tau):
    cfg = tcond.COBAConfig(tau_ampa=tau, tau_nmda=tau, tau_gabaa=tau, tau_gabab=tau)
    want = np.asarray(jnp.exp(-1.0 / tau))
    got = tcond.decay_factors(cfg, 1.0)
    assert all(np.float32(x) == want and bits(np.float32(x)) == bits(want) for x in got)


def test_decay_factors_are_f32_exp_not_rounded_double():
    """At τ = 3 the double-precision exp rounded to f32 is one ulp away;
    the port takes the f32 exp, as the reference does."""
    got = np.float32(tcond.decay_factors(tcond.COBAConfig(tau_ampa=3.0), 1.0)[0])
    assert got == np.asarray(jnp.exp(-1.0 / 3.0))
    assert got != np.float32(np.exp(-1.0 / 3.0))


@pytest.mark.parametrize("policy", ["fp16", "fp32"])
def test_decay_and_deliver_bitwise_op_by_op(policy):
    g, exc, inh, _ = random_inputs(policy)
    with jax.disable_jit():
        want = rcond.decay_and_deliver(rcond.COBAConfig(),
                                       rcond.ConductanceState(*map(jnp.asarray, g)),
                                       jnp.asarray(exc), jnp.asarray(inh), 1.0)
    got = tcond.decay_and_deliver(tcond.COBAConfig(),
                                  tcond.ConductanceState(*map(torch.from_numpy, g)),
                                  torch.from_numpy(exc), torch.from_numpy(inh), 1.0)
    for name, w, t in zip(tcond.ConductanceState._fields, want, got):
        assert t.dtype == STORAGE[policy][1]
        np.testing.assert_array_equal(bits(t.numpy()), bits(w), err_msg=name)


@pytest.mark.parametrize("policy", ["fp16", "fp32"])
def test_coba_current_bitwise_op_by_op(policy):
    g, _, _, v = random_inputs(policy, seed=1)
    with jax.disable_jit():
        want = rcond.coba_current(rcond.COBAConfig(),
                                  rcond.ConductanceState(*map(jnp.asarray, g)),
                                  jnp.asarray(v))
    state = tcond.ConductanceState(*map(torch.from_numpy, g))
    got = tcond.coba_current(tcond.COBAConfig(), state, torch.from_numpy(v))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    plain = ref.coba_current_ref(state, torch.from_numpy(v), _coeffs())
    np.testing.assert_array_equal(bits(plain.numpy()), bits(want))


def _coeffs(dt: float = 1.0):
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class Static:
        coba: tcond.COBAConfig = tcond.COBAConfig()
        dt: float = 1.0

    return be.coba_coeffs(Static(dt=dt))


def test_kernel_coefficients_are_the_references_f32_scalars():
    c = _coeffs()
    cfg = rcond.COBAConfig()
    assert c.decay == tcond.decay_factors(tcond.COBAConfig(), 1.0)
    want = [np.float32(1.0 - cfg.nmda_frac), np.float32(cfg.nmda_frac),
            np.float32(1.0 - cfg.gabab_frac), np.float32(cfg.gabab_frac)]
    assert [np.float32(x) for x in c.frac] == want
    assert all(float(np.float32(x)) == x for x in (*c.decay, *c.frac, c.e_exc, c.e_gabaa,
                                                   c.e_gabab))
    assert (c.e_exc, c.e_gabaa, c.e_gabab) == (0.0, -70.0, -90.0)


def test_decay_factors_given_or_computed_agree():
    g, exc, inh, _ = random_inputs("fp16", seed=2)
    state = tcond.ConductanceState(*map(torch.from_numpy, g))
    cfg = tcond.COBAConfig()
    a = tcond.decay_and_deliver(cfg, state, torch.from_numpy(exc), torch.from_numpy(inh), 1.0)
    b = tcond.decay_and_deliver(cfg, state, torch.from_numpy(exc), torch.from_numpy(inh), 1.0,
                                tcond.decay_factors(cfg, 1.0))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_init_state_matches_reference():
    for dt_np, dt_t in STORAGE.values():
        want = rcond.init_conductance_state(7, jnp.dtype(dt_np))
        got = tcond.init_conductance_state(7, dt_t)
        for w, t in zip(want, got):
            assert t.dtype == dt_t and t.shape == (7,)
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))
        assert len({t.data_ptr() for t in got}) == 4  # four tensors, not one shared


class TestCOBA:
    """The reference's ``tests/test_snn_core.py::TestCOBA`` unit cases on the
    port, each also equal to the reference's own numbers."""

    def _deliver(self, exc, inh):
        s = tcond.init_conductance_state(1)
        return tcond.decay_and_deliver(tcond.COBAConfig(), s, torch.full((1,), exc),
                                       torch.full((1,), inh), dt=1.0)

    def test_conductance_decay(self):
        cfg = tcond.COBAConfig()
        s = self._deliver(1.0, 0.0)
        g0 = float(s.g_ampa[0])
        rs = rcond.decay_and_deliver(rcond.COBAConfig(), rcond.init_conductance_state(1),
                                     jnp.ones((1,)), jnp.zeros((1,)), dt=1.0)
        for _ in range(20):
            s = tcond.decay_and_deliver(cfg, s, torch.zeros(1), torch.zeros(1), dt=1.0)
            rs = rcond.decay_and_deliver(rcond.COBAConfig(), rs, jnp.zeros((1,)),
                                         jnp.zeros((1,)), dt=1.0)
        assert float(s.g_ampa[0]) < 0.05 * g0
        assert float(s.g_ampa[0]) == float(rs.g_ampa[0])

    def test_excitatory_current_positive_at_rest(self):
        i = tcond.coba_current(tcond.COBAConfig(), self._deliver(1.0, 0.0),
                               torch.full((1,), -65.0))
        assert float(i[0]) > 0

    def test_inhibitory_current_negative_above_reversal(self):
        i = tcond.coba_current(tcond.COBAConfig(), self._deliver(0.0, 1.0),
                               torch.full((1,), -50.0))
        assert float(i[0]) < 0
