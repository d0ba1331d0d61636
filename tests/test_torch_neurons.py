"""The port's neuron models against the reference's: parameter factories
and initial state bit for bit, and the generic Euler/RK4 update of mixed
IZH4/IZH9/LIF/generator populations against the reference evaluated
eagerly (op by op, as PyTorch does)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import neurons as rn  # noqa: E402
from repro_torch.core import neurons as tn  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread keeps PyTorch's thread
    pool from spinning against the other test workers' cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _population(lib):
    return lib.concat_params([
        lib.izh4(5, a=0.02, b=0.2, c=-65.0, d=8.0),
        lib.izh9(4, C=100.0, k=0.7, vr=-60.0, vt=-40.0, vpeak=35.0,
                 a=0.03, b=-2.0, c=-50.0, d=100.0),
        lib.lif(4, tau=10.0, vth=-50.0, vreset=-65.0, tref=2.0),
        lib.generator(3),
    ])


def test_params_and_rest_state_match():
    tp, rp = _population(tn), _population(rn)
    for f in tp._fields:
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(rp, f)))
    for dt, jdt in ((torch.float16, jnp.float16), (torch.float32, jnp.float32)):
        ts, rs = tn.init_neuron_state(tp, dt), rn.init_neuron_state(rp, jdt)
        for f in ts._fields:
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(rs, f)))


@pytest.mark.parametrize("method", ["euler", "rk4"])
@pytest.mark.parametrize("policy", ["fp32", "fp16"])
def test_generic_update_matches_eager_reference(method, policy):
    tdt, jdt = {"fp32": (torch.float32, jnp.float32),
                "fp16": (torch.float16, jnp.float16)}[policy]
    tp, rp = _population(tn), _population(rn)
    ts, rs = tn.init_neuron_state(tp, tdt), rn.init_neuron_state(rp, jdt)
    rng = np.random.default_rng(0)
    refractory_ticks = 0
    for tick in range(40):
        i_syn = (rng.random(16) * 20 + np.r_[[0] * 9, [30] * 7]).astype(np.float32)
        ts, tsp = tn.update_neurons(tp, ts, torch.from_numpy(i_syn), method=method,
                                    state_dtype=tdt)
        rs, rsp = rn.update_neurons(rp, rs, jnp.asarray(i_syn), method=method,
                                    state_dtype=jdt)
        np.testing.assert_array_equal(tsp.numpy(), np.asarray(rsp), err_msg=f"tick {tick}")
        for f in ts._fields:
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(rs, f)),
                                          err_msg=f"{f} at tick {tick}")
        refractory_ticks += int(ts.refrac.max() > 0)
    assert refractory_ticks > 0  # the LIF refractory branch ran
    assert bool(torch.isfinite(ts.v.float()).all())
