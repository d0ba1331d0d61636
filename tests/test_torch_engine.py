"""The port's run loop against the reference's jitted ``run`` on the CPU.

Both packages build the same network from the same seed; the port gets the
generator uniforms the reference draws (``k_draw, _ = split(state0.key)``,
``uniform(k_draw, (T, n_gen))``) through ``gen_u``. Synfire's weight
tables make every propagation sum exact, so rasters must agree bit for
bit; fp16 final state too.

fp32 membranes: eager PyTorch rounds every operation on its own, and so
does the reference evaluated op by op (the port equals it bit for bit:
the slow tests below). The default jitted reference lets XLA CPU contract
mul+add into FMAs, and over 1,000 Synfire4 ticks that drifts one v entry
past ``rtol=1e-5, atol=1e-4`` (ROADMAP queue C). fp32 state is therefore
held at that tolerance against the reference's jitted ``run`` compiled
with ``xla_backend_optimization_level=0``, which keeps most of the
contraction out, and its distance from the default jitted run is printed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import synfire4 as rsyn  # noqa: E402
from repro.core import NetworkBuilder as RBuilder, izh4 as rizh4  # noqa: E402
from repro.core.engine import run as ref_run  # noqa: E402
from repro_torch.configs import synfire4 as tsyn  # noqa: E402
from repro_torch.core import Engine, NetworkBuilder, izh4, run, step  # noqa: E402
from repro_torch.core.convert import params_from_numpy, state_from_numpy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread keeps PyTorch's thread
    pool from spinning against the other test workers' cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

MINI_TICKS = 250
FULL_TICKS = 1000


def ref_uniforms(net, n_steps):
    k_draw, _ = jax.random.split(net.state0.key)
    return np.asarray(jax.random.uniform(k_draw, (n_steps, net.static.n_gen),
                                         dtype=jnp.float32))


_RUNS: dict = {}


def unfused_ref_run(net, n_steps):
    """The reference's jitted run without XLA CPU's mul+add contraction."""
    compiled = ref_run.lower(net.static, net.params, net.state0, n_steps).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return compiled(net.params, net.state0)


def both_runs(cfg_name, policy, propagation, n_steps):
    """(reference final, reference outputs, port final, port outputs,
    unfused reference final or None), cached per case so the raster and
    state tests share one set of runs; outputs hold the raster
    ``"spikes"`` and the f32 voltage trace ``"v"`` as numpy."""
    key = (cfg_name, policy, propagation, n_steps)
    if key not in _RUNS:
        rnet = rsyn.build_synfire(getattr(rsyn, cfg_name), policy=policy,
                                  propagation=propagation, monitors=None)
        tnet = tsyn.build_synfire(getattr(tsyn, cfg_name), policy=policy,
                                  propagation=propagation, device="cpu")
        gu = torch.from_numpy(ref_uniforms(rnet, n_steps).copy())
        rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, n_steps,
                               record_v=True)
        tfinal, tout = run(tnet.static, tnet.params, tnet.state0, n_steps,
                           gen_u=gu, record_v=True)
        unfused = unfused_ref_run(rnet, n_steps)[0] if policy == "fp32" else None
        _RUNS[key] = (rfinal, {k: np.asarray(v) for k, v in rout.items()}, tfinal,
                      {k: v.numpy() for k, v in tout.items()}, unfused)
    return _RUNS[key]


def assert_same_raster(ref, port):
    assert ref.shape == port.shape
    if not np.array_equal(ref, port):
        first = int(np.argwhere((ref != port).any(axis=1))[0][0])
        pytest.fail(f"rasters diverge first at tick {first}: "
                    f"{int((ref != port).sum())} entries differ")


def _report(label, name, r, t):
    print(f"{label} {name}: {int((r != t).sum())} of {r.size} entries differ, "
          f"max abs diff {float(np.abs(r - t).max())}")


def _report_trace(policy, r_v, t_v):
    """Where the per-tick f32 voltage traces first part, and how far."""
    diff = r_v != t_v
    if not diff.any():
        print(f"{policy} v trace: bitwise equal")
        return
    first = int(np.argwhere(diff.any(axis=1))[0][0])
    ulp = np.abs(r_v.view(np.int32).astype(np.int64) - t_v.view(np.int32).astype(np.int64))
    print(f"{policy} v trace vs jitted reference: first divergent tick {first} "
          f"({int(diff[first].sum())} entries, max {int(ulp[first].max())} f32 ulp); "
          f"over the run {int(diff.sum())} entries, max {int(ulp.max())} f32 ulp, "
          f"{float(np.abs(r_v - t_v).max())} mV")


def assert_same_state(policy, rfinal, rout, tfinal, tout, unfused):
    """fp16: final v, u, ring bit for bit against the jitted reference.
    fp32: v, u at rtol=1e-5, atol=1e-4 against the unfused jitted
    reference, the ring (exact sums) bit for bit. The per-tick voltage
    traces' distance from the jitted reference is printed."""
    assert tfinal.t == int(rfinal.t)
    _report_trace(policy, rout["v"], tout["v"])
    for name in ("v", "u", "ring"):
        get = (lambda s: s.ring) if name == "ring" else (
            lambda s, f=name: getattr(s.neurons, f))
        t = get(tfinal).float().numpy()
        r = np.asarray(get(rfinal), np.float32)
        _report(f"{policy} vs jitted reference", name, r, t)
        if policy == "fp16" or name == "ring":
            np.testing.assert_array_equal(t, r, err_msg=name)
            continue
        ru = np.asarray(get(unfused), np.float32)
        _report(f"{policy} vs unfused jitted reference", name, ru, t)
        np.testing.assert_allclose(t, ru, rtol=1e-5, atol=1e-4, err_msg=name)


MINI_CASES = [(p, q) for p in ("fp32", "fp16") for q in ("packed", "sparse", "auto")]
FULL_CASES = [
    ("fp16", "packed"), ("fp32", "sparse"),
    pytest.param("fp32", "packed", marks=pytest.mark.slow),
    pytest.param("fp16", "sparse", marks=pytest.mark.slow),
]


@pytest.mark.parametrize("policy,propagation", MINI_CASES)
def test_mini_raster_bitwise(policy, propagation):
    _, rout, _, tout, _ = both_runs("SYNFIRE4_MINI", policy, propagation, MINI_TICKS)
    assert rout["spikes"].sum() > 50, "wave never ignited: degenerate parity"
    assert_same_raster(rout["spikes"], tout["spikes"])


@pytest.mark.parametrize("policy,propagation", MINI_CASES)
def test_mini_final_state(policy, propagation):
    assert_same_state(policy, *both_runs("SYNFIRE4_MINI", policy, propagation,
                                         MINI_TICKS))


@pytest.mark.parametrize("policy,propagation", FULL_CASES)
def test_synfire4_raster_bitwise(policy, propagation):
    _, rout, _, tout, _ = both_runs("SYNFIRE4", policy, propagation, FULL_TICKS)
    assert 20_000 <= rout["spikes"].sum() <= 33_000
    assert_same_raster(rout["spikes"], tout["spikes"])


@pytest.mark.parametrize("policy,propagation", FULL_CASES)
def test_synfire4_final_state(policy, propagation):
    assert_same_state(policy, *both_runs("SYNFIRE4", policy, propagation,
                                         FULL_TICKS))


def _flat_params(params):
    out = {f"neuron.{f}": np.asarray(getattr(params.neuron, f))
           for f in params.neuron._fields}
    out.update({f"masks.{j}": np.asarray(m) for j, m in enumerate(params.masks)
                if m is not None})
    for f in ("gen_rate", "gen_until", "gen_rate_after"):
        out[f] = np.asarray(getattr(params, f))
    for bi, (pre, post, idx) in enumerate(zip(params.bucket_pre_ids,
                                              params.bucket_post_ids,
                                              params.bucket_csr_idx)):
        out[f"bucket_pre_ids.{bi}"] = np.asarray(pre)
        out[f"bucket_post_ids.{bi}"] = np.asarray(post)
        if idx is not None:
            out[f"bucket_csr_idx.{bi}"] = np.asarray(idx)
    return out


def _flat_state(state):
    out = {"t": np.asarray(state.t), "key": np.asarray(jax.random.key_data(state.key)),
           "ring": np.asarray(state.ring)}
    for f in ("v", "u", "refrac"):
        out[f"neurons.{f}"] = np.asarray(getattr(state.neurons, f))
    out.update({f"weights.{j}": np.asarray(w) for j, w in enumerate(state.weights)})
    return out


@pytest.mark.parametrize("policy,propagation", [("fp32", "sparse"), ("fp16", "packed")])
def test_resume_reference_state_on_port(policy, propagation):
    """The reference's params and its Synfire4 state after 137 ticks,
    carried across, continue on the port for 113 ticks into the
    reference's own 250-tick raster."""
    rnet = rsyn.build_synfire(rsyn.SYNFIRE4, policy=policy,
                              propagation=propagation, monitors=None)
    tnet = tsyn.build_synfire(tsyn.SYNFIRE4, policy=policy,
                              propagation=propagation, device="cpu")
    gu = ref_uniforms(rnet, MINI_TICKS)
    _, rout = ref_run(rnet.static, rnet.params, rnet.state0, MINI_TICKS)
    mid, rout137 = ref_run(rnet.static, rnet.params, rnet.state0, 137)
    full = np.asarray(rout["spikes"])
    np.testing.assert_array_equal(np.asarray(rout137["spikes"]), full[:137])

    params = params_from_numpy(tnet.static, _flat_params(rnet.params), "cpu")
    state = state_from_numpy(tnet.static, _flat_state(mid), "cpu")
    assert state.t == 137
    final, out = run(tnet.static, params, state, MINI_TICKS - 137,
                     gen_u=torch.from_numpy(gu[137:].copy()))
    assert full[137:].sum() > 1000
    assert_same_raster(full[137:], out["spikes"].numpy())
    assert final.t == MINI_TICKS


def test_convert_rejects_unknown_and_misshapen_arrays():
    rnet = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, policy="fp16", monitors=None)
    tnet = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16", device="cpu")
    arrays = _flat_state(rnet.state0)
    with pytest.raises(ValueError, match="no field"):
        state_from_numpy(tnet.static, {**arrays, "stdp.0": np.zeros(3)}, "cpu")
    arrays["ring"] = arrays["ring"].astype(np.float32)
    with pytest.raises(ValueError, match="ring"):
        state_from_numpy(tnet.static, arrays, "cpu")


def _gap_net(builder, lib_izh4, **kw):
    net = builder(seed=7)
    net.add_group("a", lib_izh4(30, a=0.02, b=0.2, c=-65.0, d=8.0))
    net.add_group("b", lib_izh4(20, a=0.1, b=0.2, c=-65.0, d=2.0))
    net.add_group("c", lib_izh4(25, a=0.02, b=0.2, c=-65.0, d=8.0))
    net.connect("a", "b", fanin=6, weight=2.0, delay_ms=3)
    net.connect("c", "b", fanin=5, weight=1.5, delay_ms=3)
    net.connect("b", "a", fanin=4, weight=-1.0, delay_ms=2)
    net.connect("b", "c", fanin=4, weight=-1.0, delay_ms=2)
    return net.compile(policy="fp32", **kw)


def test_gathered_and_scattered_buckets_match_reference():
    """A generator-free net driven by an external current, whose buckets
    gather non-contiguous pre spans and scatter into non-contiguous post
    spans; voltage and current traces agree too."""
    rnet = _gap_net(RBuilder, rizh4, monitors=None)
    tnet = _gap_net(NetworkBuilder, izh4, device="cpu")
    i_ext = np.zeros((MINI_TICKS, 75), np.float32)
    i_ext[:, :30] = 12.0
    i_ext[:, 50:] = 9.0
    _, rout = ref_run(rnet.static, rnet.params, rnet.state0, MINI_TICKS,
                      i_ext=jnp.asarray(i_ext), record_i=True)
    _, tout = run(tnet.static, tnet.params, tnet.state0, MINI_TICKS,
                  i_ext=torch.from_numpy(i_ext), record_i=True)
    assert np.asarray(rout["spikes"]).sum() > 100
    assert_same_raster(np.asarray(rout["spikes"]), tout["spikes"].numpy())
    np.testing.assert_array_equal(tout["i_syn"].numpy(), np.asarray(rout["i_syn"]))


def test_voltage_trace_bitwise_fp16():
    rnet = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, policy="fp16", monitors=None)
    tnet = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16", device="cpu")
    gu = torch.from_numpy(ref_uniforms(rnet, 60).copy())
    _, rout = ref_run(rnet.static, rnet.params, rnet.state0, 60, record_v=True,
                      record="none")
    _, tout = run(tnet.static, tnet.params, tnet.state0, 60, gen_u=gu,
                  record_v=True, record="none")
    assert "spikes" not in tout and tout["v"].dtype == torch.float32
    np.testing.assert_array_equal(tout["v"].numpy(), np.asarray(rout["v"]))


class TestRunAndStep:
    def _net(self):
        return tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16", device="cpu")

    def test_step_matches_run(self):
        net = self._net()
        gu = torch.rand((5, net.static.n_gen), generator=torch.Generator().manual_seed(0))
        _, out = run(net.static, net.params, net.state0, 5, gen_u=gu)
        state = net.state0
        for t in range(5):
            state, o = step(net.static, net.params, state, gen_u=gu[t])
            assert torch.equal(o.spikes, out["spikes"][t])
        assert state.t == 5
        assert torch.equal(net.state0.ring, torch.zeros_like(net.state0.ring))

    def test_step_needs_uniforms(self):
        net = self._net()
        with pytest.raises(ValueError, match="gen_u"):
            step(net.static, net.params, net.state0)

    def test_default_stream_is_seeded_and_advances(self):
        net = self._net()
        s1, o1 = run(net.static, net.params, net.state0, 100)
        _, o1b = run(net.static, net.params, net.state0, 100)
        assert torch.equal(o1["spikes"], o1b["spikes"])
        assert int(s1.key) != int(net.state0.key)
        _, o2 = run(net.static, net.params, s1._replace(t=0), 100)
        assert not torch.equal(o1["spikes"], o2["spikes"])

    def test_explicit_generator(self):
        net = self._net()
        g = torch.Generator().manual_seed(123)
        gu = torch.rand((100, net.static.n_gen), generator=torch.Generator().manual_seed(123))
        s, o = run(net.static, net.params, net.state0, 100, generator=g)
        _, o2 = run(net.static, net.params, net.state0, 100, gen_u=gu)
        assert torch.equal(o["spikes"], o2["spikes"])
        assert int(s.key) == int(net.state0.key)

    def test_monitor_records_raise(self):
        net = self._net()
        with pytest.raises(NotImplementedError, match="A6"):
            run(net.static, net.params, net.state0, 10, record="monitors")

    def test_engine_spike_counts(self):
        eng = Engine(self._net())
        _, out = eng.run(50)
        assert torch.equal(eng.spike_counts(50), out["spikes"].sum(dim=0))


@pytest.mark.slow
@pytest.mark.parametrize("cfg_name,n_steps", [("SYNFIRE4_MINI", MINI_TICKS),
                                              ("SYNFIRE4", FULL_TICKS)])
def test_fp32_state_bitwise_vs_eager_reference(cfg_name, n_steps):
    """The reference evaluated op by op (``jax.disable_jit``, 30 s and
    more) rounds as eager PyTorch does: raster, v, u and ring agree bit
    for bit."""
    from repro.core.engine import _run_impl
    rnet = rsyn.build_synfire(getattr(rsyn, cfg_name), policy="fp32",
                              propagation="packed", monitors=None)
    tnet = tsyn.build_synfire(getattr(tsyn, cfg_name), policy="fp32",
                              propagation="packed", device="cpu")
    with jax.disable_jit():
        rfinal, rout = _run_impl(rnet.static, rnet.params, rnet.state0, n_steps)
    gu = torch.from_numpy(ref_uniforms(rnet, n_steps).copy())
    tfinal, tout = run(tnet.static, tnet.params, tnet.state0, n_steps, gen_u=gu)
    assert_same_raster(np.asarray(rout["spikes"]), tout["spikes"].numpy())
    for r, t in ((rfinal.neurons.v, tfinal.neurons.v),
                 (rfinal.neurons.u, tfinal.neurons.u), (rfinal.ring, tfinal.ring)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))
