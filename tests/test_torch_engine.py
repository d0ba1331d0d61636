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
from repro_torch.core import Engine, NetworkBuilder, izh4, rng, run, step  # noqa: E402
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


@pytest.mark.parametrize("policy,propagation", [("fp32", "sparse"), ("fp16", "packed"),
                                               ("bf16", "sparse")])
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
        """Without ``gen_u`` a step draws its uniforms as the reference's
        step does: ``key, k_gen = split(key)``, one uniform per neuron from
        ``k_gen``; the generators take their columns."""
        net = self._net()
        s1, o1 = step(net.static, net.params, net.state0)
        k_next, k_gen = rng.split(net.state0.key)
        assert torch.equal(s1.key, k_next)
        full = rng.uniform(k_gen, (net.static.n,))
        gu = torch.cat([full[g0:g0 + sz] for g0, sz in net.static.gen_spans])
        _, o2 = step(net.static, net.params, net.state0, gen_u=gu)
        assert torch.equal(o1.spikes, o2.spikes)

    def test_default_stream_is_seeded_and_advances(self):
        net = self._net()
        s1, o1 = run(net.static, net.params, net.state0, 100)
        _, o1b = run(net.static, net.params, net.state0, 100)
        assert torch.equal(o1["spikes"], o1b["spikes"])
        assert not torch.equal(s1.key, net.state0.key)
        _, o2 = run(net.static, net.params, s1._replace(t=0), 100)
        assert not torch.equal(o1["spikes"], o2["spikes"])

    def test_explicit_generator(self):
        net = self._net()
        g = torch.Generator().manual_seed(123)
        gu = torch.rand((100, net.static.n_gen), generator=torch.Generator().manual_seed(123))
        s, o = run(net.static, net.params, net.state0, 100, generator=g)
        _, o2 = run(net.static, net.params, net.state0, 100, gen_u=gu)
        assert torch.equal(o["spikes"], o2["spikes"])
        assert torch.equal(s.key, net.state0.key)

    def test_monitor_records_raise(self):
        """``record="monitors"`` (ported with ROADMAP A6, so it no longer
        raises) gives the reference's telemetry from the same seed: the
        SpikeCount totals bit for bit against the reference's jitted run,
        the GroupRate levels against its opt-level-0 compile; ``"both"``
        adds the raster, whose group sums are the counts."""
        net = self._net()
        rnet = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, policy="fp16")
        _, out = run(net.static, net.params, net.state0, 200, record="monitors")
        _, both = run(net.static, net.params, net.state0, 200, record="both")
        assert set(out) == {"telemetry"} and set(both) == {"spikes", "telemetry"}
        rtel = ref_run(rnet.static, rnet.params, rnet.state0, 200,
                       record="monitors")[1]["telemetry"]
        rtel0 = ref_run.lower(rnet.static, rnet.params, rnet.state0, 200,
                              record="monitors").compile(
            compiler_options={"xla_backend_optimization_level": 0})(
            rnet.params, rnet.state0)[1]["telemetry"]
        np.testing.assert_array_equal(out["telemetry"]["spike_count"].numpy(),
                                      np.asarray(rtel["spike_count"]))
        np.testing.assert_array_equal(out["telemetry"]["group_rate"].numpy(),
                                      np.asarray(rtel0["group_rate"]))
        sums = [int(both["spikes"][:, g.start:g.start + g.size].sum())
                for g in net.static.groups]
        assert both["telemetry"]["spike_count"].tolist() == sums

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


@pytest.mark.parametrize("policy", ["fp16", "fp32"])
@pytest.mark.parametrize("cfg_name", ["SYNFIRE4_MINI", "SYNFIRE4"])
def test_propagate_packed_through_launcher_matches_per_call_path(cfg_name, policy):
    """``propagate_packed`` through the run's ``syn_matmul`` launcher
    (``assemble_matmul``, what ``run`` builds once) gives the ring that the
    per-call path (``ops.syn_matmul`` on each bucket, each tick) gives, bit
    for bit, over ticks of random spike rows; and so does the launcher it
    builds itself when given none."""
    from repro_torch.core import backend as be
    from repro_torch.kernels import ops

    net = tsyn.build_synfire(getattr(tsyn, cfg_name), policy=policy,
                             propagation="packed", device="cpu")
    static, params = net.static, net.params
    packed = be.assemble_packed(static, net.state0.weights)
    assert sum(b.kind == "dense" for b in static.buckets) == 8

    def per_call(bi, x):
        return ops.syn_matmul(x[None, :], packed[bi])[0]

    launcher = be.assemble_matmul(static, packed)
    rings = [net.state0.ring.clone() for _ in range(3)]
    rng_np = np.random.default_rng(len(cfg_name))
    for t in range(12):
        spikes = torch.from_numpy((rng_np.random(static.n) < 0.2).astype(np.float32))
        be.propagate_packed(static, params, spikes, rings[0], t, packed, matmul=per_call)
        be.propagate_packed(static, params, spikes, rings[1], t, packed, matmul=launcher)
        be.propagate_packed(static, params, spikes, rings[2], t, packed)
    assert float(rings[0].float().abs().sum()) > 0
    assert torch.equal(rings[1], rings[0]) and torch.equal(rings[2], rings[0])


class PerBucketGather:
    """The per-bucket gather path in :class:`repro_torch.kernels.ops.GatherRun`'s
    shape: each tick, ``ops.syn_gather`` on every sparse bucket's pre row
    and the drive added at its post columns, in plan order, into rows
    zeroed first (every compiled plan puts its sparse buckets first)."""

    def __init__(self, static, params, packed):
        from repro_torch.core import backend as be
        from repro_torch.kernels import ops

        self._go = lambda bi, spikes: ops.syn_gather(
            be._bucket_pre(static, params, spikes, bi), params.bucket_csr_idx[bi], packed[bi])
        self._sparse = [(bi, b) for bi, b in enumerate(static.buckets) if b.kind == "sparse"]
        self._ids = params.bucket_post_ids
        self.delays = tuple(sorted({b.delay_ms for _, b in self._sparse}))
        self.starts = [0] if self._sparse else []
        self.rows = torch.zeros((len(self.delays), static.n), device=params.neuron.a.device)

    def __call__(self, g, spikes):
        self.rows.zero_()
        for bi, b in self._sparse:
            row, drive = self.rows[self.delays.index(b.delay_ms)], self._go(bi, spikes)
            if b.post_start >= 0:
                row[b.post_start:b.post_start + b.q] += drive
            else:
                row.index_add_(0, self._ids[bi], drive)


@pytest.mark.parametrize("cfg_name,propagation,policy", [
    ("SYNFIRE4", "sparse", "fp16"), ("SYNFIRE4", "sparse", "fp32"),
    ("SYNFIRE4", "auto", "fp16"), ("SYNFIRE4_X10", "auto", "fp16")])
def test_propagate_packed_through_gather_launcher_matches_per_call_path(
        cfg_name, propagation, policy):
    """``propagate_packed`` through the run's ``syn_gather`` launcher
    (``assemble_gather``, what ``run`` builds once: one group, so one
    launch per tick on the card, and none on Synfire4's all-dense auto
    plan) gives the ring that the per-bucket path gives, bit for bit, over
    ticks of random spike rows on random normal sparse weights; and so
    does the launcher it builds itself; and a run through it gives the
    per-bucket path's raster and final state."""
    from repro_torch.core import backend as be
    from repro_torch.core import engine

    net = tsyn.build_synfire(getattr(tsyn, cfg_name), policy=policy,
                             propagation=propagation, device="cpu", budget=None,
                             monitor_ms_hint=0)
    static, params = net.static, net.params
    n_sparse = sum(b.kind == "sparse" for b in static.buckets)
    assert n_sparse == (0 if (cfg_name, propagation) == ("SYNFIRE4", "auto") else 13)
    rng_np = np.random.default_rng(len(propagation))
    weights = tuple(torch.from_numpy(rng_np.standard_normal(tuple(w.shape)).astype(np.float32))
                    .to(w.dtype) if j in static.csr_projs else w
                    for j, w in enumerate(net.state0.weights))
    packed = be.assemble_packed(static, weights)
    launcher = be.assemble_gather(static, params, packed)
    assert len(launcher.starts) == min(n_sparse, 1) and launcher.launcher is None
    per_call = PerBucketGather(static, params, packed)
    rings = [net.state0.ring.clone() for _ in range(3)]
    for t in range(12):
        spikes = torch.from_numpy((rng_np.random(static.n) < 0.2).astype(np.float32))
        be.propagate_packed(static, params, spikes, rings[0], t, packed, gather=per_call)
        be.propagate_packed(static, params, spikes, rings[1], t, packed, gather=launcher)
        be.propagate_packed(static, params, spikes, rings[2], t, packed)
    assert float(rings[0].float().abs().sum()) > 0
    assert torch.equal(rings[1], rings[0]) and torch.equal(rings[2], rings[0])

    state = net.state0._replace(weights=weights)
    gu = torch.from_numpy(rng_np.random((60, static.n_gen)).astype(np.float32))
    final, out = engine.run(static, params, state, 60, gen_u=gu)
    built = be.assemble_gather
    be.assemble_gather = lambda static, params, packed: PerBucketGather(static, params, packed)
    try:
        final_pc, out_pc = engine.run(static, params, state, 60, gen_u=gu)
    finally:
        be.assemble_gather = built
    assert torch.equal(out["spikes"], out_pc["spikes"])
    for a, b in ((final.ring, final_pc.ring), (final.neurons.v, final_pc.neurons.v)):
        assert torch.equal(a, b)


def _without(builder):
    """``backend.<builder>`` swapped for one that builds nothing, so the
    run takes that phase's per-op or per-call path, the earlier one."""
    from repro_torch.core import backend as be

    class _Swap:
        def __enter__(self):
            self.saved = getattr(be, builder)
            setattr(be, builder, lambda *a, **k: None)

        def __exit__(self, *exc):
            setattr(be, builder, self.saved)

    return _Swap()


@pytest.mark.parametrize("cfg_name,policy,propagation,n_steps", [
    ("SYNFIRE4_MINI", "fp16", "packed", 120), ("SYNFIRE4_MINI", "fp32", "sparse", 120),
    ("SYNFIRE4_MINI", "fp16", "sparse", 120), ("SYNFIRE4_MINI", "fp32", "packed", 120),
    ("SYNFIRE4", "fp16", "sparse", 150), ("SYNFIRE4", "fp32", "packed", 150)])
def test_run_through_neuron_launcher_matches_per_op_path(cfg_name, policy, propagation,
                                                         n_steps):
    """``run`` through the run's neuron-phase launcher
    (``backend.assemble_neurons``, ``ops.NeuronRun``) gives the per-op
    path's raster, v and i_syn records and final v, u, refrac and ring bit
    for bit, with an external current; the input state is left as it
    was."""
    net = tsyn.build_synfire(getattr(tsyn, cfg_name), policy=policy,
                             propagation=propagation, device="cpu")
    static, params, state = net.static, net.params, net.state0
    rng_np = np.random.default_rng(n_steps)
    gu = torch.from_numpy(rng_np.random((n_steps, static.n_gen)).astype(np.float32))
    cur = torch.from_numpy(rng_np.uniform(0, 4, (n_steps, static.n)).astype(np.float32))
    saved = [x.clone() for x in (*state.neurons, state.ring)]
    kw = dict(gen_u=gu, i_ext=cur, record_v=True, record_i=True)
    final, out = run(static, params, state, n_steps, **kw)
    with _without("assemble_neurons"):
        final_po, out_po = run(static, params, state, n_steps, **kw)
    assert int(out["spikes"].sum()) > 0
    for name in ("spikes", "v", "i_syn"):
        assert torch.equal(out[name], out_po[name]), name
    for a, b in ((final.ring, final_po.ring), *zip(final.neurons, final_po.neurons)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip((*state.neurons, state.ring), saved))


@pytest.mark.parametrize("policy", ["fp16", "fp32"])
def test_external_current_run_matches_reference(policy):
    """Synfire4-mini with an external current, through the neuron-phase
    launcher (its plain run on the CPU), against the reference with the
    same current: over 150 ticks the raster and the i_syn record bit for
    bit against its jitted ``run``; over 40 ticks the raster and the v and
    i_syn records bit for bit against it evaluated op by op (the jitted
    reference contracts the IZH4 mul+adds into FMAs: its v record then
    parts from both by an ulp here and there, ROADMAP queue C)."""
    from repro.core.engine import _run_impl

    rnet = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, policy=policy, monitors=None)
    tnet = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy=policy, device="cpu")
    cur = np.random.default_rng(5).uniform(0, 4, (150, rnet.static.n)).astype(np.float32)
    kw = dict(record_v=True, record_i=True)
    _, rout = ref_run(rnet.static, rnet.params, rnet.state0, 150, i_ext=jnp.asarray(cur), **kw)
    gu = torch.from_numpy(ref_uniforms(rnet, 150).copy())
    _, tout = run(tnet.static, tnet.params, tnet.state0, 150, gen_u=gu,
                  i_ext=torch.from_numpy(cur), **kw)
    assert_same_raster(np.asarray(rout["spikes"]), tout["spikes"].numpy())
    np.testing.assert_array_equal(tout["i_syn"].numpy(), np.asarray(rout["i_syn"]))
    with jax.disable_jit():
        _, eout = _run_impl(rnet.static, rnet.params, rnet.state0, 40,
                            i_ext=jnp.asarray(cur[:40]), **kw)
    _, tout = run(tnet.static, tnet.params, tnet.state0, 40,
                  gen_u=torch.from_numpy(ref_uniforms(rnet, 40).copy()),
                  i_ext=torch.from_numpy(cur[:40]), **kw)
    for name in ("spikes", "v", "i_syn"):
        np.testing.assert_array_equal(tout[name].numpy(), np.asarray(eout[name]),
                                      err_msg=name)
