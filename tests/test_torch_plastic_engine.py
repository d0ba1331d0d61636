"""Plastic networks end to end on the CPU: the port's ``run`` against the
reference's, and the port's storages against each other.

Both packages build the same network from the same seed; the port gets the
generator uniforms the reference draws. Plastic Synfire4 and its mini, with
the exc→exc chain under ``CHAIN_STDP``, must give the reference's raster
and final plastic weights and traces bit for bit in fp16 and fp32, packed
and sparse: STDP writes weights from spikes and traces only, and the port
rounds traces and weights as the reference evaluated op by op does. The
reference's default jit contracts mul+add into FMAs (ROADMAP queue C), so
the runs are held against its jitted ``run`` compiled at
``xla_backend_optimization_level=0``; fp32 ``v``/``u`` at ``rtol=1e-5,
atol=1e-4``, as for the non-plastic engine, and bit for bit against the
reference evaluated op by op. The plastic drive's f32 sum over the fan-in
rows runs, on the CPU, in the order of XLA CPU's tree reduction rewriter
(``core/backend.xla_cpu_row_sum``), so the ring holds the reference's
sums bit for bit as STDP moves the weights off the representable grid.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import synfire4 as rsyn  # noqa: E402
from repro.core import NetworkBuilder as RBuilder, izh4 as rizh4  # noqa: E402
from repro.core import plasticity as rpl  # noqa: E402
from repro.core import synapses as rsynapses  # noqa: E402
from repro.core.engine import run as ref_run  # noqa: E402
from repro_torch.configs import synfire4 as tsyn  # noqa: E402
from repro_torch.core import NetworkBuilder, izh4, run, step  # noqa: E402
from repro_torch.core import plasticity as tpl  # noqa: E402
from repro_torch.core import synapses as tsynapses  # noqa: E402
from repro_torch.core.convert import params_from_numpy, state_from_numpy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small: one intra-op thread keeps PyTorch's thread
    pool from spinning against the other test workers' cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


MINI_TICKS = 250
FULL_TICKS = 1000


def ref_uniforms(net, n_steps):
    k_draw, _ = jax.random.split(net.state0.key)
    return np.array(jax.random.uniform(k_draw, (n_steps, net.static.n_gen),
                                       dtype=jnp.float32))


def unfused_ref_run(net, n_steps, *, record_i=False, **kw):
    """The reference's jitted run without XLA CPU's mul+add contraction;
    ``kw`` are its traced keywords (``dopamine``)."""
    compiled = ref_run.lower(net.static, net.params, net.state0, n_steps,
                             record_i=record_i, **kw).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return compiled(net.params, net.state0, **kw)


def dense_weights(static, params, weights, j):
    """Projection ``j``'s weights as a dense f32 image, whatever its storage."""
    spec = static.projections[j]
    if j not in static.csr_projs:
        return np.asarray(weights[j], np.float32)
    if isinstance(weights[j], torch.Tensor):
        return tsynapses.csr_to_dense(tsynapses.CSRFanin(
            params.proj_csr_idx[j], weights[j], params.masks[j]), spec.pre_size)
    return rsynapses.csr_to_dense(rsynapses.CSRFanin(
        params.proj_csr_idx[j], weights[j], params.masks[j]), spec.pre_size)


def plastic_ids(static):
    return [j for j, c in enumerate(static.stdp) if c is not None]


def assert_same_raster(ref, port, what=""):
    assert ref.shape == port.shape
    if not np.array_equal(ref, port):
        first = int(np.argwhere((ref != port).any(axis=1))[0][0])
        pytest.fail(f"{what}: rasters diverge first at tick {first}: "
                    f"{int((ref != port).sum())} entries differ")


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def assert_same_plastic_state(rnet, rfinal, tnet, tfinal, what):
    """Plastic weights (as dense images), traces, eligibility and
    homeostasis rates bit for bit."""
    for j in plastic_ids(tnet.static):
        np.testing.assert_array_equal(
            dense_weights(tnet.static, tnet.params, tfinal.weights, j),
            dense_weights(rnet.static, rnet.params, rfinal.weights, j),
            err_msg=f"{what}: weights {j}")
        for f in tfinal.stdp[j]._fields:
            np.testing.assert_array_equal(_f32(getattr(tfinal.stdp[j], f)),
                                          _f32(getattr(rfinal.stdp[j], f)),
                                          err_msg=f"{what}: stdp {j}.{f}")
    for j, h in enumerate(tfinal.homeo):
        if h is not None:
            np.testing.assert_array_equal(h.numpy(), np.asarray(rfinal.homeo[j]),
                                          err_msg=f"{what}: homeo {j}")


_RUNS: dict = {}


def both_runs(cfg_name, policy, propagation, n_steps):
    """(reference net, reference final, reference raster, port net, port
    final, port raster, jitted reference final), cached per case."""
    key = (cfg_name, policy, propagation, n_steps)
    if key not in _RUNS:
        kw = dict(policy=policy, propagation=propagation)
        rnet = rsyn.build_synfire(getattr(rsyn, cfg_name), stdp_chain=rsyn.CHAIN_STDP,
                                  monitors=None, **kw)
        tnet = tsyn.build_synfire(getattr(tsyn, cfg_name), stdp_chain=tsyn.CHAIN_STDP,
                                  device="cpu", **kw)
        gu = torch.from_numpy(ref_uniforms(rnet, n_steps))
        rfinal, rout = unfused_ref_run(rnet, n_steps)
        jfinal, _ = ref_run(rnet.static, rnet.params, rnet.state0, n_steps)
        tfinal, tout = run(tnet.static, tnet.params, tnet.state0, n_steps, gen_u=gu)
        _RUNS[key] = (rnet, rfinal, np.asarray(rout["spikes"]), tnet, tfinal,
                      tout["spikes"].numpy(), jfinal)
    return _RUNS[key]


CASES = [(p, q) for p in ("fp16", "fp32") for q in ("packed", "sparse")]


@pytest.mark.parametrize("policy,propagation", CASES)
@pytest.mark.parametrize("cfg_name,n_steps", [("SYNFIRE4_MINI", MINI_TICKS),
                                              ("SYNFIRE4", FULL_TICKS)])
def test_plastic_synfire_matches_reference(cfg_name, n_steps, policy, propagation):
    """Raster, final plastic weights, traces and the ring bit for bit; v
    and u bit for bit in fp16 and at rtol=1e-5, atol=1e-4 in fp32, where
    the reference's compile contracts mul+add in the IZH4 update even at
    optimization level 0 (ROADMAP queue C; the op-by-op reference is held
    bit for bit below). Learning happened, and the jitted reference's
    distance is printed."""
    rnet, rfinal, rsp, tnet, tfinal, tsp, jfinal = both_runs(cfg_name, policy,
                                                             propagation, n_steps)
    assert rsp.sum() > (50 if cfg_name == "SYNFIRE4_MINI" else 20_000)
    assert_same_raster(rsp, tsp, f"{cfg_name} {policy}/{propagation}")
    assert_same_plastic_state(rnet, rfinal, tnet, tfinal, f"{cfg_name} {policy}")
    ids = plastic_ids(tnet.static)
    assert len(ids) == 4
    moved = sum(int((dense_weights(tnet.static, tnet.params, tfinal.weights, j)
                     != dense_weights(tnet.static, tnet.params, tnet.state0.weights,
                                      j)).sum()) for j in ids)
    assert moved > 0, "no plastic weight moved"
    jd = sum(int((dense_weights(tnet.static, tnet.params, tfinal.weights, j)
                  != dense_weights(rnet.static, rnet.params, jfinal.weights, j)).sum())
             for j in ids)
    print(f"{cfg_name} {policy}/{propagation}: {moved} plastic weights moved; "
          f"{jd} differ from the default-jitted reference's")
    for name in ("v", "u", "ring"):
        get = (lambda s: s.ring) if name == "ring" else (
            lambda s, f=name: getattr(s.neurons, f))
        t = get(tfinal).float().numpy()
        r = np.asarray(get(rfinal), np.float32)
        if policy == "fp16" or name == "ring":
            np.testing.assert_array_equal(t, r, err_msg=name)
            continue
        ulp = np.abs(t.view(np.int32).astype(np.int64) - r.view(np.int32).astype(np.int64))
        print(f"{cfg_name} fp32/{propagation} {name}: {int((t != r).sum())} of {t.size} "
              f"entries differ, max {int(ulp.max())} f32 ulp")
        np.testing.assert_allclose(t, r, rtol=1e-5, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_plastic_fp32_state_bitwise_vs_eager_reference(propagation):
    """Plastic Synfire4 fp32 for 100 ticks against the reference evaluated
    op by op (``jax.disable_jit``): raster, v, u, ring, chain weights and
    traces bit for bit. The plastic drive's sums take the reference's
    reduce order on the CPU (``core/backend.xla_cpu_row_sum``), and eager
    PyTorch rounds every other op as the op-by-op reference does."""
    from repro.core.engine import _run_impl

    n_steps = 100
    rnet = rsyn.build_synfire(rsyn.SYNFIRE4, policy="fp32", propagation=propagation,
                              stdp_chain=rsyn.CHAIN_STDP, monitors=None)
    tnet = tsyn.build_synfire(tsyn.SYNFIRE4, policy="fp32", propagation=propagation,
                              stdp_chain=tsyn.CHAIN_STDP, device="cpu")
    with jax.disable_jit():
        rfinal, rout = _run_impl(rnet.static, rnet.params, rnet.state0, n_steps)
    gu = torch.from_numpy(ref_uniforms(rnet, n_steps).copy())
    tfinal, tout = run(tnet.static, tnet.params, tnet.state0, n_steps, gen_u=gu)
    assert_same_raster(np.asarray(rout["spikes"]), tout["spikes"].numpy())
    assert_same_plastic_state(rnet, rfinal, tnet, tfinal, f"eager fp32 {propagation}")
    for r, t in ((rfinal.neurons.v, tfinal.neurons.v),
                 (rfinal.neurons.u, tfinal.neurons.u), (rfinal.ring, tfinal.ring)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    ids = plastic_ids(tnet.static)
    assert any(not np.array_equal(dense_weights(tnet.static, tnet.params, tfinal.weights, j),
                                  dense_weights(tnet.static, tnet.params, tnet.state0.weights, j))
               for j in ids), "no plastic weight moved"


def test_xla_cpu_row_sum_matches_reference_reduce():
    """``xla_cpu_row_sum`` equals the reference's compiled f32 row sum
    (optimization level 0 and the default compile) bit for bit at fan-ins
    from 1 to 1,100, on both sides of each 32-wide window and its padding;
    ``torch.sum`` does not at the chain's fan-ins."""
    from repro_torch.core.backend import xla_cpu_row_sum

    rng = np.random.default_rng(9)
    fn = jax.jit(lambda a: a.sum(axis=1))
    differs = 0
    for f in (1, 20, 32, 33, 41, 64, 76, 81, 97, 1024, 1100):
        x = (rng.random((200, f), dtype=np.float32) * 3).astype(np.float32)
        j = jnp.asarray(x)
        opt0 = np.asarray(fn.lower(j).compile(
            compiler_options={"xla_backend_optimization_level": 0})(j))
        got = xla_cpu_row_sum(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, opt0, err_msg=f"F={f}")
        np.testing.assert_array_equal(got, np.asarray(fn(j)), err_msg=f"F={f}")
        if f in (76, 81):
            differs += int((torch.from_numpy(x).sum(dim=1).numpy() != opt0).sum())
    assert differs > 0


@pytest.mark.parametrize("policy", ["fp16", "fp32"])
@pytest.mark.parametrize("cfg_name,n_steps", [("SYNFIRE4_MINI", MINI_TICKS),
                                              ("SYNFIRE4", FULL_TICKS)])
def test_packed_and_sparse_storage_agree(cfg_name, n_steps, policy):
    """Dense- and CSR-stored plastic chains: the same raster and the same
    weights at the twin cells, bit for bit, in the port."""
    *_, pnet, pfinal, psp, _ = both_runs(cfg_name, policy, "packed", n_steps)
    *_, snet, sfinal, ssp, _ = both_runs(cfg_name, policy, "sparse", n_steps)
    assert_same_raster(psp, ssp, "packed vs sparse")
    assert snet.static.plastic_csr == tuple(plastic_ids(snet.static))
    for j in plastic_ids(pnet.static):
        np.testing.assert_array_equal(
            dense_weights(pnet.static, pnet.params, pfinal.weights, j),
            dense_weights(snet.static, snet.params, sfinal.weights, j))


def _plastic_net(builder, lib_izh4, lib_pl, propagation, *, da=False, policy="fp16",
                 **compile_kw):
    net = builder(seed=5)
    net.add_spike_generator("pre", 30, rate_hz=80.0)
    net.add_group("post", lib_izh4(10, a=0.02, b=0.2, c=-65.0, d=8.0))
    net.connect("pre", "post", fanin=15, weight=3.0, delay_ms=1,
                stdp=lib_pl.STDPConfig(a_plus=0.01, a_minus=0.002, w_max=6.0,
                                       tau_elig=200.0 if da else None),
                da_modulated=da)
    return net.compile(policy=policy, propagation=propagation, **compile_kw)


class TestDopamine:
    @pytest.mark.parametrize("propagation", ["packed", "sparse"])
    @pytest.mark.parametrize("policy", ["fp16", "fp32"])
    def test_da_stdp_matches_reference(self, policy, propagation):
        """A DA-STDP net under a varying dopamine schedule: raster, weights,
        traces and eligibility as the reference's."""
        rnet = _plastic_net(RBuilder, rizh4, rpl, propagation, da=True, policy=policy,
                            monitors=None)
        tnet = _plastic_net(NetworkBuilder, izh4, tpl, propagation, da=True,
                            policy=policy, device="cpu")
        da = (np.random.default_rng(0).random(MINI_TICKS) * 1.5).astype(np.float32)
        rfinal, rout = unfused_ref_run(rnet, MINI_TICKS, dopamine=jnp.asarray(da))
        tfinal, tout = run(tnet.static, tnet.params, tnet.state0, MINI_TICKS,
                           gen_u=torch.from_numpy(ref_uniforms(rnet, MINI_TICKS)),
                           dopamine=torch.from_numpy(da))
        assert np.asarray(rout["spikes"]).sum() > 100
        assert_same_raster(np.asarray(rout["spikes"]), tout["spikes"].numpy())
        assert_same_plastic_state(rnet, rfinal, tnet, tfinal, "DA-STDP")

    def test_dopamine_gates_learning(self):
        """No dopamine: weights frozen at their initial values; dopamine:
        LTP dominates (the reference's network-level check, on the port)."""
        def total(da_level):
            c = _plastic_net(NetworkBuilder, izh4, tpl, "packed", da=True, device="cpu")
            final, _ = run(c.static, c.params, c.state0, 400,
                           dopamine=torch.full((400,), da_level))
            return float(final.weights[0].float().sum())

        c0 = _plastic_net(NetworkBuilder, izh4, tpl, "packed", device="cpu")
        w_init = float(c0.state0.weights[0].float().sum())
        assert abs(total(0.0) - w_init) < 0.02 * w_init
        assert total(1.0) > 1.05 * w_init

    @pytest.mark.parametrize("propagation", ["packed", "sparse"])
    def test_step_matches_run(self, propagation):
        """``step`` with a dopamine scalar advances the plastic state as
        ``run`` does, tick by tick."""
        c = _plastic_net(NetworkBuilder, izh4, tpl, propagation, da=True, device="cpu")
        gu = torch.rand((30, c.static.n_gen), generator=torch.Generator().manual_seed(1))
        da = torch.full((30,), 0.9)
        final, out = run(c.static, c.params, c.state0, 30, gen_u=gu, dopamine=da)
        state = c.state0
        for t in range(30):
            state, o = step(c.static, c.params, state, gen_u=gu[t], dopamine=da[t])
            assert torch.equal(o.spikes, out["spikes"][t])
        assert torch.equal(state.weights[0], final.weights[0])
        assert torch.equal(state.stdp[0].elig, final.stdp[0].elig)

    def test_schedule_is_checked(self):
        c = _plastic_net(NetworkBuilder, izh4, tpl, "packed", da=True, device="cpu")
        with pytest.raises(ValueError, match="dopamine"):
            run(c.static, c.params, c.state0, 10, dopamine=torch.ones(9))


class TestHomeostasis:
    @pytest.mark.parametrize("propagation", ["packed", "sparse"])
    @pytest.mark.parametrize("cfg_name,n_steps", [("SYNFIRE4_MINI", 300),
                                                  ("SYNFIRE4", 300)])
    def test_matches_reference(self, cfg_name, n_steps, propagation):
        """Plastic Synfire with the slow timer every 100 ticks: raster,
        weights and running rates as the reference's; the scaling moved
        the weights beyond what STDP alone did."""
        kw = dict(policy="fp16", propagation=propagation, homeostasis_period=100)
        cfg = dict(target_hz=10.0, tau_avg_ms=1000.0, beta=2.0)
        rnet = rsyn.build_synfire(getattr(rsyn, cfg_name), stdp_chain=rsyn.CHAIN_STDP,
                                  homeo_chain=rpl.HomeostasisConfig(**cfg),
                                  monitors=None, **kw)
        tnet = tsyn.build_synfire(getattr(tsyn, cfg_name), stdp_chain=tsyn.CHAIN_STDP,
                                  homeo_chain=tpl.HomeostasisConfig(**cfg),
                                  device="cpu", **kw)
        gu = torch.from_numpy(ref_uniforms(rnet, n_steps))
        rfinal, rout = unfused_ref_run(rnet, n_steps)
        tfinal, tout = run(tnet.static, tnet.params, tnet.state0, n_steps, gen_u=gu)
        assert_same_raster(np.asarray(rout["spikes"]), tout["spikes"].numpy())
        assert_same_plastic_state(rnet, rfinal, tnet, tfinal, "homeostasis")
        assert any(h is not None and bool((h > 0).any()) for h in tfinal.homeo)
        plain = tsyn.build_synfire(getattr(tsyn, cfg_name), stdp_chain=tsyn.CHAIN_STDP,
                                   device="cpu", policy="fp16", propagation=propagation)
        pfinal, _ = run(plain.static, plain.params, plain.state0, n_steps, gen_u=gu)
        j = plastic_ids(tnet.static)[0]
        assert not torch.equal(pfinal.weights[j], tfinal.weights[j])

    def test_run_length_must_cover_whole_segments(self):
        net = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, stdp_chain=tsyn.CHAIN_STDP,
                                 homeo_chain=tpl.HomeostasisConfig(),
                                 homeostasis_period=100, device="cpu")
        with pytest.raises(ValueError, match="multiple of the homeostasis period"):
            run(net.static, net.params, net.state0, 150)


def _stp_net(builder, lib_izh4, lib_syn, stp, **kw):
    net = builder(seed=0)
    net.add_spike_generator("g", 50, rate_hz=200.0)
    net.add_group("n", lib_izh4(20, a=0.02, b=0.2, c=-65.0, d=8.0))
    net.connect("g", "n", fanin=20, weight=0.3, delay_ms=1,
                stp=None if stp is None else lib_syn.STPConfig(**stp))
    return net.compile(policy="fp16", **kw)


class TestSTP:
    STP = dict(u0=0.45, tau_f=50.0, tau_d=750.0)

    def test_matches_reference(self):
        """An STP projection: raster, delivered currents and u/x as the
        reference's."""
        rnet = _stp_net(RBuilder, rizh4, rsynapses, self.STP, monitors=None)
        tnet = _stp_net(NetworkBuilder, izh4, tsynapses, self.STP, device="cpu")
        rfinal, rout = unfused_ref_run(rnet, 300, record_i=True)
        tfinal, tout = run(tnet.static, tnet.params, tnet.state0, 300,
                           gen_u=torch.from_numpy(ref_uniforms(rnet, 300)), record_i=True)
        assert_same_raster(np.asarray(rout["spikes"]), tout["spikes"].numpy())
        np.testing.assert_array_equal(tout["i_syn"].numpy(), np.asarray(rout["i_syn"]))
        for f in ("u", "x"):
            np.testing.assert_array_equal(_f32(getattr(tfinal.stp[0], f)),
                                          _f32(getattr(rfinal.stp[0], f)))

    def test_depressing_synapses_reduce_late_response(self):
        """Sustained pre firing delivers less current late than early."""
        c = _stp_net(NetworkBuilder, izh4, tsynapses, self.STP, device="cpu")
        _, out = run(c.static, c.params, c.state0, 600, record_i=True)
        i = out["i_syn"].numpy()[:, 50:]
        assert i[480:580].mean() < 0.5 * i[5:105].mean()
        c0 = _stp_net(NetworkBuilder, izh4, tsynapses, None, device="cpu")
        _, out0 = run(c0.static, c0.params, c0.state0, 600, record_i=True)
        i0 = out0["i_syn"].numpy()[:, 50:]
        assert abs(i0[480:580].mean() - i0[20:120].mean()) < 0.35 * i0[20:120].mean()


def test_inhibitory_plastic_projection_routes_correctly():
    """A plastic inhibitory projection lands its negative drive in the same
    ring slots under both storages, in the port and the reference."""
    def build(builder, lib_izh4, lib_pl, prop, **kw):
        net = builder(seed=11)
        net.add_spike_generator("g", 40, rate_hz=120.0)
        net.add_group("e", lib_izh4(20, a=0.02, b=0.2, c=-65.0, d=8.0))
        net.add_group("i", lib_izh4(10, a=0.1, b=0.2, c=-65.0, d=2.0))
        net.connect("g", "e", fanin=10, weight=2.0, delay_ms=1)
        net.connect("g", "i", fanin=10, weight=2.5, delay_ms=1)
        net.connect("i", "e", fanin=4, weight=-1.5, delay_ms=2,
                    stdp=lib_pl.STDPConfig(w_min=-4.0, w_max=0.0, a_plus=0.002,
                                           a_minus=0.01))
        return net.compile(policy="fp32", propagation=prop, **kw)

    res = {}
    for prop in ("packed", "sparse"):
        rnet = build(RBuilder, rizh4, rpl, prop, monitors=None)
        tnet = build(NetworkBuilder, izh4, tpl, prop, device="cpu")
        rfinal, rout = unfused_ref_run(rnet, 200)
        tfinal, tout = run(tnet.static, tnet.params, tnet.state0, 200,
                           gen_u=torch.from_numpy(ref_uniforms(rnet, 200)))
        assert_same_raster(np.asarray(rout["spikes"]), tout["spikes"].numpy(), prop)
        assert_same_plastic_state(rnet, rfinal, tnet, tfinal, prop)
        res[prop] = (tout["spikes"].numpy(),
                     dense_weights(tnet.static, tnet.params, tfinal.weights, 2))
    assert res["packed"][0].sum() > 50
    assert np.array_equal(res["packed"][0], res["sparse"][0])
    np.testing.assert_array_equal(res["packed"][1], res["sparse"][1])


@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_fused_backend_ticks_plastic_nets_as_default(propagation):
    """A plastic ``backend="fused"`` net is not one kernel: it ticks as the
    default backend does, learning included."""
    kw = dict(policy="fp16", propagation=propagation, stdp_chain=tsyn.CHAIN_STDP,
              device="cpu")
    fused = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, backend="fused", **kw)
    plain = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, **kw)
    assert not fused.static.fused_kernel
    gu = torch.rand((MINI_TICKS, fused.static.n_gen),
                    generator=torch.Generator().manual_seed(4))
    ffinal, fout = run(fused.static, fused.params, fused.state0, MINI_TICKS, gen_u=gu)
    pfinal, pout = run(plain.static, plain.params, plain.state0, MINI_TICKS, gen_u=gu)
    assert torch.equal(fout["spikes"], pout["spikes"])
    for a, b in zip(ffinal.weights, pfinal.weights):
        assert torch.equal(a, b)


def _flat_params(static, params):
    """The reference's params as the flat numpy dict ``convert`` reads."""
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
    for j, spec in enumerate(static.projections):
        if spec.plastic or spec.stp is not None:
            out[f"proj_csr_idx.{j}"] = np.asarray(params.proj_csr_idx[j])
    return out


def _flat_state(state):
    out = {"t": np.asarray(state.t), "key": np.asarray(jax.random.key_data(state.key)),
           "ring": np.asarray(state.ring)}
    for f in ("v", "u", "refrac"):
        out[f"neurons.{f}"] = np.asarray(getattr(state.neurons, f))
    out.update({f"weights.{j}": np.asarray(w) for j, w in enumerate(state.weights)})
    for j, s in enumerate(state.stp):
        if s is not None:
            out.update({f"stp.{j}.{f}": np.asarray(getattr(s, f)) for f in s._fields})
    for j, s in enumerate(state.stdp):
        if s is not None:
            out.update({f"stdp.{j}.{f}": np.asarray(getattr(s, f)) for f in s._fields})
    out.update({f"homeo.{j}": np.asarray(h) for j, h in enumerate(state.homeo)
                if h is not None})
    return out


@pytest.mark.parametrize("policy,propagation,homeo", [
    ("fp16", "sparse", False), ("fp32", "packed", False), ("fp16", "sparse", True)])
def test_resume_plastic_reference_state_on_port(policy, propagation, homeo):
    """The reference's params and its plastic Synfire4 state after 300
    ticks, carried across, continue on the port for 200 ticks into the
    reference's own 500-tick raster and final weights, bit for bit."""
    kw = dict(policy=policy, propagation=propagation)
    if homeo:
        kw["homeostasis_period"] = 100
    rnet = rsyn.build_synfire(
        rsyn.SYNFIRE4, stdp_chain=rsyn.CHAIN_STDP, monitors=None,
        homeo_chain=rpl.HomeostasisConfig(beta=2.0) if homeo else None, **kw)
    tnet = tsyn.build_synfire(
        tsyn.SYNFIRE4, stdp_chain=tsyn.CHAIN_STDP, device="cpu",
        homeo_chain=tpl.HomeostasisConfig(beta=2.0) if homeo else None, **kw)
    gu = ref_uniforms(rnet, 500)
    full_final, rout = unfused_ref_run(rnet, 500)
    mid, rout300 = unfused_ref_run(rnet, 300)
    full = np.asarray(rout["spikes"])
    np.testing.assert_array_equal(np.asarray(rout300["spikes"]), full[:300])

    params = params_from_numpy(tnet.static, _flat_params(rnet.static, rnet.params), "cpu")
    state = state_from_numpy(tnet.static, _flat_state(mid), "cpu")
    assert state.t == 300
    final, out = run(tnet.static, params, state, 200,
                     gen_u=torch.from_numpy(gu[300:].copy()))
    assert full[300:].sum() > 1000
    assert_same_raster(full[300:], out["spikes"].numpy(), "resumed")
    assert_same_plastic_state(rnet, full_final, tnet, final, "resumed")


def test_convert_rejects_missing_plastic_state():
    rnet = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, stdp_chain=rsyn.CHAIN_STDP,
                              policy="fp16", monitors=None)
    tnet = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, stdp_chain=tsyn.CHAIN_STDP,
                              policy="fp16", device="cpu")
    arrays = _flat_state(rnet.state0)
    del arrays["stdp.2.pre_trace"]
    with pytest.raises(KeyError, match="stdp.2.pre_trace"):
        state_from_numpy(tnet.static, arrays, "cpu")
    params = _flat_params(rnet.static, rnet.params)
    params["proj_csr_idx.2"] = params["proj_csr_idx.2"].astype(np.int32)
    with pytest.raises(ValueError, match="proj_csr_idx.2"):
        params_from_numpy(tnet.static, params, "cpu")


@pytest.mark.parametrize("cfg_name,policy,homeo", [
    ("SYNFIRE4_MINI", "fp16", False), ("SYNFIRE4_MINI", "fp32", True),
    ("SYNFIRE4", "fp16", True), ("SYNFIRE4", "fp32", False)])
def test_stdp_launcher_matches_per_call_path(cfg_name, policy, homeo):
    """Plastic sparse Synfire through the run's CSR STDP launcher
    (``backend.assemble_stdp_gather``, ``ops.StdpGatherRun``: every chain
    projection in one call a tick, traces stepped inside) and through the
    per-call path (``stdp_dispatch`` per projection), with homeostasis
    every 100 ticks where asked: raster, final weights, traces, running
    rates, v, u and ring bit for bit; the input state is left as it was;
    the final state carries the launcher's weights and current traces."""
    from repro_torch.core import backend as be

    kw = dict(homeo_chain=tpl.HomeostasisConfig(target_hz=10.0, tau_avg_ms=1000.0, beta=2.0),
              homeostasis_period=100) if homeo else {}
    net = tsyn.build_synfire(getattr(tsyn, cfg_name), policy=policy, propagation="sparse",
                             stdp_chain=tsyn.CHAIN_STDP, device="cpu", **kw)
    static, params, state = net.static, net.params, net.state0
    chain = plastic_ids(static)
    built = be.assemble_stdp_gather(static, params, state.weights, state.stdp)
    assert built.keys == tuple(chain) and len(chain) == 4
    saved = [x.clone() for j in chain for x in (state.weights[j], *state.stdp[j])]
    gu = torch.from_numpy(np.random.default_rng(1).random((200, static.n_gen))
                          .astype(np.float32))
    final, out = run(static, params, state, 200, gen_u=gu)
    swapped = be.assemble_stdp_gather
    be.assemble_stdp_gather = lambda *a, **k: None
    try:
        final_pc, out_pc = run(static, params, state, 200, gen_u=gu)
    finally:
        be.assemble_stdp_gather = swapped
    assert torch.equal(out["spikes"], out_pc["spikes"])
    for j in chain:
        assert torch.equal(final.weights[j], final_pc.weights[j])
        for a, b in zip(final.stdp[j], final_pc.stdp[j]):
            assert torch.equal(a, b)
        if homeo:
            assert torch.equal(final.homeo[j], final_pc.homeo[j])
    for a, b in ((final.ring, final_pc.ring), *zip(final.neurons, final_pc.neurons)):
        assert torch.equal(a, b)
    moved = [not torch.equal(final.weights[j], state.weights[j]) for j in chain]
    assert any(moved)
    now = [x for j in chain for x in (state.weights[j], *state.stdp[j])]
    assert all(torch.equal(a, b) for a, b in zip(now, saved))


def _swapped_run(builders, *args, **kw):
    """``run`` with each ``backend`` launcher builder named in ``builders``
    swapped for one that builds nothing: those projections then take the
    per-call path."""
    from repro_torch.core import backend as be

    saved = {name: getattr(be, name) for name in builders}
    for name in builders:
        setattr(be, name, lambda *a, **k: None)
    try:
        return run(*args, **kw)
    finally:
        for name, fn in saved.items():
            setattr(be, name, fn)


@pytest.mark.parametrize("policy", ["fp16", "fp32"])
@pytest.mark.parametrize("homeo", [False, True])
def test_dense_stdp_launcher_matches_per_call_path(policy, homeo):
    """Plastic Synfire4 packed for 1,000 ticks through the run's dense STDP
    launcher (``backend.assemble_stdp_update``, ``ops.StdpUpdateRun``:
    every chain projection in one call a tick, traces stepped inside, the
    fan-in drive reading the launcher's zero-ended weight buffers) and
    through the per-call path (``stdp_dispatch`` per projection), with
    homeostasis every 100 ticks where asked: raster, final weights,
    traces, running rates, v, u and ring bit for bit; the input state is
    left as it was; the final state carries the launcher's weights and
    current traces."""
    from repro_torch.core import backend as be

    kw = dict(homeo_chain=tpl.HomeostasisConfig(target_hz=10.0, tau_avg_ms=1000.0, beta=2.0),
              homeostasis_period=100) if homeo else {}
    net = tsyn.build_synfire(tsyn.SYNFIRE4, policy=policy, propagation="packed",
                             stdp_chain=tsyn.CHAIN_STDP, device="cpu", **kw)
    static, params, state = net.static, net.params, net.state0
    chain = plastic_ids(static)
    built = be.assemble_stdp_update(static, params, state.weights, state.stdp)
    assert built.keys == tuple(chain) and len(chain) == 4
    assert be.assemble_stdp_gather(static, params, state.weights, state.stdp) is None
    assert sorted(built.padded) == chain
    saved = [x.clone() for j in chain for x in (state.weights[j], *state.stdp[j])]
    gu = torch.from_numpy(np.random.default_rng(2).random((FULL_TICKS, static.n_gen))
                          .astype(np.float32))
    final, out = run(static, params, state, FULL_TICKS, gen_u=gu)
    final_pc, out_pc = _swapped_run(("assemble_stdp_update",), static, params, state,
                                    FULL_TICKS, gen_u=gu)
    assert torch.equal(out["spikes"], out_pc["spikes"])
    for j in chain:
        assert final.weights[j].shape == state.weights[j].shape
        assert torch.equal(final.weights[j], final_pc.weights[j])
        for a, b in zip(final.stdp[j], final_pc.stdp[j]):
            assert torch.equal(a, b)
        if homeo:
            assert torch.equal(final.homeo[j], final_pc.homeo[j])
    for a, b in ((final.ring, final_pc.ring), *zip(final.neurons, final_pc.neurons)):
        assert torch.equal(a, b)
    assert any(not torch.equal(final.weights[j], state.weights[j]) for j in chain)
    if homeo:
        no_homeo = tsyn.build_synfire(tsyn.SYNFIRE4, policy=policy, propagation="packed",
                                      stdp_chain=tsyn.CHAIN_STDP, device="cpu")
        plain, _ = run(no_homeo.static, no_homeo.params, no_homeo.state0, FULL_TICKS,
                       gen_u=gu)
        assert any(not torch.equal(final.weights[j], plain.weights[j]) for j in chain)
    now = [x for j in chain for x in (state.weights[j], *state.stdp[j])]
    assert all(torch.equal(a, b) for a, b in zip(now, saved))


def test_both_stdp_launchers_and_da_stdp_in_one_run():
    """A net with a dense-stored pair-STDP projection, a CSR-stored one
    (``propagation="auto"`` picks the storage) and a DA-STDP one: one run
    takes the dense launcher, the CSR launcher and the plain DA-STDP step
    side by side, and equals the per-call path bit for bit (raster,
    weights, traces, eligibility, v, u, ring) under a dopamine schedule."""
    from repro_torch.core import backend as be

    net = NetworkBuilder(seed=7)
    net.add_spike_generator("pre", 30, rate_hz=80.0)
    net.add_spike_generator("wide", 200, rate_hz=40.0)
    net.add_group("post", izh4(10, a=0.02, b=0.2, c=-65.0, d=8.0))
    net.add_group("post2", izh4(12, a=0.02, b=0.2, c=-65.0, d=8.0))
    pair = tpl.STDPConfig(a_plus=0.01, a_minus=0.002, w_max=6.0)
    net.connect("pre", "post", fanin=15, weight=3.0, delay_ms=1, stdp=pair)
    net.connect("wide", "post", fanin=5, weight=2.0, delay_ms=2, stdp=pair)
    net.connect("pre", "post2", fanin=10, weight=3.0, delay_ms=1, da_modulated=True,
                stdp=tpl.STDPConfig(a_plus=0.01, a_minus=0.002, w_max=6.0, tau_elig=200.0))
    c = net.compile(policy="fp16", propagation="auto", device="cpu")
    static, params, state = c.static, c.params, c.state0
    assert plastic_ids(static) == [0, 1, 2] and static.plastic_csr == (1,)
    assert be.assemble_stdp_update(static, params, state.weights, state.stdp).keys == (0,)
    assert be.assemble_stdp_gather(static, params, state.weights, state.stdp).keys == (1,)
    ticks = 300
    rng = np.random.default_rng(3)
    gu = torch.from_numpy(rng.random((ticks, static.n_gen)).astype(np.float32))
    da = torch.from_numpy((rng.random(ticks) * 1.5).astype(np.float32))
    final, out = run(static, params, state, ticks, gen_u=gu, dopamine=da)
    final_pc, out_pc = _swapped_run(("assemble_stdp_update", "assemble_stdp_gather"),
                                    static, params, state, ticks, gen_u=gu, dopamine=da)
    assert out["spikes"].sum() > 100
    assert torch.equal(out["spikes"], out_pc["spikes"])
    for j in (0, 1, 2):
        assert torch.equal(final.weights[j], final_pc.weights[j])
        assert not torch.equal(final.weights[j], state.weights[j])
        for a, b in zip(final.stdp[j], final_pc.stdp[j]):
            assert torch.equal(a, b)
    for a, b in ((final.ring, final_pc.ring), *zip(final.neurons, final_pc.neurons)):
        assert torch.equal(a, b)
