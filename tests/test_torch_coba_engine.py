"""Conductance-based (COBA) networks on the port against the reference on
the CPU, with the tolerance stated in each test (bit for bit throughout).

The reference's COBA Synfire nets are built by wrapping its
``NetworkBuilder.compile`` in the test (``monkeypatch``) so that
``build_synfire`` compiles Table II with ``conductances=COBAConfig()``;
the port compiles the same declared network
(``configs/synfire4._synfire_builder``) with the same argument. Synfire's
weights, tuned as CUBA currents, saturate the net as conductances: this
is a parity workload, and no rate gate applies.

fp16 runs are held bit for bit against the reference's default jitted
``run`` (its mul+add contraction rounds away in fp16 storage); fp32 runs
against the reference evaluated op by op (``jax.disable_jit()``), over 150
ticks: the default jit parts from any op-by-op evaluation within a few
hundred ticks (ROADMAP queue C).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core.network as rnetwork  # noqa: E402
from repro.configs import synfire4 as rsyn  # noqa: E402
from repro.core import NetworkBuilder as RBuilder, izh4 as rizh4  # noqa: E402
from repro.core.conductance import COBAConfig as RCOBA  # noqa: E402
from repro.core.engine import run as ref_run  # noqa: E402
from repro_torch.configs import synfire4 as tsyn  # noqa: E402
from repro_torch.core import (COBAConfig, NetworkBuilder, izh4, run,  # noqa: E402
                              step)
from repro_torch.core import backend as be  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.convert import params_from_numpy, state_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.memory import MCU_BUDGET_BYTES, MemoryLedger  # noqa: E402

f32 = torch.float32
FULL_TICKS = 1000
OP_BY_OP_TICKS = 150


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def ref_coba_synfire(cfg_name, policy, propagation, **kw):
    """The reference's ``build_synfire`` with its compile given
    ``conductances=COBAConfig()``."""
    orig = rnetwork.NetworkBuilder.compile

    def compile_coba(self, **ckw):
        return orig(self, conductances=RCOBA(), **ckw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rnetwork.NetworkBuilder, "compile", compile_coba)
        return rsyn.build_synfire(getattr(rsyn, cfg_name), policy=policy,
                                  propagation=propagation, **kw)


def port_coba_synfire(cfg_name, policy, propagation, device="cpu", stdp_chain=None,
                      **kw):
    """The port's Table II network compiled as ``build_synfire`` compiles
    it, with ``conductances=COBAConfig()``."""
    ledger = MemoryLedger(budget=MCU_BUDGET_BYTES, name=f"{cfg_name}/{policy}")
    return tsyn._synfire_builder(getattr(tsyn, cfg_name), stdp_chain=stdp_chain).compile(
        policy=policy, propagation=propagation, conductances=COBAConfig(), ledger=ledger,
        monitor_ms_hint=1000, device=device, **kw)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(jax.random.key_data(x) if jax.dtypes.issubdtype(
        x.dtype, jax.dtypes.prng_key) else x)


def assert_same_raster(ref, port, what=""):
    ref, port = np.asarray(ref), np.asarray(port)
    assert ref.shape == port.shape
    if not np.array_equal(ref, port):
        first = int(np.argwhere((ref != port).any(axis=1))[0][0])
        pytest.fail(f"{what} rasters diverge first at tick {first}: "
                    f"{int((ref != port).sum())} entries differ")


def assert_same_state(rfinal, tfinal, plastic=()):
    """t, v, u, refrac, ring, the four conductances and the key bit for bit
    (and the weights and STDP traces of the projections in ``plastic``)."""
    assert tfinal.t == int(rfinal.t)
    pairs = [("v", rfinal.neurons.v, tfinal.neurons.v), ("u", rfinal.neurons.u,
             tfinal.neurons.u), ("refrac", rfinal.neurons.refrac, tfinal.neurons.refrac),
             ("ring", rfinal.ring, tfinal.ring)]
    pairs += [(f"cond.{f}", getattr(rfinal.cond, f), getattr(tfinal.cond, f))
              for f in tfinal.cond._fields]
    for j in plastic:
        pairs.append((f"weights.{j}", rfinal.weights[j], tfinal.weights[j]))
        pairs += [(f"stdp.{j}.{f}", getattr(rfinal.stdp[j], f), getattr(tfinal.stdp[j], f))
                  for f in tfinal.stdp[j]._fields]
    for name, r, t in pairs:
        r = as_np(r)
        assert t.numpy().dtype == r.dtype, name
        np.testing.assert_array_equal(t.numpy(), r, err_msg=name)
    np.testing.assert_array_equal(tfinal.key.numpy().view(np.uint32), as_np(rfinal.key))


_RUNS: dict = {}


def both_runs(cfg_name, policy, propagation, n_steps):
    """(reference final, reference raster, port final, port raster), cached
    per case: the reference's default jitted run and the port's run, each
    on its own default generator stream (the same threefry draws)."""
    key = (cfg_name, policy, propagation, n_steps)
    if key not in _RUNS:
        rnet = ref_coba_synfire(cfg_name, policy, propagation)
        tnet = port_coba_synfire(cfg_name, policy, propagation)
        rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, n_steps)
        tfinal, tout = run(tnet.static, tnet.params, tnet.state0, n_steps)
        _RUNS[key] = (rfinal, np.asarray(rout["spikes"]), tfinal, tout["spikes"].numpy())
    return _RUNS[key]


FP16_CASES = [(c, p) for c in ("SYNFIRE4_MINI", "SYNFIRE4") for p in ("packed", "sparse")]


@pytest.mark.parametrize("cfg_name,propagation", FP16_CASES)
def test_fp16_raster_bitwise(cfg_name, propagation):
    _, rsp, _, tsp = both_runs(cfg_name, "fp16", propagation, FULL_TICKS)
    assert rsp.sum() > 10_000, "COBA net never ignited: degenerate parity"
    assert_same_raster(rsp, tsp)


@pytest.mark.parametrize("cfg_name,propagation", FP16_CASES)
def test_fp16_final_state_bitwise(cfg_name, propagation):
    rfinal, _, tfinal, _ = both_runs(cfg_name, "fp16", propagation, FULL_TICKS)
    assert float(tfinal.cond.g_ampa.float().abs().max()) > 0
    assert_same_state(rfinal, tfinal)


def _op_by_op_case(cfg_name, propagation):
    rnet = ref_coba_synfire(cfg_name, "fp32", propagation)
    tnet = port_coba_synfire(cfg_name, "fp32", propagation)
    with jax.disable_jit():
        rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, OP_BY_OP_TICKS)
    tfinal, tout = run(tnet.static, tnet.params, tnet.state0, OP_BY_OP_TICKS)
    assert np.asarray(rout["spikes"]).sum() > 1000
    assert_same_raster(rout["spikes"], tout["spikes"].numpy())
    assert_same_state(rfinal, tfinal)


def test_fp32_mini_bitwise_op_by_op():
    """fp32 Synfire4-mini packed, 150 ticks, bit for bit against the
    reference evaluated op by op."""
    _op_by_op_case("SYNFIRE4_MINI", "packed")


def test_fp32_synfire4_bitwise_op_by_op():
    """fp32 Synfire4 sparse, 150 ticks, bit for bit against the reference
    evaluated op by op."""
    _op_by_op_case("SYNFIRE4", "sparse")


@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_plastic_fp16_bitwise(propagation):
    """Plastic COBA Synfire4 (``CHAIN_STDP`` on the exc->exc chain) fp16,
    1,000 ticks: raster, final state, chain weights and traces bit for bit
    against the reference's default jitted run. (On the way, the jitted
    reference's contraction sets a few NMDA conductances one fp16 ulp off
    the op-by-op reference, which the port equals, and they meet again.)"""
    rnet = ref_coba_synfire("SYNFIRE4", "fp16", propagation, stdp_chain=rsyn.CHAIN_STDP)
    tnet = port_coba_synfire("SYNFIRE4", "fp16", propagation, stdp_chain=tsyn.CHAIN_STDP)
    rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, FULL_TICKS)
    tfinal, tout = run(tnet.static, tnet.params, tnet.state0, FULL_TICKS)
    assert_same_raster(rout["spikes"], tout["spikes"].numpy())
    chain = [j for j, c in enumerate(tnet.static.stdp) if c is not None]
    assert len(chain) == 4
    assert any(not torch.equal(tfinal.weights[j], tnet.state0.weights[j]) for j in chain)
    assert_same_state(rfinal, tfinal, plastic=chain)


def test_ledger_conductance_bytes_equal_reference():
    for policy in ("fp16", "fp32"):
        rnet = ref_coba_synfire("SYNFIRE4", policy, "sparse")
        tnet = port_coba_synfire("SYNFIRE4", policy, "sparse")
        want, got = rnet.ledger.name_bytes(), tnet.ledger.name_bytes()
        assert got["conductances"] == want["conductances"] == 4 * 1200 * (
            2 if policy == "fp16" else 4)
        assert got["ring"] == want["ring"] == 11 * 1200 * 2 * (2 if policy == "fp16" else 4)
        assert tnet.ledger.stage_bytes() == rnet.ledger.stage_bytes()


def test_convert_carries_conductances_across():
    """The reference's params and its COBA Synfire4 fp16 state after 137
    ticks, carried across (``cond.*`` and the two-channel ring), continue
    on the port for 113 ticks into the reference's own 250-tick raster,
    and into the port's own uninterrupted run's conductances bit for bit
    (at tick 250 the reference's jitted run holds three NMDA conductances
    one fp16 ulp off its own op-by-op evaluation, which the port equals)."""
    rnet = ref_coba_synfire("SYNFIRE4", "fp16", "sparse")
    tnet = port_coba_synfire("SYNFIRE4", "fp16", "sparse")
    rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, 250)
    mid, _ = ref_run(rnet.static, rnet.params, rnet.state0, 137)
    rp = rnet.params
    params = {f"neuron.{f}": np.asarray(getattr(rp.neuron, f)) for f in rp.neuron._fields}
    params.update({f: np.asarray(getattr(rp, f))
                   for f in ("gen_rate", "gen_until", "gen_rate_after")})
    for bi, (pre, post, idx) in enumerate(zip(rp.bucket_pre_ids, rp.bucket_post_ids,
                                              rp.bucket_csr_idx)):
        params[f"bucket_pre_ids.{bi}"] = np.asarray(pre)
        params[f"bucket_post_ids.{bi}"] = np.asarray(post)
        params[f"bucket_csr_idx.{bi}"] = np.asarray(idx)
    arrays = {"t": np.asarray(mid.t), "key": as_np(mid.key), "ring": np.asarray(mid.ring),
              **{f"neurons.{f}": np.asarray(getattr(mid.neurons, f))
                 for f in ("v", "u", "refrac")},
              **{f"weights.{j}": np.asarray(w) for j, w in enumerate(mid.weights)},
              **{f"cond.{f}": np.asarray(getattr(mid.cond, f)) for f in mid.cond._fields}}
    state = state_from_numpy(tnet.static, arrays, "cpu")
    assert state.ring.shape[2] == 2
    k_draw, _ = jax.random.split(rnet.state0.key)
    gu = np.asarray(jax.random.uniform(k_draw, (250, tnet.static.n_gen)))
    final, out = run(tnet.static, params_from_numpy(tnet.static, params, "cpu"), state, 113,
                     gen_u=torch.from_numpy(gu[137:].copy()))
    assert_same_raster(np.asarray(rout["spikes"])[137:], out["spikes"].numpy())
    own, _ = run(tnet.static, tnet.params, tnet.state0, 250)
    for f in final.cond._fields:
        np.testing.assert_array_equal(getattr(final.cond, f).numpy(),
                                      getattr(own.cond, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(final.ring.numpy(), np.asarray(rfinal.ring))
    del arrays["cond.g_nmda"]
    with pytest.raises(KeyError, match="cond.g_nmda"):
        state_from_numpy(tnet.static, arrays, "cpu")


def test_fused_backend_plans_no_kernel():
    """A COBA net on ``backend="fused"`` is never the fused tick (its plan's
    ``kernel_ok`` is false for two channels, as the reference's) and ticks
    as the default backend does."""
    net = port_coba_synfire("SYNFIRE4_MINI", "fp16", "packed", backend="fused")
    assert net.static.fused is not None and not net.static.fused.kernel_ok
    assert not net.static.fused_kernel
    plain = port_coba_synfire("SYNFIRE4_MINI", "fp16", "packed")
    _, a = run(net.static, net.params, net.state0, 200)
    _, b = run(plain.static, plain.params, plain.state0, 200)
    assert torch.equal(a["spikes"], b["spikes"])


def _coba_net(builder, lib_izh4, **kw):
    """``tests/test_snn_core.py::TestCOBA::test_coba_network_runs``'s net."""
    net = builder(seed=0)
    net.add_spike_generator("g", 10, rate_hz=200.0)
    net.add_group("n", lib_izh4(10, a=0.02, b=0.2, c=-65.0, d=8.0))
    net.connect("g", "n", fanin=5, weight=1.0, delay_ms=2)
    return net


def test_coba_network_runs_as_reference():
    rnet = _coba_net(RBuilder, rizh4).compile(policy="fp16", conductances=RCOBA())
    tnet = _coba_net(NetworkBuilder, izh4).compile(policy="fp16", conductances=COBAConfig(),
                                                   device="cpu")
    rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, 300)
    tfinal, tout = run(tnet.static, tnet.params, tnet.state0, 300)
    assert not torch.isnan(tfinal.neurons.v.float()).any()
    assert int(tout["spikes"].sum()) > 0
    assert_same_raster(rout["spikes"], tout["spikes"].numpy())
    assert_same_state(rfinal, tfinal)


def _channels_net(builder, lib_izh4, cfg, propagation, **kw):
    """``tests/test_sparse.py::test_coba_channels_route_identically``'s net."""
    net = builder(seed=2)
    net.add_spike_generator("g", 20, rate_hz=120.0)
    net.add_group("e", lib_izh4(16, a=0.02, b=0.2, c=-65.0, d=8.0))
    net.add_group("i", lib_izh4(6, a=0.1, b=0.2, c=-65.0, d=2.0))
    net.connect("g", "e", fanin=6, weight=1.0, delay_ms=2)
    net.connect("e", "i", fanin=4, weight=2.0, delay_ms=1)
    net.connect("i", "e", fanin=3, weight=-1.5, delay_ms=1)
    return net.compile(policy="fp16", propagation=propagation, conductances=cfg, **kw)


@pytest.mark.parametrize("propagation", ["loop", "sparse", "packed"])
def test_coba_channels_route_as_reference(propagation):
    """Excitatory and inhibitory drives land in their channels as absolute
    values: the port's loop and sparse rasters are equal (channels {0, 1}
    under sparse), and each mode equals the reference's, state included."""
    tnet = _channels_net(NetworkBuilder, izh4, COBAConfig(), propagation, device="cpu")
    rnet = _channels_net(RBuilder, rizh4, RCOBA(), propagation)
    if propagation == "sparse":
        assert len(tnet.static.csr_projs) == 3
        assert {b.channel for b in tnet.static.buckets} == {0, 1}
    rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, 200)
    tfinal, tout = run(tnet.static, tnet.params, tnet.state0, 200)
    assert int(tout["spikes"].sum()) > 20
    assert_same_raster(rout["spikes"], tout["spikes"].numpy(), propagation)
    assert_same_state(rfinal, tfinal)
    loop = _channels_net(NetworkBuilder, izh4, COBAConfig(), "loop", device="cpu")
    _, lout = run(loop.static, loop.params, loop.state0, 200)
    assert torch.equal(lout["spikes"], tout["spikes"])


def test_step_matches_run():
    """COBA ``step`` (the per-op phase) tick by tick gives ``run``'s raster
    and final state, conductances included."""
    net = port_coba_synfire("SYNFIRE4_MINI", "fp16", "sparse")
    gu = torch.rand((40, net.static.n_gen), generator=torch.Generator().manual_seed(1))
    final, out = run(net.static, net.params, net.state0, 40, gen_u=gu)
    state = net.state0
    for t in range(40):
        state, o = step(net.static, net.params, state, gen_u=gu[t])
        assert torch.equal(o.spikes, out["spikes"][t])
    for a, b in zip(state.cond, final.cond):
        assert torch.equal(a, b)
    assert torch.equal(state.ring, final.ring)


@pytest.mark.parametrize("policy", ["fp16", "fp32"])
def test_plain_neuron_run_equals_per_op_phase(policy):
    """``ops.NeuronRun`` in COBA mode (its plain version on the CPU) against
    the per-op phase (``engine._neuron_phase`` over ``core/conductance``),
    tick by tick on random conductances, v, u, ring, generator rows and an
    external current: v, u, refrac, ring, conductances, spike row and the
    raster, v and i_syn rows, bit for bit."""
    from repro_torch.core.conductance import ConductanceState
    from repro_torch.core.neurons import NeuronState

    net = port_coba_synfire("SYNFIRE4", policy, "sparse")
    static, params = net.static, net.params
    n, ticks, dtype = static.n, 12, net.state0.neurons.v.dtype
    g = torch.Generator().manual_seed(3)
    neurons = NeuronState(v=(torch.rand(n, generator=g) * 115 - 80).to(dtype),
                          u=(torch.rand(n, generator=g) * 10 - 15).to(dtype),
                          refrac=torch.randint(0, 3, (n,), generator=g).to(torch.int16))
    cond = ConductanceState(*((torch.rand(n, generator=g) * 3).to(dtype) for _ in range(4)))
    ring = (torch.rand(tuple(net.state0.ring.shape), generator=g) * 12).to(dtype)
    gen_spk = torch.rand((ticks, static.n_gen), generator=g) < 0.3
    cur = torch.rand((ticks, n), generator=g) * 8
    rows = {"raster": torch.zeros((ticks, n), dtype=torch.bool),
            "v_rows": torch.zeros((ticks, n)), "i_rows": torch.zeros((ticks, n))}
    run_ring = ring.clone()
    saved = [x.clone() for x in cond]
    nrun = be.assemble_neurons(static, params, neurons, run_ring, cond=cond,
                               gen_spk=gen_spk, i_ext=cur, **rows)
    assert nrun.launcher is None
    state, pcond, spiked = neurons, cond, 0
    for i in range(ticks):
        t = 30 + i
        nrun(i, t)
        state, spikes, i_syn, pcond = engine._neuron_phase(static, params, state, ring, t,
                                                           gen_spk[i], cur[i], pcond)
        for got, want in ((nrun.v, state.v), (nrun.u, state.u), (nrun.refrac, state.refrac),
                          (run_ring, ring), (nrun.spikes, spikes.to(f32)),
                          *zip(nrun.cond, pcond)):
            assert got.dtype == want.dtype and torch.equal(got, want), f"tick {t}"
        assert torch.equal(rows["raster"][i], spikes)
        assert torch.equal(rows["v_rows"][i], state.v.to(f32))
        assert torch.equal(rows["i_rows"][i], i_syn)
        spiked += int(spikes[static.n_gen:].sum())
    assert spiked > 0
    assert all(torch.equal(a, b) for a, b in zip(cond, saved))  # the caller's, untouched


def test_plain_gather_run_with_channels_equals_per_bucket_path():
    """``ops.GatherRun`` keyed by (delay, channel) (its plain version on the
    CPU) on a COBA Synfire4 sparse net's tables, against the per-bucket
    path: ``ops.syn_gather`` per bucket, its absolute value added at its
    posts into its (delay, channel) row, in plan order; random spike
    rows, and random normal weights (mixed signs in one bucket, where
    ``|drive|`` per bucket differs from ``|sum|``), bit for bit."""
    net = port_coba_synfire("SYNFIRE4", "fp16", "sparse")
    static, params = net.static, net.params
    g = torch.Generator().manual_seed(4)
    for random_w in (False, True):
        packed = list(be.assemble_packed(static, net.state0.weights))
        if random_w:
            packed = [torch.randn(tuple(w.shape), generator=g) for w in packed]
        grun = be.assemble_gather(static, params, packed)
        assert grun.keys == tuple((d, c) for d in grun.delays for c in (0, 1))
        for _ in range(3):
            spikes = (torch.rand(static.n, generator=g) < 0.3).float()
            grun(0, spikes)
            want = torch.zeros_like(grun.rows)
            for bi, b in enumerate(static.buckets):
                drive = ops.syn_gather(be._bucket_pre(static, params, spikes, bi),
                                       params.bucket_csr_idx[bi], packed[bi]).abs()
                row = want[grun.keys.index((b.delay_ms, b.channel))]
                row[b.post_start:b.post_start + b.q] += drive
            assert torch.equal(grun.rows, want)
            assert bool((grun.rows >= 0).all())


def test_propagate_packed_channels_match_reference_accumulators():
    """On a COBA packed net, ``propagate_packed`` lands the inhibitory
    buckets (delay 8) in channel 1 and the rest in channel 0 as magnitudes:
    the ring after one tick of random spikes equals the loop oracle's."""
    net = port_coba_synfire("SYNFIRE4", "fp32", "packed")
    loop = port_coba_synfire("SYNFIRE4", "fp32", "loop")
    assert {(b.delay_ms, b.channel) for b in net.static.buckets} == {(10, 0), (8, 1)}
    spikes = (torch.rand(net.static.n, generator=torch.Generator().manual_seed(5)) < 0.3
              ).float()
    ring_a, ring_b = net.state0.ring.clone(), loop.state0.ring.clone()
    be.propagate_packed(net.static, net.params, spikes, ring_a, 3,
                        be.assemble_packed(net.static, net.state0.weights),
                        net.state0.weights, net.state0.stp)
    be.propagate_loop(loop.static, spikes, ring_b, 3, loop.state0.weights, loop.state0.stp)
    assert torch.equal(ring_a, ring_b)
    assert float(ring_a[(3 + 8) % 11, :, 1].sum()) > 0 and float(ring_a[:, :, 1].min()) >= 0


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_coba_lif_net_per_op_phase_as_reference(method):
    """A COBA net with a LIF group (not IZH4-only: no neuron-phase launcher,
    the per-op COBA phase every tick), Euler and RK4, fp16, 300 ticks:
    raster and whole state bit for bit against the reference (NaN where
    the reference's RK4 membranes run away, as the reference's)."""
    from repro.core import lif as rlif
    from repro_torch.core import lif

    def build(builder, lib_izh4, lib_lif, cfg, **kw):
        b = builder(seed=3)
        b.add_spike_generator("g", 30, rate_hz=150.0)
        b.add_group("e", lib_izh4(20, a=0.02, b=0.2, c=-65.0, d=8.0))
        b.add_group("l", lib_lif(15))
        b.connect("g", "e", fanin=8, weight=1.0, delay_ms=2)
        b.connect("g", "l", fanin=6, weight=0.5, delay_ms=1)
        b.connect("e", "l", fanin=5, weight=1.0, delay_ms=3)
        b.connect("l", "e", fanin=4, weight=-1.0, delay_ms=2)
        return b.compile(policy="fp16", propagation="sparse", conductances=cfg,
                         method=method, **kw)

    rnet = build(RBuilder, rizh4, rlif, RCOBA())
    tnet = build(NetworkBuilder, izh4, lif, COBAConfig(), device="cpu")
    assert not tnet.static.izh4_only
    rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, 300)
    tfinal, tout = run(tnet.static, tnet.params, tnet.state0, 300)
    assert int(tout["spikes"].sum()) > 1000
    assert_same_raster(rout["spikes"], tout["spikes"].numpy())
    assert_same_state(rfinal, tfinal)
