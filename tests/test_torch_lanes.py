"""Lanes: B1-B3 over a leading lane dimension, ``run_batch`` and batched
states, on the CPU against loops of the one-lane versions and against the
reference's ``run_batch``.

The lane launchers' plain versions (``ref.neuron_lanes_ref``,
``ref.gather_lanes_ref``, ``ref.syn_matmul_lanes_ref``) are loops of the
one-lane plain versions; the launchers must equal one-lane launchers lane
by lane, with lanes at different ticks and with shared or per-lane
weights. ``run_batch`` forks ``split(state.key, B)`` as the reference
does (``tests/test_sparse.py:155``, ``tests/test_backends.py:141-154``,
``tests/test_fused.py:99``, ``tests/test_telemetry.py:207``): rasters bit
for bit against the reference's ``run_batch`` in every cell; fp16 state
bit for bit; fp32 v and u at rtol 1e-5, atol 1e-4 against the reference
compiled at ``xla_backend_optimization_level=0`` (the reference's mul+add
contraction, ROADMAP queue C), the ring bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import synfire4 as rsyn  # noqa: E402
from repro.core.conductance import COBAConfig as RCOBA  # noqa: E402
from repro.core.engine import run_batch as ref_run_batch  # noqa: E402
from repro.core.network import NetworkBuilder as RBuilder  # noqa: E402
from repro_torch.configs import synfire4 as tsyn  # noqa: E402
from repro_torch.core import (COBAConfig, Engine, lane_state, rng, run,  # noqa: E402
                              run_batch, set_lane, stack_states)
from repro_torch.core import backend as be  # noqa: E402
from repro_torch.core.engine import _run_lanes, batched_route  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.syn_gather import Bucket  # noqa: E402

TICKS = 200


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def key_words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).view(np.int32)


def nets(cfg="SYNFIRE4_MINI", policy="fp16", propagation="sparse", coba=False,
         plastic=False):
    """The same Synfire net in both packages; ``coba``: Table II with
    conductances (the reference's compile wrapped to add them)."""
    kw = dict(policy=policy, propagation=propagation)
    if plastic:
        kw["stdp_chain"] = rsyn.CHAIN_STDP
    if coba:
        compile_ = RBuilder.compile
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(RBuilder, "compile",
                       lambda self, **k: compile_(self, conductances=RCOBA(), **k))
            rnet = rsyn.build_synfire(getattr(rsyn, cfg), monitors=None, **kw)
        tnet = tsyn._synfire_builder(getattr(tsyn, cfg)).compile(
            conductances=COBAConfig(), device="cpu", **kw)
        return rnet, tnet
    rnet = rsyn.build_synfire(getattr(rsyn, cfg), monitors=None, **kw)
    if plastic:
        kw["stdp_chain"] = tsyn.CHAIN_STDP
    return rnet, tsyn.build_synfire(getattr(tsyn, cfg), device="cpu", **kw)


def ref_batch(rnet, n, b, opt0=False, **kw):
    if not opt0:
        return ref_run_batch(rnet.static, rnet.params, rnet.state0, n, b, **kw)
    compiled = ref_run_batch.lower(rnet.static, rnet.params, rnet.state0, n, b, **kw).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return compiled(rnet.params, rnet.state0)


def assert_raster(rout, tout):
    r, t = np.asarray(rout["spikes"]), tout["spikes"].numpy()
    assert r.shape == t.shape
    if not np.array_equal(r, t):
        lane, first = (int(x) for x in np.argwhere((r != t).any(axis=2))[0])
        pytest.fail(f"lane {lane} diverges first at tick {first}")


def assert_state(policy, rfinal, tfinal, opt0=None):
    """t, key and the ring bit for bit; v, u (and COBA conductances) bit
    for bit at fp16, at rtol 1e-5, atol 1e-4 against ``opt0`` at fp32."""
    assert tfinal.t == tuple(int(x) for x in np.asarray(rfinal.t))
    np.testing.assert_array_equal(tfinal.key.numpy(), key_words(rfinal.key))
    np.testing.assert_array_equal(tfinal.ring.numpy(), np.asarray(rfinal.ring))
    np.testing.assert_array_equal(tfinal.neurons.refrac.numpy(),
                                  np.asarray(rfinal.neurons.refrac))
    pairs = [("v", tfinal.neurons.v, rfinal.neurons.v, opt0 and opt0.neurons.v),
             ("u", tfinal.neurons.u, rfinal.neurons.u, opt0 and opt0.neurons.u)]
    if tfinal.cond is not None:
        pairs += [(f, getattr(tfinal.cond, f), getattr(rfinal.cond, f), None)
                  for f in tfinal.cond._fields]
    for name, t, r, r0 in pairs:
        if policy == "fp16" or r0 is None:
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(r, np.float32),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(r0), rtol=1e-5, atol=1e-4,
                                       err_msg=name)


# -- the lane launchers against one-lane launchers ---------------------------


def _lanes(net, lanes, seed):
    """``lanes`` states of ``net`` a random 1-40 ticks in, on random
    uniforms: lanes at different ticks (ring phases) and states."""
    g = torch.Generator().manual_seed(seed)
    states = []
    for _ in range(lanes):
        ticks = int(torch.randint(1, 41, (1,), generator=g))
        gu = torch.rand((ticks, net.static.n_gen), generator=g)
        states.append(run(net.static, net.params, net.state0, ticks, gen_u=gu)[0])
    return stack_states(states)


@pytest.mark.parametrize("policy", ["fp16", "fp32"])
@pytest.mark.parametrize("coba", [False, True], ids=["cuba", "coba"])
def test_neuron_run_lanes_equal_one_lane_runs(policy, coba):
    """``NeuronRun`` over 6 lanes at their own ticks for 12 chained ticks,
    with generator rows, raster and v rows: each lane bit for bit the
    one-lane launcher on that lane (v, u, refrac, conductances, ring,
    spikes, raster, v rows); the plain lane version is a loop of the
    one-lane plain version."""
    net = (tsyn._synfire_builder(tsyn.SYNFIRE4_MINI).compile(
        conductances=COBAConfig(), policy=policy, propagation="sparse", device="cpu")
           if coba else tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy=policy,
                                           propagation="sparse", device="cpu"))
    st = _lanes(net, 6, 1)
    assert len({t % net.static.ring_len for t in st.t}) > 1
    g = torch.Generator().manual_seed(2)
    ring = (torch.rand(tuple(st.ring.shape), generator=g) * 8).to(st.ring.dtype)
    gen = torch.rand((6, 12, net.static.n_gen), generator=g) < 0.3
    n = net.static.n
    raster = torch.zeros((6, 12, n), dtype=torch.bool)
    vs = torch.zeros((6, 12, n))
    lanes_ring = ring.clone()
    runs = be.assemble_neurons(net.static, net.params, st.neurons, lanes_ring,
                               cond=st.cond, gen_spk=gen, raster=raster, v_rows=vs,
                               t0=st.t)
    for i in range(12):
        runs(i)
    for b in range(6):
        one = lane_state(st, b)
        ring_b = ring[b].clone()
        r_b = torch.zeros((12, n), dtype=torch.bool)
        v_b = torch.zeros((12, n))
        solo = be.assemble_neurons(net.static, net.params, one.neurons, ring_b,
                                   cond=one.cond, gen_spk=gen[b], raster=r_b, v_rows=v_b)
        for i in range(12):
            solo(i, st.t[b] + i)
        for x, y in ((solo.v, runs.v[b]), (solo.u, runs.u[b]), (solo.refrac, runs.refrac[b]),
                     (ring_b, lanes_ring[b]), (solo.spikes, runs.spikes[b]),
                     (r_b, raster[b]), (v_b, vs[b]),
                     *zip(solo.cond or (), (c[b] for c in runs.cond or ()))):
            assert torch.equal(x, y), b
    assert int(raster.sum()) > 0


@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "per-lane"])
@pytest.mark.parametrize("channels", [1, 2])
def test_gather_run_lanes_equal_one_lane_runs(per_lane, channels):
    """``GatherRun`` over 5 lanes on the mini's compiled tables with random
    weights, shared or one table per lane, one and two ring channels: each
    lane's rows bit for bit the one-lane launcher's on its spike row;
    ``gather_lanes_ref`` is a loop of ``gather_run_ref``."""
    net = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16", propagation="sparse",
                             device="cpu")
    g = torch.Generator().manual_seed(3 + channels)
    lead = (5,) if per_lane else ()
    packed = tuple(torch.randn((*lead, *w.shape), generator=g)
                   for w in be.assemble_packed(net.static, net.state0.weights))
    buckets = []
    for bi, b in enumerate(net.static.buckets):
        pre = np.arange(b.pre_start, b.pre_start + b.p)
        buckets.append(Bucket(b.delay_ms, np.arange(b.post_start, b.post_start + b.q),
                                 (pre, net.params.bucket_csr_idx[bi], packed[bi]),
                                 bi % channels))
    spikes = (torch.rand((5, net.static.n), generator=g) < 0.3).float()
    runs = ops.GatherRun(net.static.n, buckets, "cpu", channels, lanes=5)
    runs(0, spikes)
    want = torch.zeros_like(runs.rows)
    ref.gather_lanes_ref(spikes, want, runs.plan.plain[0], first=True,
                         absolute=channels == 2)
    assert torch.equal(runs.rows, want)
    for k in range(5):
        one = ops.GatherRun(net.static.n, [
            b._replace(table=(b.table[0], b.table[1], b.table[2][k] if per_lane
                              else b.table[2])) for b in buckets], "cpu", channels)
        one(0, spikes[k])
        assert torch.equal(one.rows, runs.rows[k]), k
    assert bool(runs.rows.ne(0).any())


def test_gather_run_set_lane_rereads_a_lanes_tables():
    """A per-lane ``GatherRun`` whose lane 2 tables are rewritten in place
    and re-read with ``set_lane`` sums as a run built on the new tables;
    a run whose lanes share their tables refuses."""
    net = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16", propagation="sparse",
                             device="cpu")
    g = torch.Generator().manual_seed(9)
    packed = tuple(torch.randn((4, *w.shape), generator=g)
                   for w in be.assemble_packed(net.static, net.state0.weights))
    runs = be.assemble_gather(net.static, net.params, packed, 4)
    for w in packed:
        w[2] = torch.randn(tuple(w.shape[1:]), generator=g)
    runs.set_lane(2)
    fresh = be.assemble_gather(net.static, net.params, tuple(w.clone() for w in packed), 4)
    assert torch.equal(runs.plan.w, fresh.plan.w)
    spikes = (torch.rand((4, net.static.n), generator=g) < 0.3).float()
    runs(0, spikes)
    fresh(0, spikes)
    assert torch.equal(runs.rows, fresh.rows)
    shared = be.assemble_gather(net.static, net.params, tuple(w[0] for w in packed), 4)
    with pytest.raises(ValueError, match="share"):
        shared.set_lane(1)


@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "per-lane"])
def test_matmul_run_lanes_equal_one_lane_runs(per_lane):
    """``MatmulRun`` over 7 lanes (rows a strided slice of wider rows) on
    random weights, shared or per lane: each lane the one-lane product."""
    g = torch.Generator().manual_seed(4)
    lead = (7,) if per_lane else ()
    w = torch.randn((*lead, 50, 39), generator=g).half()
    x = torch.randn((7, 60), generator=g)[:, 5:55]
    got = ops.MatmulRun([None, w], 7)(1, x)
    assert got.shape == (7, 39)
    assert torch.equal(got, ref.syn_matmul_lanes_ref(x, w))
    for k in range(7):
        assert torch.equal(ops.MatmulRun([w[k] if per_lane else w])(0, x[k]), got[k])


def test_lane_slots_commit_each_lane_at_its_own_slot():
    """``LaneSlots`` adds a lane's drive at (t0[b] + tick) % L, in the
    ring's dtype, as the one-lane commit does; in one phase and in
    several."""
    g = torch.Generator().manual_seed(5)
    for t0 in ((3, 3, 14), (0, 5, 7)):
        ring = (torch.rand((3, 11, 9, 1), generator=g) * 4).half()
        x = (torch.rand((3, 9, 1), generator=g) * 4).half()
        want = ring.clone()
        for b, t in enumerate(t0):
            want[b, (t + 12) % 11] += x[b]
        be.LaneSlots(t0, 11, "cpu").add(ring, 12, x)
        assert torch.equal(ring, want)


def test_lane_state_helpers_round_trip():
    net = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16", device="cpu")
    st = _lanes(net, 3, 6)
    one = lane_state(st, 1)
    assert one.t == st.t[1] and torch.equal(one.neurons.v, st.neurons.v[1])
    one.neurons.v.zero_()  # a copy: the batched state is left as it was
    assert not torch.equal(one.neurons.v, st.neurons.v[1])
    back = set_lane(st, 2, net.state0)
    assert back.t == (st.t[0], st.t[1], 0)
    assert torch.equal(back.ring[2], net.state0.ring)


# -- run_batch against the reference -------------------------------------------

CELLS = [(b, p, q) for b in (1, 4) for p in ("fp16", "fp32") for q in ("packed", "sparse")]


@pytest.mark.parametrize("batch,policy,propagation", CELLS)
def test_run_batch_matches_reference(batch, policy, propagation):
    rnet, tnet = nets(policy=policy, propagation=propagation)
    assert batched_route(tnet.static)
    rfinal, rout = ref_batch(rnet, TICKS, batch)
    tfinal, tout = run_batch(tnet.static, tnet.params, tnet.state0, TICKS, batch)
    assert tout["spikes"].shape == (batch, TICKS, tnet.static.n)
    assert int(tout["spikes"].sum()) > 50 * batch
    assert_raster(rout, tout)
    opt0 = ref_batch(rnet, TICKS, batch, opt0=True)[0] if policy == "fp32" else None
    assert_state(policy, rfinal, tfinal, opt0)
    for w, w0 in zip(tfinal.weights, tnet.state0.weights):
        assert w.shape == (batch, *w0.shape) and torch.equal(w[-1], w0)


@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_coba_run_batch_matches_reference(propagation):
    """COBA fp16 over 4 lanes: rasters, ring and conductances bit for bit."""
    rnet, tnet = nets(propagation=propagation, coba=True)
    assert tnet.static.coba is not None and batched_route(tnet.static)
    rfinal, rout = ref_batch(rnet, 150, 4)
    tfinal, tout = run_batch(tnet.static, tnet.params, tnet.state0, 150, 4)
    assert_raster(rout, tout)
    assert_state("fp16", rfinal, tfinal)


def test_plastic_run_batch_takes_the_lane_by_lane_route():
    """Plastic fp16 sparse, which now takes the batched route (one launch
    per kernel per tick for every lane; the test keeps its earlier name):
    rasters, plastic weights and state bit for bit against the reference's
    vmapped batch."""
    rnet, tnet = nets(plastic=True)
    assert batched_route(tnet.static)
    rfinal, rout = ref_batch(rnet, 150, 4)
    tfinal, tout = Engine(tnet).run_batch(150, 4)
    assert_raster(rout, tout)
    assert_state("fp16", rfinal, tfinal)
    chain = [j for j, s in enumerate(tnet.static.projections) if s.plastic]
    for j in chain:
        np.testing.assert_array_equal(tfinal.weights[j].float().numpy(),
                                      np.asarray(rfinal.weights[j], np.float32))
    assert not torch.equal(tfinal.weights[chain[0]][0], tfinal.weights[chain[0]][1])


def test_run_batch_gen_chunk_per_trial():
    """``gen_chunk`` draws per trial (``tests/test_telemetry.py:207``)."""
    rnet, tnet = nets()
    rfinal, rout = ref_batch(rnet, 100, 2, gen_chunk=25)
    tfinal, tout = run_batch(tnet.static, tnet.params, tnet.state0, 100, 2, gen_chunk=25)
    assert int(tout["spikes"].sum()) > 20
    assert_raster(rout, tout)
    assert_state("fp16", rfinal, tfinal)


def test_synfire4_run_batch_matches_reference():
    """Synfire4 fp16 sparse, 4 lanes for 100 ticks."""
    rnet, tnet = nets("SYNFIRE4")
    rfinal, rout = ref_batch(rnet, 100, 4)
    tfinal, tout = run_batch(tnet.static, tnet.params, tnet.state0, 100, 4)
    assert_raster(rout, tout)
    assert_state("fp16", rfinal, tfinal)


@pytest.mark.parametrize("build", [dict(backend="fused"), dict(propagation="loop")],
                         ids=["fused", "loop"])
def test_lane_by_lane_nets_equal_their_trials(build):
    """Loop nets take the lane-by-lane route and fused ones, since they
    have lanes of the ``fused_tick`` kernel, the batched route (the test
    keeps its earlier name): each lane is the solo run on ``split(key,
    B)[b]``, and equals the default backend's batch."""
    net = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16", device="cpu", **build)
    assert batched_route(net.static) == ("backend" in build)
    final, out = run_batch(net.static, net.params, net.state0, 100, 3)
    keys = rng.split(net.state0.key, 3)
    for b in range(3):
        solo, o = run(net.static, net.params, net.state0._replace(key=keys[b]), 100)
        assert torch.equal(o["spikes"], out["spikes"][b]) and final.t[b] == solo.t
    base = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16", device="cpu")
    _, want = run_batch(base.static, base.params, base.state0, 100, 3)
    assert torch.equal(out["spikes"], want["spikes"])


def test_run_lanes_checks_its_streams_as_run_does():
    """``_run_lanes`` takes ``run``'s generator set-up: ``gen_base`` and
    ``gen_chunk`` exclude each other, and ``gen_base`` must hold one key per
    lane."""
    net = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16", device="cpu")
    st = _lanes(net, 2, 8)
    keys = rng.split(net.state0.key, 2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        _run_lanes(net.static, net.params, st, 100, gen_base=keys, gen_chunk=50)
    with pytest.raises(ValueError, match=r"int32 \[2, 2\] key"):
        _run_lanes(net.static, net.params, st, 10, gen_base=keys[0])
    with pytest.raises(ValueError, match="must divide"):
        _run_lanes(net.static, net.params, st, 100, gen_chunk=30)


def test_run_batch_records_and_errors():
    net = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16", device="cpu")
    final, out = Engine(net).run_batch(40, 3, record_v=True, record_i=True, record="none")
    assert set(out) == {"v", "i_syn"} and out["v"].shape == (3, 40, net.static.n)
    solo, o = run(net.static, net.params,
                  net.state0._replace(key=rng.split(net.state0.key, 3)[2]), 40,
                  record_v=True, record_i=True)
    assert torch.equal(o["v"], out["v"][2]) and torch.equal(o["i_syn"], out["i_syn"][2])
    # In-run monitors are ported (A6): every trial's telemetry [B, G] on the
    # lane route equals its solo run's, and the reference's run_batch
    # (counts bit for bit; filter levels against its opt-level-0 compile).
    rnet = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, policy="fp16")
    rtel = ref_run_batch.lower(rnet.static, rnet.params, rnet.state0, 40, 3,
                               record="monitors").compile(
        compiler_options={"xla_backend_optimization_level": 0})(
        rnet.params, rnet.state0)[1]["telemetry"]
    for record in ("monitors", "both"):
        _, mon = run_batch(net.static, net.params, net.state0, 40, 3, record=record)
        assert ("spikes" in mon) == (record == "both")
        tel = mon["telemetry"]
        assert tel["spike_count"].shape == tel["group_rate"].shape == (3, 9)
        np.testing.assert_array_equal(tel["spike_count"].numpy(),
                                      np.asarray(rtel["spike_count"]))
        np.testing.assert_array_equal(tel["group_rate"].numpy(),
                                      np.asarray(rtel["group_rate"]))
        _, o = run(net.static, net.params,
                   net.state0._replace(key=rng.split(net.state0.key, 3)[2]), 40,
                   record="monitors")
        assert torch.equal(o["telemetry"]["spike_count"], tel["spike_count"][2])
        assert torch.equal(o["telemetry"]["group_rate"], tel["group_rate"][2])
    with pytest.raises(ValueError, match="gen_chunk"):
        run_batch(net.static, net.params, net.state0, 100, 2, gen_chunk=30)


@pytest.mark.parametrize("propagation,backend", [("sparse", None), ("packed", None),
                                                 ("sparse", "fused")])
def test_run_batch_monitor_kinds_equal_solo_runs(propagation, backend):
    """Every monitor kind over lanes: SpikeCount and GroupRate (folded in
    the lanes' neuron launch), a VoltageProbe with a repeated id and a
    WeightNorm (plain ops on ``[B, ...]``), on the plastic mini (the static
    mini on the fused tick), 120 ticks: each of 3 lanes equals its solo
    run, output for output."""
    from repro_torch.telemetry import GroupRate, SpikeCount, VoltageProbe, WeightNorm

    monitors = (SpikeCount(), GroupRate(tau_ms=30.0), VoltageProbe(neurons=(5, 180, 5)),
                WeightNorm(stride=40))
    net = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16", propagation=propagation,
                             backend=backend, device="cpu", monitors=monitors,
                             stdp_chain=None if backend else tsyn.CHAIN_STDP)
    assert batched_route(net.static)
    _, out = run_batch(net.static, net.params, net.state0, 120, 3, record="monitors")
    keys = rng.split(net.state0.key, 3)
    assert out["telemetry"]["vprobe"].shape == (3, 120, 3)
    assert out["telemetry"]["weight_norm"].shape == (3, 3, len(net.static.projections))
    for b in range(3):
        _, solo = run(net.static, net.params, net.state0._replace(key=keys[b]), 120,
                      record="monitors")
        for name, got in out["telemetry"].items():
            assert torch.equal(got[b], solo["telemetry"][name]), (b, name)

