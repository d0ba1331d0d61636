"""Plastic, STP, DA-STDP, homeostasis and fused nets over lanes, on the CPU.

The batched lane route (``engine.batched_route``) covers every IZH4-only
Euler net on the default or fused backend: one launch per kernel per tick
for every lane (``StdpUpdateRun``, ``StdpGatherRun``, ``DriveRun``,
``NeuronRun`` with per-lane spike counts and ``FusedTickRun`` over lanes),
each lane bit for bit its one-lane run. The lane launchers' plain versions
are loops of the one-lane plain versions; here they are held against
one-lane launchers lane by lane on random off-grid weights, lanes at
different ticks and a third of them silent. ``run_batch`` is held against
the reference's vmapped ``run_batch``, compiled at
``xla_backend_optimization_level=0`` (its default jit contracts the STDP
trace step's mul+add, ROADMAP queue C): rasters, ring, weights, traces,
``homeo``, STP ``u``/``x`` and DA eligibilities bit for bit, fp32 ``v``
and ``u`` at rtol 1e-5, atol 1e-4; and each lane against its solo ``run``
bit for bit. The plastic drive's row sums take XLA CPU's order
(``ref.xla_cpu_row_sum``), which the CUDA drive kernel streams one
product at a time: its streaming order is mirrored here in numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import synfire4 as rsyn  # noqa: E402
from repro.core import NetworkBuilder as RBuilder, izh4 as rizh4  # noqa: E402
from repro.core import plasticity as rpl  # noqa: E402
from repro.core import synapses as rsynapses  # noqa: E402
from repro.core.engine import run_batch as ref_run_batch  # noqa: E402
from repro_torch.configs import synfire4 as tsyn  # noqa: E402
from repro_torch.core import (NetworkBuilder, izh4, lane_state, rng, run,  # noqa: E402
                              run_batch, stack_states)
from repro_torch.core import backend as be  # noqa: E402
from repro_torch.core import plasticity as tpl  # noqa: E402
from repro_torch.core import synapses as tsynapses  # noqa: E402
from repro_torch.core.engine import batched_route  # noqa: E402
from repro_torch.core.neurons import NeuronModel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.fused_tick import assemble_kernel  # noqa: E402
from repro_torch.kernels.plastic_drive import DriveProjection, xla_levels  # noqa: E402
from repro_torch.kernels.stdp_update import DenseProjection  # noqa: E402
from repro_torch.serve import LaneScheduler, Session  # noqa: E402

TICKS = 120
LANES = 3
OPT0 = {"xla_backend_optimization_level": 0}
HOMEO = dict(target_hz=10.0, tau_avg_ms=1000.0, beta=2.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def key_words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).view(np.int32)


# -- the nets, in both packages --------------------------------------------------


def synfire(ref_pkg: bool, policy="fp16", propagation="sparse", homeo=False, **kw):
    """Plastic Synfire4-mini (``CHAIN_STDP``), with homeostasis on the chain
    every 40 ticks where ``homeo``."""
    syn = rsyn if ref_pkg else tsyn
    kw["stdp_chain"] = syn.CHAIN_STDP
    if homeo:
        kw.update(homeo_chain=(rpl if ref_pkg else tpl).HomeostasisConfig(**HOMEO),
                  homeostasis_period=40)
    kw.update(monitors=None) if ref_pkg else kw.update(device="cpu")
    return syn.build_synfire(syn.SYNFIRE4_MINI, policy=policy, propagation=propagation, **kw)


def da_net(ref_pkg: bool, propagation):
    """``tests/test_torch_plastic_engine.py``'s DA-STDP net."""
    builder, lib_izh4, lib_pl = ((RBuilder, rizh4, rpl) if ref_pkg
                                 else (NetworkBuilder, izh4, tpl))
    net = builder(seed=5)
    net.add_spike_generator("pre", 30, rate_hz=80.0)
    net.add_group("post", lib_izh4(10, a=0.02, b=0.2, c=-65.0, d=8.0))
    net.connect("pre", "post", fanin=15, weight=3.0, delay_ms=1,
                stdp=lib_pl.STDPConfig(a_plus=0.01, a_minus=0.002, w_max=6.0, tau_elig=200.0),
                da_modulated=True)
    return net.compile(policy="fp16", propagation=propagation,
                       **(dict(monitors=None) if ref_pkg else dict(device="cpu")))


def stp_net(ref_pkg: bool, propagation):
    """``tests/test_torch_plastic_engine.py``'s STP net."""
    builder, lib_izh4, lib_syn = ((RBuilder, rizh4, rsynapses) if ref_pkg
                                  else (NetworkBuilder, izh4, tsynapses))
    net = builder(seed=0)
    net.add_spike_generator("g", 50, rate_hz=200.0)
    net.add_group("n", lib_izh4(20, a=0.02, b=0.2, c=-65.0, d=8.0))
    net.connect("g", "n", fanin=20, weight=0.3, delay_ms=1,
                stp=lib_syn.STPConfig(u0=0.45, tau_f=50.0, tau_d=750.0))
    return net.compile(policy="fp16", propagation=propagation,
                       **(dict(monitors=None) if ref_pkg else dict(device="cpu")))


def ref_batch(rnet, n, b):
    compiled = ref_run_batch.lower(rnet.static, rnet.params, rnet.state0, n, b).compile(
        compiler_options=OPT0)
    return compiled(rnet.params, rnet.state0)


def leaves(state):
    """(name, numpy) for the synaptic leaves of a batched state of either
    package: weights, STP u/x, traces and eligibilities, homeostasis
    rates."""
    out = [(f"weights.{j}", np.asarray(w, np.float32)) for j, w in enumerate(state.weights)]
    for field in ("stp", "stdp"):
        for j, s in enumerate(getattr(state, field)):
            if s is not None:
                out += [(f"{field}.{j}.{f}", np.asarray(getattr(s, f), np.float32))
                        for f in s._fields]
    out += [(f"homeo.{j}", np.asarray(h)) for j, h in enumerate(state.homeo) if h is not None]
    return out


def as_np(state):
    def conv(x):
        if isinstance(x, torch.Tensor):
            return x.float().numpy()
        if x is None:
            return None
        return type(x)(*(conv(y) for y in x)) if hasattr(x, "_fields") else tuple(
            conv(y) for y in x)

    return state._replace(weights=conv(state.weights), stp=conv(state.stp),
                          stdp=conv(state.stdp), homeo=conv(state.homeo))


def assert_matches_reference(rnet, tnet, policy="fp16"):
    """``run_batch(TICKS, LANES)`` of both packages: bit for bit but for
    fp32 ``v``/``u``; and every lane its solo run."""
    assert batched_route(tnet.static)
    rfinal, rout = ref_batch(rnet, TICKS, LANES)
    tfinal, tout = run_batch(tnet.static, tnet.params, tnet.state0, TICKS, LANES)
    np.testing.assert_array_equal(tout["spikes"].numpy(), np.asarray(rout["spikes"]))
    assert tfinal.t == tuple(int(x) for x in np.asarray(rfinal.t))
    np.testing.assert_array_equal(tfinal.key.numpy(), key_words(rfinal.key))
    np.testing.assert_array_equal(tfinal.ring.float().numpy(),
                                  np.asarray(rfinal.ring, np.float32))
    for f in ("v", "u"):
        got = getattr(tfinal.neurons, f).float().numpy()
        want = np.asarray(getattr(rfinal.neurons, f), np.float32)
        if policy == "fp16":
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4, err_msg=f)
    tl, rl = leaves(as_np(tfinal)), leaves(rfinal)
    assert [n for n, _ in tl] == [n for n, _ in rl]
    for (name, x), (_, y) in zip(tl, rl):
        np.testing.assert_array_equal(x, y, err_msg=name)
    keys = rng.split(tnet.state0.key, LANES)
    for b in range(LANES):
        solo, out = run(tnet.static, tnet.params, tnet.state0._replace(key=keys[b]), TICKS)
        assert torch.equal(out["spikes"], tout["spikes"][b]), b
        lane = lane_state(tfinal, b)
        assert torch.equal(solo.ring, lane.ring) and torch.equal(solo.neurons.v, lane.neurons.v)
        for (name, x), (_, y) in zip(leaves(as_np(solo)), leaves(as_np(lane))):
            np.testing.assert_array_equal(x, y, err_msg=f"lane {b} {name}")
    assert int(tout["spikes"].sum()) > 0
    return tfinal


# -- run_batch against the reference ----------------------------------------------


@pytest.mark.parametrize("policy", ["fp16", "fp32"])
@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_plastic_run_batch_matches_reference(policy, propagation):
    tnet = synfire(False, policy, propagation)
    tfinal = assert_matches_reference(synfire(True, policy, propagation), tnet, policy)
    j = next(j for j, s in enumerate(tnet.static.projections) if s.plastic)
    assert not torch.equal(tfinal.weights[j][0], tfinal.weights[j][1])


@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_homeostasis_run_batch_matches_reference(propagation):
    """Homeostasis every 40 ticks over three segments: the rates and the
    scaled weights of every lane."""
    tfinal = assert_matches_reference(synfire(True, propagation=propagation, homeo=True),
                                      synfire(False, propagation=propagation, homeo=True))
    assert any(h is not None and bool((h > 0).any()) for h in tfinal.homeo)


@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_da_stdp_run_batch_matches_reference(propagation):
    """DA-STDP with no dopamine (``run_batch`` passes none): traces and
    eligibilities move, weights hold."""
    tfinal = assert_matches_reference(da_net(True, propagation), da_net(False, propagation))
    assert bool(tfinal.stdp[0].elig.ne(0).any())


@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_stp_run_batch_matches_reference(propagation):
    tfinal = assert_matches_reference(stp_net(True, propagation), stp_net(False, propagation))
    assert not torch.equal(tfinal.stp[0].u[0], tfinal.stp[0].u[1])


@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_fused_run_batch_matches_reference(propagation):
    """Fused Synfire4-mini (the ``fused_tick`` plan): its lanes equal the
    reference's default-backend batch (the reference's fused kernel does
    not trace on this JAX) and each lane its solo fused run."""
    rnet = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, policy="fp16", propagation=propagation,
                              monitors=None)
    tnet = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16", propagation=propagation,
                              device="cpu", backend="fused")
    assert tnet.static.fused_kernel
    assert_matches_reference(rnet, tnet)


def test_plastic_fused_nets_take_the_default_tick_over_lanes():
    """A plastic net on ``backend="fused"`` (no ``fused_tick`` plan) ticks
    its lanes as the default backend does."""
    net = synfire(False, backend="fused")
    base = synfire(False)
    assert not net.static.fused_kernel and batched_route(net.static)
    final, out = run_batch(net.static, net.params, net.state0, 80, LANES)
    want_final, want = run_batch(base.static, base.params, base.state0, 80, LANES)
    assert torch.equal(out["spikes"], want["spikes"])
    for (name, x), (_, y) in zip(leaves(as_np(final)), leaves(as_np(want_final))):
        np.testing.assert_array_equal(x, y, err_msg=name)


# -- the lane launchers against one-lane launchers --------------------------------


def _spike_rows(g, lanes, n):
    """Random 0/1 f32 spike rows, a third of the lanes silent."""
    s = (torch.rand((lanes, n), generator=g) < 0.3).float()
    s[2::3] = 0.0
    return s


def _traces(g, lanes, p, q):
    return [(torch.rand((lanes, x), generator=g) * 2, torch.empty((lanes, x)))
            for x in (p, q)]


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_stdp_update_run_lanes_equal_one_lane_runs(dtype):
    """``StdpUpdateRun`` over 6 lanes, two projections (one on zero-ended
    buffers), random off-grid weights: each lane bit for bit its one-lane
    launcher over 5 ticks, weights and both trace buffers."""
    g = torch.Generator().manual_seed(11)
    lanes, n = 6, 90
    shapes = ((0, 30, 20, 25), (40, 10, 37, 11))  # pre start, P, post start, Q
    projs, solos = [], [[] for _ in range(lanes)]
    for k, (ps, p, qs, q) in enumerate(shapes):
        mask = torch.rand((p, q), generator=g) < 0.6
        w = torch.where(mask, torch.rand((lanes, p, q), generator=g) * 4, 0.0).to(dtype)
        pre, post = _traces(g, lanes, p, q)
        kw = dict(mask=mask, pre_start=ps, post_start=qs, a_plus=0.01, a_minus=0.012,
                  w_min=0.0, w_max=3.5, decay_pre=0.95, decay_post=0.9)
        padded = None
        if k == 0:
            padded = w.new_zeros((lanes, p * q + 1))
            padded[:, :-1].copy_(w.reshape(lanes, -1))
            w = padded[:, :-1].view(lanes, p, q)
        projs.append(DenseProjection(w=w, pre_tr=pre, post_tr=post, padded=padded, **kw))
        for b in range(lanes):
            solos[b].append(DenseProjection(
                w=w[b].clone(), pre_tr=tuple(t[b].clone() for t in pre),
                post_tr=tuple(t[b].clone() for t in post), **kw))
    runs = ops.StdpUpdateRun(n, projs, lanes=lanes)
    ones = [ops.StdpUpdateRun(n, s) for s in solos]
    for _ in range(5):
        spikes = _spike_rows(g, lanes, n)
        runs(spikes)
        for b, one in enumerate(ones):
            one(spikes[b])
    for b, one in enumerate(ones):
        for k in range(len(shapes)):
            assert torch.equal(one.projs[k].w, runs.projs[k].w[b]), (b, k)
            for x, y in zip(one.traces(k), runs.traces(k)):
                assert torch.equal(x, y[b]), (b, k)
    assert float(projs[0].padded[:, -1].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="padded"):
        ops.StdpUpdateRun(n, [projs[0]._replace(padded=projs[0].padded[:, 1:])], lanes=lanes)


def test_stdp_gather_run_lanes_equal_one_lane_runs():
    """``StdpGatherRun`` over 5 lanes on the plastic mini's compiled CSR
    chain tables, random off-grid fp16 weights: each lane bit for bit its
    one-lane launcher over 5 ticks."""
    net = synfire(False)
    g = torch.Generator().manual_seed(12)
    lanes = 5
    weights = tuple(torch.where(net.params.masks[j],
                                torch.rand((lanes, *w.shape), generator=g) * 4, 0.0).to(w.dtype)
                    if j in net.static.plastic_csr else w for j, w in
                    enumerate(net.state0.weights))
    stdp = tuple(None if s is None else type(s)(*(torch.rand((lanes, *x.shape), generator=g)
                                                  for x in s)) for s in net.state0.stdp)
    runs = be.assemble_stdp_gather(net.static, net.params, weights, stdp, lanes)
    assert len(runs.keys) == len(net.static.plastic_csr) > 0
    ones = [be.assemble_stdp_gather(net.static, net.params,
                                    tuple(w[b] if w.dim() == 3 else w for w in weights),
                                    tuple(None if s is None else type(s)(*(x[b] for x in s))
                                          for s in stdp)) for b in range(lanes)]
    for _ in range(5):
        spikes = _spike_rows(g, lanes, net.static.n)
        runs(spikes)
        for b, one in enumerate(ones):
            one(spikes[b])
    for b, one in enumerate(ones):
        for k in range(len(runs.keys)):
            assert torch.equal(one.projs[k].w, runs.projs[k].w[b]), (b, k)
            for x, y in zip(one.traces(k), runs.traces(k)):
                assert torch.equal(x, y[b]), (b, k)


def _drive_case(net, g, lanes):
    """A DriveRun over ``lanes`` on ``net``'s plastic and STP projections,
    random off-grid weights and STP state, landing in zeroed accumulators
    ``[B, N]``; with the same for each lane alone."""
    fanin = be.assemble_fanin(net.static, net.params)
    keys = [j for j, s in enumerate(net.static.projections) if s.plastic or s.stp is not None]
    acc = torch.rand((lanes, net.static.n), generator=g)
    one_acc = acc.clone()
    projs, ones, weights, stp = [], [[] for _ in range(lanes)], [], []
    for j in keys:
        spec, fr = net.static.projections[j], fanin[j]
        w0 = net.state0.weights[j]
        w = (torch.rand((lanes, *w0.shape), generator=g) * 3).to(w0.dtype)
        weights.append(w)
        st = None
        if spec.stp is not None:
            u0 = net.state0.stp[j].u
            st = ((torch.rand((lanes, *u0.shape), generator=g)).to(u0.dtype),
                  (torch.rand((lanes, *u0.shape), generator=g)).to(u0.dtype))
        stp.append(st)
        kw = dict(pre=fr.pre, rows=fr.rows, w_dtype=w0.dtype,
                  sentinel=spec.pre_size * spec.post_size if fr.rows is not None else -1,
                  stp=spec.stp is not None, pre_start=spec.pre_start, n_pre=spec.pre_size,
                  stp_dtype=st[0].dtype if st else torch.float32)
        cols = slice(spec.post_start, spec.post_start + spec.post_size)
        projs.append(DriveProjection(out=acc[:, cols], **kw))
        for b in range(lanes):
            ones[b].append(DriveProjection(out=one_acc[b, cols], **kw))
    return keys, acc, one_acc, projs, ones, weights, stp


@pytest.mark.parametrize("net_name", ["packed", "sparse", "stp"])
def test_drive_run_lanes_equal_one_lane_runs(net_name):
    """``DriveRun`` over 5 lanes (the plastic mini's dense or CSR chain, or
    the STP net; two projections landing on one column add in projection
    order): each lane's accumulator entries bit for bit its one-lane
    launcher's, and the plain drive is ``ref.plastic_drive_ref`` with its
    ``xla_cpu_row_sum``."""
    net = stp_net(False, "sparse") if net_name == "stp" else synfire(False,
                                                                      propagation=net_name)
    g = torch.Generator().manual_seed(13)
    lanes = 5
    keys, acc, one_acc, projs, ones, weights, stp = _drive_case(net, g, lanes)
    before = acc.clone()
    spikes = _spike_rows(g, lanes, net.static.n)
    ops.DriveRun(net.static.n, projs, lanes=lanes)(spikes, weights, stp)
    for b in range(lanes):
        ops.DriveRun(net.static.n, ones[b])(spikes[b], [w[b] for w in weights],
                                            [None if s is None else (s[0][b], s[1][b])
                                             for s in stp])
    assert torch.equal(acc, one_acc)
    assert not torch.equal(acc, before)
    # The first projection by hand: gather, product, XLA-ordered row sum.
    p, w = projs[0], weights[0]
    pre_row = torch.nn.functional.pad(spikes, (0, 1))
    if p.stp:
        pre_row = spikes[:, p.pre_start:p.pre_start + p.n_pre] * (stp[0][0] * stp[0][1])
    d = ref.plastic_drive_ref(w, p.pre, p.rows, pre_row, p.sentinel)
    assert d.shape == (lanes, p.pre.shape[0])
    cols = slice(net.static.projections[keys[0]].post_start,
                 net.static.projections[keys[0]].post_start + p.pre.shape[0])
    if len(keys) == 1:
        assert torch.equal(acc[:, cols], before[:, cols] + d)


def test_drive_run_lands_overlapping_projections_in_order_and_coba():
    """Two projections onto the same columns: the second adds after the
    first, lane by lane; with ``coba`` each lands its absolute value."""
    g = torch.Generator().manual_seed(14)
    lanes, n, q, f = 4, 40, 6, 37
    pre = torch.randint(0, n + 1, (q, f), generator=g)
    for coba in (False, True):
        acc = torch.zeros((lanes, n))
        projs = [DriveProjection(pre=pre, rows=None, out=acc[:, 3:3 + q],
                                 w_dtype=torch.float32) for _ in range(2)]
        w = [torch.randn((lanes, q, f), generator=g) for _ in range(2)]
        spikes = _spike_rows(g, lanes, n)
        ops.DriveRun(n, projs, lanes=lanes, coba=coba)(spikes, w, [None, None])
        ext = torch.nn.functional.pad(spikes, (0, 1))
        want = torch.zeros((lanes, q))
        for wk in w:
            d = ref.xla_cpu_row_sum(ext[:, pre] * wk)
            want = want + (d.abs() if coba else d)
        assert torch.equal(acc[:, 3:3 + q], want)


def test_neuron_run_lane_counts_equal_one_lane_counts():
    """``NeuronRun`` over 6 lanes at their own ticks counts each lane's
    spikes as the one-lane launcher counts them."""
    net = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16", propagation="sparse",
                             device="cpu")
    g = torch.Generator().manual_seed(15)
    states = [run(net.static, net.params, net.state0, int(t),
                  gen_u=torch.rand((int(t), net.static.n_gen), generator=g))[0]
              for t in (3, 9, 14, 20, 27, 33)]
    st = stack_states(states)
    gen = torch.rand((6, 30, net.static.n_gen), generator=g) < 0.3
    gen[2::3] = False
    counts = torch.zeros((6, net.static.n), dtype=torch.int32)
    ring = st.ring.clone()
    lanes = be.assemble_neurons(net.static, net.params, st.neurons, ring, gen_spk=gen,
                                counts=counts, t0=st.t)
    for i in range(30):
        lanes(i)
    for b in range(6):
        one = torch.zeros((net.static.n,), dtype=torch.int32)
        solo = be.assemble_neurons(net.static, net.params, states[b].neurons,
                                   states[b].ring.clone(), gen_spk=gen[b], counts=one)
        for i in range(30):
            solo(i, st.t[b] + i)
        assert torch.equal(one, counts[b]), b
    assert int(counts.sum()) > 0
    with pytest.raises(ValueError, match="counts"):
        be.assemble_neurons(net.static, net.params, st.neurons, ring, counts=counts[0],
                            t0=st.t)


@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "per-lane"])
@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_fused_tick_run_lanes_equal_one_lane_runs(propagation, per_lane):
    """``FusedTickRun`` over 6 lanes at their own ticks (random v, u, ring
    and generator rows, a third of the lanes silent), weights shared or
    each lane's own (random off-grid): each lane bit for bit its one-lane
    launcher over 12 ticks, v and i_syn rows included."""
    net = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16", propagation=propagation,
                             device="cpu", backend="fused")
    g = torch.Generator().manual_seed(16)
    lanes, ticks, n = 6, 12, net.static.n
    packed = be.assemble_packed(net.static, net.state0.weights)
    if per_lane:
        packed = tuple(torch.randn((lanes, *w.shape), generator=g) * 3 for w in packed)
    payload = assemble_kernel(net.static, net.params, packed)
    dtype = net.state0.neurons.v.dtype
    v = (torch.rand((lanes, n), generator=g) * 100 - 75).to(dtype)
    u = (torch.rand((lanes, n), generator=g) * 10 - 15).to(dtype)
    ring = (torch.rand((lanes, net.static.ring_len, n), generator=g) * 10).to(dtype)
    rows = torch.rand((lanes, ticks, n), generator=g) < 0.2
    rows[2::3] = False
    t0 = tuple(5 + 7 * b for b in range(lanes))
    p = net.params.neuron
    is_gen = p.model == NeuronModel.GENERATOR
    vs, cur = torch.zeros((lanes, ticks, n)), torch.zeros((lanes, ticks, n))
    lv, lu, lring, lrows = v.clone(), u.clone(), ring.clone(), rows.clone()
    runs = ops.FusedTickRun(payload, lv, lu, lring, is_gen, p.a, p.b, p.c, p.d, lrows, vs,
                            cur, t0=t0)
    for i in range(ticks):
        runs.tick(i)
    for b in range(lanes):
        one = payload if not per_lane else assemble_kernel(net.static, net.params,
                                                           tuple(w[b] for w in packed))
        ov, ou, oring, orows = v[b].clone(), u[b].clone(), ring[b].clone(), rows[b].clone()
        ovs, ocur = torch.zeros((ticks, n)), torch.zeros((ticks, n))
        solo = ops.FusedTickRun(one, ov, ou, oring, is_gen, p.a, p.b, p.c, p.d, orows, ovs,
                                ocur)
        for i in range(ticks):
            solo.tick(i, t0[b] + i)
        for x, y in ((ov, lv[b]), (ou, lu[b]), (oring, lring[b]), (orows, lrows[b]),
                     (ovs, vs[b]), (ocur, cur[b])):
            assert torch.equal(x, y), b
    assert int(lrows[:, :, ~is_gen].sum()) > 0


# -- the drive's sum order ---------------------------------------------------------


def _chain(xs, lo: int, hi: int) -> np.float32:
    """``xs[lo:hi]`` summed left to right from +0.0 in f32."""
    s = np.float32(0.0)
    with np.errstate(invalid="ignore"):  # inf + -inf: NaN, as on the devices
        for i in range(lo, hi):
            s = np.float32(s + xs[i])
    return s


def _warp_sum(row: np.ndarray) -> np.float32:
    """The CUDA drive kernel's row sum (``csrc/plastic_drive.cu``,
    ``Row::sum``), step for step in numpy f32: level-0 windows of 32 (slots
    outside the row +0.0) each summed on its own from +0.0, up to 32 of
    them side by side, one level-1 window at a time; the window sums
    reduced in order over their slots in range; deeper levels carried one
    partial window each and summed when full or at the level's last
    item."""
    f = len(row)
    offs = xla_levels(f)
    levels = len(offs)
    n1 = -(-f // 32)
    o0 = offs[0] if levels else 0
    o1 = offs[1] if levels > 1 else 0
    n2 = -(-n1 // 32) if levels > 1 else 1
    carry = {i: [np.float32(0.0)] * 32 for i in range(2, levels + 1)}
    total = np.float32(0.0)
    for v in range(n2):
        wb = 32 * v - o1
        lo, hi = max(wb, 0), min(wb + 32, n1)
        sums = [np.float32(0.0)] * 32
        for w in range(lo, hi):
            ks = [32 * w + lane - o0 for lane in range(32)]
            sums[w - wb] = _chain([row[k] if 0 <= k < f else np.float32(0.0) for k in ks],
                                  0, 32)
        up = _chain(sums, lo - wb, hi - wb)
        if levels <= 1:
            return up
        at, items = v, n2
        for i in range(2, levels + 1):
            pos = at + (offs[i] if i < levels else 0)
            slot = pos % 32
            carry[i][slot] = up
            if slot != 31 and at != items - 1:
                break
            up = _chain(carry[i], 0, slot + 1)
            carry[i] = [np.float32(0.0)] * 32
            if i == levels:
                total = up
            at, items = pos // 32, -(-items // 32)
    return total


def _same_bits(got: np.ndarray, want: np.ndarray) -> None:
    """NaN at the same places, and equal f32 bits everywhere else."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.int32), want[ok].view(np.int32))


def _order_rows(g: torch.Generator, f: int) -> torch.Tensor:
    """``[2, 3, F]`` f32 rows whose sums depend on the order: magnitudes
    from 1e-6 to 1e6 of both signs, -0.0 and subnormal entries in every
    row; row [1, 0] holds a +inf, row [1, 1] a +inf and a -inf (NaN; at F
    = 1 a NaN), row [1, 2] a NaN."""
    x = torch.randn((2, 3, f), generator=g) * 10.0 ** (torch.rand((2, 3, f), generator=g) * 12
                                                       - 6)
    pick = torch.rand((2, 3, f), generator=g)
    x = torch.where(pick < 0.1, torch.tensor(-0.0), x)
    x = torch.where((pick >= 0.1) & (pick < 0.15), torch.tensor(-3e-40), x)
    x = torch.where((pick >= 0.15) & (pick < 0.2), torch.tensor(1e-42), x)
    x[1, 0, f // 2] = float("inf")
    x[1, 1, 0] = float("inf")
    x[1, 1, f - 1] = float("-inf") if f > 1 else float("nan")
    x[1, 2, (2 * f) // 3] = float("nan")
    return x


@pytest.mark.parametrize("f", [1, 7, 20, 31, 32, 33, 60, 64, 65, 80, 96, 97, 1024, 1025, 1100,
                               33000])
def test_xla_cpu_row_sum_over_leading_dims(f):
    """``xla_cpu_row_sum`` on ``[2, 3, F]``: each row as its one-row call,
    and the drive kernel's warp schedule gives the same f32 sums, bit for
    bit (F below, at and just above a window, the plastic chain's 60 to 96,
    and past 1,024, where the windows nest two and three levels deep), on
    rows whose sum depends on the order, with -0.0, subnormal, infinite
    and NaN entries."""
    g = torch.Generator().manual_seed(f)
    x = _order_rows(g, f)
    got = ref.xla_cpu_row_sum(x)
    assert got.shape == (2, 3)
    for a in range(2):
        for q in range(3):
            _same_bits(ref.xla_cpu_row_sum(x[a, q][None]).numpy(), got[a, q][None].numpy())
    rows = x.reshape(-1, f).numpy()
    want = got.reshape(-1).numpy()
    _same_bits(np.array([_warp_sum(r) for r in rows], np.float32), want)
    assert np.isinf(want[3]) and np.isnan(want[4]) and np.isnan(want[5])
    assert np.isfinite(want[:3]).all() and (want[:3] != 0).all()
    if f >= 60:  # the order matters: a plain left-to-right sum differs on some row
        assert any(_chain(r, 0, f) != w for r, w in zip(rows[:3], want[:3]))
    assert be.xla_cpu_row_sum is ref.xla_cpu_row_sum


# -- the scheduler -------------------------------------------------------------------


def _solo(net, key, ticks, state=None):
    sess = Session.create(net, key=key, state=state)
    for _ in range(ticks // 40):
        sess.run(40, record="none")
    return sess.state


@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_scheduler_plastic_tenants_equal_solo_sessions(propagation):
    """Plastic tenants with homeostasis every 40 ticks in a 4-lane
    scheduler: one admitted with weights of its own, one admitted later,
    one exported into a second scheduler after two chunks; every tenant,
    at the end, equals a solo session over its key and ticks (weights,
    traces, rates, ring and neurons)."""
    net = synfire(False, propagation=propagation, homeo=True)
    assert batched_route(net.static)
    j = net.static.projections.index(next(s for s in net.static.projections if s.plastic))
    own = net.state0._replace(weights=tuple(
        (w.float() * 0.75).to(w.dtype) if k == j else w
        for k, w in enumerate(net.state0.weights)))
    big = LaneScheduler(net, 4, record="none")
    small = LaneScheduler(net, 2, record="none", ledger_key="small")
    big.admit("a", key=rng.key(1))
    big.admit("own", key=rng.key(2), state=own)
    big.step(40)
    big.admit("late", key=rng.key(3))
    big.step(40)
    small.restore(big.export("a"))
    big.step(40)
    small.step(40)
    want = {"a": _solo(net, rng.key(1), 120), "own": _solo(net, rng.key(2), 120, own),
            "late": _solo(net, rng.key(3), 80)}
    got = {"a": lane_state(small.states, small.lane_of("a")),
           "own": lane_state(big.states, big.lane_of("own")),
           "late": lane_state(big.states, big.lane_of("late"))}
    for sid in want:
        assert got[sid].t == want[sid].t, sid
        assert torch.equal(got[sid].ring, want[sid].ring), sid
        assert torch.equal(got[sid].neurons.v, want[sid].neurons.v), sid
        for (name, x), (_, y) in zip(leaves(as_np(got[sid])), leaves(as_np(want[sid]))):
            np.testing.assert_array_equal(x, y, err_msg=f"{sid} {name}")
    assert not torch.equal(got["own"].weights[j], got["late"].weights[j])


def test_drive_run_checks_its_projections():
    """``DriveRun`` refuses mismatched tables, landing entries of the wrong
    shape or dtype, a dense projection without its sentinel, and tensors
    on different devices."""
    pre = torch.zeros((4, 3), dtype=torch.int64)
    acc = torch.zeros((2, 10))
    ok = dict(pre=pre, rows=None, out=acc[:, :4], w_dtype=torch.float32)
    ops.DriveRun(10, [DriveProjection(**ok)], lanes=2)
    for bad, match in (
            (dict(rows=torch.zeros((4, 2), dtype=torch.int64)), "one \\[Q, F\\]"),
            (dict(out=acc[:, :3]), "out"), (dict(out=acc.double()[:, :4]), "out"),
            (dict(rows=pre, sentinel=-1), "sentinel"), (dict(w_dtype=torch.float64), "dtype"),
            (dict(pre=pre.to("meta")), "different devices")):
        with pytest.raises(ValueError, match=match):
            ops.DriveRun(10, [DriveProjection(**{**ok, **bad})], lanes=2)
