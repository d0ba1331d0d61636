"""The port's core-grid partitioner (``repro_torch.core.partition``) held
against the reference's ``repro.core.partition`` on the CPU.

A partitioned run must equal the reference's *unpartitioned* run bit for
bit, raster and every state leaf, as ``tests/test_partition.py`` holds the
reference to its own engine: fp16 against the reference's jitted run, fp32
against the reference evaluated op by op (``jax.disable_jit()``; its
jitted run contracts mul+adds into FMAs, ROADMAP queue C). The port's plan
must be the reference's plan: the same ``(lo, hi)`` per core, the same
verified bytes per core, the same exchange edges and bytes per tick.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import synfire4 as rsyn  # noqa: E402
from repro.core import partition as rpart  # noqa: E402
from repro.core.engine import Engine as REngine  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import synfire4 as tsyn  # noqa: E402
from repro_torch.core import partition as tpart  # noqa: E402
from repro_torch.core.distributed import core_mesh  # noqa: E402
from repro_torch.core.engine import Engine  # noqa: E402
from repro_torch.memory import MCU_BUDGET_BYTES, MemoryLedger  # noqa: E402
from repro_torch.obs.health import health_snapshot  # noqa: E402

T = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _kw_pair(kw):
    """The same Synfire keywords for the reference and the port."""
    rkw, tkw = dict(kw), dict(kw, device="cpu")
    if "stdp_chain" in kw:
        rkw["stdp_chain"], tkw["stdp_chain"] = rsyn.CHAIN_STDP, tsyn.CHAIN_STDP
    if tkw.get("backend") == "xla":
        tkw.pop("backend")
    return rkw, tkw


def _ref_unpartitioned(cfg, kw, n_steps):
    """The reference's unpartitioned run: jitted for fp16, op by op for
    fp32 (its jit contracts mul+adds, ROADMAP queue C)."""
    net = rsyn.build_synfire(getattr(rsyn, cfg), **kw)
    if kw["policy"] == "fp32":
        with jax.disable_jit():
            return REngine(net).run(n_steps)
    return REngine(net).run(n_steps)


def _key_words(k):
    return np.asarray(jax.random.key_data(k)).view(np.int32)


def _assert_vs_reference(tfinal, tout, rfinal, rout, what):
    np.testing.assert_array_equal(tout["spikes"].numpy(), np.asarray(rout["spikes"]),
                                  err_msg=f"{what}: raster")
    assert tfinal.t == int(rfinal.t)
    np.testing.assert_array_equal(tfinal.key.numpy(), _key_words(rfinal.key))
    pairs = [("ring", tfinal.ring, rfinal.ring)]
    pairs += [(f"neurons.{f}", getattr(tfinal.neurons, f), getattr(rfinal.neurons, f))
              for f in tfinal.neurons._fields]
    pairs += [(f"weights.{j}", a, b) for j, (a, b) in enumerate(zip(tfinal.weights,
                                                                   rfinal.weights))]
    for j, (a, b) in enumerate(zip(tfinal.stdp, rfinal.stdp)):
        assert (a is None) == (b is None)
        if a is not None:
            pairs += [(f"stdp.{j}.{k}", x, y) for k, (x, y) in enumerate(zip(a, b))]
    for name, a, b in pairs:
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and a.numpy().tobytes() == b.tobytes(), \
            f"{what}: {name} differs"


def _leaves(state):
    out = [state.key, state.ring, *state.neurons, *state.weights]
    for tr in state.stdp:
        if tr is not None:
            out += list(tr)
    return out


def _assert_port_equal(s0, o0, s1, o1, what):
    assert s0.t == s1.t
    if "spikes" in o0:
        assert torch.equal(o0["spikes"], o1["spikes"]), f"{what}: raster"
    for i, (a, b) in enumerate(zip(_leaves(s0), _leaves(s1))):
        assert a.dtype == b.dtype and torch.equal(a, b), f"{what}: leaf {i} differs"


class TestSequentialParity:
    """Partitioned port == unpartitioned reference, bit for bit (the
    reference's three fast cells, its plastic cut and its one-core
    identity)."""

    @pytest.mark.parametrize("kw", [
        dict(policy="fp32", propagation="packed"),
        dict(policy="fp16", propagation="auto"),
        dict(policy="fp32", propagation="packed", backend="fused"),
    ], ids=["packed-xla-fp32", "auto-xla-fp16", "packed-fused-fp32"])
    def test_two_core_parity(self, kw):
        rkw, tkw = _kw_pair(kw)
        rfinal, rout = _ref_unpartitioned("SYNFIRE4", rkw, T)
        net = tsyn.build_synfire(tsyn.SYNFIRE4, partition=tpart.PartitionSpec(n_cores=2),
                                 **tkw)
        assert net.partition.n_cores == 2
        assert all(not cp.static.fused_kernel and cp.static.backend is None
                   for cp in net.partition.cores)
        tfinal, tout = Engine(net).run(T)
        _assert_vs_reference(tfinal, tout, rfinal, rout, str(kw))

    def test_plastic_two_core_parity(self):
        """Plastic weights evolve on their owner core and reassemble to the
        reference's unpartitioned trajectory; the cut keeps the STDP
        cluster whole, leaving a 50-neuron core."""
        rkw, tkw = _kw_pair(dict(policy="fp32", propagation="sparse", stdp_chain=True))
        rfinal, rout = _ref_unpartitioned("SYNFIRE4", rkw, T)
        net = tsyn.build_synfire(tsyn.SYNFIRE4, partition=tpart.PartitionSpec(n_cores=2),
                                 **tkw)
        assert [(c.lo, c.hi) for c in net.partition.cores] == [(0, 1150), (1150, 1200)]
        tfinal, tout = Engine(net).run(T)
        _assert_vs_reference(tfinal, tout, rfinal, rout, "plastic")

    def test_one_core_identity(self):
        rkw, tkw = _kw_pair(dict(policy="fp32", propagation="sparse"))
        rfinal, rout = _ref_unpartitioned("SYNFIRE4", rkw, T)
        net = tsyn.build_synfire(tsyn.SYNFIRE4, partition=tpart.PartitionSpec(n_cores=1),
                                 **tkw)
        plan = net.partition
        assert plan.n_cores == 1 and (plan.cores[0].lo, plan.cores[0].hi) == (0, 1200)
        assert plan.exchange.edges == () and plan.exchange.bytes_per_tick == 0
        tfinal, tout = Engine(net).run(T)
        _assert_vs_reference(tfinal, tout, rfinal, rout, "one core")

    @pytest.mark.parametrize("kw", [
        dict(policy="fp16", propagation="sparse"),
        dict(policy="fp16", propagation="packed", stdp_chain=True),
        dict(policy="fp32", propagation="auto", backend="fused"),
    ], ids=["sparse-fp16", "plastic-packed-fp16", "auto-fused-fp32"])
    def test_budget_cut_matches_unpartitioned_port(self, kw):
        """Budget cuts (300,000 B static, 1,000,000 B plastic), state
        carried across two runs: the partitioned port equals the
        unpartitioned port, every leaf."""
        _, tkw = _kw_pair(kw)
        budget = 1_000_000 if "stdp_chain" in kw else 300_000
        base = tsyn.build_synfire(tsyn.SYNFIRE4, **tkw)
        net = tsyn.build_synfire(tsyn.SYNFIRE4, partition=tpart.PartitionSpec(
            core_budget_bytes=budget), **tkw)
        assert net.partition.n_cores >= 3
        s0, o0 = Engine(base).run(40)
        s1, o1 = Engine(net).run(40)
        _assert_port_equal(s0, o0, s1, o1, "first run")
        s0, o0 = Engine(base).run(40, state=s0)
        s1, o1 = Engine(net).run(40, state=s1, record="none")
        assert o1 == {}
        _assert_port_equal(s0, {}, s1, {}, "second run")


def _plan_rows(plan):
    return [(c.lo, c.hi, c.bytes_total, c.n_ext, c.gc0, c.gc1) for c in plan.cores]


def _assert_same_plan(rplan, tplan):
    assert _plan_rows(tplan) == _plan_rows(rplan)
    assert tplan.exchange.edges == rplan.exchange.edges
    assert tplan.exchange.bytes_per_tick == rplan.exchange.bytes_per_tick
    for a, b in zip(tplan.ext_ids, rplan.ext_ids):
        np.testing.assert_array_equal(a, b)


class TestPlanEqualsReference:
    @pytest.mark.parametrize("cfg", ["SYNFIRE4", "SYNFIRE4_MINI"])
    @pytest.mark.parametrize("spec", [dict(n_cores=2), dict(n_cores=4),
                                      dict(core_budget_bytes=300_000),
                                      dict(core_budget_bytes=1_000_000)],
                             ids=["n2", "n4", "b300k", "b1m"])
    @pytest.mark.parametrize("kw", [dict(policy="fp32", propagation="sparse"),
                                    dict(policy="fp16", propagation="packed"),
                                    dict(policy="fp16", propagation="auto")],
                             ids=["fp32-sparse", "fp16-packed", "fp16-auto"])
    def test_plan(self, cfg, spec, kw):
        rkw, tkw = _kw_pair(kw)
        rnet = rsyn.build_synfire(getattr(rsyn, cfg), partition=rpart.PartitionSpec(**spec),
                                  **rkw)
        tnet = tsyn.build_synfire(getattr(tsyn, cfg), partition=tpart.PartitionSpec(**spec),
                                  **tkw)
        _assert_same_plan(rnet.partition, tnet.partition)
        if cfg == "SYNFIRE4" and spec == dict(core_budget_bytes=300_000) \
                and kw["propagation"] == "sparse":
            assert [(c.lo, c.hi) for c in tnet.partition.cores] == [
                (0, 418), (418, 737), (737, 1066), (1066, 1200)]
            assert tnet.partition.exchange.bytes_per_tick == 1337

    @pytest.mark.parametrize("cfg", ["SYNFIRE4", "SYNFIRE4_MINI"])
    @pytest.mark.parametrize("spec", [dict(n_cores=2), dict(n_cores=4),
                                      dict(core_budget_bytes=1_000_000)],
                             ids=["n2", "n4", "b1m"])
    def test_plastic_plan(self, cfg, spec):
        rkw, tkw = _kw_pair(dict(policy="fp32", propagation="sparse", stdp_chain=True))
        rnet = rsyn.build_synfire(getattr(rsyn, cfg), partition=rpart.PartitionSpec(**spec),
                                  **rkw)
        tnet = tsyn.build_synfire(getattr(tsyn, cfg), partition=tpart.PartitionSpec(**spec),
                                  **tkw)
        _assert_same_plan(rnet.partition, tnet.partition)

    def test_budget_property(self):
        """Hypothesis over the budget axis: the cores tile [0, N), each
        core's verified bytes stay within the budget, and the plan is the
        reference's."""
        pytest.importorskip("hypothesis")
        from hypothesis import given, settings, strategies as st

        rbase = rsyn.build_synfire(rsyn.SYNFIRE4, policy="fp32", propagation="sparse")
        tbase = tsyn.build_synfire(tsyn.SYNFIRE4, policy="fp32", propagation="sparse",
                                   device="cpu")

        @settings(max_examples=8, deadline=None)
        @given(st.integers(min_value=320_000, max_value=4_000_000))
        def prop(budget):
            tplan = tpart.plan_partition(tbase, tpart.PartitionSpec(core_budget_bytes=budget))
            edges = [(c.lo, c.hi) for c in tplan.cores]
            assert edges[0][0] == 0 and edges[-1][1] == tbase.n_neurons
            assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))
            assert all(c.bytes_total <= budget for c in tplan.cores)
            assert all(led.total_used == c.bytes_total and led.budget == budget
                       for led, c in zip(tplan.ledgers, tplan.cores))
            _assert_same_plan(rpart.plan_partition(
                rbase, rpart.PartitionSpec(core_budget_bytes=budget)), tplan)

        prop()

    def test_plastic_cluster_is_atomic(self):
        net = tsyn.build_synfire(tsyn.SYNFIRE4, policy="fp32", propagation="sparse",
                                 stdp_chain=tsyn.CHAIN_STDP, device="cpu")
        for k in (2, 3, 4, 5):
            plan = tpart.plan_partition(net, tpart.PartitionSpec(n_cores=k))
            assert plan.n_cores == k
            assert not any(200 < c.lo < 1150 for c in plan.cores[1:]), k

    def test_exchange_plan_accounts_every_edge(self):
        base = tsyn.build_synfire(tsyn.SYNFIRE4, policy="fp32", propagation="sparse",
                                  device="cpu")
        plan = tpart.plan_partition(base, tpart.PartitionSpec(n_cores=3))
        assert plan.exchange.edges
        assert all(src != dst and n > 0 for src, dst, n in plan.exchange.edges)
        assert plan.exchange.bytes_per_tick == sum(n for _, _, n in plan.exchange.edges)
        inbound = {c.index: 0 for c in plan.cores}
        for _, dst, n in plan.exchange.edges:
            inbound[dst] += n
        for c in plan.cores:
            ext = plan.ext_ids[c.index]
            assert int(np.sum((ext < c.lo) | (ext >= c.hi))) == inbound[c.index]
            assert torch.equal(plan.ext_idx[c.index], torch.from_numpy(ext.astype(np.int64)))


class TestDegenerateSpecs:
    """Every degenerate spec of the reference's ``TestDegenerateSpecs``
    raises the same exception type with the same message."""

    @pytest.fixture(scope="class")
    def nets(self):
        return (rsyn.build_synfire(rsyn.SYNFIRE4, policy="fp32", propagation="sparse"),
                tsyn.build_synfire(tsyn.SYNFIRE4, policy="fp32", propagation="sparse",
                                   device="cpu"))

    @pytest.mark.parametrize("spec,match", [
        (dict(core_budget_bytes=None), "n_cores or core_budget"),
        (dict(n_cores=0), "n_cores must be >= 1"),
        (dict(n_cores=10, split_groups=False), "split_groups=False"),
        (dict(n_cores=2, lowering="tpu"), "unknown lowering"),
    ], ids=["no-sizing", "zero-cores", "unsplittable", "unknown-lowering"])
    def test_plan_errors(self, nets, spec, match):
        rnet, tnet = nets
        for part, net in ((rpart, rnet), (tpart, tnet)):
            with pytest.raises(part.PartitionError, match=match):
                part.plan_partition(net, part.PartitionSpec(**spec))
        assert issubclass(tpart.PartitionError, ValueError)

    def test_budget_below_atomic_span(self):
        for syn, part, dev in ((rsyn, rpart, {}), (tsyn, tpart, {"device": "cpu"})):
            net = syn.build_synfire(syn.SYNFIRE4, policy="fp32", propagation="sparse",
                                    stdp_chain=syn.CHAIN_STDP, **dev)
            with pytest.raises(part.PartitionError, match="atomic span"):
                part.plan_partition(net, part.PartitionSpec(core_budget_bytes=100_000))

    @pytest.mark.parametrize("kw,match", [
        (dict(propagation="loop", partition=dict(n_cores=2)), "loop"),
        (dict(propagation="sparse", stdp_chain=True,
              partition=dict(n_cores=2, lowering="mesh")), "mesh"),
        (dict(propagation="sparse", stdp_chain=True, homeo_chain=True,
              homeostasis_period=10, partition=dict(n_cores=2)), "homeostasis"),
    ], ids=["loop", "mesh-plastic", "homeostasis"])
    def test_compile_errors(self, kw, match):
        for syn, part, dev in ((rsyn, rpart, {}), (tsyn, tpart, {"device": "cpu"})):
            k = dict(kw, partition=part.PartitionSpec(**kw["partition"]))
            if "stdp_chain" in k:
                k["stdp_chain"] = syn.CHAIN_STDP
            if "homeo_chain" in k:
                k["homeo_chain"] = _homeo(syn)
            with pytest.raises(part.PartitionError, match=match):
                syn.build_synfire(syn.SYNFIRE4, policy="fp32", **k, **dev)

    def test_partitioned_run_rejects_monitors_and_keywords(self):
        net = tsyn.build_synfire(tsyn.SYNFIRE4, policy="fp32", propagation="sparse",
                                 partition=tpart.PartitionSpec(n_cores=2), device="cpu")
        with pytest.raises(tpart.PartitionError, match="record"):
            Engine(net).run(10, record="monitors")
        with pytest.raises(tpart.PartitionError, match="unsupported kwargs"):
            Engine(net).run(10, gen_chunk=5)

    def test_partitioned_run_batch_rejected(self):
        net = tsyn.build_synfire(tsyn.SYNFIRE4, policy="fp32", propagation="sparse",
                                 partition=tpart.PartitionSpec(n_cores=2), device="cpu")
        with pytest.raises(tpart.PartitionError, match="run_batch"):
            Engine(net).run_batch(10, 4)

    def test_watches_rejected_first(self):
        for syn, part, dev in ((rsyn, rpart, {}), (tsyn, tpart, {"device": "cpu"})):
            with pytest.raises(ValueError, match="partitioned"):
                syn.build_synfire(syn.SYNFIRE4, policy="fp32", propagation="sparse",
                                  watches="default",
                                  partition=part.PartitionSpec(n_cores=2), **dev)


def _homeo(syn):
    from repro_torch.core.plasticity import HomeostasisConfig as THomeo
    from repro.core.plasticity import HomeostasisConfig as RHomeo
    return RHomeo() if syn is rsyn else THomeo()


class TestMeshLowering:
    """The mesh lowering on ``core_mesh(devices=["cpu"] * 4)``: each core on
    its mesh entry, one all-gather per tick."""

    @pytest.mark.parametrize("kw", [dict(policy="fp32", propagation="sparse"),
                                    dict(policy="fp16", propagation="packed")],
                             ids=["fp32-sparse", "fp16-packed"])
    def test_mesh_equals_unpartitioned(self, kw):
        rkw, tkw = _kw_pair(kw)
        n = 120 if kw["policy"] == "fp16" else T
        rfinal, rout = _ref_unpartitioned("SYNFIRE4", rkw, n)
        base = tsyn.build_synfire(tsyn.SYNFIRE4, **tkw)
        net = tsyn.build_synfire(tsyn.SYNFIRE4, partition=tpart.PartitionSpec(
            n_cores=4, lowering="mesh"), **tkw)
        plan = net.partition
        mesh = core_mesh(devices=["cpu"] * 4)
        s1, o1 = tpart.run_partitioned_mesh(net.static, plan, plan.run_params, net.state0, n,
                                            mesh=mesh)
        _assert_vs_reference(s1, o1, rfinal, rout, "mesh")
        s0, o0 = Engine(base).run(n)
        _assert_port_equal(s0, o0, s1, o1, "mesh vs port")
        s2, o2 = tpart.run_partitioned(net.static, plan, plan.run_params, net.state0, n)
        _assert_port_equal(s2, o2, s1, o1, "mesh vs sequential")

    def test_mesh_size_must_match_cores(self):
        net = tsyn.build_synfire(tsyn.SYNFIRE4, policy="fp32", propagation="sparse",
                                 partition=tpart.PartitionSpec(n_cores=4, lowering="mesh"),
                                 device="cpu")
        plan = net.partition
        with pytest.raises(tpart.PartitionError, match="must match"):
            tpart.run_partitioned_mesh(net.static, plan, plan.run_params, net.state0, 5,
                                       mesh=core_mesh(devices=["cpu"] * 3))
        with pytest.raises(tpart.PartitionError, match="no axis"):
            tpart.run_partitioned_mesh(net.static, plan, plan.run_params, net.state0, 5,
                                       mesh=core_mesh(devices=["cpu"] * 4, axis="x"))

    def test_mesh_rejects_coba(self):
        from repro_torch.core import COBAConfig
        builder = tsyn._synfire_builder(tsyn.SYNFIRE4)
        with pytest.raises(tpart.PartitionError, match="COBA"):
            builder.compile(conductances=COBAConfig(), propagation="sparse", device="cpu",
                            partition=tpart.PartitionSpec(n_cores=2, lowering="mesh"))


class TestLedgerHealthObs:
    def test_ledger_child(self):
        led = MemoryLedger(budget=1000, name="net")
        child = led.child("core3")
        assert child.name == "net/core3" and child.budget == 1000
        assert child.total_used == 0 and led.child("c", budget=7).budget == 7
        assert MemoryLedger(name="x").child("c").budget is None

    def test_core_ledgers_match_reference(self):
        rkw, tkw = _kw_pair(dict(policy="fp16", propagation="sparse", stdp_chain=True))
        spec = dict(n_cores=3)
        rnet = rsyn.build_synfire(rsyn.SYNFIRE4, partition=rpart.PartitionSpec(**spec), **rkw)
        tnet = tsyn.build_synfire(tsyn.SYNFIRE4, partition=tpart.PartitionSpec(**spec), **tkw)
        for rl, tl in zip(rnet.partition.ledgers, tnet.partition.ledgers):
            assert tl.name == rl.name and tl.name.startswith("synfire4/fp16/core")
            assert tl.name_bytes() == rl.name_bytes()
            assert tl.stage_bytes() == rl.stage_bytes()

    def test_health_per_core_checks(self):
        net = tsyn.build_synfire(tsyn.SYNFIRE4, policy="fp32", propagation="sparse",
                                 partition=tpart.PartitionSpec(core_budget_bytes=300_000),
                                 device="cpu")
        rnet = rsyn.build_synfire(rsyn.SYNFIRE4, policy="fp32", propagation="sparse",
                                  partition=rpart.PartitionSpec(core_budget_bytes=300_000))
        from repro.obs.health import health_snapshot as rhealth
        h, rh = health_snapshot(net), rhealth(rnet)
        rows = [c for c in h["checks"] if c["name"].startswith("core_bytes")]
        assert [(c["name"], c["value"], c["limit"], c["status"]) for c in rows] == [
            (c["name"], c["value"], c["limit"], c["status"]) for c in rh["checks"]
            if c["name"].startswith("core_bytes")]
        assert len(rows) == 4 and all(c["limit"] == 300_000 for c in rows)
        budget = [c for c in h["checks"] if c["name"] == "ledger_budget"]
        assert budget and budget[0]["limit"] == 4 * 300_000
        assert budget == [c for c in rh["checks"] if c["name"] == "ledger_budget"]

    def test_obs_counters_spans_and_bitwise_off(self):
        obs.configure(enabled=True, reset=True)
        try:
            net = tsyn.build_synfire(tsyn.SYNFIRE4, policy="fp16", propagation="sparse",
                                     partition=tpart.PartitionSpec(n_cores=3), device="cpu")
            reg = obs.registry()
            plan = net.partition
            assert reg.gauge("repro_partition_cores").value() == 3.0
            for c in plan.cores:
                assert reg.gauge("repro_partition_core_bytes").value(
                    core=str(c.index)) == float(c.bytes_total)
            assert reg.gauge("repro_partition_exchange_bytes_per_tick").value() == float(
                plan.exchange.bytes_per_tick)
            s_on, o_on = Engine(net).run(30)
            assert reg.counter("repro_partition_ticks_total").value() == 30.0
            assert reg.counter("repro_partition_exchange_bytes_total").value() == \
                30.0 * plan.exchange.bytes_per_tick
            assert reg.counter("repro_engine_ticks_total").value() == 30.0
            names = [e.name for e in obs.tracer().snapshot()]
            assert "partition_plan" in names
            (ev,) = [e for e in obs.tracer().snapshot() if e.name == "partition_run"]
            assert ev.args == {"lowering": "sequential", "n_cores": 3, "n_ticks": 30,
                               "record": "raster"}
            obs.configure(enabled=False)
            s_off, o_off = Engine(net).run(30)
            _assert_port_equal(s_on, o_on, s_off, o_off, "obs on/off")
        finally:
            obs.configure(enabled=True, reset=True)


@pytest.mark.slow
def test_x100_under_mcu_budget():
    """Synfire4×100 (120,000 neurons) cut under the MCU budget per core,
    the reference's plan, each core's verified ledger within 8.477 MB, and
    the partitioned run equal to the unpartitioned one bit for bit."""
    cfg = tsyn.scale_synfire(tsyn.SYNFIRE4, 100)
    kw = dict(policy="fp16", propagation="sparse", monitors=None, monitor_ms_hint=0)
    net = tsyn.build_synfire(cfg, partition=tpart.PartitionSpec(), device="cpu", **kw)
    rnet = rsyn.build_synfire(rsyn.scale_synfire(rsyn.SYNFIRE4, 100),
                              partition=rpart.PartitionSpec(), **kw)
    plan = net.partition
    _assert_same_plan(rnet.partition, plan)
    assert net.n_neurons == 120_000 and plan.n_cores == 10
    assert all(c.bytes_total <= MCU_BUDGET_BYTES for c in plan.cores)
    assert plan.exchange.bytes_per_tick == 314_338
    base = tsyn.build_synfire(cfg, budget=None, device="cpu", **kw)
    s0, o0 = Engine(base).run(20)
    s1, o1 = Engine(net).run(20)
    _assert_port_equal(s0, o0, s1, o1, "x100")
    rows = [c for c in health_snapshot(net)["checks"] if c["name"].startswith("core_bytes")]
    assert len(rows) == plan.n_cores and all(c["status"] == "pass" for c in rows)


def test_core_static_slices_the_global_plan():
    """A core's buckets are post slices of the global plan: every bucket
    keeps its delay and pre union, and the core's ring is its column
    slice of the global ring's layout."""
    net = tsyn.build_synfire(tsyn.SYNFIRE4, policy="fp16", propagation="auto",
                             partition=tpart.PartitionSpec(n_cores=4), device="cpu")
    g = net.static
    for cp in net.partition.cores:
        cs = cp.static
        assert cs.n == cp.hi - cp.lo and cs.ring_len == g.ring_len
        assert all(dataclasses.replace(b, q=0, pre_start=0, post_start=0, members=())
                   in {dataclasses.replace(gb, q=0, pre_start=0, post_start=0, members=())
                       for gb in g.buckets} for b in cs.buckets)
        assert sum(b.q for b in cs.buckets) <= sum(b.q for b in g.buckets)
