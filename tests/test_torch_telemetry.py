"""In-run monitors and the paper's metrics on the port (``repro_torch.telemetry``),
on the CPU against the reference's ``repro.telemetry``.

Mirrors ``tests/test_telemetry.py`` (its fast cases) on the port, and holds
the port against the reference built from the same seed:

* SpikeCount totals, ``summarize``'s group rates and VoltageProbe rows bit
  for bit against the reference's jitted run; the post-hoc
  ``core.monitors.group_rates`` equal to the streamed rates, dict for dict.
* GroupRate filter levels bit for bit against the reference compiled at
  ``xla_backend_optimization_level=0``; the default jit contracts the
  level's mul+add into an FMA (its distance from the port is bounded
  below and recorded in ROADMAP queue C).
* WeightNorm at rtol 1e-6 against the reference (the reference reduces
  each projection's squares in an order XLA picks per shape; the port in
  a fixed one on both devices: ROADMAP queue C).
* The ledger's ``monitor.telemetry`` and totals equal to the reference's
  for equal compile arguments.
* The metrics and sizing layers equal to the reference's value for value,
  and the paper's checks through the port's own telemetry: fp16 spike-count
  accuracy ≥ 0.975 on Synfire4, the mini real time on the M33.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import telemetry as rtelemetry  # noqa: E402
from repro.configs import synfire4 as rsyn  # noqa: E402
from repro.core import NetworkBuilder as RBuilder, STDPConfig as RSTDP, izh4 as rizh4  # noqa: E402
from repro.core import monitors as rcm  # noqa: E402
from repro.core import sizing as rsizing  # noqa: E402
from repro.core.engine import run as ref_run  # noqa: E402
from repro.telemetry import metrics as rmetrics  # noqa: E402
from repro_torch import telemetry  # noqa: E402
from repro_torch.configs import synfire4 as tsyn  # noqa: E402
from repro_torch.configs.synfire4 import (  # noqa: E402
    SYNFIRE4,
    SYNFIRE4_MINI,
    SYNFIRE4_X10,
    build_synfire,
)
from repro_torch.core import Engine, NetworkBuilder, izh4, run  # noqa: E402
from repro_torch.core import sizing  # noqa: E402
from repro_torch.core.monitors import (  # noqa: E402
    group_rates,
    isi_stats,
    population_summary,
    synchrony_index,
)
from repro_torch.core.plasticity import STDPConfig  # noqa: E402
from repro_torch.core.sizing import M33, PI_ZERO_2W  # noqa: E402
from repro_torch.telemetry import (  # noqa: E402
    GroupRate,
    SpikeCount,
    VoltageProbe,
    WeightNorm,
    metrics,
)

TICKS = 1000  # the paper's 1 s cross-check window
PROPS = ("loop", "packed", "sparse", "auto")
BACKENDS = (None, "fused")
OPT0 = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def mini(**kw):
    kw.setdefault("policy", "fp16")
    return build_synfire(SYNFIRE4_MINI, device="cpu", **kw)


def _check_rates_bitwise(net, n_ticks):
    """record="both": streamed counts/rates must match the raster exactly."""
    _, out = Engine(net).run(n_ticks, record="both")
    raster = out["spikes"]
    s = telemetry.summarize(net.static, out["telemetry"], n_ticks)
    assert int(raster.sum()) > 0, "degenerate run — nothing to cross-check"
    for g in net.static.groups:
        assert s["group_spike_counts"][g.name] == int(raster[:, g.start:g.start + g.size].sum())
    assert s["group_rates"] == group_rates(net.static, raster)
    assert s["total_spikes"] == int(raster.sum())
    return s


class TestMonitorRasterParity:
    """The mode × backend matrix on Synfire4-mini (the fused backend takes
    no loop oracle)."""

    @pytest.mark.parametrize("backend", BACKENDS, ids=["default", "fused"])
    @pytest.mark.parametrize("prop", PROPS)
    def test_group_rates_bitwise(self, prop, backend):
        if backend == "fused" and prop == "loop":
            with pytest.raises(ValueError, match="loop"):
                mini(propagation=prop, backend=backend)
            return
        _check_rates_bitwise(mini(propagation=prop, backend=backend), TICKS)

    def test_monitors_only_matches_both(self):
        eng = Engine(mini())
        _, o_mon = eng.run(300, record="monitors")
        _, o_both = eng.run(300, record="both")
        assert torch.equal(o_mon["telemetry"]["spike_count"], o_both["telemetry"]["spike_count"])
        assert torch.equal(o_mon["telemetry"]["group_rate"], o_both["telemetry"]["group_rate"])

    def test_record_none_returns_no_outputs(self):
        final, out = Engine(mini()).run(100, record="none")
        assert out == {}
        assert final.t == 100

    def test_raster_mode_unchanged_by_telemetry_compile(self):
        _, o1 = Engine(mini()).run(300)
        _, o2 = Engine(mini(monitors=None)).run(300)
        assert torch.equal(o1["spikes"], o2["spikes"])


class TestReferenceParity:
    """The port's telemetry against the reference's from the same seed."""

    @pytest.mark.parametrize("cfg,policy", [("SYNFIRE4_MINI", "fp16"), ("SYNFIRE4_MINI", "fp32"),
                                            ("SYNFIRE4", "fp16"), ("SYNFIRE4", "fp32")])
    def test_counts_and_levels_bitwise(self, cfg, policy):
        """SpikeCount and ``summarize`` bit for bit against the jitted
        reference, GroupRate against its opt-level-0 compile; the default
        jit's levels within 8 f32 ulps (its FMA, ROADMAP queue C)."""
        rnet = rsyn.build_synfire(getattr(rsyn, cfg), policy=policy)
        tnet = build_synfire(getattr(tsyn, cfg), policy=policy, device="cpu")
        n = 400
        rtel = ref_run(rnet.static, rnet.params, rnet.state0, n, record="monitors")[1]
        rtel0 = ref_run.lower(rnet.static, rnet.params, rnet.state0, n,
                              record="monitors").compile(compiler_options=OPT0)(
            rnet.params, rnet.state0)[1]["telemetry"]
        ttel = run(tnet.static, tnet.params, tnet.state0, n, record="monitors")[1]["telemetry"]
        np.testing.assert_array_equal(ttel["spike_count"].numpy(),
                                      np.asarray(rtel["telemetry"]["spike_count"]))
        np.testing.assert_array_equal(ttel["group_rate"].numpy(), np.asarray(rtel0["group_rate"]))
        got = telemetry.summarize(tnet.static, ttel, n)
        want = rtelemetry.summarize(rnet.static, rtel["telemetry"], n)
        assert got.pop("group_rate_filtered_hz") == rtelemetry.summarize(
            rnet.static, rtel0, n)["group_rate_filtered_hz"]
        want.pop("group_rate_filtered_hz")
        assert got == want
        jit = np.asarray(rtel["telemetry"]["group_rate"])
        ulps = np.abs(jit.view(np.int32).astype(np.int64)
                      - ttel["group_rate"].numpy().view(np.int32).astype(np.int64))
        assert ulps.max() <= 8, ulps.max()

    def test_group_rate_fma_divergence_recorded(self):
        """Where the reference's default jit first leaves the opt-level-0
        levels: per neuron, the port's fold against the same fold with the
        mul+add fused (``fma(alpha, inst - c, c)``: the product exact in
        f64, the sum rounded to f32) over a Synfire4 fp16 raster. The fused
        fold's group means are the jitted reference's bit for bit, so the
        FMA is the whole difference, and the two folds part at the third
        tick (index 2)."""
        rnet = rsyn.build_synfire(rsyn.SYNFIRE4, policy="fp16")
        tnet = build_synfire(SYNFIRE4, policy="fp16", device="cpu")
        n = 300
        _, out = run(tnet.static, tnet.params, tnet.state0, n, record="both")
        spikes = out["spikes"].numpy()
        alpha, inst = (np.float32(x) for x in telemetry.monitors.rate_constants(
            tnet.static, tnet.static.monitors[1]))
        plain = np.zeros(tnet.static.n, np.float32)
        fused = np.zeros(tnet.static.n, np.float32)
        first = None
        for t in range(n):
            x = spikes[t].astype(np.float32) * inst
            plain = plain + alpha * (x - plain)
            fused = (np.float64(alpha) * (x - fused).astype(np.float64)
                     + fused.astype(np.float64)).astype(np.float32)
            if first is None and not np.array_equal(plain, fused):
                first = t
        assert np.array_equal(plain, run(tnet.static, tnet.params, tnet.state0, n,
                                         record="monitors", return_tel_carry=True)[1][
            "tel_carry"][1].numpy())
        rtel = ref_run(rnet.static, rnet.params, rnet.state0, n, record="monitors")[1]["telemetry"]
        means = telemetry.monitors._group_means(tnet.static, torch.from_numpy(fused))
        np.testing.assert_array_equal(np.asarray(rtel["group_rate"]), means)
        assert first == 2, first  # the third tick, the first with a nonzero level

    def test_voltage_probe_rows_bitwise(self):
        """A probe that lists a neuron twice gathers it twice; its rows equal
        the reference's, and ``record_v``'s columns."""
        ids = (0, 60, 185, 60)
        specs = (SpikeCount(), VoltageProbe(neurons=ids))
        rspecs = (rtelemetry.SpikeCount(), rtelemetry.VoltageProbe(neurons=ids))
        tnet = mini(monitors=specs)
        rnet = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, policy="fp16", monitors=rspecs)
        _, out = run(tnet.static, tnet.params, tnet.state0, 300, record="both", record_v=True)
        rout = ref_run(rnet.static, rnet.params, rnet.state0, 300, record="monitors")[1]
        probe = out["telemetry"]["vprobe"].numpy()
        assert probe.shape == (300, len(ids))
        np.testing.assert_array_equal(probe, np.asarray(rout["telemetry"]["vprobe"]))
        np.testing.assert_array_equal(probe, out["v"].numpy()[:, list(ids)])

    @pytest.mark.parametrize("propagation", ["packed", "sparse"])
    def test_weight_norm_close_to_reference(self, propagation):
        """WeightNorm snapshots of the STDP net at rtol 1e-6 (the stated
        tolerance: the sum order of each projection's squares, ROADMAP
        queue C); the snapshots move with STDP."""
        def build(builder, lib_izh4, stdp, specs, **kw):
            net = builder(seed=5)
            net.add_spike_generator("pre", 30, rate_hz=80.0)
            net.add_group("post", lib_izh4(10, a=0.02, b=0.2, c=-65.0, d=8.0))
            net.connect("pre", "post", fanin=15, weight=3.0, delay_ms=1,
                        stdp=stdp(a_plus=0.01, a_minus=0.002, w_max=6.0))
            return net.compile(policy="fp16", propagation=propagation, monitors=specs, **kw)

        tnet = build(NetworkBuilder, izh4, STDPConfig, (WeightNorm(stride=50),), device="cpu")
        rnet = build(RBuilder, rizh4, RSTDP, (rtelemetry.WeightNorm(stride=50),))
        got = run(tnet.static, tnet.params, tnet.state0, 250,
                  record="monitors")[1]["telemetry"]["weight_norm"].numpy()
        want = np.asarray(ref_run(rnet.static, rnet.params, rnet.state0, 250,
                                  record="monitors")[1]["telemetry"]["weight_norm"])
        assert got.shape == want.shape == (5, 1)
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert got[0, 0] != got[-1, 0]

    def test_ledger_bytes_equal_reference(self):
        """``monitor.telemetry`` and every stage for equal compile arguments,
        default monitors and a probe/WeightNorm set."""
        for tspecs, rspecs in (
                ("default", "default"),
                ((VoltageProbe(neurons=(1, 2, 3)), WeightNorm(stride=7)),
                 (rtelemetry.VoltageProbe(neurons=(1, 2, 3)), rtelemetry.WeightNorm(stride=7)))):
            for hint in (0, 250):
                tnet = mini(monitors=tspecs, monitor_ms_hint=hint)
                rnet = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, policy="fp16", monitors=rspecs,
                                          monitor_ms_hint=hint)
                assert tnet.ledger.name_bytes() == rnet.ledger.name_bytes()
                assert tnet.ledger.stage_bytes() == rnet.ledger.stage_bytes()
                assert tnet.ledger.monitor_bytes() == rnet.ledger.monitor_bytes()
                assert tnet.ledger.format_table() == rnet.ledger.format_table()
                assert tnet.ledger.rampup_rows() == rnet.ledger.rampup_rows()

    def test_chunked_carry_equals_reference(self):
        """``tel_carry``/``return_tel_carry`` over three chunks on
        ``gen_base``: each chunk's raw carry and its flush equal the
        reference's (levels against its opt-level-0 chunks)."""
        rnet = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, policy="fp16")
        tnet = mini()
        key = jax.random.key(3)
        rcarry = rtelemetry.init_carry(rnet.static, 50)
        chunk = ref_run.lower(rnet.static, rnet.params, rnet.state0, 50, gen_base=key,
                              record="monitors", tel_carry=rcarry,
                              return_tel_carry=True).compile(compiler_options=OPT0)
        tkey = torch.from_numpy(np.asarray(jax.random.key_data(key)).view(np.int32).copy())
        rstate, tstate, tcarry = rnet.state0, tnet.state0, None
        for _ in range(3):
            rstate, rout = chunk(rnet.params, rstate, gen_base=key, tel_carry=rcarry)
            tstate, tout = run(tnet.static, tnet.params, tstate, 50, record="monitors",
                               gen_base=tkey, tel_carry=tcarry, return_tel_carry=True)
            for a, b in zip(tout["tel_carry"], rout["tel_carry"]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            rvals, rcarry = rtelemetry.flush_carry(rnet.static, rout["tel_carry"])
            tvals, tcarry = telemetry.flush_carry(tnet.static, tout["tel_carry"])
            for k in rvals:
                np.testing.assert_array_equal(tvals[k], rvals[k], k)


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_per_op_nets_fold_monitors_as_plain_ops(method):
    """A net with a LIF group (not IZH4-only: no neuron kernel, so every
    monitor folds as plain ops each tick), Euler and RK4, fp16, 300 ticks:
    SpikeCount and the VoltageProbe rows (a repeated id included) bit for
    bit against the reference's jitted run, GroupRate against its
    opt-level-0 compile."""
    from repro.core import lif as rlif
    from repro_torch.core import lif

    def build(builder, lib_izh4, lib_lif, tel, **kw):
        b = builder(seed=3)
        b.add_spike_generator("g", 30, rate_hz=150.0)
        b.add_group("e", lib_izh4(20, a=0.02, b=0.2, c=-65.0, d=8.0))
        b.add_group("l", lib_lif(15))
        b.connect("g", "e", fanin=8, weight=4.0, delay_ms=2)
        b.connect("g", "l", fanin=6, weight=2.0, delay_ms=1)
        b.connect("e", "l", fanin=5, weight=3.0, delay_ms=3)
        return b.compile(policy="fp16", propagation="sparse", method=method, monitors=(
            tel.SpikeCount(), tel.GroupRate(tau_ms=20.0),
            tel.VoltageProbe(neurons=(31, 50, 31))), **kw)

    rnet = build(RBuilder, rizh4, rlif, rtelemetry)
    tnet = build(NetworkBuilder, izh4, lif, telemetry, device="cpu")
    assert not tnet.static.izh4_only
    rout = ref_run(rnet.static, rnet.params, rnet.state0, 300, record="monitors")[1]
    rout0 = ref_run.lower(rnet.static, rnet.params, rnet.state0, 300,
                          record="monitors").compile(compiler_options=OPT0)(
        rnet.params, rnet.state0)[1]
    tout = run(tnet.static, tnet.params, tnet.state0, 300, record="monitors")[1]
    tel, rtel = tout["telemetry"], rout["telemetry"]
    assert int(tel["spike_count"].sum()) > 100
    np.testing.assert_array_equal(tel["spike_count"].numpy(), np.asarray(rtel["spike_count"]))
    np.testing.assert_array_equal(tel["vprobe"].numpy(), np.asarray(rtel["vprobe"]))
    np.testing.assert_array_equal(tel["group_rate"].numpy(),
                                  np.asarray(rout0["telemetry"]["group_rate"]))


class TestConstantMemory:
    X10_KW = dict(policy="fp16", budget=None, monitor_ms_hint=0, propagation="sparse")

    def test_x10_monitors_without_raster(self):
        """12k neurons, sparse CSR, streaming monitors: no [T, N] raster in
        the outputs, telemetry registered in the ledger (8 bytes a neuron)."""
        net = build_synfire(SYNFIRE4_X10, device="cpu", **self.X10_KW)
        _, out = Engine(net).run(300, record="monitors")
        assert set(out) == {"telemetry"}
        tel = out["telemetry"]
        assert tel["spike_count"].shape == (len(net.static.groups),)
        assert int(tel["spike_count"].sum()) > 0
        assert net.ledger.monitor_bytes() == 8 * net.static.n


class TestChunkedGenerator:
    def _eng(self):
        return Engine(mini())

    def test_chunk_covering_run_is_bitwise_whole_draw(self):
        eng = self._eng()
        _, whole = eng.run(300)
        _, covered = eng.run(300, gen_chunk=300)
        assert torch.equal(whole["spikes"], covered["spikes"])

    def test_chunked_run_deterministic_and_statistically_matched(self):
        eng = self._eng()
        _, whole = eng.run(300)
        _, a = eng.run(300, gen_chunk=50)
        _, b = eng.run(300, gen_chunk=50)
        assert torch.equal(a["spikes"], b["spikes"])
        sw, sa = int(whole["spikes"].sum()), int(a["spikes"].sum())
        assert 0.5 * sw < sa < 2.0 * sw

    def test_chunked_monitors_cross_check_bitwise(self):
        eng = self._eng()
        _, both = eng.run(400, gen_chunk=100, record="both")
        counts = both["spikes"].sum(dim=0)
        st = eng.net.static
        want = [int(counts[g.start:g.start + g.size].sum()) for g in st.groups]
        assert both["telemetry"]["spike_count"].tolist() == want
        _, mon = eng.run(400, gen_chunk=100, record="monitors")
        assert "spikes" not in mon
        assert mon["telemetry"]["spike_count"].tolist() == want

    def test_chunked_probe_and_weightnorm_outputs_flatten(self):
        net = NetworkBuilder(seed=4)
        net.add_spike_generator("g", 20, rate_hz=150.0)
        net.add_group("n", izh4(10, a=0.02, b=0.2, c=-65.0, d=8.0))
        net.connect("g", "n", fanin=8, weight=2.0, delay_ms=1,
                    stdp=STDPConfig(a_plus=0.01, a_minus=0.002, w_max=6.0))
        c = net.compile(policy="fp16", device="cpu", monitors=(
            VoltageProbe(neurons=(22,)), WeightNorm(stride=25)))
        _, out = Engine(c).run(200, gen_chunk=50, record="monitors")
        assert out["telemetry"]["vprobe"].shape == (200, 1)
        assert out["telemetry"]["weight_norm"].shape == (8, 1)

    def test_non_divisor_chunk_raises(self):
        with pytest.raises(ValueError, match="gen_chunk"):
            self._eng().run(300, gen_chunk=77)

    def test_nonpositive_chunk_raises(self):
        eng = self._eng()
        with pytest.raises(ValueError, match="gen_chunk"):
            eng.run(300, gen_chunk=0)
        with pytest.raises(ValueError, match="gen_chunk"):
            eng.run(300, gen_chunk=-5)

    def test_run_batch_accepts_gen_chunk(self):
        _, out = self._eng().run_batch(100, 2, gen_chunk=25, record="both")
        assert out["spikes"].shape == (2, 100, 186)
        assert int(out["spikes"].sum()) > 20
        assert out["telemetry"]["spike_count"].shape == (2, 9)


class TestMonitorKinds:
    def _stdp_net(self, monitors):
        net = NetworkBuilder(seed=5)
        net.add_spike_generator("pre", 30, rate_hz=80.0)
        net.add_group("post", izh4(10, a=0.02, b=0.2, c=-65.0, d=8.0))
        net.connect("pre", "post", fanin=15, weight=3.0, delay_ms=1,
                    stdp=STDPConfig(a_plus=0.01, a_minus=0.002, w_max=6.0))
        return net.compile(policy="fp16", monitors=monitors, device="cpu")

    def test_voltage_probe_matches_record_v(self):
        ids = (0, 60, 185)
        net = mini(monitors=(SpikeCount(), VoltageProbe(neurons=ids)))
        _, out = Engine(net).run(300, record="both", record_v=True)
        probe = out["telemetry"]["vprobe"]
        assert probe.shape == (300, len(ids))
        assert torch.equal(probe, out["v"][:, list(ids)])

    def test_weight_norm_snapshots_track_stdp(self):
        c = self._stdp_net((WeightNorm(stride=50),))
        _, out = Engine(c).run(250, record="monitors")
        wn = out["telemetry"]["weight_norm"].numpy()
        assert wn.shape == (5, 1)
        assert np.all(np.isfinite(wn)) and np.all(wn > 0)
        assert wn[0, 0] != wn[-1, 0], "STDP ran but norms never moved"

    def test_group_rate_filter_tracks_generator_rate(self):
        net = NetworkBuilder(seed=7)
        net.add_spike_generator("g", 200, rate_hz=100.0)
        net.add_group("sink", izh4(10, a=0.02, b=0.2, c=-65.0, d=8.0))
        net.connect("g", "sink", fanin=5, weight=0.1, delay_ms=1)
        c = net.compile(policy="fp32", monitors=(GroupRate(tau_ms=100.0),), device="cpu")
        _, out = Engine(c).run(1000, record="monitors")
        s = telemetry.summarize(c.static, out["telemetry"], 1000)
        assert 70.0 < s["group_rate_filtered_hz"]["g"] < 130.0

    def test_spec_validation(self):
        with pytest.raises(ValueError, match="duplicate"):
            self._stdp_net((SpikeCount(), SpikeCount()))
        with pytest.raises(ValueError, match="out of range"):
            self._stdp_net((VoltageProbe(neurons=(40,)),))
        with pytest.raises(ValueError, match="at least one"):
            self._stdp_net((VoltageProbe(),))
        with pytest.raises(ValueError, match="stride"):
            self._stdp_net((WeightNorm(stride=0),))
        with pytest.raises(ValueError, match="stable"):
            self._stdp_net((GroupRate(tau_ms=0.3),))
        with pytest.raises(TypeError):
            self._stdp_net(("spike_count",))
        with pytest.raises(ValueError, match="monitors"):
            Engine(self._stdp_net(None)).run(10, record="monitors")
        with pytest.raises(ValueError, match="record"):
            Engine(self._stdp_net("default")).run(10, record="rasters")

    def test_run_batch_monitors(self):
        net = mini()
        _, out = Engine(net).run_batch(200, 3, record="both")
        counts = out["telemetry"]["spike_count"]
        raster = out["spikes"]
        assert counts.shape == (3, len(net.static.groups))
        for b in range(3):
            for gi, g in enumerate(net.static.groups):
                assert int(counts[b, gi]) == int(raster[b][:, g.start:g.start + g.size].sum())

    def test_second_spike_count_and_rate_fold_as_plain_ops(self):
        """Monitors beyond the first SpikeCount and GroupRate (which the
        neuron kernel holds) fold as plain ops and agree with the first."""
        net = mini(monitors=(SpikeCount(), GroupRate(), SpikeCount(name="b"),
                             GroupRate(name="r2")))
        tel = Engine(net).run(300, record="monitors")[1]["telemetry"]
        assert torch.equal(tel["spike_count"], tel["b"])
        assert torch.equal(tel["group_rate"], tel["r2"])


class TestPaperFidelityAccuracy:
    def test_fp16_total_spike_accuracy_at_least_97_5(self):
        counts = {}
        for pol in ("fp32", "fp16"):
            net = build_synfire(SYNFIRE4, policy=pol, device="cpu", propagation="sparse")
            _, s = Engine(net).run_monitored(TICKS)
            counts[pol] = s["total_spikes"]
        assert 20_000 <= counts["fp16"] <= 33_000, "degenerate run"
        acc = metrics.spike_count_accuracy(counts["fp16"], counts["fp32"])
        assert acc >= 0.975, (acc, counts)

    def test_mini_realtime_on_m33_from_port_telemetry(self):
        """The mini's 5 s run through the port's SpikeCount: mean rate and
        synaptic events from the port's telemetry, the M33 real time at
        20 mW, as ``benchmarks/report.py`` computes it; every figure equals
        the reference's from its own telemetry."""
        tnet = mini()
        rnet = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, policy="fp16")
        n = 5000
        ts = Engine(tnet).run_monitored(n)[1]
        tel = run(tnet.static, tnet.params, tnet.state0, n, record="monitors")[1]["telemetry"]
        rtel = ref_run(rnet.static, rnet.params, rnet.state0, n, record="monitors")[1]["telemetry"]
        rs = rtelemetry.summarize(rnet.static, rtel, n)
        assert ts["total_spikes"] == rs["total_spikes"] and ts["mean_rate_hz"] == rs["mean_rate_hz"]
        events = metrics.synaptic_events(tnet.static, tel["spike_count"].numpy())
        assert events == rmetrics.synaptic_events(rnet.static, np.asarray(rtel["spike_count"]))
        syn = sum(p.n_syn for p in tnet.static.projections)
        kw = dict(n_neurons=tnet.static.n, fanin=syn / tnet.static.n, synaptic_events=events,
                  model_time_s=ts["model_time_s"], mean_rate_hz=ts["mean_rate_hz"])
        rep = metrics.energy_report(M33, **kw)
        assert rep.realtime_factor >= 1.0 and rep.snn_power_w == pytest.approx(0.020)
        assert rep.as_dict() == rmetrics.energy_report(rsizing.M33, **kw).as_dict()


class TestVectorizedStats:
    @staticmethod
    def _isi_ref(raster, dt_ms=1.0):
        isis = []
        for i in range(raster.shape[1]):
            t = np.nonzero(raster[:, i])[0]
            if len(t) >= 2:
                isis.append(np.diff(t) * dt_ms)
        if not isis:
            return {"mean_ms": float("nan"), "cv": float("nan"), "n": 0}
        isis = np.concatenate(isis)
        mean = float(isis.mean())
        cv = float(isis.std() / mean) if mean > 0 else float("nan")
        return {"mean_ms": mean, "cv": cv, "n": int(len(isis))}

    @pytest.mark.parametrize("seed,density", [(0, 0.02), (1, 0.2), (2, 0.9)])
    def test_isi_stats_matches_loop_reference(self, seed, density):
        rng = np.random.default_rng(seed)
        raster = rng.random((400, 60)) < density
        got, want = isi_stats(torch.from_numpy(raster), dt_ms=0.5), self._isi_ref(raster, 0.5)
        assert got["n"] == want["n"]
        for k in ("mean_ms", "cv"):
            assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k]))
        assert got == rcm.isi_stats(raster, dt_ms=0.5) or got["n"] == 0

    def test_isi_stats_edge_cases(self):
        empty = np.zeros((50, 8), bool)
        assert isi_stats(empty)["n"] == 0
        one = empty.copy()
        one[10, 3] = True
        assert isi_stats(one)["n"] == 0
        two = one.copy()
        two[25, 3] = True
        assert isi_stats(two) == {"mean_ms": 15.0, "cv": 0.0, "n": 1}

    @pytest.mark.parametrize("seed", [0, 3])
    def test_synchrony_matches_reference(self, seed):
        rng = np.random.default_rng(seed)
        raster = rng.random((200, 40)) < 0.1
        assert synchrony_index(torch.from_numpy(raster)) == rcm.synchrony_index(raster)
        assert np.isnan(synchrony_index(raster[:6]))

    def test_population_summary_equals_reference(self):
        tnet = mini()
        rnet = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, policy="fp16")
        raster = run(tnet.static, tnet.params, tnet.state0, 500)[1]["spikes"]
        got = population_summary(tnet.static, raster)
        want = rcm.population_summary(rnet.static, raster.numpy())
        assert got == want


class TestMetricsLayer:
    def test_rate_from_count_is_the_raster_expression(self):
        assert metrics.rate_from_count(37, 25, 500) == float(37 / (25 * 0.5))
        assert metrics.rate_from_count(37, 25, 500, 0.5) == rmetrics.rate_from_count(
            37, 25, 500, 0.5)

    def test_spike_count_accuracy(self):
        assert metrics.spike_count_accuracy(27364, 26694) == 26694 / 27364
        assert metrics.spike_count_accuracy(5, 5) == 1.0
        assert metrics.spike_count_accuracy(0, 0) == 1.0

    def test_synaptic_events_exact_on_known_topology(self):
        net = NetworkBuilder(seed=1)
        net.add_spike_generator("a", 20, rate_hz=50.0)
        net.add_group("b", izh4(10, a=0.02, b=0.2, c=-65.0, d=8.0))
        net.connect("a", "b", fanin=4, weight=1.0, delay_ms=1)
        c = net.compile(policy="fp32", device="cpu")
        assert metrics.synaptic_events(c.static, np.array([100, 7])) == 200.0

    def test_mini_is_realtime_on_m33_at_20mw(self):
        rep = metrics.energy_report(
            M33, n_neurons=186, fanin=2489 / 186, synaptic_events=5000,
            model_time_s=30.0, mean_rate_hz=0.074)
        assert rep.realtime_factor >= 1.0
        assert rep.snn_power_w == pytest.approx(0.020)
        assert rep.as_dict()["snn_power_mw"] == pytest.approx(20.0)
        assert 0 < rep.joules_per_synaptic_event < float("inf")
        assert rep.snn_energy_j == pytest.approx(0.020 * 30.0)

    def test_full_synfire_slower_than_realtime_on_m33(self):
        rep = metrics.energy_report(
            M33, n_neurons=1200, fanin=75, synaptic_events=2e6,
            model_time_s=1.0, mean_rate_hz=22.0)
        assert rep.realtime_factor < 1.0
        assert rep.busy_s > rep.model_time_s

    def test_energy_ratios_match_paper_claims(self):
        kw = dict(n_neurons=186, fanin=13.4, synaptic_events=5000,
                  model_time_s=30.0, mean_rate_hz=0.074)
        mcu = metrics.energy_report(M33, **kw)
        pi = metrics.energy_report(PI_ZERO_2W, **kw)
        cmp = metrics.energy_comparison(mcu, pi)
        assert cmp["snn_energy_ratio"] >= 4.5
        assert cmp["soc_energy_ratio"] >= 10.0
        assert cmp == rmetrics.energy_comparison(
            rmetrics.energy_report(rsizing.M33, **kw),
            rmetrics.energy_report(rsizing.PI_ZERO_2W, **kw))

    def test_ledger_monitor_bytes_scales_with_probe_horizon(self):
        small = mini(monitor_ms_hint=100)
        big = mini(monitor_ms_hint=10_000)
        small_tel = [e for e in small.ledger._entries if e.name == "monitor.telemetry"]
        big_tel = [e for e in big.ledger._entries if e.name == "monitor.telemetry"]
        assert small_tel[0].nbytes == big_tel[0].nbytes == 8 * 186
        assert big.ledger.monitor_bytes() > small.ledger.monitor_bytes()

    def test_sizing_equals_reference(self):
        """``HardwareSpec``, ``M33``, ``PI_ZERO_2W`` and ``realtime_sizing``
        value for value; the card's spec carries the peaks the bounds use
        and no power figure."""
        for spec, rspec in ((M33, rsizing.M33), (PI_ZERO_2W, rsizing.PI_ZERO_2W)):
            assert dataclasses.asdict(spec) == dataclasses.asdict(rspec)
            for kw in ({}, {"dense_traversal": False}, {"fanin": 75, "bytes_per_weight": 4}):
                assert dataclasses.asdict(sizing.realtime_sizing(spec, **kw)) == \
                    dataclasses.asdict(rsizing.realtime_sizing(rspec, **kw))
        h = sizing.H100
        assert (h.flops, h.hbm_bw, h.link_bw, h.active_power_w, h.soc_power_w) == (
            67e12, 3.35e12, 0.0, 0.0, 0.0)
        assert sizing.realtime_sizing(M33, dense_traversal=False).max_neurons == \
            rsizing.realtime_sizing(rsizing.M33, dense_traversal=False).max_neurons
        assert metrics.device_tick_seconds(h, n_neurons=1200, fanin=75,
                                           active_fraction=0.023) > 0
