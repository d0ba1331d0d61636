"""The port's observability plane (``repro_torch.obs``): tracing, metrics,
health, exporters, on the CPU against the reference's ``repro.obs`` — and
the contract everything rests on: obs on or off is bitwise invisible to
the results.

Mirrors ``tests/test_obs.py``: the exporters' formats (Chrome-trace JSON,
Prometheus text with escaping and cumulative buckets), the ring bound, the
compile/cache-hit classification (the port's counterpart of jit's cache
probe: kernel libraries loaded and launcher sets built), the SLO health
verdicts against the paper's budgets on the port's M33, the serving
layer's spans, counters, gauges and histograms, and the typed
checkpoint-failure surface. The reference's registry, fed the same series,
exports the same Prometheus text and JSON snapshot, string for string.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as robs  # noqa: E402
from repro.obs import metrics as rmetrics  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs.synfire4 import SYNFIRE4_MINI, build_synfire  # noqa: E402
from repro_torch.core import Engine, rng  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.memory import MemoryLedger  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.obs.metrics import Histogram, MetricsRegistry, escape_label_value  # noqa: E402
from repro_torch.obs.trace import EVENT_KINDS, Tracer  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    CheckpointError,
    LaneScheduler,
    ServePool,
    Session,
    restore_lane,
    restore_session,
    save_session,
)


@pytest.fixture(autouse=True)
def _fresh_obs():
    """Every test starts with an empty, enabled obs plane and leaves it
    reset for whoever runs next."""
    obs.configure(enabled=True, reset=True)
    yield
    obs.configure(enabled=True, reset=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mini(policy="fp16", prop="packed", backend=None, **kw):
    return build_synfire(SYNFIRE4_MINI, policy=policy, propagation=prop, backend=backend,
                         device="cpu", **kw)


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------
class TestTracer:
    def test_nested_spans_record_depth_and_duration(self):
        tr = Tracer()
        with tr.span("admit", rung="cap4"):
            with tr.span("step_chunk", n_ticks=10):
                pass
        inner, outer = tr.snapshot()  # the inner span exits (and records) first
        assert (outer.name, outer.depth) == ("admit", 0)
        assert (inner.name, inner.depth) == ("step_chunk", 1)
        assert outer.dur_us >= inner.dur_us >= 0.0
        assert outer.cat == inner.cat == "runtime"
        assert outer.args == {"rung": "cap4"}

    def test_span_exposes_dur_s_for_metric_reuse(self):
        tr = Tracer()
        with tr.span("flush") as sp:
            pass
        assert sp.dur_s == tr.snapshot()[0].dur_us / 1e6

    def test_ring_overflow_counts_dropped(self):
        tr = Tracer(capacity=4)
        for i in range(10):
            tr.event("e", i=i)
        assert len(tr) == 4 and tr.dropped == 6
        assert [e.args["i"] for e in tr.snapshot()] == [6, 7, 8, 9]

    def test_span_records_error_tag_on_exception(self):
        tr = Tracer()
        with pytest.raises(ValueError):
            with tr.span("evict"):
                raise ValueError("boom")
        (ev,) = tr.snapshot()
        assert ev.args["error"] == "ValueError"

    def test_jsonl_export(self, tmp_path):
        tr = Tracer(capacity=8)
        tr.event("admit", session="a")
        with tr.span("step_chunk"):
            pass
        path = tmp_path / "trace.jsonl"
        tr.to_jsonl(str(path))
        lines = [json.loads(line) for line in path.read_text().splitlines()]
        assert lines[0]["meta"]["retained"] == 2 and lines[0]["meta"]["capacity"] == 8
        assert [ln["name"] for ln in lines[1:]] == ["admit", "step_chunk"]
        assert lines[1]["ph"] == "i" and lines[2]["ph"] == "X"

    def test_chrome_export_is_loadable_trace_json(self, tmp_path):
        tr = Tracer()
        tr.event("route", fingerprint="abc")
        with tr.span("rung_migrate", from_rung=8, to_rung=64):
            pass
        path = tmp_path / "trace.chrome.json"
        tr.to_chrome(str(path))
        doc = json.loads(path.read_text())
        events = doc["traceEvents"]
        assert events[0]["ph"] == "M"  # the process_name metadata first
        by_name = {e["name"]: e for e in events[1:]}
        assert by_name["route"]["ph"] == "i" and by_name["route"]["s"] == "t"
        assert by_name["rung_migrate"]["ph"] == "X" and by_name["rung_migrate"]["dur"] >= 0
        assert all({"ts", "pid", "tid"} <= set(e) for e in events[1:])

    def test_event_vocabulary_is_the_reference_s(self):
        from repro.obs.trace import EVENT_KINDS as REF_KINDS

        assert EVENT_KINDS == REF_KINDS


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
class TestMetrics:
    def test_histogram_bucketing_le_semantics(self):
        h = Histogram("h", buckets=(1.0, 2.0, 5.0))
        for v in (0.5, 1.0, 1.5, 7.0):
            h.observe(v)
        (counts, total_sum, total) = h.series()[()]
        assert counts == [2, 1, 0, 1]  # 0.5, 1.0 in le=1; 1.5 in le=2; 7.0 in +Inf
        assert total == 4 and total_sum == pytest.approx(10.0)
        assert h.quantile(0.5) == pytest.approx(1.0)
        assert h.quantile(1.0) == pytest.approx(5.0)  # +Inf -> the last edge
        assert Histogram("e", buckets=(1.0,)).quantile(0.5) is None

    def test_histogram_merged_quantile_across_series(self):
        h = Histogram("h", buckets=(1.0, 10.0))
        h.observe(0.5, rung="a")
        h.observe(9.0, rung="b")
        assert h.quantile(1.0, {"rung": "a"}) == pytest.approx(1.0)
        assert h.quantile(1.0) == pytest.approx(10.0)  # labels=None merges

    def test_prometheus_cumulative_buckets_and_headers(self):
        reg = MetricsRegistry()
        h = reg.histogram("repro_serve_chunk_latency_ms")
        for v in (0.4, 3.0, 9999.0):
            h.observe(v, rung="cap4")
        text = reg.to_prometheus()
        assert "# HELP repro_serve_chunk_latency_ms " in text
        assert "# TYPE repro_serve_chunk_latency_ms histogram" in text
        assert 'repro_serve_chunk_latency_ms_bucket{rung="cap4",le="0.5"} 1' in text
        assert 'repro_serve_chunk_latency_ms_bucket{rung="cap4",le="5"} 2' in text
        assert 'repro_serve_chunk_latency_ms_bucket{rung="cap4",le="+Inf"} 3' in text
        assert 'repro_serve_chunk_latency_ms_count{rung="cap4"} 3' in text

    def test_prometheus_label_value_escaping(self):
        assert escape_label_value('a"b\\c\nd') == 'a\\"b\\\\c\\nd'
        reg = MetricsRegistry()
        reg.counter("c_total").inc(path='tmp\\x "y"\nz')
        line = next(ln for ln in reg.to_prometheus().splitlines()
                    if ln.startswith("c_total{"))
        assert line == 'c_total{path="tmp\\\\x \\"y\\"\\nz"} 1'

    def test_counter_rejects_negative_and_kind_clash(self):
        reg = MetricsRegistry()
        with pytest.raises(ValueError):
            reg.counter("c").inc(-1.0)
        with pytest.raises(ValueError):
            reg.gauge("c")  # already registered as a counter

    def test_gauge_clear_where_subset(self):
        g = MetricsRegistry().gauge("g")
        g.set(1.0, ledger="a", rung="r1")
        g.set(2.0, ledger="a", rung="r2")
        g.set(3.0, ledger="b", rung="r1")
        g.clear_where(ledger="a")
        assert list(g.series().values()) == [3.0]

    def test_snapshot_is_json_safe_with_quantiles(self):
        reg = MetricsRegistry()
        reg.histogram("repro_serve_us_per_tick").observe(30.0, rung="x")
        (series,) = json.loads(reg.to_json())["repro_serve_us_per_tick"]["series"]
        assert series["count"] == 1 and 25.0 <= series["p95"] <= 50.0

    def test_declared_names_are_the_reference_s(self):
        """Every metric the reference declares, with its kind and buckets;
        the help text differs only where the port's meaning does (the
        dispatch classification, and the serving latencies that time the
        host's enqueue)."""
        assert set(metrics.DECLARED) == set(rmetrics.DECLARED)
        differ = set()
        for name, (kind, help_, buckets) in metrics.DECLARED.items():
            rkind, rhelp, rbuckets = rmetrics.DECLARED[name]
            assert (kind, buckets) == (rkind, rbuckets), name
            if help_ != rhelp:
                differ.add(name)
        assert differ == {"repro_serve_chunk_latency_ms", "repro_serve_us_per_tick",
                          "repro_compiles_total", "repro_jit_cache_hits_total"}
        for name in ("repro_serve_chunk_latency_ms", "repro_serve_us_per_tick"):
            assert "not synchronized" in metrics.DECLARED[name][1]

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_exports_equal_the_reference_s(self, seed):
        """The same series recorded into both registries (counters, gauges,
        histograms with non-finite samples, escaped labels) export the same
        Prometheus text and JSON snapshot, string for string."""
        g = np.random.default_rng(seed)
        regs = (MetricsRegistry(), rmetrics.MetricsRegistry())
        names = [n for n in sorted(metrics.DECLARED)
                 if metrics.DECLARED[n][1] == rmetrics.DECLARED[n][1]]
        ops = []
        for _ in range(60):
            name = names[g.integers(len(names))]
            kind = metrics.DECLARED[name][0]
            labels = {"rung": f"r{g.integers(3)}", "path": ['a"b', "c\\d", "e\nf"][g.integers(3)]}
            value = float(g.choice([g.uniform(0, 3000), 0.5, 1.0, np.inf, np.nan]))
            ops.append((name, kind, value, labels))
        ops.append(("custom_total", "counter", 2.5, {}))
        ops.append(("custom_hist", "histogram", 7.0, {"x": "1"}))
        for reg in regs:
            for name, kind, value, labels in ops:
                if kind == "counter":
                    reg.counter(name).inc(abs(value) if np.isfinite(value) else 1.0, **labels)
                elif kind == "gauge":
                    reg.gauge(name).set(value if np.isfinite(value) else -1.0, **labels)
                else:
                    reg.histogram(name).observe(value, **labels)
        assert regs[0].to_prometheus() == regs[1].to_prometheus()
        assert regs[0].to_json() == regs[1].to_json()
        assert metrics.us_per_tick(0.25, 1000) == rmetrics.us_per_tick(0.25, 1000)


# ---------------------------------------------------------------------------
# facade: enable/disable, dispatch classification
# ---------------------------------------------------------------------------
class TestFacade:
    def test_disabled_records_nothing(self):
        obs.configure(enabled=False)
        with obs.span("step_chunk") as sp:
            assert sp is None
        obs.event("admit")
        obs.inc("repro_serve_admits_total")
        obs.observe("repro_serve_us_per_tick", 1.0)
        obs.gauge("repro_serve_lane_occupancy", 1.0)
        assert len(obs.tracer()) == 0
        assert obs.registry().get("repro_serve_admits_total") is None
        assert obs.build_count() is None

    def test_scheduler_first_step_compiles_then_hits(self):
        """The scheduler's first step builds its propagation launchers (a
        compile), later steps reuse them (cache hits); on the CPU the
        engine's runs load no kernel library (hits)."""
        sched = LaneScheduler(_mini(), 2)
        sched.admit("a", seed=1)
        for _ in range(3):
            sched.step(10)
        eng = Engine(_mini())
        eng.run(17)
        eng.run(17)
        reg = obs.registry()
        assert reg.counter("repro_compiles_total").value(site="serve.step_lanes") == 1.0
        assert reg.counter("repro_jit_cache_hits_total").value(site="serve.step_lanes") == 2.0
        assert reg.counter("repro_jit_cache_hits_total").value(site="engine.run") == 2.0
        assert reg.counter("repro_engine_ticks_total").value() == 34.0
        names = [e.name for e in obs.tracer().snapshot()]
        assert "compile" in names and "jit_cache_hit" in names

    def test_library_load_is_a_compile(self, monkeypatch):
        """A dispatch during which a kernel library was loaded is a compile
        (the card's first run of a net); ``note_build`` counts too."""
        before = obs.build_count()
        monkeypatch.setitem(_build._LIBS, "probe", object())
        obs.note_dispatch("engine.run", before)
        before = obs.build_count()
        obs.note_dispatch("engine.run", before)
        before = obs.build_count()
        obs.note_build()
        obs.note_dispatch("engine.run_batch", before)
        reg = obs.registry()
        assert reg.counter("repro_compiles_total").value(site="engine.run") == 1.0
        assert reg.counter("repro_jit_cache_hits_total").value(site="engine.run") == 1.0
        assert reg.counter("repro_compiles_total").value(site="engine.run_batch") == 1.0

    def test_run_batch_counts_lane_ticks(self):
        Engine(_mini()).run_batch(20, 3)
        assert obs.registry().counter("repro_engine_ticks_total").value() == 60.0
        (ev,) = [e for e in obs.tracer().snapshot() if e.name == "engine_run"]
        assert ev.args == {"n_ticks": 20, "batch": 3, "record": "raster"}

    def test_env_var_default(self, monkeypatch):
        from repro_torch.obs import _env_enabled

        monkeypatch.delenv("REPRO_OBS", raising=False)
        assert _env_enabled()
        for off in ("0", "off", "false", "no"):
            monkeypatch.setenv("REPRO_OBS", off)
            assert not _env_enabled()

    def test_spans_never_synchronize_the_device(self, monkeypatch):
        """Nothing the instrumented serving path runs synchronizes the
        device: a span times the host's enqueue."""
        def forbidden(*a, **k):
            raise AssertionError("torch.cuda.synchronize inside the obs plane")

        monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
        net = _mini(watches="default")
        sched = LaneScheduler(net, 2, flight_window=1)
        sched.admit("a", seed=1)
        sched.step(20)
        sched.check_watches()
        sched.flush("a")
        sess = Session.create(net, seed=2)
        sess.run(20)
        sess.check_watches()
        assert obs.registry().histogram("repro_serve_us_per_tick").count(
            scope="scheduler", rung="cap2") == 1

    def test_facade_mirrors_the_reference_s(self):
        """The same calls into both facades export the same text."""
        for o in (obs, robs):
            o.configure(enabled=True, reset=True)
            o.inc("repro_serve_admits_total", rung="cap4")
            o.gauge("repro_serve_lane_occupancy", 3.0, rung="cap4")
            o.observe("repro_serve_chunk_latency_ms", 4.0, rung="cap4")
            o.remove_gauge("repro_serve_lane_capacity", rung="cap4")
        port, ref = obs.registry(), robs.registry()
        assert port.get("repro_serve_admits_total").series() == \
            ref.get("repro_serve_admits_total").series()
        assert port.to_json().replace(metrics.DECLARED["repro_serve_chunk_latency_ms"][1],
                                      "") == ref.to_json().replace(
            rmetrics.DECLARED["repro_serve_chunk_latency_ms"][1], "")
        robs.configure(enabled=True, reset=True)


# ---------------------------------------------------------------------------
# bitwise parity: obs on/off must not touch the results
# ---------------------------------------------------------------------------
def _leaf_bytes(tree):
    if isinstance(tree, torch.Tensor):
        return [tree.numpy().tobytes()]
    if isinstance(tree, (tuple, list)):
        return [b for x in tree for b in _leaf_bytes(x)]
    return [] if tree is None else [np.asarray(tree).tobytes()]


def _cell_outputs(policy, prop, backend, enabled):
    """Raster, telemetry, final state, watch carry and flushed serve
    telemetry of one workload under the given obs setting, as bytes."""
    obs.configure(enabled=enabled, reset=True)
    net = _mini(policy, prop, backend, watches="default")
    final, out = Engine(net).run(120, gen_base=rng.key(5), record="both")
    sched = LaneScheduler(net, 2, flight_window=2)
    sched.admit("a", seed=1)
    sched.admit("b", seed=2)
    sched.step(40)
    sched.step(40)
    flushed = sched.flush_all()
    alerts = sched.check_watches()
    sched.close()
    return {
        "raster": out["spikes"].numpy().tobytes(),
        "telemetry": {k: v.numpy().tobytes() for k, v in out["telemetry"].items()},
        "state": _leaf_bytes(tuple(final._replace(t=np.int32(final.t)))),
        "watch": _leaf_bytes(out["watch_carry"]),
        "lanes": _leaf_bytes(tuple(sched.states._replace(t=np.asarray(sched.states.t)))),
        "flight": [_leaf_bytes(tuple(s.state._replace(t=np.int32(s.state.t))))
                   for s in sched.flight("a")],
        "flushed": {sid: {k: np.asarray(v).tobytes() for k, v in f.items()}
                    for sid, f in flushed.items()},
        "alerts": alerts,
    }


def _assert_parity(policy, prop, backend):
    on = _cell_outputs(policy, prop, backend, enabled=True)
    off = _cell_outputs(policy, prop, backend, enabled=False)
    assert on == off, f"obs on/off changed the results ({prop}/{backend}/{policy})"


class TestBitwiseParity:
    def test_mini_cell_fast(self):
        _assert_parity("fp16", "packed", None)

    @pytest.mark.slow
    @pytest.mark.parametrize("prop", ["packed", "sparse", "auto"])
    @pytest.mark.parametrize("backend", [None, "fused"], ids=["default", "fused"])
    @pytest.mark.parametrize("policy", ["fp32", "fp16"])
    def test_full_matrix(self, prop, backend, policy):
        _assert_parity(policy, prop, backend)


# ---------------------------------------------------------------------------
# serving instrumentation lands in the registry and the trace
# ---------------------------------------------------------------------------
class TestServeInstrumentation:
    def test_scheduler_emits_counters_gauges_histograms(self):
        sched = LaneScheduler(_mini(), 4)
        sched.admit("a", seed=1)
        sched.admit("b", seed=2)
        sched.step(40)
        sched.evict("a")
        reg = obs.registry()
        assert reg.counter("repro_serve_admits_total").value(rung="cap4") == 2.0
        assert reg.counter("repro_serve_evicts_total").value(rung="cap4") == 1.0
        assert reg.counter("repro_serve_flushes_total").value(rung="cap4") == 1.0
        assert reg.gauge("repro_serve_lane_occupancy").value(rung="cap4") == 1.0
        assert reg.gauge("repro_serve_lane_capacity").value(rung="cap4") == 4.0
        assert reg.counter("repro_serve_ticks_total").value(rung="cap4") == 80.0
        assert reg.histogram("repro_serve_us_per_tick").count(scope="scheduler",
                                                              rung="cap4") == 1
        assert reg.histogram("repro_serve_chunk_latency_ms").count(scope="scheduler",
                                                                   rung="cap4") == 1
        names = [e.name for e in obs.tracer().snapshot()]
        for expected in ("admit", "step_chunk", "evict", "flush"):
            assert expected in names
        sched.close()
        assert reg.gauge("repro_serve_lane_occupancy").value(rung="cap4") is None

    def test_rung_bytes_gauge_tracks_ledger(self):
        net = _mini()
        rungs = net.ledger.serve_rung_bytes()
        sched = LaneScheduler(net, 2, ledger_key="rungtest")
        g = obs.registry().gauge("repro_serve_rung_bytes")
        live = net.ledger.serve_rung_bytes()["rungtest"]
        assert g.value(ledger=net.ledger.name, rung="rungtest") == live
        assert obs.registry().gauge("repro_ledger_total_bytes").value(
            ledger=net.ledger.name) == net.ledger.total_used
        sched.close()
        assert g.value(ledger=net.ledger.name, rung="rungtest") is None
        assert net.ledger.serve_rung_bytes() == rungs

    def test_ledger_gauges_mirror_name_bytes(self):
        ledger = MemoryLedger(budget=1000, name="gauged")
        ledger.register("a", torch.zeros(10), stage="1. CARLsim Init.")
        ledger.register("b", torch.zeros(5, dtype=torch.int16), stage="2. Random Gen.")
        ledger.release("a")
        g = obs.registry().gauge("repro_ledger_bytes")
        assert {dict(k)["name"]: v for k, v in g.series().items()
                if dict(k)["ledger"] == "gauged"} == {"b": 10.0}
        assert ledger.total_available == 990

    def test_pool_migration_spans_and_counter(self):
        net = _mini()
        pool = ServePool(rungs=(2, 4))
        for i in range(3):  # the third admit overflows rung 2: migrate up
            pool.admit(net, f"s{i}", seed=i)
        reg = obs.registry()
        assert reg.counter("repro_rung_migrations_total").value(direction="up") == 1.0
        assert reg.counter("repro_pool_routes_total").series()
        names = [e.name for e in obs.tracer().snapshot()]
        for expected in ("route", "rung_build", "rung_migrate", "export", "restore"):
            assert expected in names, f"missing {expected} in the trace"

    def test_session_chunk_histogram(self):
        sess = Session.create(_mini(), seed=3)
        sess.run(40)
        sess.flush()
        reg = obs.registry()
        assert reg.histogram("repro_serve_chunk_latency_ms").count(scope="session",
                                                                   rung="solo") == 1
        assert reg.counter("repro_serve_flushes_total").value(rung="solo") == 1.0

    def test_watch_flight_and_quarantine_series(self):
        net = _mini(watches="default")
        sched = LaneScheduler(net, 2, flight_window=2)
        sched.admit("a", seed=1)
        sched.admit("b", seed=2)
        sched.step(20)
        lane = sched.lane_of("a")
        sched.states.neurons.v[lane, 40] = float("nan")
        sched.step(20)
        alerts = sched.check_watches()
        sched.quarantine("a", alerts["a"])
        reg = obs.registry()
        assert reg.counter("repro_flight_records_total").value(rung="cap2") == 4.0
        assert reg.counter("repro_watch_trips_total").value(watch="nonfinite",
                                                            rung="cap2") == 1.0
        assert reg.counter("repro_quarantines_total").value(rung="cap2") == 1.0
        names = {e.name for e in obs.tracer().snapshot()}
        assert {"flight_record", "watch_trip", "quarantine"} <= names
        checks = {c["name"]: c for c in obs.health.health_snapshot(net)["checks"]}
        assert checks["watchpoints"]["status"] == "warn"
        assert "nonfinite=1" in checks["watchpoints"]["detail"]


# ---------------------------------------------------------------------------
# health snapshots vs the paper's budgets
# ---------------------------------------------------------------------------
class TestHealth:
    def test_mini_realtime_passes_on_m33(self):
        snap = obs.health.health_snapshot(_mini())
        by_name = {c["name"]: c for c in snap["checks"]}
        rt = by_name["realtime_vs_rp2350_m33"]
        assert rt["status"] == "pass" and rt["value"] >= 1.0
        assert by_name["ledger_budget"]["status"] == "pass"
        assert snap["status"] == "pass" and snap["hardware"] == "rp2350_m33"

    def test_synfire4_misses_realtime_on_m33(self):
        check = obs.health.realtime_check(n_neurons=1200, fanin=120.0)
        assert check.status == "fail" and check.value < 1.0

    def test_checks_equal_the_reference_s(self):
        """The mini's snapshot against the reference's for the same net:
        every check's name, status, value, limit and detail."""
        from repro.configs import synfire4 as rsyn
        from repro.obs import health as rhealth

        rnet = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, policy="fp16")
        got = obs.health.health_snapshot(_mini(), registry=MetricsRegistry())
        want = rhealth.health_snapshot(rnet, registry=rmetrics.MetricsRegistry())
        assert got == want

    def test_oversized_rung_fails_mcu_budget(self):
        ledger = MemoryLedger(budget=None, name="test")
        big = torch.empty((9 * 1024 * 1024 // 4 + 1024, 2), device="meta")  # ~9 MB
        ledger.register("serve.lanes.rungbig", big)
        snap = obs.health.health_snapshot(ledger=ledger)
        by_name = {c["name"]: c for c in snap["checks"]}
        assert by_name["rung_bytes[rungbig]"]["status"] == "fail"
        assert snap["status"] == "fail"
        assert snap["mcu_budget_bytes"] == int(8.477 * 1024**2)

    def test_measured_serve_check_from_live_histogram(self):
        h = obs.registry().histogram("repro_serve_us_per_tick")
        for _ in range(20):
            h.observe(40.0, scope="scheduler", rung="cap4")
        by_name = {c["name"]: c for c in obs.health.health_snapshot()["checks"]}
        assert by_name["serve_realtime_measured"]["status"] == "pass"
        for _ in range(3):  # push more than 5% of the samples past the bar
            h.observe(50_000.0, scope="scheduler", rung="cap4")
        by_name = {c["name"]: c for c in obs.health.health_snapshot()["checks"]}
        assert by_name["serve_realtime_measured"]["status"] == "fail"

    def test_registry_rung_gauges_feed_health_without_a_net(self):
        obs.gauge("repro_serve_rung_bytes", 9_500_000.0, ledger="x", rung="rung512")
        by_name = {c["name"]: c for c in obs.health.health_snapshot()["checks"]}
        assert by_name["rung_bytes[rung512]"]["status"] == "fail"


# ---------------------------------------------------------------------------
# typed checkpoint failures
# ---------------------------------------------------------------------------
class TestCheckpointErrors:
    def _session(self):
        sess = Session.create(_mini(), seed=9)
        sess.run(40)
        return sess

    def test_roundtrip_still_works_and_counts(self, tmp_path):
        sess = self._session()
        save_session(str(tmp_path), sess)
        assert restore_session(str(tmp_path), sess.engine).ticks == sess.ticks
        reg = obs.registry()
        assert reg.counter("repro_checkpoint_saves_total").value(kind="session") == 1.0
        assert reg.counter("repro_checkpoint_restores_total").value(status="ok") == 1.0
        names = [e.name for e in obs.tracer().snapshot()]
        assert "checkpoint_save" in names and "checkpoint_restore" in names

    def test_truncated_file_raises_typed_error(self, tmp_path):
        sess = self._session()
        path = save_session(str(tmp_path), sess)
        with open(path, "wb") as f:
            f.write(b"definitely not an npz archive")
        with pytest.raises(CheckpointError) as ei:
            restore_session(str(tmp_path), sess.engine)
        assert ei.value.path == path and "corrupt or truncated" in str(ei.value)
        errs = [e for e in obs.tracer().snapshot()
                if e.name == "checkpoint_restore" and e.args.get("status") == "error"]
        assert errs and errs[0].args["path"] == path
        assert obs.registry().counter("repro_checkpoint_restores_total").value(
            status="error") == 1.0

    def test_unstamped_checkpoint_rejected(self, tmp_path):
        from repro_torch.checkpoint import ckpt

        sess = self._session()
        ckpt.save(str(tmp_path), 7, {"gen_key": np.zeros(1, np.uint32)})
        with pytest.raises(CheckpointError) as ei:
            restore_session(str(tmp_path), sess.engine, step=7)
        assert ei.value.key == "fmt" and "format stamp" in str(ei.value)

    def test_wrong_format_version_rejected(self, tmp_path):
        from repro_torch.checkpoint import ckpt

        sess = self._session()
        ckpt.save(str(tmp_path), 7, {"fmt": np.int32(99)})
        with pytest.raises(CheckpointError) as ei:
            restore_lane(str(tmp_path), sess.engine, step=7)
        assert ei.value.key == "fmt" and "format 99" in str(ei.value)

    def test_missing_payload_key_is_named(self, tmp_path):
        from repro_torch.checkpoint import ckpt

        sess = self._session()
        ckpt.save(str(tmp_path), 7, {"fmt": np.int32(1), "ticks": np.int32(0)})
        with pytest.raises(CheckpointError) as ei:
            restore_session(str(tmp_path), sess.engine, step=7)
        assert "missing payload key" in str(ei.value) and ei.value.key

    def test_missing_file_stays_file_not_found(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            restore_session(str(tmp_path), Engine(_mini()))


def test_reference_obs_is_left_alone():
    """The port keeps its own plane: recording into it leaves the
    reference's registry and tracer untouched."""
    robs.configure(enabled=True, reset=True)
    obs.inc("repro_serve_admits_total", rung="x")
    obs.event("admit")
    assert robs.registry().get("repro_serve_admits_total") is None
    assert len(robs.tracer()) == 0
