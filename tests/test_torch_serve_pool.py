"""The elastic serving plane on the port (``repro_torch.serve.pool``): rung
migration parity, admit/evict churn, recycled lanes, per-rung ledger
bytes, admission policy; on the CPU, mirroring ``tests/test_serve_pool.py``
(its fast cases; the mesh-sharded case is ROADMAP A11).

Elasticity is invisible to tenants: a session that rode the capacity
ladder up and back down produces the state, weights, flushed telemetry and
generator stream of a session that never moved, bit for bit. The ladder
here climbs 1 → 8 → 16 (the reference's test climbs to 64; the CPU's
plain lane versions loop over the lanes, and the migration logic is the
same). Where the reference is held beside the port, a lane's flushes equal
the reference session's chunks compiled at ``xla_backend_optimization_level
=0`` (its default jit contracts the GroupRate fold's mul+add, ROADMAP queue
C), and the ledger's serve bytes equal the reference scheduler's.
"""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import serve as rserve  # noqa: E402
from repro.configs import synfire4 as rsyn  # noqa: E402
from repro.core.engine import run as ref_run  # noqa: E402
from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4_MINI, build_synfire  # noqa: E402
from repro_torch.core.plasticity import HomeostasisConfig  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    CapacityLadder,
    LaneScheduler,
    ServePool,
    Session,
    compile_fingerprint,
    restore_lane,
    save_lane,
)

HOMEO = HomeostasisConfig(target_hz=8.0, tau_avg_ms=500.0, beta=1.0)
OPT0 = {"xla_backend_optimization_level": 0}

# Sustained stimulus keeps every tenant spiking through the whole horizon,
# so plasticity and homeostasis state keeps moving.
DRIVEN = dataclasses.replace(SYNFIRE4_MINI, stim_rate_hz=60.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mini(policy, prop, backend=None, *, plastic=False, homeo=False):
    return build_synfire(
        DRIVEN, policy=policy, propagation=prop, backend=backend,
        stdp_chain=CHAIN_STDP if plastic else None,
        homeo_chain=HOMEO if (plastic and homeo) else None,
        homeostasis_period=40 if (plastic and homeo) else 0, device="cpu")


def _leaves(state):
    out = [np.asarray(state.t), state.key.numpy(), state.ring.numpy()]
    out += [x.numpy() for x in state.neurons]
    out += [w.numpy() for w in state.weights]
    out += [h.numpy() for h in state.homeo if h is not None]
    for tr in state.stdp:
        if tr is not None:
            out += [x.numpy() for x in tr]
    return out


def _assert_state_eq(a, b, what="state"):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f"{what}: leaf {i} differs"


def _assert_flush_eq(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), f"flush value {k!r} differs"


def _seed_of(session_id: str) -> int:
    return zlib.crc32(session_id.encode())


def _ladder_roundtrip_vs_solo(net, chunk=40):
    """Drive tenant "t" up the ladder 1 → 8 → 16 and back down to 1 (five
    chunks), then compare against a solo session that never moved: state,
    weights, flushed telemetry and the next chunk's raster."""
    lad = CapacityLadder(net, rungs=(1, 8, 16), idle_after=1)
    lad.admit("t")
    lad.step(chunk)
    for i in range(7):
        lad.admit(f"filler{i}")
    lad.step(chunk)
    for i in range(7, 9):
        lad.admit(f"filler{i}")
    lad.step(chunk)
    for i in range(9):
        lad.evict(f"filler{i}")
    lad.step(chunk)
    assert lad.rung == 1, "down-rung migration did not fire"
    lad.step(chunk)
    assert lad.migrations == 3

    solo = Session.create(net, seed=_seed_of("t"))
    for _ in range(5):
        solo.run(chunk)
    _assert_flush_eq(lad.flush("t"), solo.flush())
    ev = lad.evict("t")
    _assert_state_eq(ev.state, solo.state, "post-ladder NetState")
    cont = Session.create(net, key=ev.gen_key, state=ev.state)
    assert torch.equal(cont.spike_raster(chunk), solo.spike_raster(chunk))
    return lad


class TestRungMigrationParity:
    def test_mini_rung_migration(self):
        _ladder_roundtrip_vs_solo(_mini("fp16", "sparse", plastic=True, homeo=True))

    @pytest.mark.parametrize("backend", [None, "fused"], ids=["default", "fused"])
    def test_nonplastic_rung_migration(self, backend):
        _ladder_roundtrip_vs_solo(_mini("fp32", "auto", backend))

    def test_migration_preserves_flush_accounting(self):
        """A flush after a migration reports the counts since the tenant's
        last flush, not since the move."""
        net = _mini("fp32", "packed")
        lad = CapacityLadder(net, rungs=(1, 8))
        lad.admit("t")
        lad.step(50)
        for i in range(3):
            lad.admit(f"f{i}")
        lad.step(50)
        flush = lad.flush("t")
        assert flush["n_ticks"] == 100
        solo = Session.create(net, seed=_seed_of("t"))
        solo.run(50)
        solo.run(50)
        _assert_flush_eq(flush, solo.flush())

    def test_top_rung_overflow_raises(self):
        lad = CapacityLadder(_mini("fp32", "packed"), rungs=(1, 8))
        for i in range(8):
            lad.admit(f"t{i}")
        with pytest.raises(RuntimeError, match="top rung"):
            lad.admit("t8")


class TestPoolRouting:
    def test_fingerprint_semantics(self):
        a1 = _mini("fp16", "packed")
        a2 = _mini("fp16", "packed")
        b = _mini("fp16", "sparse")
        c = _mini("fp32", "packed")
        d = build_synfire(DRIVEN, policy="fp16", propagation="packed", device="cpu",
                          monitors=None)
        assert compile_fingerprint(a1) == compile_fingerprint(a2)
        assert len({compile_fingerprint(x) for x in (a1, b, c, d)}) == 4

    def test_heterogeneous_tenants_route_and_match_solo(self):
        net_a = _mini("fp16", "packed", plastic=True)
        net_b = _mini("fp32", "sparse")
        pool = ServePool(rungs=(1, 8))
        fa = pool.admit(net_a, "a0")
        fb = pool.admit(net_b, "b0")
        assert fa != fb and set(pool.fingerprints) == {fa, fb}
        assert pool.admit(net_a, "a1") == fa
        pool.step(50)
        pool.step(50)
        for sid, net in [("a0", net_a), ("b0", net_b), ("a1", net_a)]:
            solo = Session.create(net, seed=_seed_of(sid))
            solo.run(50)
            solo.run(50)
            _assert_flush_eq(pool.flush(sid), solo.flush())
            _assert_state_eq(pool.evict(sid).state, solo.state, sid)

    def test_duplicate_session_id_rejected(self):
        net = _mini("fp32", "packed")
        pool = ServePool()
        pool.admit(net, "x")
        with pytest.raises(ValueError, match="already admitted"):
            pool.admit(net, "x")

    def test_export_checkpoint_restore_across_pools(self, tmp_path):
        net = _mini("fp16", "auto", plastic=True)
        pool1 = ServePool(rungs=(1, 8))
        pool1.admit(net, "mig")
        pool1.step(50)
        save_lane(str(tmp_path), pool1.export("mig"))
        pool2 = ServePool(rungs=(1, 8))
        pool2.restore(net, restore_lane(str(tmp_path), net))
        pool2.step(50)
        solo = Session.create(net, seed=_seed_of("mig"))
        solo.run(50)
        solo.run(50)
        _assert_flush_eq(pool2.flush("mig"), solo.flush())
        _assert_state_eq(pool2.evict("mig").state, solo.state)

    def test_unported_parts_raise(self):
        net = _mini("fp32", "packed")
        pool = ServePool()
        pool.admit(net, "x")
        for call in (pool.check_watches, lambda: pool.quarantine("x"),
                     lambda: pool.flight("x"), pool.ladder_of("x").check_watches):
            with pytest.raises(NotImplementedError, match="A10"):
                call()
        with pytest.raises(NotImplementedError, match="A11"):
            ServePool(mesh=object())
        with pytest.raises(NotImplementedError, match="A11"):
            CapacityLadder(net, mesh=object())


class TestReferenceParity:
    def test_lane_flushes_equal_reference_session(self):
        """A pool tenant's flushes, chunk by chunk, equal the reference
        session's over the same key (its chunks at opt level 0): spike
        counts, filter levels and tick counts bit for bit."""
        tnet = build_synfire(SYNFIRE4_MINI, policy="fp16", propagation="sparse", device="cpu")
        rnet = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, policy="fp16", propagation="sparse")
        key = jax.random.key(_seed_of("p"))
        rmon = rserve.SessionMonitors(rnet.static)
        chunk = ref_run.lower(rnet.static, rnet.params, rnet.state0, 40, gen_base=key,
                              record="monitors", tel_carry=rmon.chunk_carry(40),
                              return_tel_carry=True).compile(compiler_options=OPT0)
        pool = ServePool(rungs=(1, 8))
        pool.admit(tnet, "p")
        pool.admit(tnet, "q")
        rstate = rnet.state0
        for _ in range(3):
            pool.step(40)
            rstate, rout = chunk(rnet.params, rstate, gen_base=key,
                                 tel_carry=rmon.chunk_carry(40))
            rmon.absorb(rout["tel_carry"], 40)
            _assert_flush_eq(pool.flush("p"), rmon.flush())

    def test_serve_bytes_equal_reference(self):
        """The ledger's ``serve.lanes`` and ``serve.telemetry`` entries, and
        a session's bytes, equal the reference scheduler's."""
        tnet = build_synfire(SYNFIRE4_MINI, policy="fp16", propagation="sparse", device="cpu")
        rnet = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, policy="fp16", propagation="sparse")
        for kw in ({}, {"ledger_key": "k.rung8"}, {"record": "none"}):
            t, r = LaneScheduler(tnet, 8, **kw), rserve.LaneScheduler(rnet, 8, **kw)
            assert tnet.ledger.name_bytes() == rnet.ledger.name_bytes()
            assert tnet.ledger.serve_rung_bytes() == rnet.ledger.serve_rung_bytes()
            assert t.session_bytes == r.session_bytes
            t.close()
            r.close()
        assert tnet.ledger.serve_bytes() == rnet.ledger.serve_bytes() == 0


class TestRecycledLane:
    @pytest.mark.parametrize("leave", ["evict", "export"])
    def test_recycled_lane_is_pristine(self, leave):
        net = _mini("fp16", "packed", plastic=True, homeo=True)
        sched = LaneScheduler(net, 1)
        sched.admit("hot")
        sched.step(80)
        getattr(sched, leave)("hot")
        sched.admit("fresh")
        sched.step(80)
        virgin = LaneScheduler(net, 1)
        virgin.admit("fresh")
        virgin.step(80)
        flush_r, flush_v = sched.flush("fresh"), virgin.flush("fresh")
        assert np.array_equal(flush_r["group_rate"], flush_v["group_rate"]), \
            "recycled lane leaked its predecessor's rate-filter level"
        _assert_flush_eq(flush_r, flush_v)
        _assert_state_eq(sched.evict("fresh").state, virgin.evict("fresh").state)


class TestLedgerRungBytes:
    def test_per_rung_bytes_track_the_occupied_rung(self):
        net = _mini("fp16", "packed")
        lad = CapacityLadder(net, rungs=(1, 8), ledger_prefix="p.")
        lad.admit("t")
        by_rung = net.ledger.serve_rung_bytes()
        assert set(by_rung) == {"p.rung1"} and by_rung["p.rung1"] > 0
        lane_bytes_1 = by_rung["p.rung1"]
        for i in range(3):
            lad.admit(f"f{i}")
        by_rung = net.ledger.serve_rung_bytes()
        assert set(by_rung) == {"p.rung8"}, "old rung must be released"
        assert by_rung["p.rung8"] == 8 * lane_bytes_1

    def test_unkeyed_scheduler_groups_under_empty_key(self):
        net = _mini("fp16", "packed")
        LaneScheduler(net, 2)
        assert net.ledger.serve_rung_bytes()[""] > 0
        assert net.ledger.serve_bytes() >= net.ledger.serve_rung_bytes()[""]


try:
    from hypothesis import given, settings, strategies as st
    _HAS_HYPOTHESIS = True
except ImportError:
    _HAS_HYPOTHESIS = False

if _HAS_HYPOTHESIS:
    _CHURN_NETS = {}

    def _churn_net(kind):
        if kind not in _CHURN_NETS:
            _CHURN_NETS[kind] = (_mini("fp16", "packed", plastic=True) if kind == "plastic"
                                 else _mini("fp32", "sparse"))
        return _CHURN_NETS[kind]

    class TestPoolChurnProperty:
        """Under a random admit/step/evict/flush/migrate schedule over a
        two-topology pool, every surviving tenant's final state equals its
        solo-run oracle; the falsifying ``sched_seed`` replays the
        schedule."""

        CHUNK = 25

        @given(sched_seed=st.integers(min_value=0, max_value=2 ** 31 - 1),
               n_ops=st.integers(min_value=4, max_value=14))
        @settings(max_examples=8, deadline=None, print_blob=True)
        def test_survivors_equal_solo_oracle(self, sched_seed, n_ops):
            rng = np.random.default_rng(sched_seed)
            pool = ServePool(rungs=(1, 8), idle_after=2)
            served, schedule, next_id = {}, [], 0
            for _ in range(n_ops):
                live = pool.session_ids
                sid = "*"
                op = rng.choice(["admit", "step", "evict", "flush", "migrate"])
                if op == "admit" and len(live) < 8:
                    kind = rng.choice(["plastic", "simple"])
                    sid = f"{kind}-{next_id}"
                    next_id += 1
                    pool.admit(_churn_net(kind), sid)
                    served[sid] = 0
                elif op == "step":
                    pool.step(self.CHUNK)
                    for sid in pool.session_ids:
                        served[sid] += 1
                elif op == "evict" and live:
                    sid = live[int(rng.integers(len(live)))]
                    pool.evict(sid)
                    del served[sid]
                elif op == "flush" and live:
                    sid = live[int(rng.integers(len(live)))]
                    pool.flush(sid)
                elif op == "migrate" and live:
                    sid = live[int(rng.integers(len(live)))]
                    pool.restore(pool.network_of(sid), pool.export(sid))
                else:
                    continue
                schedule.append((op, sid))
            for sid in pool.session_ids:
                oracle = Session.create(_churn_net(sid.split("-")[0]), seed=_seed_of(sid))
                for _ in range(served[sid]):
                    oracle.run(self.CHUNK)
                _assert_state_eq(pool.evict(sid).state, oracle.state,
                                 f"survivor {sid} after {schedule} (sched_seed={sched_seed})")


class TestAdmissionPolicy:
    def test_bad_policy_rejected(self):
        with pytest.raises(ValueError, match="admission policy"):
            ServePool(policy="worst_fit")
        with pytest.raises(ValueError, match="bin_lanes"):
            ServePool(policy="best_fit", bin_lanes=0)

    def test_pinned_lane_must_be_free(self):
        sched = LaneScheduler(_mini("fp32", "packed"), 2, record="monitors")
        assert sched.admit("a") == 0
        with pytest.raises(ValueError, match="not free"):
            sched.admit("b", lane=0)
        assert sched.admit("b", lane=1) == 1
        assert sched.lane_sessions == ["a", "b"]

    def test_default_first_fit_unchanged(self):
        net = _mini("fp32", "packed")
        pool = ServePool(rungs=(8,))
        for i in range(5):
            pool.admit(net, f"t{i}")
        pool.evict("t1")
        pool.admit(net, "t5")
        sched = pool.ladder_of("t5").scheduler
        assert sched.lane_sessions[:6] == ["t0", "t5", "t2", "t3", "t4", None]

    def test_best_fit_prefers_fullest_bin(self):
        net = _mini("fp32", "packed")
        pool = ServePool(rungs=(8,), policy="best_fit", bin_lanes=4)
        for i in range(7):
            pool.admit(net, f"t{i}")
        for sid in ("t1", "t2", "t3"):
            pool.evict(sid)
        pool.admit(net, "t7")
        sched = pool.ladder_of("t7").scheduler
        assert sched.lane_sessions == ["t0", None, None, None, "t4", "t5", "t6", "t7"]

    def test_best_fit_activity_tiebreak(self):
        net = _mini("fp32", "packed")
        pool = ServePool(rungs=(8,), policy="best_fit", bin_lanes=4)
        for i in range(5):
            pool.admit(net, f"t{i}")
        for sid in ("t1", "t2", "t3"):
            pool.evict(sid)
        pool._activity.update({"t0": 40.0, "t4": 2.0})
        pool.admit(net, "cool")
        sched = pool.ladder_of("cool").scheduler
        assert sched.lane_sessions[5] == "cool"
        pool.evict("cool")
        pool._activity.update({"t0": 2.0, "t4": 40.0})
        pool.admit(net, "hot")
        assert sched.lane_sessions[1] == "hot"

    def test_flush_feeds_activity_and_evict_clears_it(self):
        net = _mini("fp32", "packed")
        pool = ServePool(rungs=(8,), policy="best_fit")
        pool.admit(net, "t")
        pool.step(50)
        values = pool.flush("t")
        assert pool._activity["t"] == float(np.asarray(values["group_rate"],
                                                       dtype=np.float64).mean())
        assert np.isfinite(pool._activity["t"]) and pool._activity["t"] >= 0.0
        pool.evict("t")
        assert "t" not in pool._activity

    def test_best_fit_streams_match_solo(self):
        net = _mini("fp16", "packed", plastic=True)
        pool = ServePool(rungs=(8,), policy="best_fit", bin_lanes=2)
        for i in range(5):
            pool.admit(net, f"s{i}")
        pool.evict("s1")
        pool.admit(net, "s5")
        pool.step(40)
        pool.step(40)
        for sid in ("s0", "s2", "s3", "s4", "s5"):
            solo = Session.create(net, seed=_seed_of(sid))
            solo.run(40)
            solo.run(40)
            _assert_flush_eq(pool.flush(sid), solo.flush())
            _assert_state_eq(pool.evict(sid).state, solo.state, sid)


def test_scheduler_lane_with_per_chunk_monitors_moves():
    """A scheduler whose monitors include per-chunk kinds (a VoltageProbe and
    a WeightNorm beside SpikeCount) exports, restores and flushes a lane:
    the snapshot holds ``()`` for the per-chunk slots, and the restored
    lane's flush equals its solo session's."""
    from repro_torch.telemetry import SpikeCount, VoltageProbe, WeightNorm

    net = build_synfire(DRIVEN, policy="fp16", propagation="sparse", device="cpu",
                        stdp_chain=CHAIN_STDP, monitors=(
                            SpikeCount(), VoltageProbe(neurons=(3, 3)), WeightNorm(stride=20)))
    a, b = LaneScheduler(net, 2), LaneScheduler(net, 4)
    a.admit("m")
    a.step(40)
    snap = a.export("m")
    assert snap.tel[1] == () and snap.tel[2] == ()
    b.restore(snap)
    b.step(40)
    solo = Session.create(net, seed=_seed_of("m"))
    out = solo.run(40)
    assert out["telemetry"]["vprobe"].shape == (40, 2)
    assert out["telemetry"]["weight_norm"].shape == (2, len(net.static.projections))
    solo.run(40)
    _assert_flush_eq(b.flush("m"), solo.flush())
