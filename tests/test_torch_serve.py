"""Serving on the port (``repro_torch.serve``): sessions and the lane
scheduler, on the CPU against the reference's ``repro.serve``.

A session advanced in k chunks equals one ``Engine.run(gen_base=...)``
bit for bit (``tests/test_serve.py:61-118``), and the port's ``Session``
equals the reference's chunk by chunk. The scheduler mirrors
``tests/test_serve.py:213-335`` with final states where the reference
reads flushed telemetry (telemetry is ROADMAP A6): a lane equals a solo
session, an evicted lane resumes bit for bit, idle lanes stay silent, the
admit/evict errors, the ledger's bytes, 64 tenants static and plastic,
lanes at different ticks, and every lane of ``sched.states``, idle ones
included, equal to the reference scheduler's.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import serve as rserve  # noqa: E402
from repro.serve import scheduler as rscheduler  # noqa: E402
from repro.configs import synfire4 as rsyn  # noqa: E402
from repro.core.engine import run as ref_run  # noqa: E402
from repro.core.plasticity import HomeostasisConfig as RHomeo  # noqa: E402
from repro_torch.configs import synfire4 as tsyn  # noqa: E402
from repro_torch.core import Engine, lane_state, rng  # noqa: E402
from repro_torch.core.distributed import lane_mesh  # noqa: E402
from repro_torch.core.plasticity import HomeostasisConfig  # noqa: E402
from repro_torch.serve import LaneScheduler, LaneSnapshot, Session  # noqa: E402

HOMEO = dict(target_hz=8.0, tau_avg_ms=500.0, beta=1.0)
OPT0 = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def key_words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).view(np.int32)


def mini(policy="fp16", propagation="sparse", plastic=False, homeo=False, ref=False,
         **kw):
    """Synfire4-mini in the port (or, with ``ref``, the reference, compiled
    without monitors); ``plastic``: CHAIN_STDP; ``homeo``: homeostasis on
    the chain every 40 ticks."""
    syn = rsyn if ref else tsyn
    if plastic:
        kw["stdp_chain"] = syn.CHAIN_STDP
    if homeo:
        kw.update(homeo_chain=(RHomeo if ref else HomeostasisConfig)(**HOMEO),
                  homeostasis_period=40)
    if ref:
        kw.setdefault("monitors", None)
    else:
        kw["device"] = "cpu"
    return syn.build_synfire(syn.SYNFIRE4_MINI, policy=policy, propagation=propagation, **kw)


def state_leaves(state):
    """(name, numpy) for every leaf of a NetState of either package."""
    out = [("t", np.asarray(state.t)), ("ring", np.asarray(state.ring))]
    key = state.key
    out.append(("key", key.numpy() if isinstance(key, torch.Tensor) else key_words(key)))
    out += [(f"neurons.{f}", np.asarray(getattr(state.neurons, f)))
            for f in state.neurons._fields]
    out += [(f"weights.{j}", np.asarray(w)) for j, w in enumerate(state.weights)]
    out += [(f"homeo.{j}", np.asarray(h)) for j, h in enumerate(state.homeo) if h is not None]
    for j, tr in enumerate(state.stdp):
        if tr is not None:
            out += [(f"stdp.{j}.{f}", np.asarray(getattr(tr, f))) for f in tr._fields]
    return out


def assert_same_state(a, b):
    la, lb = state_leaves(a), state_leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(x, y, err_msg=name)


def as_np_state(state):
    """A port state's tensors as numpy (for :func:`state_leaves`)."""
    return state._replace(
        ring=state.ring.numpy(), neurons=type(state.neurons)(*(x.numpy() for x in state.neurons)),
        weights=tuple(w.numpy() for w in state.weights),
        homeo=tuple(None if h is None else h.numpy() for h in state.homeo),
        stdp=tuple(None if s is None else type(s)(*(x.numpy() for x in s)) for s in state.stdp))


# -- sessions ------------------------------------------------------------------


class TestSession:
    @pytest.mark.parametrize("policy,propagation,plastic", [
        ("fp16", "sparse", False), ("fp32", "packed", False), ("fp16", "auto", False),
        ("fp16", "sparse", True), ("fp32", "packed", True)])
    def test_chunks_equal_one_run(self, policy, propagation, plastic):
        """k chunks of a session equal one ``Engine.run(gen_base=)``: raster
        and final state bit for bit (plastic: homeostasis every 40 ticks on
        40-tick chunks)."""
        net = mini(policy, propagation, plastic=plastic, homeo=plastic)
        key = rng.key(11)
        whole, out = Engine(net).run(120, gen_base=key)
        sess = Session.create(net, key=key, monitors=False)
        parts = [sess.spike_raster(40) for _ in range(3)]
        assert torch.equal(torch.cat(parts), out["spikes"]) and int(out["spikes"].sum()) > 0
        assert sess.ticks == 120
        assert_same_state(as_np_state(whole), as_np_state(sess.state))

    def test_session_equals_reference_session_chunk_by_chunk(self):
        """The port's session and the reference's, over the same key, chunk
        by chunk: rasters and states bit for bit."""
        rsess = rserve.Session.create(mini(ref=True), seed=5, monitors=False)
        tsess = Session.create(mini(), seed=5)
        assert np.array_equal(tsess.gen_key.numpy(), key_words(rsess.gen_key))
        for _ in range(3):
            np.testing.assert_array_equal(tsess.spike_raster(40).numpy(),
                                          rsess.spike_raster(40))
            assert_same_state(as_np_state(tsess.state), rsess.state)
        assert tsess.ticks == rsess.ticks == 120

    def test_plastic_session_equals_reference_chunks(self):
        """A plastic session with homeostasis every 40 ticks, chunk by
        chunk, against the reference session's chunks (``run(40,
        gen_base=key)`` on the threaded state) compiled at
        ``xla_backend_optimization_level=0``: the default jit contracts the
        STDP trace step's mul+add into an FMA, one f32 ulp off in a trace
        (ROADMAP queue C). Rasters, weights, traces, rates and state bit for
        bit."""
        rnet = mini(plastic=True, homeo=True, ref=True)
        key = jax.random.key(5)
        chunk = ref_run.lower(rnet.static, rnet.params, rnet.state0, 40,
                              gen_base=key).compile(compiler_options=OPT0)
        tsess = Session.create(mini(plastic=True, homeo=True), seed=5)
        rstate = rnet.state0
        for _ in range(3):
            rstate, rout = chunk(rnet.params, rstate, gen_base=key)
            np.testing.assert_array_equal(tsess.spike_raster(40).numpy(),
                                          np.asarray(rout["spikes"]))
            assert_same_state(as_np_state(tsess.state), rstate)

    def test_unported_modes_raise(self):
        """The monitor modes are ported (A6): the reference's default
        ``record="monitors"`` and ``"both"`` keep the session's telemetry,
        and every flush equals the reference session's (spike counts bit for
        bit; filter levels bit for bit against its chunks compiled at opt
        level 0); a session without monitors cannot flush. Watchpoints are
        ported (A10): over a net without watches ``check_watches`` is the
        reference's ValueError, and over one with them it drains the
        session's carry."""
        rnet = mini(ref=True, monitors="default")
        key = jax.random.key(5)
        chunk = ref_run.lower(rnet.static, rnet.params, rnet.state0, 40, gen_base=key,
                              record="monitors", return_tel_carry=True,
                              tel_carry=rserve.SessionMonitors(rnet.static).chunk_carry(40)
                              ).compile(compiler_options=OPT0)
        rmon = rserve.SessionMonitors(rnet.static)
        rstate = rnet.state0
        sess = Session.create(mini(), seed=5)
        for record in ("monitors", "both", "monitors"):
            out = sess.run(40, record=record)
            assert ("spikes" in out) == (record == "both") and "telemetry" in out
            rstate, rout = chunk(rnet.params, rstate, gen_base=key,
                                 tel_carry=rmon.chunk_carry(40))
            rmon.absorb(rout["tel_carry"], 40)
            got, want = sess.flush(), rmon.flush()
            assert got.keys() == want.keys() and got["n_ticks"] == 40
            for name in ("spike_count", "group_rate"):
                np.testing.assert_array_equal(got[name], np.asarray(want[name]), name)
        with pytest.raises(ValueError, match="without watches"):
            sess.check_watches()
        watched = Session.create(mini(watches="default"), seed=5)
        assert watched.check_watches() == []
        watched.run(40)
        verdicts = watched.check_watches()
        assert [v.watch for v in verdicts] == ["nonfinite", "rate_band", "silent"]
        assert int(watched.watch_carry[1][1]) == 0  # the drained window restarts
        bare = Session.create(mini(), monitors=False)
        with pytest.raises(ValueError, match="monitors"):
            bare.flush()
        with pytest.raises(ValueError, match="monitors"):
            bare.run(10)
        with pytest.raises(ValueError, match="mutually exclusive"):
            sess.run(100, record="none", gen_chunk=50)

    def test_chunk_misaligned_with_homeostasis_period_raises(self):
        sess = Session.create(mini(plastic=True, homeo=True))
        with pytest.raises(ValueError, match="homeostasis"):
            sess.run(30, record="raster")  # the period is 40

    def test_from_snapshot_continues_the_lane(self):
        net = mini()
        sched = LaneScheduler(net, 2, record="none")
        sched.admit("a", seed=3)
        sched.step(60)
        sess = Session.from_snapshot(net, sched.snapshot("a"))
        assert sess.ticks == 60
        sched.step(40)
        sess.run(40, record="none")
        assert_same_state(as_np_state(sess.state),
                          as_np_state(lane_state(sched.states, 0)))


# -- the lane scheduler --------------------------------------------------------


def solo_state(net, seed, ticks, state=None, key=None, spikes=False):
    """The state (and, with ``spikes``, the spike count) of a solo session
    after ``ticks``."""
    sess = Session.create(net, seed=seed, key=key, state=state)
    out = sess.run(ticks, record="raster")
    return (sess.state, int(out["spikes"].sum())) if spikes else sess.state


class TestLaneScheduler:
    @pytest.mark.parametrize("propagation", ["sparse", "packed"])
    def test_lane_equals_solo_session_bitwise(self, propagation):
        net = mini(propagation=propagation)
        sched = LaneScheduler(net, capacity=3, record="none")
        sched.admit("a", key=rng.key(1))
        sched.admit("b", key=rng.key(2))
        for _ in range(3):
            sched.step(40)
        for lane, seed in ((0, 1), (1, 2)):
            want, fired = solo_state(net, seed, 120, spikes=True)
            assert_same_state(as_np_state(lane_state(sched.states, lane)), as_np_state(want))
            assert fired > 0

    @pytest.mark.parametrize("plastic", [False, True])
    def test_every_lane_equals_the_reference_scheduler(self, plastic, monkeypatch):
        """Waves of admits at different ticks, an evict and a re-admit: every
        lane of ``states``, the idle ones too, equals the reference
        scheduler's, bit for bit. The reference's chunk is compiled at
        ``xla_backend_optimization_level=0`` for the plastic net (its
        default jit contracts the STDP trace step's mul+add, ROADMAP queue
        C)."""
        if plastic:
            step = rscheduler._step_lanes

            def step_opt0(static, params, states, keys, active, n_ticks, record, **kw):
                return step.lower(static, params, states, keys, active, n_ticks, record,
                                  **kw).compile(compiler_options=OPT0)(
                    params, states, keys, active, **kw)

            monkeypatch.setattr(rscheduler, "_step_lanes", step_opt0)
        scheds = (rserve.LaneScheduler(mini(plastic=plastic, ref=True), 4, record="none"),
                  LaneScheduler(mini(plastic=plastic), 4, record="none"))
        for s in scheds:
            s.admit("a", seed=1)
            s.step(30)
            s.admit("b", seed=2)
            s.step(20)
            s.evict("a")
            s.admit("c")
            s.step(30)
        rs, ts = scheds
        assert ts.lane_sessions == rs.lane_sessions == ["c", "b", None, None]
        np.testing.assert_array_equal(ts.gen_keys.numpy(), key_words(rs.gen_keys))
        np.testing.assert_array_equal(ts.active.numpy(), np.asarray(rs.active))
        for lane in range(4):
            r = jax.tree.map(lambda x, i=lane: x[i], rs.states)
            assert_same_state(as_np_state(lane_state(ts.states, lane)), r)

    @pytest.mark.parametrize("plastic", [False, True])
    def test_flushes_equal_the_reference_scheduler(self, plastic, monkeypatch):
        """Under the reference's default ``record="monitors"``: waves of
        admits at different ticks, flushes between chunks, an evict (its
        final flush), a re-admit into the recycled lane and an
        export/restore: every flush equals the reference scheduler's bit for
        bit, spike counts, filter levels and ticks, its chunks compiled at
        ``xla_backend_optimization_level=0`` (the default jit contracts the
        GroupRate fold, ROADMAP queue C); the serve bytes are equal."""
        step = rscheduler._step_lanes

        def step_opt0(static, params, states, keys, active, n_ticks, record, **kw):
            return step.lower(static, params, states, keys, active, n_ticks, record,
                              **kw).compile(compiler_options=OPT0)(
                params, states, keys, active, **kw)

        monkeypatch.setattr(rscheduler, "_step_lanes", step_opt0)
        rnet = mini(plastic=plastic, ref=True, monitors="default")
        tnet = mini(plastic=plastic)
        flushes = []
        for sched in (rserve.LaneScheduler(rnet, 4), LaneScheduler(tnet, 4)):
            out = []
            sched.admit("a", seed=1)
            sched.step(30)
            sched.admit("b", seed=2)
            sched.step(20)
            out.append(sched.flush("a"))
            out.append(sched.evict("a").flush)
            sched.admit("c")
            sched.step(30)
            sched.restore(sched.export("b"))
            sched.step(20)
            out += [sched.flush_all()[sid] for sid in ("b", "c")]
            flushes.append(out)
        assert tnet.ledger.serve_bytes() == rnet.ledger.serve_bytes()
        for want, got in zip(*flushes):
            assert got.keys() == want.keys() and got["n_ticks"] == want["n_ticks"]
            for name in ("spike_count", "group_rate"):
                np.testing.assert_array_equal(got[name], np.asarray(want[name]), name)

    def test_evict_resumes_bitwise_as_solo(self):
        net = mini()
        sched = LaneScheduler(net, capacity=2, record="none")
        sched.admit("a", key=rng.key(7))
        sched.step(60)
        ev = sched.evict("a")
        assert sched.occupancy == 0 and ev.flush is None
        assert torch.equal(ev.gen_key, rng.key(7))
        resumed = Session.create(net, key=ev.gen_key, state=ev.state)
        solo = Session.create(net, key=rng.key(7))
        solo.run(60, record="none")
        assert torch.equal(resumed.spike_raster(60), solo.spike_raster(60))

    def test_idle_lanes_are_silent(self):
        """Idle lanes draw no generator spike: they emit no spike, so their
        rings stay empty, while the admitted lane's fills."""
        net = mini()
        sched = LaneScheduler(net, capacity=4, record="none")
        sched.admit("only", key=rng.key(3))
        sched.step(50)
        ring = sched.states.ring.float().abs().sum(dim=(1, 2, 3))
        assert float(ring[1:].sum()) == 0
        want, fired = solo_state(net, 0, 50, key=rng.key(3), spikes=True)
        assert fired > 0
        assert_same_state(as_np_state(lane_state(sched.states, 0)), as_np_state(want))

    def test_admit_evict_readmit_cycle(self):
        sched = LaneScheduler(mini(), capacity=2, record="none")
        a = sched.admit("a", seed=1)
        b = sched.admit("b", seed=2)
        assert {a, b} == {0, 1} and sched.free_lanes == []
        with pytest.raises(RuntimeError, match="full"):
            sched.admit("c", seed=3)
        sched.evict("a")
        with pytest.raises(ValueError, match="already admitted"):
            sched.admit("b", seed=9)
        with pytest.raises(ValueError, match="not free"):
            sched.admit("c", lane=1)
        c = sched.admit("c", seed=3)
        assert c == a and sched.occupancy == 2 and sched.session_ids == ["c", "b"]
        assert sched.lane_of("b") == 1
        with pytest.raises(KeyError):
            sched.evict("a")  # evicted: no longer addressable
        with pytest.raises(KeyError):
            sched.lane_of("a")

    def test_default_seed_is_crc32_of_the_session_id(self):
        sched = LaneScheduler(mini(), capacity=1, record="none")
        sched.admit("tenant-7")
        assert torch.equal(sched.gen_keys[0], rng.key(zlib.crc32(b"tenant-7")))

    def test_ledger_registration_and_session_bytes(self):
        """The lanes' bytes under stage "8. Serve Lanes", the reference's
        per-session bytes, and a second scheduler replaces the first's
        registration."""
        net = mini()
        before = net.ledger.total_used
        sched = LaneScheduler(net, capacity=8, record="none")
        assert net.ledger.serve_bytes() == sched.session_bytes * 8 > 0
        assert net.ledger.total_used == before + net.ledger.serve_bytes()
        stages = net.ledger.stage_bytes()
        assert "8. Serve Lanes" in stages
        LaneScheduler(net, capacity=8, record="none")
        assert net.ledger.stage_bytes()["8. Serve Lanes"] == stages["8. Serve Lanes"]
        keyed = LaneScheduler(net, capacity=2, record="none", ledger_key="rung2")
        assert net.ledger.serve_rung_bytes() == {"": stages["8. Serve Lanes"],
                                                  "rung2": keyed.session_bytes * 2}
        keyed.close()
        assert net.ledger.serve_rung_bytes() == {"": stages["8. Serve Lanes"]}
        rsched = rserve.LaneScheduler(mini(ref=True), 8, record="none")
        assert sched.session_bytes == rsched.session_bytes

    @pytest.mark.parametrize("plastic", [False, True])
    def test_64_sessions(self, plastic):
        """64 mini tenants in two chunks: every tenant's wave ignites, and
        with plasticity each lane's weights evolve on their own."""
        net = mini(plastic=plastic)
        sched = LaneScheduler(net, capacity=64, record="none")
        for i in range(64):
            sched.admit(f"t{i}", seed=i)
        sched.step(50)
        sched.step(50)
        assert sched.occupancy == 64 and sched.session_bytes > 0
        assert bool((sched.states.neurons.v != net.state0.neurons.v).any(dim=1).all())
        if plastic:
            j = next(j for j, s in enumerate(net.static.projections) if s.plastic)
            w = sched.states.weights[j]
            assert not torch.equal(w[0], w[1])
            want = solo_state(net, 17, 100)
            assert torch.equal(w[17], want.weights[j])

    def test_lanes_at_different_ticks_equal_solo_sessions(self):
        """Tenants admitted at ticks 0, 30 and 70 and one re-admitted from an
        evicted state: each equals its solo session over its own ticks."""
        net = mini(propagation="packed")
        sched = LaneScheduler(net, capacity=5, record="none")
        sched.admit("a", seed=1)
        sched.step(30)
        sched.admit("b", seed=2)
        sched.step(40)
        sched.admit("c", seed=3)
        ev = sched.evict("a")
        sched.admit("a2", key=ev.gen_key, state=ev.state)
        sched.step(50)
        assert len({t % net.static.ring_len for t in sched.states.t}) > 2
        for sid, seed, ticks in (("a2", 1, 120), ("b", 2, 90), ("c", 3, 50)):
            got = lane_state(sched.states, sched.lane_of(sid))
            assert got.t == ticks
            assert_same_state(as_np_state(got), as_np_state(solo_state(net, seed, ticks)))

    @pytest.mark.parametrize("propagation", ["sparse", "packed"])
    def test_lane_admitted_with_weights_of_its_own(self, propagation, monkeypatch):
        """The scheduler builds its propagation launchers once: a chunk
        builds no gather plan and decodes no weights. A tenant admitted
        after the first chunk with weights of its own runs on them and
        equals its solo session; a tenant re-admitted into the lane it
        freed runs on the net's weights again."""
        net = mini(propagation=propagation)
        sched = LaneScheduler(net, capacity=3, record="none")
        sched.admit("a", seed=1)
        sched.step(30)
        own = net.state0._replace(weights=tuple((w.float() * 1.25).to(w.dtype)
                                                for w in net.state0.weights))
        lane = sched.admit("b", seed=2, state=own)
        built = []
        from repro_torch.core import backend

        for name in ("assemble_packed", "assemble_gather", "assemble_matmul"):
            monkeypatch.setattr(backend, name, lambda *a, _n=name, **k: built.append(_n))
        sched.step(40)
        monkeypatch.undo()
        assert built == []
        got = lane_state(sched.states, lane)
        assert_same_state(as_np_state(got), as_np_state(solo_state(net, 2, 40, state=own)))
        sched.evict("b")
        assert sched.admit("c", seed=3) == lane
        sched.step(30)
        for sid, seed, ticks in (("a", 1, 100), ("c", 3, 30)):
            got = lane_state(sched.states, sched.lane_of(sid))
            assert_same_state(as_np_state(got), as_np_state(solo_state(net, seed, ticks)))

    def test_export_restore_into_another_scheduler(self):
        net = mini()
        big = LaneScheduler(net, capacity=6, record="none", ledger_key="big")
        small = LaneScheduler(net, capacity=2, record="none", ledger_key="small")
        big.admit("x", seed=4)
        big.admit("y", seed=5)
        big.step(40)
        snaps = big.export_all()
        assert [s.session_id for s in snaps] == ["x", "y"] and big.occupancy == 0
        assert isinstance(snaps[0], LaneSnapshot) and snaps[0].ticks == 40
        for s in snaps:
            small.restore(s)
        small.step(60)
        for sid, seed in (("x", 4), ("y", 5)):
            got = lane_state(small.states, small.lane_of(sid))
            assert_same_state(as_np_state(got), as_np_state(solo_state(net, seed, 100)))

    def test_unported_options_raise(self):
        """The reference's default, ``record="monitors"``, is ported (A6):
        its flushes equal solo sessions'. The mesh (A11) is ported: a lane
        mesh whose size does not divide the capacity is the reference's
        ValueError, and one that does shards the lanes. The
        flight recorder, watchpoints and quarantine are ported (A10): a
        flight window keeps the last chunk boundaries, ``check_watches``
        over a net without watches is the reference's ValueError, and
        ``quarantine`` frees the lane with its evidence."""
        net = mini()
        sched = LaneScheduler(net, capacity=2)
        assert sched.record == "monitors"
        sched.admit("m", seed=3)
        sched.step(40)
        sess = Session.create(net, seed=3)
        sess.run(40)
        got, want = sched.flush("m"), sess.flush()
        for name in ("spike_count", "group_rate", "n_ticks"):
            np.testing.assert_array_equal(got[name], want[name], name)
        with pytest.raises(ValueError, match="compiled with monitors"):
            LaneScheduler(mini(monitors=None), capacity=2)
        with pytest.raises(ValueError, match="multiple of the mesh axis size"):
            LaneScheduler(net, capacity=2, record="none",
                          mesh=lane_mesh(devices=["cpu"] * 4))
        assert LaneScheduler(net, capacity=2, record="none",
                             mesh=lane_mesh(devices=["cpu"] * 2))._blocks[1][1:] == (1, 2)
        recorder = LaneScheduler(net, capacity=2, record="none", flight_window=3)
        recorder.admit("f", seed=3)
        for _ in range(4):
            recorder.step(10)
        assert [s.ticks for s in recorder.flight("f")] == [20, 30, 40]
        with pytest.raises(ValueError, match="raster"):
            LaneScheduler(net, capacity=2, record="raster")
        with pytest.raises(ValueError, match="capacity"):
            LaneScheduler(net, capacity=0, record="none")
        sched = LaneScheduler(net, capacity=2, record="none")
        sched.admit("a", seed=0)
        with pytest.raises(ValueError, match="record='none'"):
            sched.flush("a")
        with pytest.raises(ValueError, match="without watches"):
            sched.check_watches()
        q = sched.quarantine("a")
        assert q.session_id == "a" and q.verdicts == () and q.recording == ()
        assert sched.session_ids == [] and q.snapshot.ticks == 0
