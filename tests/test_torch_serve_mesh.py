"""The mesh-sharded lane axis of the port's serving plane
(``LaneScheduler(mesh=)``, ``CapacityLadder(mesh=)``, ``ServePool(mesh=)``)
on a device list of four CPU entries, the counterpart of the reference's
four forced host devices (``tests/test_serve_pool.py``,
``TestShardedLaneParity``).

Each lane block ticks on its mesh entry through launchers of its own, with
no exchange: every lane's state, flush, watch carry and lane checkpoint
equal the unsharded scheduler's bit for bit, and the reference's unsharded
scheduler's (its chunks compiled at ``xla_backend_optimization_level=0``
where its default jit contracts a mul+add, ROADMAP queue C).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import serve as rserve  # noqa: E402
from repro.configs import synfire4 as rsyn  # noqa: E402
from repro.serve import scheduler as rscheduler  # noqa: E402
from repro_torch.configs import synfire4 as tsyn  # noqa: E402
from repro_torch.core import lane_state  # noqa: E402
from repro_torch.core.distributed import lane_mesh  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    CapacityLadder,
    LaneScheduler,
    ServePool,
    restore_lane,
    save_lane,
)

OPT0 = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def mesh4():
    return lane_mesh(devices=["cpu"] * 4)


def mini(plastic=False, ref=False, hz=None, **kw):
    syn = rsyn if ref else tsyn
    cfg = syn.SYNFIRE4_MINI if hz is None else dataclasses.replace(syn.SYNFIRE4_MINI,
                                                                   stim_rate_hz=hz)
    if plastic:
        kw["stdp_chain"] = syn.CHAIN_STDP
    if not ref:
        kw["device"] = "cpu"
    return syn.build_synfire(cfg, policy="fp16", propagation="sparse", **kw)


def _leaves(state):
    out = [("ring", state.ring), ("key", state.key)]
    out += [(f"neurons.{f}", getattr(state.neurons, f)) for f in state.neurons._fields]
    out += [(f"weights.{j}", w) for j, w in enumerate(state.weights)]
    for j, tr in enumerate(state.stdp):
        if tr is not None:
            out += [(f"stdp.{j}.{f}", getattr(tr, f)) for f in tr._fields]
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if jax.dtypes.issubdtype(getattr(x, "dtype", np.float32), jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(x)).view(np.int32)
    return np.asarray(x)


def assert_states(a, b):
    assert tuple(a.t) == tuple(int(t) for t in b.t)
    for (name, x), (_, y) in zip(_leaves(a), _leaves(b)):
        x, y = _np(x), _np(y)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name


def assert_flushes(a, b):
    assert a.keys() == b.keys()
    for sid in a:
        assert a[sid].keys() == b[sid].keys()
        for k in a[sid]:
            np.testing.assert_array_equal(np.asarray(a[sid][k]), np.asarray(b[sid][k]),
                                          err_msg=f"{sid}.{k}")


def _opt0(monkeypatch):
    step = rscheduler._step_lanes

    def step_opt0(static, params, states, keys, active, n_ticks, record, **kw):
        return step.lower(static, params, states, keys, active, n_ticks, record,
                          **kw).compile(compiler_options=OPT0)(params, states, keys, active,
                                                               **kw)

    monkeypatch.setattr(rscheduler, "_step_lanes", step_opt0)


class TestShardedScheduler:
    def test_plastic_mini_equals_unsharded(self):
        """The reference's case: plastic Synfire4-mini fp16 sparse at 60 Hz,
        8 lanes on 4 mesh entries, two 50-tick chunks; states and flushes
        equal the unsharded scheduler's."""
        net = mini(plastic=True, hz=60.0)

        def drive(mesh):
            s = LaneScheduler(net, 8, mesh=mesh)
            for i in range(8):
                s.admit(f"t{i}")
            s.step(50)
            s.step(50)
            return s.states, s.flush_all()

        st_m, fl_m = drive(mesh4())
        st_1, fl_1 = drive(None)
        assert_states(st_m, st_1)
        assert_flushes(fl_m, fl_1)

    def test_waves_watches_and_lane_checkpoints(self, tmp_path):
        """Admits in waves at different ticks, an evict, a re-admit, the
        default watches and a lane checkpoint out of the sharded scheduler
        into the unsharded one: every lane, watch verdict and flush
        agrees."""
        net = mini(watches="default")
        scheds = [LaneScheduler(net, 8, mesh=mesh4()), LaneScheduler(net, 8)]
        for s in scheds:
            s.admit("a", seed=1)
            s.step(30)
            s.admit("b", seed=2, lane=5)
            s.step(20)
            s.evict("a")
            s.admit("c", lane=7)
            s.step(30)
        sharded, single = scheds
        assert sharded.lane_sessions == single.lane_sessions
        assert_states(sharded.states, single.states)
        for a, b in zip(sharded._watch, single._watch):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
        assert sharded.check_watches() == single.check_watches()
        snap = sharded.export("b")
        save_lane(str(tmp_path / "lane"), snap)
        single.export("b")
        assert single.restore(restore_lane(str(tmp_path / "lane"), net)) == \
            sharded.restore(snap)
        for s in scheds:
            s.step(20)
        assert_states(sharded.states, single.states)
        assert_flushes(sharded.flush_all(), single.flush_all())

    def test_equals_reference_scheduler(self, monkeypatch):
        """Every lane of the sharded port scheduler, idle ones too, and its
        flushes equal the reference's unsharded scheduler's."""
        _opt0(monkeypatch)
        rs = rserve.LaneScheduler(mini(ref=True), 4)
        ts = LaneScheduler(mini(), 4, mesh=lane_mesh(devices=["cpu"] * 2))
        flushes = []
        for s in (rs, ts):
            s.admit("a", seed=1)
            s.step(30)
            s.admit("b", seed=2)
            s.step(20)
            flushes.append(s.flush_all())
        for lane in range(4):
            r = jax.tree.map(lambda x, i=lane: x[i], rs.states)
            t = lane_state(ts.states, lane)
            assert t.t == int(r.t)
            for (name, x), (_, y) in zip(_leaves(t), _leaves(r)):
                assert _np(x).tobytes() == _np(y).tobytes(), (lane, name)
        assert_flushes(flushes[1], flushes[0])

    def test_mesh_errors(self):
        net = mini()
        with pytest.raises(ValueError, match="multiple of the mesh axis size"):
            LaneScheduler(net, 6, mesh=mesh4())
        with pytest.raises(ValueError, match="no axis"):
            LaneScheduler(net, 8, mesh=mesh4(), mesh_axis="cores")
        rnet = mini(ref=True)
        from repro.core.distributed import lane_mesh as rlane_mesh
        with pytest.raises(ValueError, match="no axis"):
            rserve.LaneScheduler(rnet, 1, mesh=rlane_mesh(1), mesh_axis="cores")


class TestShardedPool:
    def test_ladder_rungs_below_the_mesh_run_unsharded(self):
        net = mini()
        ladders = (CapacityLadder(net, mesh=mesh4()), CapacityLadder(net))
        for lad in ladders:
            lad.admit("x", seed=3)
            lad.step(20)
        assert ladders[0].rung == 1 and ladders[0].scheduler.mesh is None
        for lad in ladders:
            for i in range(4):
                lad.admit(f"y{i}", seed=10 + i)
            lad.step(20)
        assert ladders[0].rung == 8 and ladders[0].scheduler.mesh is not None
        assert ladders[0].scheduler._blocks[1][1:] == (2, 4)
        assert_states(ladders[0].scheduler.states, ladders[1].scheduler.states)

    def test_pool_passes_the_mesh(self):
        net = mini()
        pools = (ServePool(mesh=mesh4()), ServePool())
        for pool in pools:
            for i in range(3):
                pool.admit(net, f"s{i}")
            pool.step(25)
        sched = pools[0].ladder_of("s0").scheduler
        assert sched.capacity == 8 and sched.mesh is not None
        assert sched.mesh.shape == {"lanes": 4}
        assert_states(sched.states, pools[1].ladder_of("s0").scheduler.states)
        assert_flushes({s: pools[0].flush(s) for s in ("s0", "s1", "s2")},
                       {s: pools[1].flush(s) for s in ("s0", "s1", "s2")})
