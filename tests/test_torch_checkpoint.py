"""Checkpoints across the packages: ``repro_torch.checkpoint.ckpt`` and
``repro_torch.serve.lifecycle`` write and read the reference's npz format.

The leaf names and dtypes of a session or lane checkpoint are read off
files the reference writes, not guessed. A reference ``save_session``
restored by the port continues bit for bit as the reference continues,
and the port's ``save_session`` and ``save_lane`` restore in the
reference the same way. A missing format stamp, a foreign format, a
truncated file and a missing payload key raise ``CheckpointError`` with
the key the reference names.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import serve as rserve  # noqa: E402
from repro.checkpoint import ckpt as rckpt  # noqa: E402
from repro.configs import synfire4 as rsyn  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import synfire4 as tsyn  # noqa: E402
from repro_torch.core import lane_state, rng  # noqa: E402
from repro_torch.serve import (CheckpointError, LaneScheduler, Session,  # noqa: E402
                               latest_session_step, restore_lane, restore_session,
                               save_lane, save_session)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def nets(policy="fp16", propagation="sparse", plastic=False):
    kw = dict(policy=policy, propagation=propagation)
    rkw, tkw = dict(kw, monitors=None), dict(kw, device="cpu")
    if plastic:
        rkw["stdp_chain"], tkw["stdp_chain"] = rsyn.CHAIN_STDP, tsyn.CHAIN_STDP
    return (rsyn.build_synfire(rsyn.SYNFIRE4_MINI, **rkw),
            tsyn.build_synfire(tsyn.SYNFIRE4_MINI, **tkw))


def key_words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).view(np.int32)


def files(path) -> dict:
    with np.load(path) as data:
        return {k: (data[k].dtype, data[k].shape) for k in data.files}


def assert_states_equal(tstate, rstate):
    """Every leaf of a port state against a reference state, bit for bit."""
    assert tstate.t == int(rstate.t)
    np.testing.assert_array_equal(tstate.key.numpy(), key_words(rstate.key))
    np.testing.assert_array_equal(tstate.ring.numpy(), np.asarray(rstate.ring))
    for a, b in zip(tstate.neurons, rstate.neurons):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tstate.weights, rstate.weights):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tstate.stdp, rstate.stdp):
        assert (a is None) == (b is None)
        if a is not None:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("plastic", [False, True])
def test_session_file_is_the_reference_format(tmp_path, plastic):
    """The same session saved by each package: the same leaf names, dtypes
    and shapes, and the same values."""
    rnet, tnet = nets(plastic=plastic)
    rsess = rserve.Session.create(rnet, seed=3, monitors=False)
    tsess = Session.create(tnet, seed=3)
    rpath = rserve.save_session(str(tmp_path / "ref"), rsess)
    tpath = save_session(str(tmp_path / "port"), tsess)
    assert os.path.basename(rpath) == os.path.basename(tpath) == "step_0000000000.npz"
    assert files(tpath) == files(rpath)
    assert "['state']||.neurons||.v" in files(tpath) and "['gen_key']" in files(tpath)
    assert files(tpath)["['state']||.key"][0] == np.uint32
    with np.load(tpath) as t, np.load(rpath) as r:
        for k in r.files:
            np.testing.assert_array_equal(t[k], r[k], err_msg=k)


@pytest.mark.parametrize("policy,propagation,plastic", [
    ("fp16", "sparse", False), ("fp16", "packed", True), ("fp32", "sparse", False)])
def test_reference_session_resumes_in_the_port(tmp_path, policy, propagation, plastic):
    """The reference saves a session 60 ticks in; the port restores it and
    runs 60 more ticks; the reference continues too: the same raster and
    the same state, bit for bit."""
    rnet, tnet = nets(policy, propagation, plastic)
    rsess = rserve.Session.create(rnet, seed=8, monitors=False)
    rsess.spike_raster(60)
    rserve.save_session(str(tmp_path), rsess)
    tsess = restore_session(str(tmp_path), tnet)
    assert tsess.ticks == 60 and latest_session_step(str(tmp_path)) == 60
    assert_states_equal(tsess.state, rsess.state)
    want = rsess.spike_raster(20)
    np.testing.assert_array_equal(tsess.spike_raster(20).numpy(), want)
    if policy == "fp16" and not plastic:
        assert_states_equal(tsess.state, rsess.state)


@pytest.mark.parametrize("plastic", [False, True])
def test_port_session_resumes_in_the_reference(tmp_path, plastic):
    rnet, tnet = nets(plastic=plastic)
    tsess = Session.create(tnet, seed=9)
    tsess.run(40, record="none")
    save_session(str(tmp_path), tsess, step=7)
    rsess = rserve.restore_session(str(tmp_path), rnet, step=7)
    assert rsess.ticks == 40
    assert_states_equal(tsess.state, rsess.state)
    np.testing.assert_array_equal(tsess.spike_raster(20).numpy(), rsess.spike_raster(20))


def test_lanes_move_across_the_packages(tmp_path):
    """A port lane saved with ``save_lane`` joins a reference scheduler and
    a reference lane joins a port scheduler; each continues as its solo
    session."""
    rnet, tnet = nets()
    tsched = LaneScheduler(tnet, 3, record="none")
    tsched.admit("p", seed=21)
    tsched.step(30)
    save_lane(str(tmp_path / "p"), tsched.export("p"))
    rsched = rserve.LaneScheduler(rnet, 2, record="none")
    rsched.admit("r", seed=22)
    rsched.step(50)
    rserve.save_lane(str(tmp_path / "r"), rsched.export("r"))

    rsched.restore(rserve.restore_lane(str(tmp_path / "p"), rnet))
    snap = restore_lane(str(tmp_path / "r"), tnet)
    assert (snap.session_id, snap.ticks, snap.state.t) == ("r", 50, 50)
    tsched.restore(snap)
    assert files(str(tmp_path / "p" / "step_0000000030.npz")) == files(
        str(tmp_path / "r" / "step_0000000050.npz"))
    rsched.step(40)
    tsched.step(40)
    for sid, seed, ticks in (("p", 21, 70), ("r", 22, 90)):
        solo = Session.create(tnet, seed=seed)
        solo.run(ticks, record="none")
        if sid == "p":
            lane = rsched.lane_of("p")
            got = jax.tree.map(lambda x: x[lane], rsched.states)
            assert_states_equal(solo.state, got)
        else:
            got = lane_state(tsched.states, tsched.lane_of("r"))
            for a, b in ((got.ring, solo.state.ring), *zip(got.neurons, solo.state.neurons)):
                assert torch.equal(a, b)
            assert got.t == solo.state.t == ticks


def _saved(tmp_path):
    rnet, tnet = nets()
    d = str(tmp_path / "ok")
    save_session(d, Session.create(tnet, seed=1))
    return rnet, tnet, d


def _both_fail(tmp_path, rnet, tnet, mutate):
    """The same damaged file through both packages' restore: the port's
    ``CheckpointError`` names the reference's key."""
    errs = []
    for pkg, net in ((rserve, rnet), (None, tnet)):
        d = str(tmp_path / f"bad-{len(errs)}")
        shutil.copytree(str(tmp_path / "ok"), d)
        mutate(os.path.join(d, "step_0000000000.npz"))
        if pkg is None:
            with pytest.raises(CheckpointError) as e:
                restore_session(d, net)
        else:
            with pytest.raises(pkg.CheckpointError) as e:
                pkg.restore_session(d, net)
        errs.append(e.value)
    assert errs[1].key == errs[0].key and errs[1].path.endswith("step_0000000000.npz")
    return errs[1]


def _rewrite(path, drop=(), **change):
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files if k not in drop}
    arrays.update(change)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def test_missing_stamp_raises(tmp_path):
    err = _both_fail(tmp_path, *_saved(tmp_path)[:2], lambda p: _rewrite(p, drop=("['fmt']",)))
    assert err.key == "fmt" and "format stamp" in str(err)


def test_wrong_format_raises(tmp_path):
    err = _both_fail(tmp_path, *_saved(tmp_path)[:2],
                     lambda p: _rewrite(p, **{"['fmt']": np.int32(2)}))
    assert err.key == "fmt" and "unsupported checkpoint format 2" in str(err)


def test_truncated_file_raises(tmp_path):
    def truncate(path):
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)

    err = _both_fail(tmp_path, *_saved(tmp_path)[:2], truncate)
    assert err.key is None and "corrupt or truncated" in str(err)


def test_missing_key_raises(tmp_path):
    err = _both_fail(tmp_path, *_saved(tmp_path)[:2],
                     lambda p: _rewrite(p, drop=("['state']||.ring",)))
    assert "['state']||.ring" in err.key


def test_telemetry_in_a_file_is_not_restored(tmp_path):
    """Session telemetry is ported (A6), so a file's accumulators are
    restored now: a session saved after a monitored chunk, with counts
    written into its file, comes back with those counts and its flush
    counter, and flushes them."""
    _, tnet = nets()
    sess = Session.create(tnet, seed=1)
    sess.run(30)
    d = str(tmp_path / "tel")
    path = save_session(d, sess)
    counts = np.arange(tnet.static.n, dtype=np.int32)
    assert files(path)["['tel']||[0]"] == (np.int32, (tnet.static.n,))
    _rewrite(path, **{"['tel']||[0]": counts})
    back = restore_session(d, tnet)
    np.testing.assert_array_equal(back.monitors.carry[0].numpy(), counts)
    assert torch.equal(back.monitors.carry[1], sess.monitors.carry[1])
    flushed = back.flush()
    assert flushed["n_ticks"] == 30
    assert flushed["spike_count"].tolist() == [
        int(counts[g.start:g.start + g.size].sum()) for g in tnet.static.groups]


def _monitored_nets(policy="fp16", propagation="sparse"):
    kw = dict(policy=policy, propagation=propagation)
    return (rsyn.build_synfire(rsyn.SYNFIRE4_MINI, **kw),
            tsyn.build_synfire(tsyn.SYNFIRE4_MINI, device="cpu", **kw))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_session_telemetry_crosses_packages(tmp_path, writer):
    """A monitored session saved by one package after two chunks (one
    flush between them) restores in the other with its accumulators and
    flush counter bit for bit: the next flush of both equals, and both
    sessions continue to the same next flush."""
    rnet, tnet = _monitored_nets()
    rsess = rserve.Session.create(rnet, seed=7)
    tsess = Session.create(tnet, seed=7)
    for sess in (rsess, tsess):
        sess.run(40)
        sess.flush()
        sess.run(40)
    d = str(tmp_path / writer)
    if writer == "reference":
        rserve.save_session(d, rsess)
        moved, source = restore_session(d, tnet), rsess
        assert torch.equal(moved.monitors.carry[0],
                           torch.from_numpy(np.array(rsess.monitors.carry[0])))
    else:
        save_session(d, tsess)
        moved, source = rserve.restore_session(d, rnet), tsess
        np.testing.assert_array_equal(np.asarray(moved.monitors.carry[0]),
                                      tsess.monitors.carry[0].numpy())
        np.testing.assert_array_equal(np.asarray(moved.monitors.carry[1]),
                                      tsess.monitors.carry[1].numpy())
    assert moved.monitors.ticks_since_flush == source.monitors.ticks_since_flush == 40
    a, b = moved.flush(), source.flush()
    assert a["n_ticks"] == b["n_ticks"] == 40
    np.testing.assert_array_equal(np.asarray(a["spike_count"]), np.asarray(b["spike_count"]))
    np.testing.assert_array_equal(np.asarray(a["group_rate"]), np.asarray(b["group_rate"]))


def test_lane_telemetry_crosses_packages(tmp_path):
    """A monitored scheduler lane exported after two chunks: the reference
    restores the port's lane file with its cumulative slots and flush
    counter, and the port the reference's."""
    rnet, tnet = _monitored_nets()
    tsched, rsched = LaneScheduler(tnet, 2), rserve.LaneScheduler(rnet, 2)
    for sched in (tsched, rsched):
        sched.admit("x", seed=4)
        sched.step(40)
        sched.step(40)
    save_lane(str(tmp_path / "t"), tsched.export("x"))
    rserve.save_lane(str(tmp_path / "r"), rsched.export("x"))
    from_port = rserve.restore_lane(str(tmp_path / "t"), rnet)
    from_ref = restore_lane(str(tmp_path / "r"), tnet)
    assert from_port.ticks_since_flush == from_ref.ticks_since_flush == 80
    np.testing.assert_array_equal(np.asarray(from_port.tel[0]), from_ref.tel[0].numpy())
    assert from_port.tel[0].dtype == np.int32 and from_ref.tel[1].dtype == torch.float32
    again = LaneScheduler(tnet, 2)
    again.restore(from_ref)
    flushed = again.flush("x")
    assert flushed["n_ticks"] == 80
    np.testing.assert_array_equal(flushed["spike_count"],
                                  np.asarray(rsched_flush(rnet, from_port)["spike_count"]))


def rsched_flush(rnet, snap) -> dict:
    """The reference scheduler's flush of a restored lane snapshot."""
    sched = rserve.LaneScheduler(rnet, 2)
    sched.restore(snap)
    return sched.flush(snap.session_id)


def test_restore_without_checkpoints_raises(tmp_path):
    _, tnet = nets()
    with pytest.raises(FileNotFoundError):
        restore_session(str(tmp_path / "none"), tnet)
    with pytest.raises(FileNotFoundError):
        restore_lane(str(tmp_path / "none"), tnet)


def test_ckpt_round_trip_and_retention(tmp_path):
    """``ckpt.save``/``restore`` on a tree of tensors, numpy arrays and
    numbers (the reference's own ``ckpt.restore`` reads the file), and
    ``save_every``'s retention."""
    tree = {"b": (torch.arange(3, dtype=torch.int16), None, ()),
            "a": {"w": torch.ones(2, 2, dtype=torch.float16), "n": np.float32(2.5)},
            "k": rng.key(4)}
    path = ckpt.save(str(tmp_path), 5, tree)
    assert sorted(files(path)) == ["['a']||['n']", "['a']||['w']", "['b']||[0]", "['k']"]
    back = ckpt.restore(str(tmp_path), 5, tree)
    assert torch.equal(back["b"][0], tree["b"][0]) and back["b"][1:] == (None, ())
    assert back["a"]["w"].dtype == torch.float16 and float(back["a"]["n"]) == 2.5
    like = {"a": {"n": np.float32(0), "w": np.zeros((2, 2), np.float16)},
            "b": (np.zeros(3, np.int16), None, ()), "k": np.zeros(2, np.int32)}
    rback = rckpt.restore(str(tmp_path), 5, like)
    np.testing.assert_array_equal(np.asarray(rback["k"]), tree["k"].numpy())
    for step in range(0, 50, 10):
        ckpt.save_every(str(tmp_path / "every"), step, tree, interval=20, keep_last=2)
    assert ckpt.latest_step(str(tmp_path / "every")) == 40
    assert sorted(os.listdir(tmp_path / "every")) == ["step_0000000020.npz",
                                                      "step_0000000040.npz"]
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
