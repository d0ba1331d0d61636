"""The SNN under the reference's beyond-paper policies on the CPU: bf16
storage, ``fp16_opt``, ``fp16_sr`` and int8-round-tripped weights, the
port against the reference from the same seed.

bf16 rounds state, ring and weights to 8 significant bits; the reference's
XLA run rounds every bf16 value where the port's eager ops do (its excess
precision changes nothing here: the same bits with
``--xla_allow_excess_precision=false``), so rasters and state are held bit
for bit, bf16 bits compared through an int16 view. ``fp16_opt`` and
``fp16_sr`` store the SNN exactly as ``fp16`` does (the reference's
``compile`` reads only the storage dtypes). Checkpoints hold bf16 leaves
as the reference writes them, raw bits (``|V2``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serve as rserve  # noqa: E402
from repro.configs import synfire4 as rsyn  # noqa: E402
from repro.core import Engine as REngine  # noqa: E402
from repro.core import NetState as RNetState  # noqa: E402
from repro.core import network as rnetwork  # noqa: E402
from repro.core.conductance import COBAConfig as RCOBA  # noqa: E402
from repro.core.engine import run as ref_run  # noqa: E402
from repro.precision import dequantize as jdequantize  # noqa: E402
from repro.precision import quantize_int8 as jquantize  # noqa: E402
from repro_torch.configs import synfire4 as tsyn  # noqa: E402
from repro_torch.core import COBAConfig, Engine, run  # noqa: E402
from repro_torch.core.lanes import lane_state  # noqa: E402
from repro_torch.core.partition import PartitionSpec  # noqa: E402
from repro_torch.precision import dequantize, quantize_int8  # noqa: E402
from repro_torch.serve import LaneScheduler, Session, restore_session, save_session  # noqa: E402

TICKS = 1000
SYNFIRE4_BF16_SPIKES = 25_779  # the reference's bf16 count over 1,000 ticks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def bits(x) -> np.ndarray:
    """A leaf of either package as its raw bits (floats through an integer
    view of their width; a reference key as its words)."""
    if isinstance(x, torch.Tensor):
        if x.is_floating_point():
            x = x.view({2: torch.int16, 4: torch.int32}[x.element_size()])
        return x.numpy()
    if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(x)).view(np.int32)
    a = np.asarray(x)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize]) if a.dtype.kind in "fV" else a


def assert_same_raster(ref, port, what=""):
    ref, port = np.asarray(ref), np.asarray(port)
    assert ref.shape == port.shape
    if not np.array_equal(ref, port):
        first = int(np.argwhere((ref != port).reshape(ref.shape[0], -1).any(axis=1))[0][0])
        pytest.fail(f"{what}: rasters diverge first at tick {first}")


def assert_same_state(rfinal, tfinal, what=""):
    """Tick, key, neuron state, ring, weights, traces and conductances bit
    for bit (every storage dtype compared by its bits)."""
    assert tfinal.t == int(rfinal.t)
    pairs = [("key", rfinal.key, tfinal.key), ("ring", rfinal.ring, tfinal.ring)]
    pairs += list(zip(("v", "u", "refrac"), rfinal.neurons, tfinal.neurons))
    pairs += [(f"weights.{j}", a, b) for j, (a, b) in enumerate(zip(rfinal.weights,
                                                                    tfinal.weights))]
    for j, (a, b) in enumerate(zip(rfinal.stdp, tfinal.stdp)):
        assert (a is None) == (b is None)
        if b is not None:
            pairs += [(f"stdp.{j}.{f}", x, y) for f, x, y in zip(b._fields, a, b)]
    if tfinal.cond is not None:
        pairs += [(f"cond.{f}", x, y) for f, x, y in zip(tfinal.cond._fields, rfinal.cond,
                                                         tfinal.cond)]
    for name, r, t in pairs:
        np.testing.assert_array_equal(bits(t), bits(r), err_msg=f"{what} {name}")


_RUNS: dict = {}


def synfire_runs(policy, propagation, backend=None, *, plastic=False, n_steps=TICKS):
    """(reference final, reference raster, port net, port final, port
    raster) of Synfire4 from the same seed, each on its default generator
    stream; cached per case."""
    key = (policy, propagation, backend, plastic, n_steps)
    if key not in _RUNS:
        kw = dict(policy=policy, propagation=propagation)
        rkw, tkw = dict(kw, monitors=None), dict(kw, device="cpu")
        if backend:
            rkw["backend"] = tkw["backend"] = backend
        if plastic:
            rkw["stdp_chain"], tkw["stdp_chain"] = rsyn.CHAIN_STDP, tsyn.CHAIN_STDP
        rnet = rsyn.build_synfire(rsyn.SYNFIRE4, **rkw)
        tnet = tsyn.build_synfire(tsyn.SYNFIRE4, **tkw)
        rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, n_steps)
        tfinal, tout = run(tnet.static, tnet.params, tnet.state0, n_steps)
        _RUNS[key] = (rfinal, np.asarray(rout["spikes"]), tnet, tfinal,
                      tout["spikes"].numpy())
    return _RUNS[key]


@pytest.mark.parametrize("backend", [None, "fused"], ids=["default", "fused"])
@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_synfire4_bf16_bitwise(propagation, backend):
    """bf16 Synfire4, 1,000 ticks: the reference's raster (25,779 spikes)
    and final state bit for bit, on the default and fused backends; the
    state is bf16."""
    rfinal, rr, tnet, tfinal, tr = synfire_runs("bf16", propagation, backend)
    assert tfinal.neurons.v.dtype == tfinal.ring.dtype == torch.bfloat16
    assert all(w.dtype == torch.bfloat16 for w in tfinal.weights)
    assert_same_raster(rr, tr, f"bf16 {propagation}/{backend}")
    assert int(tr.sum()) == SYNFIRE4_BF16_SPIKES
    assert_same_state(rfinal, tfinal, f"bf16 {propagation}/{backend}")
    if backend == "fused":
        assert tnet.static.fused_kernel


def test_bf16_accuracy_against_fp32():
    """The reference's paper table (``bf16_accuracy_pct``): bf16 against
    fp32 spike counts, at least 0.97 as fp16's."""
    c32 = int(synfire_runs("fp32", "sparse")[4].sum())
    c16 = int(synfire_runs("bf16", "sparse")[4].sum())
    assert min(c16, c32) / max(c16, c32) >= 0.97, (c16, c32)


@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_plastic_synfire4_bf16_bitwise(propagation):
    """Plastic Synfire4 (``CHAIN_STDP``) bf16, 1,000 ticks: raster, state,
    chain weights (bf16) and traces bit for bit against the reference's
    default jitted run."""
    rfinal, rr, tnet, tfinal, tr = synfire_runs("bf16", propagation, plastic=True)
    assert_same_raster(rr, tr, f"plastic bf16 {propagation}")
    assert_same_state(rfinal, tfinal, f"plastic bf16 {propagation}")
    assert any(c is not None for c in tnet.static.stdp)


def _ref_coba(cfg_name, policy, propagation):
    orig = rnetwork.NetworkBuilder.compile

    def compile_coba(self, **ckw):
        return orig(self, conductances=RCOBA(), **ckw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rnetwork.NetworkBuilder, "compile", compile_coba)
        return rsyn.build_synfire(getattr(rsyn, cfg_name), policy=policy,
                                  propagation=propagation)


@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_coba_mini_bf16_bitwise(propagation):
    """COBA Synfire4-mini bf16 (the conductances in bf16), 1,000 ticks:
    raster and state, conductances included, bit for bit."""
    rnet = _ref_coba("SYNFIRE4_MINI", "bf16", propagation)
    tnet = tsyn._synfire_builder(tsyn.SYNFIRE4_MINI).compile(
        policy="bf16", propagation=propagation, conductances=COBAConfig(), device="cpu",
        monitor_ms_hint=1000)
    rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, TICKS)
    tfinal, tout = run(tnet.static, tnet.params, tnet.state0, TICKS)
    assert tfinal.cond.g_ampa.dtype == torch.bfloat16
    assert_same_raster(rout["spikes"], tout["spikes"].numpy(), f"COBA bf16 {propagation}")
    assert_same_state(rfinal, tfinal, f"COBA bf16 {propagation}")


@pytest.mark.parametrize("segments", ["gen_chunk", "gen_base"])
def test_generator_segments_bf16(segments):
    """bf16 Synfire4 sparse over 300 ticks with ``gen_chunk=100`` or
    ``gen_base``: raster and state bit for bit against the reference run
    with the same argument."""
    from repro_torch.core import rng

    rnet = rsyn.build_synfire(rsyn.SYNFIRE4, policy="bf16", propagation="sparse",
                              monitors=None)
    tnet = tsyn.build_synfire(tsyn.SYNFIRE4, policy="bf16", propagation="sparse",
                              device="cpu")
    rkw, tkw = ((dict(gen_chunk=100),) * 2 if segments == "gen_chunk" else
                (dict(gen_base=jax.random.key(7)), dict(gen_base=rng.key(7))))
    rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, 300, **rkw)
    tfinal, tout = run(tnet.static, tnet.params, tnet.state0, 300, **tkw)
    assert int(tout["spikes"].sum()) > 1000
    assert_same_raster(rout["spikes"], tout["spikes"].numpy(), f"bf16 {segments}")
    assert_same_state(rfinal, tfinal, f"bf16 {segments}")


def test_run_batch_bf16_lanes():
    """``run_batch(300, 4)`` bf16 sparse: every lane's raster and state equal
    the reference's ``run_batch``."""
    rnet = rsyn.build_synfire(rsyn.SYNFIRE4, policy="bf16", propagation="sparse", monitors=None)
    tnet = tsyn.build_synfire(tsyn.SYNFIRE4, policy="bf16", propagation="sparse", device="cpu")
    rfinal, rout = REngine(rnet).run_batch(300, 4)
    tfinal, tout = Engine(tnet).run_batch(300, 4)
    assert_same_raster(rout["spikes"], tout["spikes"].numpy(), "bf16 run_batch")
    for name in ("ring", "neurons"):
        for a, b in zip(jax.tree.leaves(getattr(rfinal, name)),
                        (getattr(tfinal, name),) if name == "ring" else getattr(tfinal, name)):
            np.testing.assert_array_equal(bits(b), bits(a), err_msg=name)


def test_scheduler_bf16_lanes_equal_solo_sessions():
    """A bf16 ``LaneScheduler`` (default monitors) runs two lanes over
    three chunks; each equals its own ``Session`` run."""
    net = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="bf16", propagation="sparse",
                             device="cpu")
    sched = LaneScheduler(net, 3)
    sched.admit("a", seed=1)
    sched.admit("b", seed=2)
    for _ in range(3):
        sched.step(40)
    for lane, seed in ((0, 1), (1, 2)):
        solo = Session.create(net, seed=seed)
        solo.run(120, record="none")
        want, got = solo.state, lane_state(sched.states, lane)
        for a, b in ((want.ring, got.ring), *zip(want.neurons, got.neurons)):
            np.testing.assert_array_equal(bits(b), bits(a))


def test_bf16_partition_equals_unpartitioned():
    """bf16 Synfire4 packed cut at ``PartitionSpec(n_cores=2)``, 200 ticks:
    the unpartitioned run bit for bit (6,268 spikes both ways, as the
    reference's)."""
    kw = dict(policy="bf16", propagation="packed", device="cpu", monitors=None)
    cut = tsyn.build_synfire(tsyn.SYNFIRE4, partition=PartitionSpec(n_cores=2), **kw)
    whole = tsyn.build_synfire(tsyn.SYNFIRE4, **kw)
    assert len(cut.partition.cores) == 2
    cf, co = Engine(cut).run(200)
    wf, wo = Engine(whole).run(200)
    assert int(co["spikes"].sum()) == int(wo["spikes"].sum()) == 6268
    assert torch.equal(co["spikes"], wo["spikes"])
    for a, b in ((cf.ring, wf.ring), *zip(cf.neurons, wf.neurons)):
        np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.parametrize("policy", ["fp16_opt", "fp16_sr"])
def test_fp16_variants_are_the_fp16_net(policy):
    """``fp16_opt`` and ``fp16_sr`` compile and run the fp16 net: the same
    storage, ledger, raster and state (the SNN never rounds stochastically:
    ``compile`` reads only the storage dtypes, as the reference's does)."""
    a = tsyn.build_synfire(tsyn.SYNFIRE4, policy=policy, propagation="sparse", device="cpu")
    b = tsyn.build_synfire(tsyn.SYNFIRE4, policy="fp16", propagation="sparse", device="cpu")
    assert a.static.policy_name == policy
    assert a.ledger.rampup_rows() == b.ledger.rampup_rows()
    fa, oa = Engine(a).run(300)
    fb, ob = Engine(b).run(300)
    assert torch.equal(oa["spikes"], ob["spikes"])
    assert fa.neurons.v.dtype == fa.ring.dtype == fa.weights[0].dtype == torch.float16
    for x, y in ((fa.ring, fb.ring), *zip(fa.neurons, fb.neurons), *zip(fa.weights, fb.weights)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("policy", ["fp32", "fp16", "bf16", "fp16_opt", "fp16_sr"])
def test_ledger_stage_bytes_match_reference(policy):
    """Every stage's bytes under every policy equal the reference's (bf16
    and the fp16 variants: 2,171,384 B in all, as fp16)."""
    r = rsyn.build_synfire(rsyn.SYNFIRE4, policy=policy)
    t = tsyn.build_synfire(tsyn.SYNFIRE4, policy=policy, device="cpu")
    assert t.ledger.rampup_rows() == r.ledger.rampup_rows()
    assert t.ledger.total_used == r.ledger.total_used
    if policy != "fp32":
        assert t.ledger.total_used == 2_171_384


def test_monitors_and_watches_bf16():
    """bf16 Synfire4 sparse with the default monitors and watches, 400
    ticks: SpikeCount bit for bit against the reference's jitted run and
    every watch carry equal."""
    rnet = rsyn.build_synfire(rsyn.SYNFIRE4, policy="bf16", propagation="sparse",
                              watches="default")
    tnet = tsyn.build_synfire(tsyn.SYNFIRE4, policy="bf16", propagation="sparse",
                              device="cpu", watches="default")
    _, rout = ref_run(rnet.static, rnet.params, rnet.state0, 400, record="monitors")
    _, tout = run(tnet.static, tnet.params, tnet.state0, 400, record="monitors")
    np.testing.assert_array_equal(tout["telemetry"]["spike_count"].numpy(),
                                  np.asarray(rout["telemetry"]["spike_count"]))
    want = jax.tree.leaves(jax.tree.map(np.asarray, rout["watch_carry"]))
    got = [x.numpy() for slot in tout["watch_carry"] for x in slot]
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


# -- checkpoints ------------------------------------------------------------------------


def test_bf16_session_file_is_the_reference_file(tmp_path):
    """A bf16 session saved by each package: the same leaves, the bf16 ones
    as raw bits (``|V2``, what ``np.asarray`` of a JAX bf16 array writes),
    equal byte for byte."""
    rnet = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, policy="bf16", propagation="sparse",
                              monitors=None)
    tnet = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="bf16", propagation="sparse",
                              device="cpu")
    rsess = rserve.Session.create(rnet, seed=3, monitors=False)
    tsess = Session.create(tnet, seed=3)
    rsess.spike_raster(30)
    tsess.spike_raster(30)
    rpath = rserve.save_session(str(tmp_path / "ref"), rsess)
    tpath = save_session(str(tmp_path / "port"), tsess)
    with np.load(tpath) as t, np.load(rpath) as r:
        assert sorted(t.files) == sorted(r.files)
        v2 = [k for k in r.files if r[k].dtype.str == "|V2"]
        assert "['state']||.neurons||.v" in v2 and "['state']||.ring" in v2
        for k in r.files:
            assert t[k].dtype == r[k].dtype and t[k].shape == r[k].shape, k
            assert t[k].tobytes() == r[k].tobytes(), k


def test_bf16_session_round_trip(tmp_path):
    """The port restores its own bf16 session by the leaves' bits and runs
    on as the uninterrupted session does."""
    net = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="bf16", propagation="packed",
                             device="cpu", stdp_chain=tsyn.CHAIN_STDP)
    a = Session.create(net, seed=4)
    a.run(50, record="none")
    save_session(str(tmp_path), a)
    b = restore_session(str(tmp_path), net)
    for x, y in ((a.state.ring, b.state.ring), *zip(a.state.neurons, b.state.neurons),
                 *zip(a.state.weights, b.state.weights)):
        assert x.dtype == y.dtype and np.array_equal(bits(x), bits(y))
    assert torch.equal(a.spike_raster(40), b.spike_raster(40))
    np.testing.assert_array_equal(bits(a.state.neurons.v), bits(b.state.neurons.v))


def test_reference_cannot_restore_its_bf16_file(tmp_path):
    """Recorded defect of the reference (ROADMAP queue C): its
    ``ckpt.restore`` hands the ``|V2`` leaf to ``jnp.asarray``, which
    refuses it, so neither ``restore_session`` nor ``restore_lane`` reads a
    bf16 file back; the port reads the reference's file."""
    rnet = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, policy="bf16", propagation="sparse",
                              monitors=None)
    tnet = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="bf16", propagation="sparse",
                              device="cpu")
    rsess = rserve.Session.create(rnet, seed=5, monitors=False)
    rsess.spike_raster(20)
    rserve.save_session(str(tmp_path), rsess)
    with pytest.raises(TypeError, match="V2"):
        rserve.restore_session(str(tmp_path), rnet)
    tsess = restore_session(str(tmp_path), tnet)
    np.testing.assert_array_equal(bits(tsess.state.neurons.v), bits(rsess.state.neurons.v))
    np.testing.assert_array_equal(tsess.spike_raster(20).numpy(), rsess.spike_raster(20))


# -- int8 storage (the reference's TestInt8Storage) --------------------------------------


def test_synfire_accuracy_survives_int8():
    """Synfire4 fp32 on weights round-tripped through int8 storage (axis 0),
    1,000 ticks: the port's raster equals the reference's on the reference's
    round-tripped weights, and spike-count accuracy against fp32 is at
    least 0.97 (the reference marks its version slow; the port's run takes
    a second)."""
    rnet = rsyn.build_synfire(rsyn.SYNFIRE4, policy="fp32", monitors=None)
    tnet = tsyn.build_synfire(tsyn.SYNFIRE4, policy="fp32", device="cpu")
    rw = tuple(jdequantize(jquantize(w.astype(jnp.float32), axis=0), jnp.float32)
               for w in rnet.state0.weights)
    tw = tuple(dequantize(quantize_int8(w.float(), axis=0), torch.float32)
               for w in tnet.state0.weights)
    for a, b in zip(rw, tw):
        np.testing.assert_array_equal(bits(b), bits(a))
    rnet.state0 = RNetState(**{**rnet.state0._asdict(), "weights": rw})
    tnet.state0 = tnet.state0._replace(weights=tw)
    _, rout = REngine(rnet).run(TICKS)
    _, tout = Engine(tnet).run(TICKS)
    assert_same_raster(rout["spikes"], tout["spikes"].numpy(), "int8 round trip")
    c8 = int(tout["spikes"].sum())
    c32 = int(synfire_runs("fp32", "packed")[4].sum())
    assert min(c8, c32) / max(c8, c32) >= 0.97, (c8, c32)
