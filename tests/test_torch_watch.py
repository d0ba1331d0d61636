"""In-run watchpoints, the flight recorder, quarantine and replay on the port
(``repro_torch.obs.watch`` and the serving plane's watch surface), on the
CPU against the reference's ``repro.obs.watch`` and ``repro.serve``.

Mirrors ``tests/test_watch.py`` and holds the port against the reference:

* watch carries equal to the reference's jitted run bit for bit (integer
  carries leave nothing to round), the kernel's slot fold equal to the
  reference's plain fold, chunked sessions included;
* ``WeightDrift`` norms at rtol 1e-6 (WeightNorm's sum order, ROADMAP
  queue C) with ``tripped`` equal, and ``drain``'s verdicts equal in
  ``tripped``, ``value``, ``limit`` and ``detail``;
* watches are pure reads: rasters, state and weights bitwise equal with
  watches compiled in or out;
* a NaN-poisoned fp16 lane found within one chunk and quarantined, the
  survivors equal to a fleet never poisoned; flight replays bit for bit;
  quarantine dumps bounded and restorable by either package.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import serve as rserve  # noqa: E402
from repro.configs import synfire4 as rsyn  # noqa: E402
from repro.core.engine import run as ref_run  # noqa: E402
from repro.core.plasticity import HomeostasisConfig as RHomeo  # noqa: E402
from repro.obs import watch as rwat  # noqa: E402
from repro_torch import obs, serve  # noqa: E402
from repro_torch.configs import synfire4 as tsyn  # noqa: E402
from repro_torch.core import backend as be  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.core.engine import Engine, run, run_batch  # noqa: E402
from repro_torch.core.lanes import lane_state, set_lane  # noqa: E402
from repro_torch.core.plasticity import HomeostasisConfig  # noqa: E402
from repro_torch.kernels.ref import watch_fold_ref  # noqa: E402
from repro_torch.obs import watch as wat  # noqa: E402
from repro_torch.obs.health import PASS, WARN, watch_check  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402

OPT0 = {"xla_backend_optimization_level": 0}
MODES = [("packed", None), ("sparse", None), ("auto", None),
         ("packed", "fused"), ("sparse", "fused"), ("auto", "fused")]
HOMEO = dict(target_hz=8.0, tau_avg_ms=500.0, beta=1.0)


def _driven(syn):
    # Sustained stimulus keeps the chain spiking, so plasticity and the rate
    # accumulators keep moving: a watch bug cannot hide behind silence.
    return dataclasses.replace(syn.SYNFIRE4_MINI, stim_rate_hz=60.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mini(policy="fp16", prop="packed", backend=None, *, plastic=False, homeo=False,
          watches=None, ref=False, cfg=None, **kw):
    """Driven Synfire4-mini (or ``cfg``) in the port, or with ``ref`` the
    reference (compiled without monitors unless given)."""
    syn = rsyn if ref else tsyn
    if plastic:
        kw["stdp_chain"] = syn.CHAIN_STDP
    if plastic and homeo:
        kw.update(homeo_chain=(RHomeo if ref else HomeostasisConfig)(**HOMEO),
                  homeostasis_period=40)
    if ref:
        kw.setdefault("monitors", None)
        backend = backend or "xla"
    else:
        kw["device"] = "cpu"
    cfg = _driven(syn) if cfg is None else getattr(syn, cfg)
    return syn.build_synfire(cfg, policy=policy, propagation=prop, backend=backend,
                             watches=watches, **kw)


def _np(x):
    """A leaf of either package as numpy (a reference key as the port's
    int32 words)."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "dtype") and jax.numpy.issubdtype(x.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(x)).view(np.int32)
    return np.asarray(x)


def _assert_carry_eq(got, want, what="carry"):
    """Two watch carries (either package) equal slot for slot, bit for bit."""
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), f"{what} slot {k}"
        for j, (x, y) in enumerate(zip(g, w)):
            x, y = _np(x), _np(y)
            assert x.dtype == y.dtype and x.shape == y.shape, f"{what} {k}.{j}"
            assert x.tobytes() == y.tobytes(), f"{what} {k}.{j}: {x} vs {y}"


def _leaves(state):
    out = [np.int32(state.t), _np(state.ring), _np(state.key)]
    out += [_np(x) for x in state.neurons]
    out += [_np(w) for w in state.weights]
    out += [_np(h) for h in state.homeo if h is not None]
    for tr in state.stdp:
        if tr is not None:
            out += [_np(x) for x in tr]
    return out


def _assert_state_eq(a, b, what="state"):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.tobytes() == y.tobytes(), f"{what}: leaf {i} differs"


def _poison(sched, session_id, neuron=40, value=float("nan")):
    """Write ``value`` into the tenant's membrane in place (lane surgery)."""
    lane = sched.lane_of(session_id)
    st = lane_state(sched.states, lane)
    st.neurons.v[neuron] = value
    sched.states = set_lane(sched.states, lane, st)


# ---------------------------------------------------------------------------
# Spec resolution and validation
# ---------------------------------------------------------------------------

class TestResolve:
    def test_default_set(self):
        specs = wat.resolve("default", n=10, n_projections=2)
        assert tuple(s.name for s in specs) == ("nonfinite", "rate_band", "silent")
        assert [dataclasses.asdict(s) for s in specs] == [
            dataclasses.asdict(s) for s in rwat.resolve("default", n=10, n_projections=2)]

    def test_none_is_empty(self):
        assert wat.resolve(None, n=10, n_projections=2) == ()

    def test_single_spec_wraps(self):
        assert len(wat.resolve(wat.Silent(window=10), n=10, n_projections=2)) == 1

    def test_duplicate_names_rejected(self):
        with pytest.raises(ValueError, match="duplicate"):
            wat.resolve((wat.Silent(), wat.Silent()), n=10, n_projections=2)

    @pytest.mark.parametrize("spec", [
        wat.NonFinite(weight_stride=0), wat.RateBand(lo_hz=50.0, hi_hz=10.0),
        wat.WeightDrift(limit=0.0), wat.Silent(window=0)])
    def test_bad_params_rejected(self, spec):
        with pytest.raises(ValueError):
            wat.resolve(spec, n=10, n_projections=2)

    def test_drift_baseline_length_must_match(self):
        with pytest.raises(ValueError, match="baseline"):
            wat.resolve(wat.WeightDrift(), n=10, n_projections=2, baseline_norms=(1.0,))

    def test_unknown_string_rejected(self):
        with pytest.raises(ValueError):
            wat.resolve("everything", n=10, n_projections=2)

    def test_compile_fills_drift_baseline(self):
        """The baselines are ``state0``'s L2 norms, as the reference's
        compile fills them (rtol 1e-6: WeightNorm's sum order)."""
        net = _mini("fp32", watches=(wat.WeightDrift(limit=0.5),))
        rnet = _mini("fp32", watches=(rwat.WeightDrift(limit=0.5),), ref=True)
        (spec,), (rspec,) = net.static.watches, rnet.static.watches
        assert len(spec.baseline) == len(net.state0.weights)
        assert all(b > 0 for b in spec.baseline)
        np.testing.assert_allclose(spec.baseline, rspec.baseline, rtol=1e-6)

    def test_compile_registers_watch_bytes(self):
        """``monitor.watch`` in the ledger at the reference's bytes; the
        watch-free ledger is the reference's too."""
        for watches in (None, "default", (wat.WeightDrift(), wat.NonFinite())):
            rw = watches if not isinstance(watches, tuple) else (rwat.WeightDrift(),
                                                                 rwat.NonFinite())
            got = _mini(watches=watches).ledger.name_bytes()
            want = _mini(watches=rw, ref=True, monitors="default").ledger.name_bytes()
            assert got.get("monitor.watch") == want.get("monitor.watch")
            assert got.get("monitor.watch", 0) == (0 if watches is None else {
                "default": 8 + 4 * 186 + 4 + 8}.get(watches, 4 * 13 + 8))


# ---------------------------------------------------------------------------
# Drain semantics on synthetic carries
# ---------------------------------------------------------------------------

def _drain_both(watches, rwatches, carry):
    """Drain one carry through both packages; the verdicts must agree field
    for field."""
    net, rnet = _mini("fp32", watches=watches), _mini("fp32", watches=rwatches, ref=True)
    got, reset = wat.drain(net.static, tuple(tuple(torch.as_tensor(x) for x in c)
                                             for c in carry))
    want, rreset = rwat.drain(rnet.static, carry)
    assert [v.as_dict() for v in got] == [v.as_dict() for v in want]
    _assert_carry_eq(reset, rreset, "reset")
    return got, reset


class TestDrain:
    def test_nonfinite_trips_and_resets(self):
        (v,), reset = _drain_both((wat.NonFinite(),), (rwat.NonFinite(),),
                                  ((np.int32(3), np.int32(0)),))
        assert v.watch == "nonfinite" and v.tripped and v.value == 3.0
        assert int(reset[0][0]) == 0  # the window restarts clean

    def test_rate_band_high_trips(self):
        n = 186
        (v,), reset = _drain_both((wat.RateBand(lo_hz=0.0, hi_hz=20.0),),
                                  (rwat.RateBand(lo_hz=0.0, hi_hz=20.0),),
                                  ((np.full(n, 100, np.int32), np.int32(100)),))
        assert v.tripped and v.value > 20.0
        assert int(reset[0][1]) == 0  # the tick window resets

    def test_rate_band_low_and_in_band(self):
        n = 186
        counts = np.arange(n, dtype=np.int32) % 3
        for lo in (0.0, 20.0):
            _drain_both((wat.RateBand(lo_hz=lo, hi_hz=900.0),),
                        (rwat.RateBand(lo_hz=lo, hi_hz=900.0),), ((counts, np.int32(50)),))

    def test_silent_trips_at_window(self):
        (v,), reset = _drain_both((wat.Silent(window=50),), (rwat.Silent(window=50),),
                                  ((np.int32(60), np.int32(60)),))
        assert v.tripped and v.value == 60.0
        assert int(reset[0][0]) == 60  # the running silence is a level

    def test_weight_drift_verdict(self):
        net = _mini("fp32", watches=(wat.WeightDrift(limit=0.1),))
        base = np.asarray(net.static.watches[0].baseline, np.float32)
        norms = base * np.float32(1.25)
        rbase = tuple(float(b) for b in base)
        (v,), reset = _drain_both((wat.WeightDrift(limit=0.1, baseline=rbase),),
                                  (rwat.WeightDrift(limit=0.1, baseline=rbase),), ((norms,),))
        assert v.tripped and v.value == pytest.approx(0.25, rel=1e-6)
        np.testing.assert_array_equal(_np(reset[0][0]), norms)  # a level: kept

    def test_untripped_verdicts_are_reported_too(self):
        net = _mini("fp32", watches="default")
        verdicts, _ = wat.drain(net.static, wat.init_carry(net.static))
        assert len(verdicts) >= 3
        assert not any(v.tripped for v in verdicts)
        assert {"watch", "kind", "tripped", "value", "limit"} <= set(verdicts[0].as_dict())


# ---------------------------------------------------------------------------
# Carries against the reference, and the kernel slot fold against the plain one
# ---------------------------------------------------------------------------

def _ref_carry(rnet, ticks, **kw):
    _, out = ref_run(rnet.static, rnet.params, rnet.state0, ticks, record="none", **kw)
    return jax.tree.map(np.asarray, out["watch_carry"])


def _carry_parity(cfg, policy, prop, backend, ticks=1000):
    """The port's CPU run and the reference's jitted run from the same
    seed: watch carries bit for bit (the integer carries leave nothing to
    round; fp32 too, though the jit's FMAs move membranes by an ulp)."""
    tnet = _mini(policy, prop, backend, watches="default", cfg=cfg)
    rnet = _mini(policy, prop, backend, watches="default", ref=True, cfg=cfg)
    _, out = run(tnet.static, tnet.params, tnet.state0, ticks, record="none")
    _assert_carry_eq(out["watch_carry"], _ref_carry(rnet, ticks),
                     f"{cfg} {policy}/{prop}/{backend}")
    assert int(out["watch_carry"][1][0].sum()) > 0
    return out["watch_carry"]


class TestKernelWords:
    @pytest.mark.parametrize("lanes", [None, 3])
    def test_words_fold_equals_update(self, lanes):
        """The kernels' words (``kernel_words``, folded by
        ``watch_fold_ref`` as the CUDA kernels fold them, back through
        ``carry_from_words``) equal the reference's plain fold tick by tick,
        from arbitrary carries: a lane that never spikes, a lane that spikes
        at step 0, a lane whose membrane goes NaN, one whose fp16 membrane
        is inf."""
        g = torch.Generator().manual_seed(3)
        lead = () if lanes is None else (lanes,)
        n, ticks = 40, 25
        net = _mini(watches=(wat.NonFinite(), wat.Silent()))
        static = dataclasses.replace(net.static, n=n, stdp=(None,) * len(net.static.stdp))
        spikes = torch.rand((ticks, *lead, n), generator=g) < 0.02
        v = (torch.rand((ticks, *lead, n), generator=g) * 60 - 70).to(torch.float16)
        if lanes:
            spikes[:, 0] = False  # silent throughout
            spikes[0, 1, 3] = True  # a spike at step 0
            v[7:, 2, 5] = float("nan")
            v[11, 1, 9] = float("inf")
        else:
            spikes[:12] = False
            v[4, 2] = float("-inf")
        carry = tuple(tuple(torch.randint(0, 30, lead, generator=g, dtype=torch.int32)
                            for _ in range(2)) for _ in range(2))
        want = carry
        for i in range(ticks):
            want = wat.update(static, want, i, spikes[i], v[i], ())
        words = [wat.kernel_words(s, c) for s, c in zip(static.watches, carry)]
        for i in range(ticks):
            watch_fold_ref(i, spikes[i], v[i], w_bad=words[0], w_silent=words[1])
        got = tuple(wat.carry_from_words(s, w, c, ticks)
                    for s, w, c in zip(static.watches, words, carry))
        _assert_carry_eq((got[0][:1], got[1]), (want[0][:1], want[1]), "words vs update")


class TestCarryParity:
    def test_mini_fp16_sparse_default(self):
        _carry_parity("SYNFIRE4_MINI", "fp16", "sparse", None, ticks=500)

    def test_synfire4_fp32_packed_fused(self):
        _carry_parity("SYNFIRE4", "fp32", "packed", "fused", ticks=300)

    def test_plain_fold_equals_kernel_slots(self, monkeypatch):
        """The per-op neuron phase (no ``NeuronRun``: every watch folds as
        plain ops) gives the kernel route's carry bit for bit, and so does
        the reference's plain ``update`` tick by tick."""
        net = _mini("fp16", "sparse", watches=(wat.NonFinite(), wat.RateBand(),
                                               wat.Silent(), wat.Silent(window=9, name="s2")))
        key = rng.key(4)
        _, kern = run(net.static, net.params, net.state0, 200, gen_base=key, record="raster")
        monkeypatch.setattr(be, "assemble_neurons", lambda *a, **k: None)
        _, plain = run(net.static, net.params, net.state0, 200, gen_base=key, record="raster")
        _assert_carry_eq(kern["watch_carry"], plain["watch_carry"], "kernel vs plain")
        carry = wat.init_carry(net.static)
        v_rows = run(net.static, net.params, net.state0, 200, gen_base=key, record_v=True)[1]
        for i in range(200):
            carry = wat.update(net.static, carry, i, kern["spikes"][i],
                               v_rows["v"][i].to(torch.float16), net.state0.weights)
        _assert_carry_eq(kern["watch_carry"], carry, "kernel vs update")

    def test_rk4_net_folds_plainly(self):
        """A net without a neuron kernel (RK4) against the reference."""
        tnet = _mini("fp16", "packed", method="rk4", watches="default")
        rnet = _mini("fp16", "packed", method="rk4", watches="default", ref=True)
        _, out = run(tnet.static, tnet.params, tnet.state0, 300, record="none")
        _assert_carry_eq(out["watch_carry"], _ref_carry(rnet, 300), "rk4")

    def test_chunked_carry_resumes(self):
        """Three 40-tick chunks threading ``watch_carry`` equal one 120-tick
        run, and equal the reference's chunks."""
        net = _mini("fp16", "sparse", watches="default")
        rnet = _mini("fp16", "sparse", watches="default", ref=True)
        key, rkey = rng.key(7), jax.random.key(7)
        _, whole = run(net.static, net.params, net.state0, 120, gen_base=key, record="none")
        state, carry = net.state0, None
        rstate, rcarry = rnet.state0, None
        for _ in range(3):
            state, out = run(net.static, net.params, state, 40, gen_base=key, record="none",
                             watch_carry=carry)
            carry = out["watch_carry"]
            rstate, rout = ref_run(rnet.static, rnet.params, rstate, 40, gen_base=rkey,
                                   record="none", watch_carry=rcarry)
            rcarry = rout["watch_carry"]
            _assert_carry_eq(carry, jax.tree.map(np.asarray, rcarry), "chunk")
        _assert_carry_eq(carry, whole["watch_carry"], "chunks vs whole")

    def test_carry_from_numpy_and_caller_values_kept(self):
        """A reference-style carry (numpy scalars) resumes, and the caller's
        tensors are left as they were."""
        net = _mini("fp16", "packed", watches="default")
        mine = wat.init_carry(net.static)
        before = [x.clone() for c in mine for x in c]
        _, a = run(net.static, net.params, net.state0, 30, watch_carry=mine, record="none")
        assert all(torch.equal(x, y) for x, y in zip(before, (x for c in mine for x in c)))
        rcarry = jax.tree.map(np.asarray, rwat.init_carry(
            _mini("fp16", "packed", watches="default", ref=True).static))
        _, b = run(net.static, net.params, net.state0, 30, watch_carry=rcarry, record="none")
        _assert_carry_eq(a["watch_carry"], b["watch_carry"])
        with pytest.raises(ValueError, match="watch_carry"):
            run(net.static, net.params, net.state0, 30, watch_carry=((),), record="none")

    def test_run_batch_lanes_equal_solo_runs(self):
        """``run_batch`` returns ``[B, ...]`` carries, each lane its solo
        run's (the batched route and the fused route)."""
        for backend in (None, "fused"):
            net = _mini("fp16", "sparse", backend, watches="default")
            _, out = run_batch(net.static, net.params, net.state0, 60, 3, record="none")
            keys = rng.split(net.state0.key, 3)
            for b in range(3):
                _, solo = run(net.static, net.params, net.state0._replace(key=keys[b]), 60,
                              record="none")
                _assert_carry_eq(tuple(tuple(x[b] for x in c) for c in out["watch_carry"]),
                                 solo["watch_carry"], f"lane {b}")

    def test_strides_count_the_local_step(self):
        """A plastic net with ``NonFinite(weight_stride=30)`` and
        ``WeightDrift(stride=30)`` against the reference's opt-level-0 run:
        counts equal, norms at rtol 1e-6 with ``tripped`` equal; two chunks
        of 45 check the weights at local steps 0 and 30 of each."""
        specs = (wat.NonFinite(weight_stride=30), wat.WeightDrift(limit=0.01, stride=30))
        rspecs = (rwat.NonFinite(weight_stride=30), rwat.WeightDrift(limit=0.01, stride=30))
        net = _mini("fp16", "sparse", plastic=True, watches=specs)
        rnet = _mini("fp16", "sparse", plastic=True, watches=rspecs, ref=True)
        key, rkey = rng.key(2), jax.random.key(2)
        state, carry, rstate, rcarry = net.state0, None, rnet.state0, None
        step = ref_run.lower(rnet.static, rnet.params, rnet.state0, 45, gen_base=rkey,
                             record="none", watch_carry=rwat.init_carry(rnet.static)
                             ).compile(compiler_options=OPT0)
        for _ in range(2):
            state, out = run(net.static, net.params, state, 45, gen_base=key, record="none",
                             watch_carry=carry)
            carry = out["watch_carry"]
            rstate, rout = step(rnet.params, rstate, gen_base=rkey,
                                watch_carry=rcarry if rcarry is not None
                                else rwat.init_carry(rnet.static))
            rcarry = rout["watch_carry"]
        want = jax.tree.map(np.asarray, rcarry)
        _assert_carry_eq(carry[:1], want[:1], "nonfinite")
        assert int(carry[0][1]) == 0 and int(carry[0][0]) == 0
        np.testing.assert_allclose(_np(carry[1][0]), want[1][0], rtol=1e-6)
        got_v, _ = wat.drain(net.static, carry)
        want_v, _ = rwat.drain(rnet.static, want)
        assert [v.tripped for v in got_v] == [v.tripped for v in want_v]
        assert got_v[1].value == pytest.approx(want_v[1].value, abs=1e-5)

    def test_nonfinite_weights_counted_on_stride(self):
        """A NaN'd plastic weight counts once per strided check."""
        net = _mini("fp16", "sparse", plastic=True,
                    watches=(wat.NonFinite(weight_stride=25),))
        j = next(j for j, c in enumerate(net.static.stdp) if c is not None)
        w = net.state0.weights[j].clone()
        w.view(-1)[0] = float("nan")
        weights = list(net.state0.weights)
        weights[j] = w
        _, out = run(net.static, net.params, net.state0._replace(weights=tuple(weights)), 100,
                     record="none")
        bad_v, bad_w = out["watch_carry"][0]
        assert int(bad_w) == 4  # local steps 0, 25, 50, 75


@pytest.mark.slow
class TestCarryParityMatrix:
    @pytest.mark.parametrize("backend", [None, "fused"], ids=["default", "fused"])
    @pytest.mark.parametrize("prop", ["packed", "sparse"])
    @pytest.mark.parametrize("policy", ["fp16", "fp32"])
    @pytest.mark.parametrize("cfg", ["SYNFIRE4_MINI", "SYNFIRE4"])
    def test_carry(self, cfg, policy, prop, backend):
        _carry_parity(cfg, policy, prop, backend)


# ---------------------------------------------------------------------------
# Watches are pure reads
# ---------------------------------------------------------------------------

def _parity(policy, prop, backend, *, plastic, homeo, T=120):
    base = _mini(policy, prop, backend, plastic=plastic, homeo=homeo)
    watched = _mini(policy, prop, backend, plastic=plastic, homeo=homeo, watches="default")
    s0, o0 = Engine(base).run(T, record="both")
    s1, o1 = Engine(watched).run(T, record="both")
    wc = o1.pop("watch_carry")
    assert torch.equal(o0["spikes"], o1["spikes"]), "raster differs"
    for k in o0["telemetry"]:
        assert torch.equal(o0["telemetry"][k], o1["telemetry"][k]), k
    _assert_state_eq(s0, s1, f"{policy}/{prop}/{backend}")
    verdicts, _ = wat.drain(watched.static, wc)
    assert not any(v.tripped for v in verdicts if v.watch == "nonfinite")


class TestWatchParityFast:
    def test_fp16_plastic_packed_default(self):
        _parity("fp16", "packed", None, plastic=True, homeo=False)

    def test_fp32_homeo_sparse_fused(self):
        _parity("fp32", "sparse", "fused", plastic=True, homeo=True)

    def test_fp16_static_sparse_fused(self):
        _parity("fp16", "sparse", "fused", plastic=False, homeo=False)


@pytest.mark.slow
class TestWatchParityMatrix:
    @pytest.mark.parametrize("prop,backend", MODES)
    @pytest.mark.parametrize("policy", ["fp32", "fp16"])
    @pytest.mark.parametrize("plastic,homeo", [(False, False), (True, False), (True, True)])
    def test_parity(self, prop, backend, policy, plastic, homeo):
        _parity(policy, prop, backend, plastic=plastic, homeo=homeo)


# ---------------------------------------------------------------------------
# Solo sessions
# ---------------------------------------------------------------------------

class TestSessionWatch:
    def test_check_watches_requires_watches(self):
        s = serve.Session.create(_mini("fp32"))
        with pytest.raises(ValueError, match="without watches"):
            s.check_watches()

    def test_check_before_first_chunk_is_empty(self):
        s = serve.Session.create(_mini("fp32", watches="default"))
        assert s.check_watches() == []

    def test_carry_threads_across_chunks(self):
        net = _mini("fp32", watches=(wat.RateBand(lo_hz=0.0, hi_hz=1000.0),))
        s = serve.Session.create(net, seed=5)
        s.run(40)
        t1 = int(s.watch_carry[0][1])
        s.run(40)
        t2 = int(s.watch_carry[0][1])
        assert (t1, t2) == (40, 80)  # accumulates, never resets mid-run
        assert len(s.check_watches()) == 1
        assert int(s.watch_carry[0][1]) == 0  # drained

    def test_session_verdicts_equal_reference_session(self):
        """The port's session and the reference's, chunk by chunk and drain
        by drain: the same verdicts, and solo trips counted under
        ``rung="solo"``."""
        obs.configure(enabled=True, reset=True)
        specs = (wat.NonFinite(), wat.RateBand(hi_hz=30.0), wat.Silent(window=60))
        rspecs = (rwat.NonFinite(), rwat.RateBand(hi_hz=30.0), rwat.Silent(window=60))
        sess = serve.Session.create(_mini(watches=specs), seed=3)
        rsess = rserve.Session.create(_mini(watches=rspecs, ref=True), seed=3, monitors=False)
        trips = 0
        for _ in range(3):
            sess.run(100, record="none")
            rsess.run(100, record="none")
            got, want = sess.check_watches(), rsess.check_watches()
            assert [v.as_dict() for v in got] == [v.as_dict() for v in want]
            trips += sum(v.tripped for v in got)
        assert trips > 0
        counter = obs.registry().counter("repro_watch_trips_total")
        assert sum(v for k, v in counter.series().items() if ("rung", "solo") in k) == trips


# ---------------------------------------------------------------------------
# Fleet detection and quarantine: the survivors must not notice
# ---------------------------------------------------------------------------

class TestDetectionAndQuarantine:
    CHUNK = 40
    TENANTS = 4

    def _fleet(self, net, flight_window=0):
        sched = serve.LaneScheduler(net, self.TENANTS, flight_window=flight_window)
        for i in range(self.TENANTS):
            sched.admit(f"t{i}", seed=i)
        return sched

    @pytest.mark.parametrize("backend,value", [(None, float("nan")), ("fused", 70000.0)],
                             ids=["nan-default", "overflow-fused"])
    def test_poisoned_fp16_lane_detected_within_one_chunk(self, backend, value):
        """A NaN'd membrane (and, on the fused tick, one pushed past fp16's
        65,504: stored as inf, so non-finite) trips ``nonfinite`` in one
        chunk; after quarantine the survivors equal a fleet never
        poisoned."""
        net = _mini("fp16", "packed", backend, watches="default")
        live = self._fleet(net, flight_window=2)
        clean = self._fleet(net)
        for _ in range(2):
            live.step(self.CHUNK)
            clean.step(self.CHUNK)
        assert live.check_watches() == {}
        _poison(live, "t1", value=value)
        live.step(self.CHUNK)  # one chunk with the poison in place
        clean.step(self.CHUNK)
        alerts = live.check_watches()
        assert set(alerts) == {"t1"}
        assert any(v.watch == "nonfinite" and v.tripped for v in alerts["t1"])
        q = live.quarantine("t1", alerts["t1"])
        assert q.session_id == "t1" and len(q.recording) == 2
        assert live.session_ids == ["t0", "t2", "t3"]
        for sid in ("t0", "t2", "t3"):
            _assert_state_eq(live.snapshot(sid).state, clean.snapshot(sid).state, sid)
        live.step(self.CHUNK)
        clean.step(self.CHUNK)
        for sid in ("t0", "t2", "t3"):
            _assert_state_eq(live.snapshot(sid).state, clean.snapshot(sid).state, f"{sid} post")
        assert live.check_watches() == {}  # the fleet is healthy again

    def test_scheduler_carries_equal_reference_scheduler(self):
        """Every lane of the port's scheduler's watch carry, idle lanes
        included, equals the reference scheduler's, before and after a
        drain; the session bytes are the reference's."""
        net = _mini("fp16", "sparse", watches="default")
        rnet = _mini("fp16", "sparse", watches="default", ref=True)
        scheds = (serve.LaneScheduler(net, 4, record="none"),
                  rserve.LaneScheduler(rnet, 4, record="none"))
        for s in scheds:
            s.admit("a", seed=1)
            s.step(30)
            s.admit("b", seed=2)
            s.step(20)
        mine, ref = scheds[0]._watch, jax.tree.map(np.asarray, scheds[1]._watch)
        _assert_carry_eq(mine, ref, "before drain")
        got, want = scheds[0].check_watches(), scheds[1].check_watches()
        assert got == {} and want == {}
        _assert_carry_eq(scheds[0]._watch, jax.tree.map(np.asarray, scheds[1]._watch),
                         "after drain")
        assert scheds[0].session_bytes == scheds[1].session_bytes

    def test_pool_routes_quarantine(self):
        net = _mini("fp16", "packed", watches="default")
        pool = serve.ServePool(rungs=(2, 4), flight_window=2)
        for i in range(3):
            pool.admit(net, f"t{i}", seed=i)
        pool.step(self.CHUNK)
        _poison(pool.ladder_of("t1").scheduler, "t1")
        pool.step(self.CHUNK)
        alerts = pool.check_watches()
        assert set(alerts) == {"t1"}
        assert len(pool.flight("t1")) == 2
        q = pool.quarantine("t1", alerts["t1"])
        assert "t1" not in pool.session_ids
        assert q.verdicts and q.verdicts[0].watch == "nonfinite"

    def test_check_watches_requires_watches(self):
        sched = serve.LaneScheduler(_mini("fp16", "packed"), 2)
        with pytest.raises(ValueError, match="without watches"):
            sched.check_watches()


# ---------------------------------------------------------------------------
# Flight recorder: bounded ring, bit-exact replay
# ---------------------------------------------------------------------------

def _replay_roundtrip(policy, prop, backend, *, plastic, chunk=40, window=3, chunks=5):
    net = _mini(policy, prop, backend, plastic=plastic, watches="default")
    sched = serve.LaneScheduler(net, 2, flight_window=window)
    sched.admit("a", seed=1)
    sched.admit("b", seed=2)
    for _ in range(chunks):
        sched.step(chunk)
    ring = sched.flight("a")
    assert len(ring) == window  # bounded: the oldest fell off
    assert [s.ticks for s in ring] == [chunk * (chunks - window + 1 + i) for i in range(window)]
    span = ring[-1].ticks - ring[0].ticks
    session, out = serve.replay(net, ring[0], span, record="both")
    assert out["spikes"].shape == (span, net.static.n)
    _assert_state_eq(session.state, ring[-1].state, f"replay {policy}/{prop}/{backend}")
    if session.monitors is not None and ring[-1].tel is not None:
        for x, y in zip(session.monitors.carry, ring[-1].tel):
            assert torch.equal(x, y)
        assert session.monitors.ticks_since_flush == ring[-1].ticks_since_flush


class TestFlightRecorder:
    def test_disabled_by_default(self):
        sched = serve.LaneScheduler(_mini(watches="default"), 2)
        sched.admit("a")
        sched.step(20)
        assert sched.flight("a") == ()

    def test_negative_window_rejected(self):
        with pytest.raises(ValueError):
            serve.LaneScheduler(_mini(), 2, flight_window=-1)

    def test_ring_replays_bit_exactly_fast(self):
        _replay_roundtrip("fp16", "packed", None, plastic=True)

    def test_ring_survives_rung_migration(self):
        net = _mini(watches="default")
        lad = serve.CapacityLadder(net, rungs=(1, 4), idle_after=1, flight_window=2)
        lad.admit("a")
        lad.step(40)
        lad.admit("b")  # up a rung, 1 -> 4
        lad.step(40)
        ring = lad.flight("a")
        assert [s.ticks for s in ring] == [40, 80]
        session, _ = serve.replay(net, ring[0], ring[-1].ticks - ring[0].ticks)
        _assert_state_eq(session.state, ring[-1].state, "post-migration")


@pytest.mark.slow
class TestFlightReplayMatrix:
    @pytest.mark.parametrize("prop,backend", MODES)
    @pytest.mark.parametrize("policy", ["fp32", "fp16"])
    @pytest.mark.parametrize("plastic", [False, True])
    def test_replay(self, prop, backend, policy, plastic):
        _replay_roundtrip(policy, prop, backend, plastic=plastic)


# ---------------------------------------------------------------------------
# Quarantine dumps: persistence, replayability, bounded retention
# ---------------------------------------------------------------------------

class TestRetention:
    def _quarantined(self, net, *, poison=True):
        sched = serve.LaneScheduler(net, 2, flight_window=2)
        sched.admit("bad", seed=7)
        sched.admit("ok", seed=8)
        for _ in range(2):
            sched.step(40)
        if poison:
            _poison(sched, "bad")
        sched.step(40)
        alerts = sched.check_watches()
        return sched.quarantine("bad", alerts.get("bad", ()))

    def test_dump_manifest_and_restore(self, tmp_path):
        net = _mini(watches="default")
        q = self._quarantined(net)
        ddir = serve.dump_quarantine(str(tmp_path), q)
        man = json.load(open(os.path.join(ddir, "manifest.json")))
        assert man["session_id"] == "bad"
        assert len(man["flight"]) == 2
        assert any(v["watch"] == "nonfinite" and v["tripped"] for v in man["verdicts"])
        snap = serve.restore_lane(os.path.join(ddir, "final"), net)
        _assert_state_eq(snap.state, q.snapshot.state, "dumped final")
        flight0 = serve.restore_lane(os.path.join(ddir, "flight"), net,
                                     step=man["flight_ticks"][0])
        _assert_state_eq(flight0.state, q.recording[0].state, "dumped ring")

    def test_dumps_restore_across_packages(self, tmp_path):
        """A dump written by the port restores in the reference (and
        replays there to the port's next snapshot), and one written by the
        reference restores in the port, bit for bit."""
        net = _mini("fp16", "sparse", watches="default")
        rnet = _mini("fp16", "sparse", watches="default", ref=True, monitors="default")
        q = self._quarantined(net, poison=False)
        ddir = serve.dump_quarantine(str(tmp_path / "port"), q)
        rsnap = rserve.restore_lane(os.path.join(ddir, "flight"), rnet,
                                    step=q.recording[0].ticks)
        _assert_state_eq(q.recording[0].state, rsnap.state, "port dump in the reference")
        rsess, _ = rserve.replay(rnet, rsnap, 40, record="none")
        _assert_state_eq(q.recording[1].state, rsess.state, "reference replay of a port dump")
        rsched = rserve.LaneScheduler(rnet, 2, flight_window=2)
        rsched.admit("bad", seed=7)
        for _ in range(2):
            rsched.step(40)
        rq = rsched.quarantine("bad", ())
        rdir = rserve.dump_quarantine(str(tmp_path / "ref"), rq)
        snap = serve.restore_lane(os.path.join(rdir, "final"), net)
        _assert_state_eq(snap.state, rq.snapshot.state, "reference dump in the port")
        assert snap.ticks == 80 and snap.session_id == "bad"
        man = json.load(open(os.path.join(ddir, "manifest.json")))
        rman = json.load(open(os.path.join(rdir, "manifest.json")))
        assert set(man) == set(rman)

    def test_count_cap_drops_oldest(self, tmp_path):
        q = self._quarantined(_mini(watches="default"))
        for k in range(4):
            serve.dump_quarantine(str(tmp_path), q._replace(session_id=f"s{k}"), keep_last=2)
        kept = sorted(os.listdir(tmp_path))
        assert len(kept) == 2
        assert all(d.startswith(("s2", "s3")) for d in kept)

    def test_byte_cap_keeps_newest(self, tmp_path):
        q = self._quarantined(_mini(watches="default"))
        d0 = serve.dump_quarantine(str(tmp_path), q, keep_last=10)
        one = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(d0) for f in fs)
        serve.dump_quarantine(str(tmp_path), q._replace(session_id="newer"), keep_last=10,
                              max_bytes=one + one // 2)
        kept = os.listdir(tmp_path)
        assert len(kept) == 1 and kept[0].startswith("newer")

    def test_newest_survives_even_over_byte_cap(self, tmp_path):
        q = self._quarantined(_mini(watches="default"))
        serve.dump_quarantine(str(tmp_path), q, keep_last=10, max_bytes=1)
        assert len(os.listdir(tmp_path)) == 1

    def test_typed_errors(self, tmp_path):
        with pytest.raises(serve.RetentionError):
            serve.rotate_dumps(str(tmp_path), keep_last=0)
        with pytest.raises(serve.RetentionError):
            serve.rotate_dumps(str(tmp_path), keep_last=2, max_bytes=0)
        f = tmp_path / "not_a_dir"
        f.write_text("x")
        with pytest.raises(serve.RetentionError):
            serve.rotate_dumps(str(f))
        assert isinstance(serve.RetentionError("x"), serve.CheckpointError)

    def test_rotate_missing_dir_is_noop(self, tmp_path):
        assert serve.rotate_dumps(str(tmp_path / "nope")) == []

    def test_half_written_dump_is_not_rotations_to_delete(self, tmp_path):
        crashed = tmp_path / "crashed_dump"
        crashed.mkdir()
        (crashed / "final").mkdir()
        removed = serve.rotate_dumps(str(tmp_path), keep_last=1)
        assert removed == [] and crashed.exists()


# ---------------------------------------------------------------------------
# Alert plumbing: counters and health verdicts
# ---------------------------------------------------------------------------

class TestAlertPlumbing:
    def test_watch_check_absent_until_counters_exist(self):
        assert watch_check(MetricsRegistry()) is None

    def test_watch_check_warns_on_trips(self):
        reg = MetricsRegistry()
        reg.counter("repro_watch_trips_total").inc(watch="nonfinite", rung="cap4")
        reg.counter("repro_quarantines_total").inc(rung="cap4")
        hc = watch_check(reg)
        assert hc.status == WARN and hc.value == 1.0
        assert "nonfinite=1" in hc.detail and "1 tenant" in hc.detail

    def test_watch_check_passes_when_clean(self):
        reg = MetricsRegistry()
        reg.counter("repro_watch_trips_total")  # touched, never tripped
        hc = watch_check(reg)
        assert hc.status == PASS and hc.value == 0.0

    def test_alert_emits_only_tripped(self):
        v_ok = wat.WatchVerdict("silent", "silent", False, 0.0, 500.0, "")
        v_bad = wat.WatchVerdict("nonfinite", "nonfinite", True, 2.0, 0.0, "bad values")
        counter = obs.registry().counter("repro_watch_trips_total")
        before = counter.value(watch="nonfinite", rung="test_alert")
        assert wat.alert([v_ok, v_bad], rung="test_alert") == [v_bad]
        assert counter.value(watch="nonfinite", rung="test_alert") == before + 1
