"""The port's plasticity against the reference's on the CPU: the STDP,
DA-STDP, homeostasis and STP ops step by step, CSR rows against their
dense twins, and the compile side of plastic networks (storage layout,
fan-in tables, cost model, memory ledger, the fused plan).

Inputs are made with numpy from a seed and handed to both packages. The
reference's jitted ops let XLA CPU contract mul+add into FMAs (``trace ·
decay + s``, ``w + a⁺·x``), and even a compile at
``xla_backend_optimization_level=0`` rounds one fp16 DA eligibility cell
of 3,200 otherwise; eager PyTorch rounds every operation on its own. Each
op is therefore held bit for bit against the reference evaluated op by op
(``jax.disable_jit``), and its distance from the default jitted op is
printed (``pytest -s``)."""
import dataclasses
import functools

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import synfire4 as rsyn  # noqa: E402
from repro.core import NetworkBuilder as RBuilder, izh4 as rizh4  # noqa: E402
from repro.core import plasticity as rpl  # noqa: E402
from repro.core import synapses as rsynapses  # noqa: E402
from repro_torch.configs import synfire4 as tsyn  # noqa: E402
from repro_torch.core import NetworkBuilder, izh4  # noqa: E402
from repro_torch.core import plasticity as tpl  # noqa: E402
from repro_torch.core import synapses as tsynapses  # noqa: E402
from repro_torch.core.network import _csr_wins  # noqa: E402
from repro_torch.memory import MCU_BUDGET_BYTES  # noqa: E402
from repro_torch.precision.policy import tree_bytes  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread keeps PyTorch's thread
    pool from spinning against the other test workers' cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


DTYPES = {"fp32": (np.float32, torch.float32), "fp16": (np.float16, torch.float16)}


def _jax_tree(x):
    return jax.tree.map(jnp.asarray, x)


def eager(fn, *args):
    """The reference's ``fn`` evaluated op by op on ``args``."""
    with jax.disable_jit():
        return fn(*_jax_tree(args))


def jitted(fn, *args):
    """The reference's ``fn`` as its engine runs it: jitted (FMA-contracted)."""
    return jax.jit(fn)(*_jax_tree(args))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if np.issubdtype(x.dtype, np.floating) else x


def assert_tree_equal(port, ref, what, default=None):
    """Leaves of the port's result equal the reference's bit for bit; with
    ``default`` (the jitted reference) the differing cells are printed."""
    pl, rl = jax.tree.leaves(port), jax.tree.leaves(ref)
    assert len(pl) == len(rl), what
    dl = jax.tree.leaves(default) if default is not None else [None] * len(pl)
    for i, (p, r, d) in enumerate(zip(pl, rl, dl)):
        np.testing.assert_array_equal(_np(p), _np(r), err_msg=f"{what} leaf {i}")
        if d is not None:
            print(f"{what} leaf {i}: {int((_np(p) != _np(d)).sum())} of {_np(p).size} "
                  "cells differ from the jitted reference")


def _torch_tree(x):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_torch_tree(v) for v in x))
    return torch.from_numpy(np.array(x, copy=True))


def _instance(seed, p, q, density, npd):
    """A dense plastic rectangle and its spikes/traces: (mask, w, pre_sp,
    post_sp, pre_t, post_t) as numpy."""
    rng = np.random.default_rng(seed)
    mask = rng.random((p, q)) < density
    w = np.where(mask, rng.normal(1.0, 0.4, (p, q)), 0.0).astype(npd)
    return (mask, w, rng.random(p) < 0.3, rng.random(q) < 0.3,
            (rng.random(p) * 2).astype(np.float32), (rng.random(q) * 2).astype(np.float32))


def _csr(mask, w):
    """The reference's CSR rows of a dense (mask, w) pair as numpy:
    (idx, weight rows, valid)."""
    c = rsynapses.dense_to_csr(mask, w, storage_dtype=w.dtype)
    return np.array(c.idx), np.array(c.weight), np.array(c.valid)


STDP = dict(a_plus=0.013, a_minus=0.009, w_min=0.0, w_max=4.0)
TICKS = 3  # chained ticks per op test: the traces decay and accumulate


class TestSteps:
    @pytest.mark.parametrize("layout", ["dense", "csr"])
    @pytest.mark.parametrize("policy", ["fp16", "fp32"])
    def test_stdp_step_matches_reference(self, policy, layout):
        npd = DTYPES[policy][0]
        mask, w, _, _, pre_t, post_t = _instance(0, 90, 40, 0.3, npd)
        rcfg, tcfg = rpl.STDPConfig(**STDP), tpl.STDPConfig(**STDP)
        rng = np.random.default_rng(1)
        rstate = rpl.STDPState(pre_trace=pre_t, post_trace=post_t)
        tstate = _torch_tree(tpl.STDPState(*rstate))
        if layout == "csr":
            idx, w, valid = _csr(mask, w)
            rfn = functools.partial(rpl.stdp_step_csr, rcfg)
            extra = (idx, valid)
        else:
            rfn = functools.partial(rpl.stdp_step, rcfg)
            extra = (mask,)
        rw, tw = w, torch.from_numpy(w.copy())
        for tick in range(TICKS):
            pre_sp, post_sp = rng.random(90) < 0.3, rng.random(40) < 0.3
            args = (rstate, rw, *extra, pre_sp, post_sp)
            rstate, rw = eager(rfn, *args)
            default = jitted(rfn, *args)
            tfn = tpl.stdp_step_csr if layout == "csr" else tpl.stdp_step
            tstate, tw = tfn(tcfg, tstate, tw, *map(torch.from_numpy, extra),
                             torch.from_numpy(pre_sp), torch.from_numpy(post_sp))
            assert tw.dtype == DTYPES[policy][1]
            assert_tree_equal((tstate, tw), (rstate, rw), f"{layout} {policy} tick {tick}",
                              default)
        assert not np.array_equal(_np(tw), _np(w)), "no weight moved"

    @pytest.mark.parametrize("layout", ["dense", "csr"])
    @pytest.mark.parametrize("policy", ["fp16", "fp32"])
    def test_da_stdp_step_matches_reference(self, policy, layout):
        npd, tdt = DTYPES[policy]
        p, q = 80, 40
        mask, w, _, _, pre_t, post_t = _instance(2, p, q, 0.3, npd)
        kw = dict(STDP, w_max=5.0, tau_elig=150.0)
        rcfg, tcfg = rpl.STDPConfig(**kw), tpl.STDPConfig(**kw)
        if layout == "csr":
            idx, w, valid = _csr(mask, w)
            fanin, extra = idx.shape[1], (idx, valid)
            rfn = functools.partial(rpl.da_stdp_step_csr, rcfg)
            tfn = tpl.da_stdp_step_csr
        else:
            fanin, extra = None, (mask,)
            rfn = functools.partial(rpl.da_stdp_step, rcfg)
            tfn = tpl.da_stdp_step
        rstate = rpl.init_da_stdp_state(p, q, npd, fanin=fanin)._replace(
            pre_trace=pre_t, post_trace=post_t)
        tstate = tpl.init_da_stdp_state(p, q, tdt, fanin=fanin)._replace(
            pre_trace=torch.from_numpy(pre_t), post_trace=torch.from_numpy(post_t))
        assert_tree_equal(tstate, rstate, "initial DA state")
        rng = np.random.default_rng(3)
        rw, tw = w, torch.from_numpy(w.copy())
        for tick in range(TICKS):
            pre_sp, post_sp = rng.random(p) < 0.3, rng.random(q) < 0.3
            da = np.float32(0.7)
            args = (rstate, rw, *extra, pre_sp, post_sp, da)
            rstate, rw = eager(rfn, *args)
            default = jitted(rfn, *args)
            tstate, tw = tfn(tcfg, tstate, tw, *map(torch.from_numpy, extra),
                             torch.from_numpy(pre_sp), torch.from_numpy(post_sp),
                             torch.tensor(0.7))
            assert_tree_equal((tstate, tw), (rstate, rw), f"DA {layout} {policy} tick {tick}",
                              default)

    @pytest.mark.parametrize("cadence", ["tick", "segment"])
    @pytest.mark.parametrize("layout", ["dense", "csr"])
    @pytest.mark.parametrize("policy", ["fp16", "fp32"])
    def test_homeostasis_step_matches_reference(self, policy, layout, cadence):
        """Per tick (bool spikes, dt 1 ms) and on the engine's slow timer
        (int32 spike counts of a 100-tick segment, dt 100 ms)."""
        npd = DTYPES[policy][0]
        mask, w, _, _, _, _ = _instance(4, 60, 30, 0.35, npd)
        if layout == "csr":
            _, w, _ = _csr(mask, w)
        rng = np.random.default_rng(5)
        cfg = dict(target_hz=10.0, tau_avg_ms=500.0, beta=20.0)
        rfn = functools.partial(
            rpl.homeostasis_step_csr if layout == "csr" else rpl.homeostasis_step,
            rpl.HomeostasisConfig(**cfg))
        tfn = tpl.homeostasis_step_csr if layout == "csr" else tpl.homeostasis_step
        ravg = rng.random(30).astype(np.float32) * 40
        tavg, rw, tw = torch.from_numpy(ravg.copy()), w, torch.from_numpy(w.copy())
        dt = 1.0 if cadence == "tick" else 100.0
        for tick in range(TICKS):
            post = (rng.random(30) < 0.3 if cadence == "tick"
                    else rng.integers(0, 6, 30).astype(np.int32))
            fn = functools.partial(rfn, dt=dt)
            args = (ravg, rw, post)
            ravg, rw = eager(fn, *args)
            default = jitted(fn, *args)
            tavg, tw = tfn(tpl.HomeostasisConfig(**cfg), tavg, tw, torch.from_numpy(post),
                           dt)
            assert_tree_equal((tavg, tw), (ravg, rw), f"homeostasis {layout} {policy} "
                              f"{cadence} {tick}", default)
        assert not np.array_equal(_np(tw), _np(w))

    @pytest.mark.parametrize("policy", ["fp16", "fp32"])
    def test_stp_update_matches_reference(self, policy):
        npd, tdt = DTYPES[policy]
        cfg = dict(u0=0.45, tau_f=50.0, tau_d=750.0)
        rstate = rsynapses.init_stp_state(rsynapses.STPConfig(**cfg), 70, npd)
        tstate = tsynapses.init_stp_state(tsynapses.STPConfig(**cfg), 70, tdt)
        assert_tree_equal(tstate, rstate, "initial STP state")
        rng = np.random.default_rng(6)
        rfn = functools.partial(rsynapses.stp_update, rsynapses.STPConfig(**cfg), dt=1.0)
        for tick in range(20):
            sp = rng.random(70) < 0.4
            rstate = eager(rfn, rstate, sp)
            tstate = tsynapses.stp_update(tsynapses.STPConfig(**cfg), tstate,
                                          torch.from_numpy(sp), 1.0)
            assert tstate.u.dtype == tdt
            assert_tree_equal(tstate, rstate, f"STP {policy} tick {tick}")

    def test_homeostasis_pushes_rate_toward_target(self):
        """The reference's engine-level check on the port: an over-active
        neuron's weights shrink, a silent one's grow, all finite."""
        cfg = tpl.HomeostasisConfig(target_hz=10.0, tau_avg_ms=100.0, beta=50.0)
        w = torch.full((4, 2), 1.0, dtype=torch.float16)
        avg = torch.tensor([1000.0, 0.0])
        for _ in range(50):
            avg, w = tpl.homeostasis_step(cfg, avg, w, torch.tensor([True, False]))
        wf = w.float()
        assert float(wf[:, 0].mean()) < 0.5 and float(wf[:, 1].mean()) > 2.0
        assert bool(torch.isfinite(wf).all())

    def test_da_steps_need_tau_elig(self):
        st0 = tpl.init_da_stdp_state(3, 2)
        with pytest.raises(ValueError, match="tau_elig"):
            tpl.da_stdp_step(tpl.STDPConfig(), st0, torch.ones((3, 2)),
                             torch.ones((3, 2), dtype=torch.bool), torch.ones(3),
                             torch.ones(2), 1.0)


class TestCSRTwins:
    """A CSR row and its dense twin evolve bit for bit (the port's mirror of
    ``tests/test_properties.py``'s plasticity properties)."""

    @staticmethod
    def _twins(seed, p, q, density, tdt):
        mask, w, pre_sp, post_sp, pre_t, post_t = _instance(seed, p, q, density,
                                                            np.float32)
        wd = torch.from_numpy(w).to(tdt)
        csr = tsynapses.dense_to_csr(torch.from_numpy(mask), wd)
        return (torch.from_numpy(mask), wd, csr, torch.from_numpy(pre_sp),
                torch.from_numpy(post_sp), torch.from_numpy(pre_t), torch.from_numpy(post_t))

    @given(st.integers(min_value=0, max_value=2**31 - 1),
           st.integers(min_value=2, max_value=120), st.integers(min_value=1, max_value=60),
           st.floats(min_value=0.05, max_value=0.6), st.sampled_from(["fp32", "fp16"]))
    @settings(max_examples=20, deadline=None)
    def test_stdp_csr_bitwise_equals_dense(self, seed, p, q, density, policy):
        mask, wd, csr, pre_sp, post_sp, pre_t, post_t = self._twins(
            seed, p, q, density, DTYPES[policy][1])
        cfg = tpl.STDPConfig(**STDP)
        st0 = tpl.STDPState(pre_trace=pre_t, post_trace=post_t)
        st_d, w_d = tpl.stdp_step(cfg, st0, wd, mask, pre_sp, post_sp)
        st_c, w_c = tpl.stdp_step_csr(cfg, st0, csr.weight, csr.idx,
                                      torch.from_numpy(csr.valid), pre_sp, post_sp)
        np.testing.assert_array_equal(_np(w_d), tsynapses.csr_to_dense(
            csr._replace(weight=w_c), p))
        assert torch.equal(st_d.pre_trace, st_c.pre_trace)

    @given(st.integers(min_value=0, max_value=2**31 - 1), st.sampled_from(["fp32", "fp16"]))
    @settings(max_examples=10, deadline=None)
    def test_da_stdp_csr_bitwise_equals_dense(self, seed, policy):
        tdt = DTYPES[policy][1]
        p, q = 80, 40
        mask, wd, csr, pre_sp, post_sp, pre_t, post_t = self._twins(seed, p, q, 0.3, tdt)
        cfg = tpl.STDPConfig(a_plus=0.01, a_minus=0.004, w_max=5.0, tau_elig=150.0)
        st_d = tpl.init_da_stdp_state(p, q, tdt)._replace(pre_trace=pre_t,
                                                          post_trace=post_t)
        st_c = tpl.init_da_stdp_state(p, q, tdt, fanin=csr.idx.shape[1])._replace(
            pre_trace=pre_t, post_trace=post_t)
        valid = torch.from_numpy(csr.valid)
        for _ in range(2):  # two ticks: the eligibility decay runs too
            st_d, wd = tpl.da_stdp_step(cfg, st_d, wd, mask, pre_sp, post_sp, 0.7)
            st_c, wc = tpl.da_stdp_step_csr(cfg, st_c, csr.weight, csr.idx, valid,
                                            pre_sp, post_sp, 0.7)
            csr = csr._replace(weight=wc)
        np.testing.assert_array_equal(_np(wd), tsynapses.csr_to_dense(csr, p))
        idx = csr.idx.long().numpy()
        cols = np.broadcast_to(np.arange(q)[:, None], idx.shape)
        np.testing.assert_array_equal(_np(st_d.elig)[idx[csr.valid], cols[csr.valid]],
                                      _np(st_c.elig)[csr.valid])

    @given(st.integers(min_value=0, max_value=2**31 - 1), st.sampled_from(["fp32", "fp16"]))
    @settings(max_examples=10, deadline=None)
    def test_homeostasis_csr_bitwise_equals_dense(self, seed, policy):
        mask, wd, csr, _, post_sp, _, _ = self._twins(seed, 60, 30, 0.35,
                                                      DTYPES[policy][1])
        cfg = tpl.HomeostasisConfig(target_hz=10.0, tau_avg_ms=500.0, beta=20.0)
        avg = torch.from_numpy(np.random.default_rng(seed).random(30).astype(np.float32) * 40)
        avg_d, w_d = tpl.homeostasis_step(cfg, avg, wd, post_sp)
        avg_c, w_c = tpl.homeostasis_step_csr(cfg, avg, csr.weight, post_sp)
        assert torch.equal(avg_d, avg_c)
        np.testing.assert_array_equal(_np(w_d), tsynapses.csr_to_dense(
            csr._replace(weight=w_c), 60))


def _stdp_cfg(lib, **kw):
    kw.setdefault("a_plus", 0.01)
    kw.setdefault("a_minus", 0.002)
    kw.setdefault("w_max", 6.0)
    return lib.STDPConfig(**kw)


def _plastic_net(builder, lib_izh4, lib_pl, propagation, *, da=False, **compile_kw):
    net = builder(seed=5)
    net.add_spike_generator("pre", 30, rate_hz=80.0)
    net.add_group("post", lib_izh4(10, a=0.02, b=0.2, c=-65.0, d=8.0))
    net.connect("pre", "post", fanin=15, weight=3.0, delay_ms=1,
                stdp=_stdp_cfg(lib_pl, tau_elig=200.0 if da else None), da_modulated=da)
    return net.compile(policy="fp16", propagation=propagation, **compile_kw)


def port_plastic_net(propagation, **kw):
    return _plastic_net(NetworkBuilder, izh4, tpl, propagation, device="cpu", **kw)


def ref_plastic_net(propagation, **kw):
    return _plastic_net(RBuilder, rizh4, rpl, propagation, **kw)


class TestPlasticCSRLayout:
    def test_sparse_forces_plastic_to_csr_storage(self):
        c = port_plastic_net("sparse")
        assert c.static.plastic_csr == (0,) and 0 in c.static.csr_projs
        spec = c.static.projections[0]
        assert c.state0.weights[0].shape == (spec.post_size, spec.fanin)
        assert c.params.masks[0].shape == (spec.post_size, spec.fanin)
        assert c.params.masks[0].dtype == torch.bool
        assert c.params.proj_csr_idx[0].shape == (spec.post_size, spec.fanin)

    def test_packed_keeps_dense_storage_but_builds_fanin_table(self):
        c = port_plastic_net("packed")
        assert c.static.plastic_csr == () and c.static.csr_projs == frozenset()
        assert c.state0.weights[0].shape == (30, 10)
        assert c.params.masks[0].shape == (30, 10)
        idx = c.params.proj_csr_idx[0].numpy()
        counts = c.params.masks[0].numpy().sum(axis=0)
        for q in range(10):
            assert np.all(idx[q, counts[q]:] == 30), "sentinel pad missing"

    @pytest.mark.parametrize("da", [False, True])
    @pytest.mark.parametrize("propagation", ["packed", "sparse", "auto"])
    def test_tables_match_reference(self, propagation, da):
        """Plan, masks, fan-in tables, weights and initial plastic state
        equal the reference's, dtypes included."""
        ref, port = ref_plastic_net(propagation, da=da), port_plastic_net(propagation, da=da)
        for f in ("plastic_csr", "stp_csr", "csr_projs", "buckets", "homeo_period"):
            assert getattr(port.static, f) == getattr(ref.static, f), f
        assert [dataclasses.asdict(c) for c in port.static.stdp] == [
            dataclasses.asdict(c) for c in ref.static.stdp]
        if da:
            assert port.static.stdp[0].tau_elig == 200.0
        for what, p_, r_ in (("masks", port.params.masks, ref.params.masks),
                             ("proj_csr_idx", port.params.proj_csr_idx,
                              ref.params.proj_csr_idx),
                             ("weights", port.state0.weights, ref.state0.weights),
                             ("stdp", port.state0.stdp, ref.state0.stdp)):
            for i, (a, b) in enumerate(zip(jax.tree.leaves(p_), jax.tree.leaves(r_))):
                assert str(a.dtype).removeprefix("torch.") == str(np.asarray(b).dtype), what
                np.testing.assert_array_equal(_np(a), _np(b), err_msg=f"{what} {i}")

    def test_csr_to_dense_roundtrip(self):
        rng = np.random.default_rng(3)
        mask = rng.random((50, 30)) < 0.25
        w = np.where(mask, rng.normal(1.0, 0.4, (50, 30)), 0.0).astype(np.float32)
        back = tsynapses.csr_to_dense(tsynapses.dense_to_csr(
            torch.from_numpy(mask), torch.from_numpy(w)), 50)
        np.testing.assert_array_equal(back, w)

    def test_da_eligibility_rides_fanin_rows(self):
        c = port_plastic_net("sparse", da=True)
        spec = c.static.projections[0]
        assert c.state0.stdp[0].elig.shape == (spec.post_size, spec.fanin)
        assert port_plastic_net("packed", da=True).state0.stdp[0].elig.shape == (30, 10)

    def test_init_da_stdp_state_fanin_kwarg(self):
        s = tpl.init_da_stdp_state(100, 20, torch.float16, fanin=7)
        assert s.elig.shape == (20, 7) and s.elig.dtype == torch.float16
        assert s.pre_trace.shape == (100,) and s.post_trace.shape == (20,)


def _stp_net(builder, lib_izh4, lib_syn, lib_pl, propagation, **kw):
    net = builder(seed=2)
    net.add_spike_generator("g", 50, rate_hz=100.0)
    net.add_group("n", lib_izh4(20, a=0.02, b=0.2, c=-65.0, d=8.0))
    net.connect("g", "n", fanin=10, weight=0.5, delay_ms=1, stdp=_stdp_cfg(lib_pl),
                stp=lib_syn.STPConfig())
    return net.compile(policy="fp16", propagation=propagation, **kw)


class TestPlasticCostModel:
    def _spec(self, pre, post, fanin, **kw):
        return tsynapses.ProjectionSpec(
            name="t", pre_start=0, pre_size=pre, post_start=pre, post_size=post,
            delay_ms=1, receptor="exc", fanin=fanin, n_syn=post * fanin, **kw)

    @pytest.mark.parametrize("pre,post,fanin,plastic", [
        (200, 200, 60, True), (2000, 2000, 60, True), (200, 200, 10, False),
        (600, 20, 300, True), (600, 600, 12, True), (50, 50, 49, False)])
    def test_matches_reference_cost_model(self, pre, post, fanin, plastic):
        from repro.core.network import _csr_wins as ref_csr_wins
        spec = self._spec(pre, post, fanin, plastic=plastic)
        ref = rsynapses.ProjectionSpec(**{**dataclasses.asdict(spec), "stp": None})
        assert _csr_wins(spec) == ref_csr_wins(ref)

    def test_plastic_small_projection_stays_dense(self):
        assert not _csr_wins(self._spec(200, 200, 60, plastic=True))

    def test_plastic_large_sparse_fanin_goes_sparse(self):
        assert _csr_wins(self._spec(2000, 2000, 60, plastic=True))

    def test_auto_assigns_plastic_storage_per_projection(self):
        net = NetworkBuilder(seed=1)
        net.add_spike_generator("g", 600, rate_hz=40.0)
        net.add_group("a", izh4(600, a=0.02, b=0.2, c=-65.0, d=8.0))
        net.add_group("b", izh4(20, a=0.02, b=0.2, c=-65.0, d=8.0))
        net.connect("g", "a", fanin=12, weight=1.0, delay_ms=2, stdp=_stdp_cfg(tpl))
        net.connect("a", "b", fanin=300, weight=0.1, delay_ms=1, stdp=_stdp_cfg(tpl))
        c = net.compile(policy="fp16", propagation="auto", device="cpu")
        assert c.static.plastic_csr == (0,)
        assert c.state0.weights[0].shape == (600, 12)
        assert c.state0.weights[1].shape == (600, 20)

    @pytest.mark.parametrize("propagation", ["sparse", "packed", "auto"])
    def test_stp_projection_rides_csr_rows(self, propagation):
        c = _stp_net(NetworkBuilder, izh4, tsynapses, tpl, propagation, device="cpu")
        ref = _stp_net(RBuilder, rizh4, rsynapses, rpl, propagation)
        spec = c.static.projections[0]
        assert c.static.plastic_csr == () and c.static.stp_csr == (0,)
        assert 0 in c.static.csr_projs
        assert c.state0.weights[0].shape == (spec.post_size, spec.fanin)
        assert c.params.masks[0].shape == (spec.post_size, spec.fanin)
        assert c.params.proj_csr_idx[0].shape == (spec.post_size, spec.fanin)
        assert_tree_equal((c.state0.stp, c.params.proj_csr_idx, c.params.masks,
                           c.state0.weights),
                          (ref.state0.stp, ref.params.proj_csr_idx, ref.params.masks,
                           ref.state0.weights), f"STP net {propagation}")
        assert c.ledger.stage_bytes() == ref.ledger.stage_bytes()


class TestPlasticLedger:
    def _net(self, propagation, da=False):
        net = NetworkBuilder(seed=7)
        net.add_spike_generator("g", 600, rate_hz=40.0)
        net.add_group("a", izh4(600, a=0.02, b=0.2, c=-65.0, d=8.0))
        net.connect("g", "a", fanin=12, weight=1.0, delay_ms=2,
                    stdp=_stdp_cfg(tpl, tau_elig=100.0 if da else None), da_modulated=da)
        return net.compile(policy="fp16", propagation=propagation, device="cpu")

    def test_csr_plastic_bytes_replace_dense_bytes(self):
        dense, sparse = self._net("packed").ledger, self._net("sparse").ledger
        assert sparse.synapse_bytes() < dense.synapse_bytes() / 10
        nb = sparse.name_bytes()
        assert nb["weights"] == 600 * 12 * 2
        assert nb["masks"] == 600 * 12
        assert nb["csr.indices"] == 600 * 12 * 2

    def test_dense_plastic_registers_gather_table(self):
        nb = self._net("packed").ledger.name_bytes()
        assert nb["masks"] == 600 * 600
        assert nb["csr.indices"] == 600 * 12 * 2

    def test_da_eligibility_bytes_shrink(self):
        eb_dense = tree_bytes(self._net("packed", da=True).state0.stdp[0].elig)
        eb_sparse = tree_bytes(self._net("sparse", da=True).state0.stdp[0].elig)
        assert eb_dense == 600 * 600 * 2 and eb_sparse == 600 * 12 * 2

    @pytest.mark.parametrize("policy,propagation", [
        (p, q) for p in ("fp16", "fp32") for q in ("packed", "sparse")])
    def test_plastic_synfire4_stage_bytes_match_reference(self, policy, propagation):
        kw = dict(policy=policy, propagation=propagation)
        ref = rsyn.build_synfire(rsyn.SYNFIRE4, stdp_chain=rsyn.CHAIN_STDP, **kw)
        port = tsyn.build_synfire(tsyn.SYNFIRE4, stdp_chain=tsyn.CHAIN_STDP, device="cpu",
                                  **kw)
        assert port.ledger.stage_bytes() == ref.ledger.stage_bytes()
        assert port.ledger.name_bytes() == ref.ledger.name_bytes()
        assert port.ledger.total_used <= MCU_BUDGET_BYTES

    def test_homeostasis_stage_bytes_match_reference(self):
        kw = dict(policy="fp16", propagation="sparse", homeostasis_period=100)
        ref = rsyn.build_synfire(rsyn.SYNFIRE4, stdp_chain=rsyn.CHAIN_STDP,
                                 homeo_chain=rpl.HomeostasisConfig(), **kw)
        port = tsyn.build_synfire(tsyn.SYNFIRE4, stdp_chain=tsyn.CHAIN_STDP, device="cpu",
                                  homeo_chain=tpl.HomeostasisConfig(), **kw)
        assert port.ledger.name_bytes()["homeo.avg_rate"] == 4 * 200 * 4
        assert port.ledger.stage_bytes() == ref.ledger.stage_bytes()

    def test_plastic_x10_fits_mcu_budget(self):
        """Plastic Synfire4×10 sparse (12,000 neurons) inside the paper's
        8.477 MB, byte for byte the reference's ledger."""
        kw = dict(policy="fp16", propagation="sparse", budget=MCU_BUDGET_BYTES,
                  monitor_ms_hint=0)
        port = tsyn.build_synfire(tsyn.SYNFIRE4_X10, stdp_chain=tsyn.CHAIN_STDP,
                                  device="cpu", **kw)
        assert len(port.static.plastic_csr) == 4  # the exc->exc chain
        assert port.ledger.total_used <= MCU_BUDGET_BYTES
        ref = rsyn.build_synfire(rsyn.SYNFIRE4_X10, stdp_chain=rsyn.CHAIN_STDP, **kw)
        assert port.ledger.stage_bytes() == ref.ledger.stage_bytes()


class TestFusedPlan:
    """A plastic net never runs the fused_tick kernel (which knows nothing of
    learning), and its plan equals the reference's."""

    @pytest.mark.parametrize("propagation", ["packed", "sparse"])
    def test_plastic_fused_plan_matches_reference(self, propagation):
        kw = dict(policy="fp16", propagation=propagation, backend="fused")
        ref = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, monitors=None,
                                 stdp_chain=rsyn.CHAIN_STDP, **kw)
        port = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, device="cpu",
                                  stdp_chain=tsyn.CHAIN_STDP, **kw)
        assert port.static.fused_kernel is False
        assert port.static.fused.kernel_ok is False
        for f in dataclasses.fields(port.static.fused):
            assert getattr(port.static.fused, f.name) == getattr(ref.static.fused, f.name), f
        assert port.static.csr_projs == ref.static.csr_projs
        # The chain's delays stay in the plan though its projections left
        # every bucket.
        assert port.static.fused.delays == (8, 10)

    def test_stp_net_is_not_kernel_ok(self):
        c = _stp_net(NetworkBuilder, izh4, tsynapses, tpl, "sparse", device="cpu",
                     backend="fused")
        ref = _stp_net(RBuilder, rizh4, rsynapses, rpl, "sparse", monitors=None,
                       backend="fused")
        assert not c.static.fused_kernel
        assert c.static.fused.delays == ref.static.fused.delays == (1,)
        assert c.static.csr_projs == ref.static.csr_projs == frozenset({0})


class TestBuilderChecks:
    def _net(self, **connect_kw):
        net = NetworkBuilder(seed=1)
        net.add_group("a", izh4(10, a=0.02, b=0.2, c=-65.0, d=8.0))
        net.connect("a", "a", fanin=2, weight=1.0, delay_ms=1, **connect_kw)
        return net

    def test_homeostasis_needs_a_period(self):
        with pytest.raises(ValueError, match="homeostasis_period is 0"):
            self._net(homeostasis=tpl.HomeostasisConfig()).compile(device="cpu")

    def test_homeostasis_refuses_stp(self):
        with pytest.raises(ValueError, match="STP"):
            self._net(homeostasis=tpl.HomeostasisConfig(), stp=tsynapses.STPConfig())

    def test_da_modulated_defaults_tau_elig(self):
        c = self._net(stdp=tpl.STDPConfig(), da_modulated=True).compile(device="cpu")
        assert c.static.stdp[0].tau_elig == 100.0
        assert c.state0.stdp[0].elig.shape == (10, 10)
