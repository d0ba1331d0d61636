"""``run``'s serving arguments (``gen_chunk``, ``gen_base``, ``active``) and
the ``loop`` propagation oracle on the port, against the reference on the
CPU, bit for bit throughout.

``gen_chunk`` draws the generator uniforms chunk by chunk from
``split(k_draw, T // chunk)``, ``gen_base`` tick by tick from
``fold_in(gen_base, t)`` (call-split invariant), and ``active`` silences
the generators and holds homeostasis: the same streams, rasters and
states as the reference's. The reference's errors are mirrored
(``tests/test_telemetry.py``, ``tests/test_serve.py``; the monitor cases
raise ``NotImplementedError`` naming ROADMAP A6/A10 here). The loop oracle
equals packed, sparse and auto as in ``tests/test_backends.py`` and
``tests/test_sparse.py``, and the reference's own loop runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import synfire4 as rsyn  # noqa: E402
from repro.core import NetworkBuilder as RBuilder, izh4 as rizh4  # noqa: E402
from repro.core import plasticity as rpl  # noqa: E402
from repro.core.engine import run as ref_run  # noqa: E402
from repro.core.synapses import STPConfig as RSTP  # noqa: E402
from repro_torch.configs import synfire4 as tsyn  # noqa: E402
from repro_torch.core import Engine, NetworkBuilder, izh4, rng, run  # noqa: E402
from repro_torch.core import plasticity as tpl  # noqa: E402
from repro_torch.core.synapses import STPConfig  # noqa: E402

TICKS = 300
HOMEO = dict(target_hz=10.0, tau_avg_ms=1000.0, beta=2.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def nets(cfg_name="SYNFIRE4_MINI", policy="fp16", propagation="sparse", homeo=False,
         plastic=False):
    """The same Synfire net in both packages (``homeo``: homeostasis on the
    exc->exc chain every 100 ticks; ``plastic``: ``CHAIN_STDP`` there)."""
    kw = dict(policy=policy, propagation=propagation)
    rkw, tkw = dict(kw, monitors=None), dict(kw, device="cpu")
    if homeo:
        rkw.update(homeo_chain=rpl.HomeostasisConfig(**HOMEO), homeostasis_period=100)
        tkw.update(homeo_chain=tpl.HomeostasisConfig(**HOMEO), homeostasis_period=100)
    if plastic:
        rkw["stdp_chain"], tkw["stdp_chain"] = rsyn.CHAIN_STDP, tsyn.CHAIN_STDP
    cfg = getattr(rsyn, cfg_name), getattr(tsyn, cfg_name)
    return rsyn.build_synfire(cfg[0], **rkw), tsyn.build_synfire(cfg[1], **tkw)


def key_words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).view(np.int32)


def port_key(k) -> torch.Tensor:
    return torch.from_numpy(key_words(k).copy())


def assert_same(rfinal, rout, tfinal, tout, plastic=()):
    """Raster, t, key, v, u, refrac, ring, and the weights (and homeostasis
    rates) of the projections in ``plastic``, bit for bit."""
    np.testing.assert_array_equal(tout["spikes"].numpy(), np.asarray(rout["spikes"]))
    assert tfinal.t == int(rfinal.t)
    np.testing.assert_array_equal(tfinal.key.numpy(), key_words(rfinal.key))
    for name in ("v", "u", "refrac"):
        np.testing.assert_array_equal(getattr(tfinal.neurons, name).numpy(),
                                      np.asarray(getattr(rfinal.neurons, name)), err_msg=name)
    np.testing.assert_array_equal(tfinal.ring.numpy(), np.asarray(rfinal.ring))
    for j in plastic:
        np.testing.assert_array_equal(tfinal.weights[j].numpy(),
                                      np.asarray(rfinal.weights[j]), err_msg=f"weights {j}")
        if tfinal.homeo[j] is not None:
            np.testing.assert_array_equal(tfinal.homeo[j].numpy(),
                                          np.asarray(rfinal.homeo[j]), err_msg=f"homeo {j}")


def _chain(net):
    return [j for j, s in enumerate(net.static.projections) if s.plastic]


class TestGenBase:
    @pytest.mark.parametrize("propagation", ["sparse", "packed"])
    def test_matches_reference(self, propagation):
        rnet, tnet = nets(propagation=propagation)
        base = jax.random.key(7)
        rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, TICKS, gen_base=base)
        tfinal, tout = run(tnet.static, tnet.params, tnet.state0, TICKS,
                           gen_base=port_key(base))
        assert int(tout["spikes"].sum()) > 100
        assert_same(rfinal, rout, tfinal, tout)
        assert torch.equal(tfinal.key, tnet.state0.key)  # the key is left as it was

    def test_call_split_invariant(self):
        """One run(300) equals three run(100)s with the state threaded
        through: raster and final state bit for bit (homeostasis riding the
        same 100-tick boundaries)."""
        _, tnet = nets(homeo=True)
        base = rng.key(11)
        whole, wout = run(tnet.static, tnet.params, tnet.state0, TICKS, gen_base=base)
        state, parts = tnet.state0, []
        for _ in range(3):
            state, out = run(tnet.static, tnet.params, state, 100, gen_base=base)
            parts.append(out["spikes"])
        assert torch.equal(torch.cat(parts), wout["spikes"])
        for a, b in zip((state.neurons.v, state.neurons.u, state.ring, state.key,
                         *state.weights, *(h for h in state.homeo if h is not None)),
                        (whole.neurons.v, whole.neurons.u, whole.ring, whole.key,
                         *whole.weights, *(h for h in whole.homeo if h is not None))):
            assert torch.equal(a, b)

    def test_fold_in_stream_equals_reference_uniforms(self):
        base = jax.random.key(3)
        ts = jnp.arange(40, 90, dtype=jnp.int32)
        want = jax.vmap(lambda k: jax.random.uniform(k, (30,), dtype=jnp.float32))(
            jax.vmap(lambda i: jax.random.fold_in(base, i))(ts))
        got = rng.uniform(rng.fold_in(port_key(base), torch.arange(40, 90)), (30,))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestGenChunk:
    @pytest.mark.parametrize("chunk", [50, 100, 300, 1000])
    def test_matches_reference(self, chunk):
        rnet, tnet = nets()
        rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, TICKS, gen_chunk=chunk)
        tfinal, tout = run(tnet.static, tnet.params, tnet.state0, TICKS, gen_chunk=chunk)
        assert int(tout["spikes"].sum()) > 100
        assert_same(rfinal, rout, tfinal, tout)

    def test_chunk_covering_run_is_bitwise_whole_draw(self):
        _, tnet = nets()
        eng = Engine(tnet)
        _, whole = eng.run(TICKS)
        _, covered = eng.run(TICKS, gen_chunk=TICKS)
        assert torch.equal(whole["spikes"], covered["spikes"])

    def test_chunked_run_deterministic_and_statistically_matched(self):
        _, tnet = nets()
        eng = Engine(tnet)
        _, whole = eng.run(TICKS)
        _, a = eng.run(TICKS, gen_chunk=50)
        _, b = eng.run(TICKS, gen_chunk=50)
        assert torch.equal(a["spikes"], b["spikes"])
        sa, sw = int(a["spikes"].sum()), int(whole["spikes"].sum())
        assert 0.5 * sw < sa < 2.0 * sw

    @pytest.mark.parametrize("plastic", [False, True])
    def test_with_homeostasis_matches_reference(self, plastic):
        """The chunks and the homeostasis segments share their boundaries;
        weights and rates bit for bit (with ``CHAIN_STDP`` too)."""
        rnet, tnet = nets(homeo=True, plastic=plastic)
        rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, TICKS, gen_chunk=100)
        tfinal, tout = run(tnet.static, tnet.params, tnet.state0, TICKS, gen_chunk=100)
        assert_same(rfinal, rout, tfinal, tout, plastic=_chain(tnet))

    def test_fused_backend_matches_default(self):
        _, tnet = nets(propagation="packed")
        fused = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16", backend="fused",
                                   device="cpu")
        assert fused.static.fused_kernel
        f, fo = run(fused.static, fused.params, fused.state0, TICKS, gen_chunk=50)
        p, po = run(tnet.static, tnet.params, tnet.state0, TICKS, gen_chunk=50)
        assert torch.equal(fo["spikes"], po["spikes"]) and torch.equal(f.key, p.key)


class TestActive:
    @pytest.mark.parametrize("gen", ["default", "gen_base", "gen_chunk"])
    def test_inactive_matches_reference(self, gen):
        """``active=False``: no generator spike, so the net stays at rest,
        and homeostasis holds the weights, as the reference's."""
        rnet, tnet = nets(homeo=True)
        kw = {"default": {}, "gen_chunk": {"gen_chunk": 100}}.get(gen)
        rkw = kw if kw is not None else {"gen_base": jax.random.key(5)}
        tkw = kw if kw is not None else {"gen_base": port_key(jax.random.key(5))}
        rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, 200,
                               active=jnp.asarray(False), **rkw)
        tfinal, tout = run(tnet.static, tnet.params, tnet.state0, 200,
                           active=torch.tensor(False), **tkw)
        assert int(tout["spikes"].sum()) == 0
        assert_same(rfinal, rout, tfinal, tout, plastic=_chain(tnet))
        for j in _chain(tnet):
            assert torch.equal(tfinal.weights[j], tnet.state0.weights[j])
            assert torch.equal(tfinal.homeo[j], tnet.state0.homeo[j])

    def test_active_true_changes_nothing(self):
        _, tnet = nets(homeo=True)
        a, ao = run(tnet.static, tnet.params, tnet.state0, 200, active=torch.tensor(True))
        b, bo = run(tnet.static, tnet.params, tnet.state0, 200)
        assert torch.equal(ao["spikes"], bo["spikes"])
        assert all(torch.equal(x, y) for x, y in zip(a.weights, b.weights))
        assert any(not torch.equal(a.weights[j], tnet.state0.weights[j])
                   for j in _chain(tnet))

    def test_python_bool_and_bad_values(self):
        _, tnet = nets()
        _, o = run(tnet.static, tnet.params, tnet.state0, 50, active=False)
        assert int(o["spikes"].sum()) == 0
        with pytest.raises(ValueError, match="active"):
            run(tnet.static, tnet.params, tnet.state0, 50, active=torch.tensor([True]))
        with pytest.raises(ValueError, match="active"):
            run(tnet.static, tnet.params, tnet.state0, 50, active=torch.tensor(1.0))


class TestErrors:
    def _net(self, **kw):
        return nets(**kw)[1]

    def test_non_divisor_chunk_raises(self):
        net = self._net()
        with pytest.raises(ValueError, match="gen_chunk"):
            run(net.static, net.params, net.state0, TICKS, gen_chunk=77)

    @pytest.mark.parametrize("chunk", [0, -5])
    def test_nonpositive_chunk_raises(self, chunk):
        net = self._net()
        with pytest.raises(ValueError, match="gen_chunk"):
            run(net.static, net.params, net.state0, TICKS, gen_chunk=chunk)

    def test_gen_base_excludes_gen_chunk(self):
        net = self._net()
        with pytest.raises(ValueError, match="mutually exclusive"):
            run(net.static, net.params, net.state0, 100, gen_base=rng.key(0), gen_chunk=50)

    def test_chunk_misaligned_with_homeostasis_period_raises(self):
        net = self._net(homeo=True)
        with pytest.raises(ValueError, match="homeostasis"):
            run(net.static, net.params, net.state0, 30)  # the period is 100
        with pytest.raises(ValueError, match="homeostasis"):
            run(net.static, net.params, net.state0, 200, gen_chunk=50)

    def test_injected_uniforms_exclude_streams(self):
        net = self._net()
        gu = torch.rand((100, net.static.n_gen))
        with pytest.raises(ValueError, match="exclude"):
            run(net.static, net.params, net.state0, 100, gen_u=gu, gen_chunk=50)
        with pytest.raises(ValueError, match="exclude"):
            run(net.static, net.params, net.state0, 100,
                generator=torch.Generator().manual_seed(0), gen_base=rng.key(0))

    def test_bad_gen_base_raises(self):
        net = self._net()
        with pytest.raises(ValueError, match="gen_base"):
            run(net.static, net.params, net.state0, 10, gen_base=torch.zeros(2))
        with pytest.raises(ValueError, match="gen_base"):
            run(net.static, net.params, net.state0, 10,
                gen_base=torch.zeros(3, dtype=torch.int32))

    @pytest.mark.parametrize("kw,item", [({"tel_carry": ()}, "A6"),
                                         ({"return_tel_carry": True}, "A6"),
                                         ({"watch_carry": ()}, "A10")])
    def test_unported_carries_raise(self, kw, item):
        """The telemetry carries are ported (A6): ``tel_carry`` resumes a
        run's monitors, so two runs of 50 ticks on ``gen_base`` fed each
        other's carry equal one of 100, as in the reference;
        ``return_tel_carry`` without monitors is the reference's ValueError.
        So is ``watch_carry`` (A10): a net without watches ignores it, as
        the reference's run does, and on a net with watches two runs of 50
        fed each other's carry give one run's of 100, and the reference's
        carry."""
        net = self._net()
        if item == "A10":
            key = rng.key(5)
            _, bare = run(net.static, net.params, net.state0, 10, gen_base=key)
            _, ignored = run(net.static, net.params, net.state0, 10, gen_base=key, **kw)
            assert ignored.keys() == bare.keys() == {"spikes"}
            assert torch.equal(ignored["spikes"], bare["spikes"])
            watched = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16",
                                         propagation="sparse", device="cpu",
                                         watches="default")
            _, whole = run(watched.static, watched.params, watched.state0, 100,
                           gen_base=key, record="none")
            mid, first = run(watched.static, watched.params, watched.state0, 50,
                             gen_base=key, record="none")
            _, second = run(watched.static, watched.params, mid, 50, gen_base=key,
                            record="none", watch_carry=first["watch_carry"])
            rwatched = rsyn.build_synfire(rsyn.SYNFIRE4_MINI, policy="fp16",
                                          propagation="sparse", monitors=None,
                                          watches="default")
            _, rwhole = ref_run(rwatched.static, rwatched.params, rwatched.state0, 100,
                                gen_base=jax.random.key(5), record="none")
            for got, one, want in zip(second["watch_carry"], whole["watch_carry"],
                                      rwhole["watch_carry"]):
                for x, y, z in zip(got, one, want):
                    assert torch.equal(x, y)
                    np.testing.assert_array_equal(x.numpy(), np.asarray(z))
            return
        if "return_tel_carry" in kw:
            with pytest.raises(ValueError, match="return_tel_carry requires"):
                run(net.static, net.params, net.state0, 10, **kw)
            return
        key = rng.key(5)
        _, whole = run(net.static, net.params, net.state0, 100, record="monitors",
                       gen_base=key)
        mid, first = run(net.static, net.params, net.state0, 50, record="monitors",
                         gen_base=key, return_tel_carry=True)
        _, second = run(net.static, net.params, mid, 50, record="monitors", gen_base=key,
                        tel_carry=first["tel_carry"])
        for name in ("spike_count", "group_rate"):
            assert torch.equal(second["telemetry"][name], whole["telemetry"][name]), name


def _raster(tnet, ticks=TICKS, **kw):
    _, out = run(tnet.static, tnet.params, tnet.state0, ticks, **kw)
    return out["spikes"]


class TestLoop:
    @pytest.mark.parametrize("policy", ["fp32", "fp16"])
    def test_loop_matches_packed_sparse_auto(self, policy):
        """``tests/test_sparse.py::test_sparse_matches_loop_and_packed_bitwise``
        on the port, and the loop raster equals the reference's loop raster."""
        rasters = {p: _raster(nets(policy=policy, propagation=p)[1])
                   for p in ("loop", "packed", "sparse", "auto")}
        assert int(rasters["loop"].sum()) > 50
        for p in ("packed", "sparse", "auto"):
            assert torch.equal(rasters["loop"], rasters[p]), p
        rnet, tnet = nets(policy=policy, propagation="loop")
        rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, TICKS)
        tfinal, tout = run(tnet.static, tnet.params, tnet.state0, TICKS)
        if policy == "fp16":
            assert_same(rfinal, rout, tfinal, tout)
            return
        # fp32 membranes: the jitted reference contracts mul+add (ROADMAP
        # queue C); raster and ring (exact sums) bit for bit, v and u at
        # test_torch_engine's tolerance against the compile without it.
        np.testing.assert_array_equal(tout["spikes"].numpy(), np.asarray(rout["spikes"]))
        np.testing.assert_array_equal(tfinal.ring.numpy(), np.asarray(rfinal.ring))
        unfused = ref_run.lower(rnet.static, rnet.params, rnet.state0, TICKS).compile(
            compiler_options={"xla_backend_optimization_level": 0})(rnet.params, rnet.state0)[0]
        for name in ("v", "u"):
            np.testing.assert_allclose(getattr(tfinal.neurons, name).numpy(),
                                       np.asarray(getattr(unfused.neurons, name)),
                                       rtol=1e-5, atol=1e-4, err_msg=name)

    @pytest.mark.parametrize("policy", ["fp32", "fp16"])
    def test_synfire4_loop_matches_packed(self, policy):
        _, loop = nets("SYNFIRE4", policy, "loop")
        _, packed = nets("SYNFIRE4", policy, "packed")
        a, b = _raster(loop), _raster(packed)
        assert int(a.sum()) > 1000 and torch.equal(a, b)

    def test_loop_stores_every_projection_dense(self):
        _, tnet = nets(propagation="loop", plastic=True)
        assert tnet.static.csr_projs == frozenset()
        assert all(i is None for i in tnet.params.proj_csr_idx)
        for j, s in enumerate(tnet.static.projections):
            assert tuple(tnet.state0.weights[j].shape) == (s.pre_size, s.post_size)

    def test_loop_rejects_fused_backend(self):
        with pytest.raises(ValueError, match="loop"):
            tsyn.build_synfire(tsyn.SYNFIRE4_MINI, backend="fused", propagation="loop",
                               device="cpu")

    def test_auto_mixed_plan_matches_loop(self):
        """``tests/test_sparse.py::test_auto_mixed_plan_matches_loop_bitwise``:
        dense and sparse buckets in one tick against the loop oracle."""
        def build(propagation):
            net = NetworkBuilder(seed=9)
            net.add_spike_generator("g", 200, rate_hz=60.0)
            net.add_group("e", izh4(200, a=0.02, b=0.2, c=-65.0, d=8.0))
            net.add_group("i", izh4(40, a=0.1, b=0.2, c=-65.0, d=2.0))
            net.connect("g", "e", fanin=8, weight=2.5, delay_ms=3)
            net.connect("e", "i", fanin=60, weight=0.5, delay_ms=1)
            net.connect("i", "e", fanin=10, weight=-1.0, delay_ms=2)
            return net.compile(policy="fp32", propagation=propagation, device="cpu")

        auto = build("auto")
        assert sorted(b.kind for b in auto.static.buckets) == ["dense", "dense", "sparse"]
        a, b = _raster(auto, 200), _raster(build("loop"), 200)
        assert int(b.sum()) > 100 and torch.equal(a, b)

    def test_packed_matches_loop_on_deterministic_net(self):
        """``tests/test_backends.py::test_packed_matches_loop_on_deterministic_net``:
        no generators, an external current; the loop raster also equals
        the reference's."""
        def build(builder, lib_izh4, propagation, **kw):
            net = builder(seed=3)
            net.add_group("a", lib_izh4(40, a=0.02, b=0.2, c=-65.0, d=8.0))
            net.add_group("b", lib_izh4(40, a=0.1, b=0.2, c=-65.0, d=2.0))
            net.connect("a", "b", fanin=10, weight=2.0, delay_ms=3)
            net.connect("b", "a", fanin=5, weight=-1.0, delay_ms=2)
            return net.compile(policy="fp32", propagation=propagation, **kw)

        i_ext = np.zeros((TICKS, 80), np.float32)
        i_ext[:, :40] = 12.0
        rasters = [_raster(build(NetworkBuilder, izh4, p, device="cpu"),
                           i_ext=torch.from_numpy(i_ext)) for p in ("packed", "loop")]
        assert int(rasters[0].sum()) > 100 and torch.equal(rasters[0], rasters[1])
        rnet = build(RBuilder, rizh4, "loop")
        _, rout = ref_run(rnet.static, rnet.params, rnet.state0, TICKS, i_ext=jnp.asarray(i_ext))
        np.testing.assert_array_equal(rasters[1].numpy(), np.asarray(rout["spikes"]))

    @pytest.mark.parametrize("policy", ["fp16", "fp32"])
    def test_plastic_and_stp_loop_match_reference(self, policy):
        """Plastic (pair STDP with homeostasis, DA-STDP) and STP projections
        under the loop oracle, dense-stored, against the reference's loop:
        raster, v, u, ring, weights, traces, STP state and homeostasis rates
        bit for bit. fp16 against the reference compiled without XLA CPU's
        mul+add contraction, as ``test_torch_plastic_engine`` holds plastic
        runs; fp32, whose f32 traces and scaling that compile still
        contracts (ROADMAP queue C), against the reference evaluated op by
        op over 150 ticks."""
        def build(builder, lib_izh4, stdp_cfg, stp_cfg, homeo_cfg, **kw):
            net = builder(seed=12)
            net.add_spike_generator("g", 40, rate_hz=80.0)
            net.add_group("e", lib_izh4(30, a=0.02, b=0.2, c=-65.0, d=8.0))
            net.add_group("i", lib_izh4(10, a=0.1, b=0.2, c=-65.0, d=2.0))
            net.connect("g", "e", fanin=12, weight=2.0, delay_ms=2,
                        stdp=stdp_cfg(a_plus=0.01, a_minus=0.002, w_max=6.0),
                        homeostasis=homeo_cfg(**HOMEO))
            net.connect("e", "i", fanin=8, weight=1.5, delay_ms=1, stp=stp_cfg())
            net.connect("i", "e", fanin=4, weight=-1.0, delay_ms=3,
                        stdp=stdp_cfg(a_plus=0.01, a_minus=0.002, w_min=-4.0, w_max=0.0),
                        da_modulated=True)
            return net.compile(policy=policy, propagation="loop", homeostasis_period=50,
                               **kw)

        rnet = build(RBuilder, rizh4, rpl.STDPConfig, RSTP, rpl.HomeostasisConfig)
        tnet = build(NetworkBuilder, izh4, tpl.STDPConfig, STPConfig, tpl.HomeostasisConfig,
                     device="cpu")
        ticks = TICKS if policy == "fp16" else 150
        da = jnp.asarray(np.linspace(0.0, 1.0, ticks).astype(np.float32))
        if policy == "fp16":
            rfinal, rout = ref_run.lower(rnet.static, rnet.params, rnet.state0, ticks,
                                         dopamine=da).compile(
                compiler_options={"xla_backend_optimization_level": 0})(
                rnet.params, rnet.state0, dopamine=da)
        else:
            with jax.disable_jit():
                rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, ticks,
                                       dopamine=da)
        tfinal, tout = run(tnet.static, tnet.params, tnet.state0, ticks,
                           dopamine=torch.from_numpy(np.asarray(da)))
        assert int(tout["spikes"].sum()) > 50
        assert_same(rfinal, rout, tfinal, tout, plastic=(0, 2))
        for a, b in (*zip(tfinal.stp[1], rfinal.stp[1]),
                     *(x for j in (0, 2) for x in zip(tfinal.stdp[j], rfinal.stdp[j]))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
