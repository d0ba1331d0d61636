"""``backend="fused"`` on the port against the reference, on the CPU.

* the fused plan, field for field;
* the fused tick's plain version against the reference's
  ``kernels.ref.fused_tick_ref``, jitted, on random small cases;
* whole runs against the reference's ``backend="fused"`` runs (which take
  its XLA fused path on the CPU) and against the port's own default
  backend: rasters bit for bit, fp16 state bit for bit, fp32 state at
  slice 1's tolerance against the reference compiled without mul+add
  contraction (``tests/test_torch_engine.py`` says why);
* fused nets whose tick is not one kernel, which tick as the default
  backend does, against the reference's ``propagate_fused``;
* the default generator stream: the reference's threefry draws, so the
  same seed gives the same raster without injecting uniforms;
* the ``ops.FusedTickRun`` wrapper on CPU tensors.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against its plain version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import synfire4 as rsyn  # noqa: E402
from repro.core import NetworkBuilder as RBuilder, izh4 as rizh4  # noqa: E402
from repro.core.engine import run as ref_run, step as ref_step  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro_torch.configs import synfire4 as tsyn  # noqa: E402
from repro_torch.core import NetworkBuilder, izh4, run, step  # noqa: E402
from repro_torch.core.backend import assemble_fused  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.fused_tick import assemble_kernel  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread keeps PyTorch's thread
    pool from spinning against the other test workers' cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


MINI_TICKS = 250
FULL_TICKS = 1000
NO_CONTRACTION = {"xla_backend_optimization_level": 0}


def build_both(cfg_name, policy, propagation, backend="fused", **kw):
    rnet = rsyn.build_synfire(getattr(rsyn, cfg_name), policy=policy,
                              propagation=propagation, monitors=None,
                              backend="xla" if backend is None else backend, **kw)
    tnet = tsyn.build_synfire(getattr(tsyn, cfg_name), policy=policy,
                              propagation=propagation, device="cpu",
                              backend=backend, **kw)
    return rnet, tnet


def ref_uniforms(rnet, n_steps):
    k_draw, _ = jax.random.split(rnet.state0.key)
    return np.asarray(jax.random.uniform(k_draw, (n_steps, rnet.static.n_gen),
                                         dtype=jnp.float32))


def assert_same_raster(ref_sp, port_sp):
    ref_sp, port_sp = np.asarray(ref_sp), np.asarray(port_sp)
    assert ref_sp.shape == port_sp.shape
    if not np.array_equal(ref_sp, port_sp):
        first = int(np.argwhere((ref_sp != port_sp).any(axis=1))[0][0])
        pytest.fail(f"rasters diverge first at tick {first}: "
                    f"{int((ref_sp != port_sp).sum())} entries differ")


def key_words(k):
    return k.cpu().numpy().view(np.uint32)


# -- the plan -----------------------------------------------------------------

def _gap_net(builder, lib_izh4, **kw):
    """Buckets that gather non-contiguous pre spans and scatter into
    non-contiguous post spans (``test_torch_engine.py``'s net)."""
    net = builder(seed=7)
    net.add_group("a", lib_izh4(30, a=0.02, b=0.2, c=-65.0, d=8.0))
    net.add_group("b", lib_izh4(20, a=0.1, b=0.2, c=-65.0, d=2.0))
    net.add_group("c", lib_izh4(25, a=0.02, b=0.2, c=-65.0, d=8.0))
    net.connect("a", "b", fanin=6, weight=2.0, delay_ms=3)
    net.connect("c", "b", fanin=5, weight=1.5, delay_ms=3)
    net.connect("b", "a", fanin=4, weight=-1.0, delay_ms=2)
    net.connect("b", "c", fanin=4, weight=-1.0, delay_ms=2)
    return net.compile(policy="fp32", backend="fused", **kw)


def assert_same_plan(rstatic, tstatic):
    for f in ("delays", "dense_classes", "sparse_ids", "kernel_ok"):
        assert getattr(tstatic.fused, f) == getattr(rstatic.fused, f), f
    assert tstatic.backend == "fused" and tstatic.fused_kernel == tstatic.fused.kernel_ok


@pytest.mark.parametrize("cfg_name,propagation", [
    ("SYNFIRE4", "packed"), ("SYNFIRE4", "sparse"), ("SYNFIRE4", "auto"),
    ("SYNFIRE4_MINI", "packed"), ("SYNFIRE4_MINI", "sparse")])
def test_fused_plan_matches_reference(cfg_name, propagation):
    rnet, tnet = build_both(cfg_name, "fp16", propagation)
    assert_same_plan(rnet.static, tnet.static)
    assert tnet.static.fused.kernel_ok


def test_fused_plan_of_gathered_net_matches_reference():
    rnet = _gap_net(RBuilder, rizh4, monitors=None)
    tnet = _gap_net(NetworkBuilder, izh4, device="cpu")
    assert_same_plan(rnet.static, tnet.static)
    assert not tnet.static.fused.kernel_ok


def test_fused_rejects_loop_propagation():
    with pytest.raises(ValueError, match="loop"):
        tsyn.build_synfire(tsyn.SYNFIRE4_MINI, device="cpu", backend="fused",
                           propagation="loop")
    with pytest.raises(ValueError, match="backend"):
        tsyn.build_synfire(tsyn.SYNFIRE4_MINI, device="cpu", backend="pallas")


# -- the plain version against the reference's --------------------------------

N, L, N_GEN = 64, 4, 10
# (pre_start, post_start, delay, P, Q): two buckets share a post span and a
# delay, as Synfire4's packed plan does.
DENSE = ((0, 20, 2, 10, 15), (10, 20, 2, 12, 15), (30, 45, 3, 15, 19))
CSR = ((0, 3, 20, 40, 20, 6),)  # (post_start, delay, pre_start, pre_size, Q, F)


def _tick_case(seed, dtype, exact):
    """A random tick case: state, ring, generator rows and bucket tables."""
    r = np.random.default_rng(seed)
    v = r.uniform(-75.0, 25.0, N).astype(np.float32)
    u = r.uniform(-16.0, -8.0, N).astype(np.float32)
    ring = (r.integers(-24, 40, (L, N)) / 8.0).astype(np.float32)
    is_gen = np.arange(N) < N_GEN
    a = np.where(np.arange(N) % 3 == 0, 0.1, 0.02).astype(np.float32)
    b = np.full(N, 0.2, np.float32)
    c = np.full(N, -65.0, np.float32)
    d = np.where(np.arange(N) % 3 == 0, 2.0, 8.0).astype(np.float32)

    def weights(shape):
        if exact:
            return (r.integers(-16, 17, shape) / 4.0).astype(np.float32)
        return r.standard_normal(shape).astype(np.float32)

    dense = [(ps, qs, dly, weights((p, q))) for ps, qs, dly, p, q in DENSE]
    csr = []
    for qs, dly, ps, pn, q, f in CSR:
        idx = np.stack([r.choice(pn, f, replace=False) for _ in range(q)]) + ps
        w = weights((q, f))
        idx[::3, -2:] = ps  # padding: index pre_start, weight +0.0
        w[::3, -2:] = 0.0
        csr.append((qs, dly, idx.astype(np.int32), w))
    gen_rows = r.random((12, N)) < 0.3
    return dict(v=v.astype(dtype), u=u.astype(dtype), ring=ring.astype(dtype),
                is_gen=is_gen, a=a, b=b, c=c, d=d, dense=dense, csr=csr,
                gen_rows=gen_rows)


def _ref_tick_fn(case):
    """The reference's plain tick, jitted over the array operands."""
    shape_d = [(ps, qs, dly) for ps, qs, dly, _ in case["dense"]]
    shape_c = [(qs, dly) for qs, dly, _, _ in case["csr"]]

    def tick(v, u, ring, gen_row, is_gen, a, b, c, d, t, dws, cis, cws):
        dense = [(ps, qs, dly, w) for (ps, qs, dly), w in zip(shape_d, dws)]
        csr = [(qs, dly, i, w) for (qs, dly), i, w in zip(shape_c, cis, cws)]
        return rref.fused_tick_ref(v, u, ring, gen_row, is_gen, a, b, c, d, t,
                                   dense=dense, csr=csr, ring_len=L)

    return jax.jit(tick)


def _ref_ticks(case, *, eager: bool):
    """The reference's outputs for every tick of the case, state chained:
    jitted without mul+add contraction, or evaluated op by op."""
    dws = [jnp.asarray(w) for *_, w in case["dense"]]
    cis = [jnp.asarray(i) for _, _, i, _ in case["csr"]]
    cws = [jnp.asarray(w) for *_, w in case["csr"]]
    fn = _ref_tick_fn(case)
    state = tuple(jnp.asarray(case[k]) for k in ("v", "u", "ring"))
    consts = [jnp.asarray(case[k]) for k in ("is_gen", "a", "b", "c", "d")]
    if not eager:
        fn = fn.lower(*state, jnp.asarray(case["gen_rows"][0]), *consts, jnp.int32(0),
                      dws, cis, cws).compile(compiler_options=NO_CONTRACTION)
    outs = []
    for t, gen in enumerate(case["gen_rows"]):
        if eager:
            with jax.disable_jit():
                out = fn(*state, jnp.asarray(gen), *consts, jnp.int32(t), dws, cis, cws)
        else:
            out = fn(*state, jnp.asarray(gen), *consts, jnp.int32(t), dws, cis, cws)
        outs.append([np.asarray(x) for x in out])
        state = (out[0], out[1], out[3])
    return outs


def _port_ticks(case):
    tt = {k: torch.from_numpy(np.array(case[k])) for k in
          ("v", "u", "ring", "is_gen", "a", "b", "c", "d")}
    dense = tuple((ps, qs, dly, torch.from_numpy(w)) for ps, qs, dly, w in case["dense"])
    csr = tuple((qs, dly, torch.from_numpy(i), torch.from_numpy(w))
                for qs, dly, i, w in case["csr"])
    state = (tt["v"], tt["u"], tt["ring"])
    outs = []
    for t, gen in enumerate(case["gen_rows"]):
        out = ref.fused_tick_ref(*state, torch.from_numpy(gen), tt["is_gen"], tt["a"],
                                 tt["b"], tt["c"], tt["d"], t, dense=dense, csr=csr,
                                 ring_len=L)
        outs.append(out)
        state = (out[0], out[1], out[3])
    return outs


OUT_NAMES = ("v", "u", "spikes", "ring", "i_syn")


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "normal"])
@pytest.mark.parametrize("dtype", [np.float16, np.float32], ids=["fp16", "fp32"])
def test_fused_tick_ref_matches_reference(dtype, exact):
    """Twelve chained ticks against the reference compiled without mul+add
    contraction. Exactly representable weights: every output bit for bit,
    but fp32 v and u, which that compile still rounds a few ulp apart
    (ROADMAP queue C) and which are held at slice 1's rtol=1e-5,
    atol=1e-4 there and bit for bit against the reference evaluated op by
    op. Random normal weights: spikes bit for bit, the rest at that
    tolerance (f32 sums in another order)."""
    case = _tick_case(seed=3 if exact else 4, dtype=dtype, exact=exact)
    port = _port_ticks(case)
    jitted = _ref_ticks(case, eager=False)
    fp32 = dtype == np.float32
    n_spikes = 0
    for t, (out_t, out_r) in enumerate(zip(port, jitted)):
        for name, t_, r_ in zip(OUT_NAMES, out_t, out_r):
            assert str(t_.dtype).removeprefix("torch.") == str(r_.dtype), name
            if name == "spikes" or (exact and not (fp32 and name in ("v", "u"))):
                np.testing.assert_array_equal(t_.numpy(), r_, err_msg=f"tick {t} {name}")
            else:
                np.testing.assert_allclose(t_.float().numpy(), r_.astype(np.float32),
                                           rtol=1e-5, atol=1e-4, err_msg=f"tick {t} {name}")
        n_spikes += int(out_t[2][N_GEN:].sum())
    assert n_spikes > 0, "no neuron spiked: degenerate case"
    if exact and fp32:
        for t, (out_t, out_r) in enumerate(zip(port, _ref_ticks(case, eager=True))):
            for name, t_, r_ in zip(OUT_NAMES, out_t, out_r):
                np.testing.assert_array_equal(t_.numpy(), r_, err_msg=f"tick {t} {name}")


@pytest.mark.parametrize("bad", [-1, -N, -(N + 1), N], ids=["m1", "mN", "below", "N"])
def test_fused_tick_ref_csr_index_outside_row_matches_reference(bad):
    """A CSR index outside [0, N) in the plain version, as in the
    reference's ``fused_tick_ref`` (``jnp.take``): one in [-N, -1] counts
    from the end of the spike row, any other makes its row's drive NaN.
    Twelve chained ticks, every output bit for bit (NaN at the same
    places)."""
    case = _tick_case(seed=5, dtype=np.float16, exact=True)
    qs, dly, idx, w = case["csr"][0]
    idx = idx.copy()
    idx[1, 0] = bad
    case["csr"] = [(qs, dly, idx, w)]
    port = _port_ticks(case)
    for t, (out_t, out_r) in enumerate(zip(port, _ref_ticks(case, eager=False))):
        for name, t_, r_ in zip(OUT_NAMES, out_t, out_r):
            np.testing.assert_array_equal(t_.numpy(), r_, err_msg=f"tick {t} {name}")
    assert bool(port[0][3].isnan().any()) == (bad in (-(N + 1), N))


# -- whole runs ---------------------------------------------------------------

_RUNS: dict = {}


def fused_runs(cfg_name, policy, propagation, n_steps):
    """Reference fused run (and, for fp32, its uncontracted compile), port
    fused run and port default-backend run on the reference's uniforms."""
    key = (cfg_name, policy, propagation, n_steps)
    if key not in _RUNS:
        rnet, tnet = build_both(cfg_name, policy, propagation)
        plain = tsyn.build_synfire(getattr(tsyn, cfg_name), policy=policy,
                                   propagation=propagation, device="cpu")
        gu = ref_uniforms(rnet, n_steps)
        rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, n_steps)
        unfused = None
        if policy == "fp32":
            unfused = ref_run.lower(rnet.static, rnet.params, rnet.state0, n_steps).compile(
                compiler_options=NO_CONTRACTION)(rnet.params, rnet.state0)[0]
        tgu = torch.from_numpy(gu.copy())
        tfinal, tout = run(tnet.static, tnet.params, tnet.state0, n_steps, gen_u=tgu)
        _, pout = run(plain.static, plain.params, plain.state0, n_steps, gen_u=tgu)
        _RUNS[key] = (rfinal, np.asarray(rout["spikes"]), unfused, tfinal,
                      tout["spikes"].numpy(), pout["spikes"].numpy())
    return _RUNS[key]


RUN_CASES = [(c, p, q) for c in ("SYNFIRE4_MINI", "SYNFIRE4")
             for p in ("fp16", "fp32") for q in ("packed", "sparse")]


def _ticks(cfg_name):
    return MINI_TICKS if cfg_name == "SYNFIRE4_MINI" else FULL_TICKS


@pytest.mark.parametrize("cfg_name,policy,propagation", RUN_CASES)
def test_fused_raster_matches_reference(cfg_name, policy, propagation):
    _, rsp, _, _, tsp, psp = fused_runs(cfg_name, policy, propagation, _ticks(cfg_name))
    assert rsp.sum() > (50 if cfg_name == "SYNFIRE4_MINI" else 20_000)
    assert_same_raster(rsp, tsp)
    assert_same_raster(psp, tsp)  # and the port's default backend


@pytest.mark.parametrize("cfg_name,policy,propagation", RUN_CASES)
def test_fused_final_state_matches_reference(cfg_name, policy, propagation):
    rfinal, _, unfused, tfinal, _, _ = fused_runs(cfg_name, policy, propagation,
                                                  _ticks(cfg_name))
    assert tfinal.t == int(rfinal.t)
    np.testing.assert_array_equal(tfinal.neurons.refrac.numpy(),
                                  np.asarray(rfinal.neurons.refrac))
    for name in ("v", "u", "ring"):
        get = (lambda s: s.ring) if name == "ring" else (
            lambda s, f=name: getattr(s.neurons, f))
        t = get(tfinal).float().numpy()
        if policy == "fp16" or name == "ring":
            np.testing.assert_array_equal(t, np.asarray(get(rfinal), np.float32),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(t, np.asarray(get(unfused), np.float32),
                                       rtol=1e-5, atol=1e-4, err_msg=name)


def test_fused_records_match_default_backend():
    """v and i_syn traces, and record="none", on the fused kernel path."""
    _, tnet = build_both("SYNFIRE4_MINI", "fp16", "sparse")
    plain = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16",
                               propagation="sparse", device="cpu")
    f1, o1 = run(tnet.static, tnet.params, tnet.state0, 80, record_v=True, record_i=True)
    f2, o2 = run(plain.static, plain.params, plain.state0, 80, record_v=True, record_i=True)
    for k in ("spikes", "v", "i_syn"):
        assert torch.equal(o1[k], o2[k]), k
    assert float(o1["i_syn"].abs().sum()) > 0
    f3, o3 = run(tnet.static, tnet.params, tnet.state0, 80, record="none")
    assert o3 == {} and torch.equal(f3.ring, f1.ring)
    assert torch.equal(f1.neurons.v, f2.neurons.v) and torch.equal(f1.ring, f2.ring)
    assert torch.equal(tnet.state0.ring, torch.zeros_like(tnet.state0.ring))


def test_fused_step_matches_run():
    _, tnet = build_both("SYNFIRE4_MINI", "fp16", "packed")
    gu = torch.rand((40, tnet.static.n_gen), generator=torch.Generator().manual_seed(1))
    final, out = run(tnet.static, tnet.params, tnet.state0, 40, gen_u=gu)
    state = tnet.state0
    payload = assemble_fused(tnet.static, state.weights, tnet.params)
    for t in range(40):
        state, o = step(tnet.static, tnet.params, state, packed=payload, gen_u=gu[t])
        assert torch.equal(o.spikes, out["spikes"][t]), t
    assert torch.equal(state.neurons.v, final.neurons.v)
    assert torch.equal(state.ring, final.ring) and state.t == 40
    with pytest.raises(ValueError, match="payload"):
        step(tnet.static, tnet.params, state, gen_u=gu[0],
             packed=assemble_fused(tnet.static, state.weights))


# -- fused nets whose tick is not one kernel ----------------------------------

def test_gathered_net_runs_propagate_fused_like_reference():
    """Gathered and scattered buckets keep the net off the kernel."""
    rnet = _gap_net(RBuilder, rizh4, monitors=None)
    tnet = _gap_net(NetworkBuilder, izh4, device="cpu")
    assert not tnet.static.fused_kernel
    i_ext = np.zeros((MINI_TICKS, 75), np.float32)
    i_ext[:, :30] = 12.0
    i_ext[:, 50:] = 9.0
    _, rout = ref_run(rnet.static, rnet.params, rnet.state0, MINI_TICKS,
                      i_ext=jnp.asarray(i_ext), record_i=True)
    _, tout = run(tnet.static, tnet.params, tnet.state0, MINI_TICKS,
                  i_ext=torch.from_numpy(i_ext), record_i=True)
    assert np.asarray(rout["spikes"]).sum() > 100
    assert_same_raster(rout["spikes"], tout["spikes"].numpy())
    np.testing.assert_array_equal(tout["i_syn"].numpy(), np.asarray(rout["i_syn"]))


def test_rk4_synfire_runs_propagate_fused_like_reference():
    """RK4 keeps the net off the kernel."""
    rnet, tnet = build_both("SYNFIRE4_MINI", "fp16", "packed", method="rk4")
    assert not tnet.static.fused_kernel
    gu = ref_uniforms(rnet, MINI_TICKS)
    rfinal, rout = ref_run(rnet.static, rnet.params, rnet.state0, MINI_TICKS)
    tfinal, tout = run(tnet.static, tnet.params, tnet.state0, MINI_TICKS,
                       gen_u=torch.from_numpy(gu.copy()))
    assert np.asarray(rout["spikes"]).sum() > 50
    assert_same_raster(rout["spikes"], tout["spikes"].numpy())
    np.testing.assert_array_equal(tfinal.ring.numpy(), np.asarray(rfinal.ring))


def test_external_current_takes_propagate_fused_like_reference():
    """``i_ext`` moves a kernel_ok net off the kernel, as in the reference."""
    rnet, tnet = build_both("SYNFIRE4_MINI", "fp16", "sparse")
    i_ext = np.zeros((MINI_TICKS, tnet.static.n), np.float32)
    i_ext[100:140, 30:60] = 6.0
    gu = ref_uniforms(rnet, MINI_TICKS)
    _, rout = ref_run(rnet.static, rnet.params, rnet.state0, MINI_TICKS,
                      i_ext=jnp.asarray(i_ext))
    ops.reset_launches()
    _, tout = run(tnet.static, tnet.params, tnet.state0, MINI_TICKS,
                  i_ext=torch.from_numpy(i_ext), gen_u=torch.from_numpy(gu.copy()))
    assert_same_raster(rout["spikes"], tout["spikes"].numpy())
    assert ops.LAUNCHES["fused_tick"] == 0


# -- the default generator stream --------------------------------------------

@pytest.mark.parametrize("backend", [None, "fused"], ids=["default", "fused"])
@pytest.mark.parametrize("cfg_name", ["SYNFIRE4_MINI", "SYNFIRE4"])
def test_default_stream_matches_reference(cfg_name, backend):
    """Without ``gen_u``: the reference's raster and carry key, over two
    chained runs."""
    rnet, tnet = build_both(cfg_name, "fp16", "packed", backend=backend)
    n_steps = _ticks(cfg_name)
    r_state, t_state = rnet.state0, tnet.state0
    for _ in range(2):
        r_state, rout = ref_run(rnet.static, rnet.params, r_state, n_steps)
        t_state, tout = run(tnet.static, tnet.params, t_state, n_steps)
        assert_same_raster(rout["spikes"], tout["spikes"].numpy())
        np.testing.assert_array_equal(key_words(t_state.key),
                                      np.asarray(jax.random.key_data(r_state.key)))
        assert t_state.t == int(r_state.t)


def test_default_step_matches_reference_step():
    """``step`` without ``gen_u``: the reference's per-tick draw over the
    whole row."""
    rnet, tnet = build_both("SYNFIRE4_MINI", "fp16", "packed", backend=None)
    rstep = jax.jit(ref_step, static_argnums=0)
    r_state, t_state = rnet.state0, tnet.state0
    n_gen_spikes = 0
    for _ in range(20):
        r_state, r_out = rstep(rnet.static, rnet.params, r_state)
        t_state, t_out = step(tnet.static, tnet.params, t_state)
        np.testing.assert_array_equal(t_out.spikes.numpy(), np.asarray(r_out.spikes))
        np.testing.assert_array_equal(key_words(t_state.key),
                                      np.asarray(jax.random.key_data(r_state.key)))
        n_gen_spikes += int(t_out.spikes[:tnet.static.n_gen].sum())
    assert n_gen_spikes > 0


# -- the wrapper ----------------------------------------------------------------

def _mini_tick_args(policy="fp16"):
    net = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy=policy, device="cpu",
                             backend="fused")
    payload = assemble_kernel(net.static, net.params,
                              assemble_fused(net.static, net.state0.weights).packed)
    p = net.params.neuron
    s = net.state0
    gen_row = torch.zeros(net.static.n, dtype=torch.bool)
    gen_row[:5] = True
    is_gen = p.model == 0
    return net, payload, [s.neurons.v, s.neurons.u, s.ring[:, :, 0], gen_row, is_gen,
                          p.a, p.b, p.c, p.d]


def test_wrapper_runs_plain_version_on_cpu():
    net, payload, args = _mini_tick_args()
    want = ref.fused_tick_ref(*args, 0, dense=payload.dense, csr=payload.csr,
                              ring_len=net.static.ring_len)
    v, u, ring = (x.clone() for x in args[:3])
    rows = torch.stack([args[3], torch.zeros_like(args[3])])
    v_rows, i_rows = (torch.full(rows.shape, -1.0) for _ in range(2))
    ops.reset_launches()
    ops.FusedTickRun(payload, v, u, ring, *args[4:], rows, v_rows, i_rows).tick(0, 0)
    got = (v, u, rows[0], ring, i_rows[0])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(v_rows[0], want[0].float())
    assert not rows[1].any() and bool((v_rows[1] == -1).all())  # row 1 untouched
    assert int(got[2][:5].sum()) == 5
    assert float(got[3].abs().sum()) > 0  # the generator spikes reached the ring
    assert ops.LAUNCHES["fused_tick"] == 0


def test_payload_layout():
    net, payload, _ = _mini_tick_args()
    desc = payload.desc.tolist()
    assert len(desc) == len(net.static.buckets)
    for row, b in zip(desc, net.static.buckets):
        assert row[:5] == [0 if b.kind == "dense" else 1, b.pre_start, b.post_start,
                           b.p, b.q]
        assert payload.delays[row[6]] == b.delay_ms
    assert payload.wd.numel() == sum(b.p * b.q for b in net.static.buckets)
    sparse = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16", device="cpu",
                                backend="fused", propagation="sparse")
    sp = assemble_fused(sparse.static, sparse.state0.weights, sparse.params).kernel
    for (qs, dly, idx, w), bi in zip(sp.csr, sparse.static.fused.sparse_ids):
        b = sparse.static.buckets[bi]
        assert idx.dtype == torch.int32 and int(idx.min()) >= b.pre_start
        assert int(idx.max()) < b.pre_start + b.p
        np.testing.assert_array_equal(
            idx.numpy(), sparse.params.bucket_csr_idx[bi].numpy().astype(np.int32)
            + b.pre_start)


@pytest.mark.parametrize("bad", ["ring_shape", "u_dtype", "ab_dtype", "gen_dtype",
                                 "device", "mixed_devices"])
def test_wrapper_rejects_bad_operands(bad):
    _, payload, args = _mini_tick_args()
    v, u, ring, gen_row, is_gen, a, b, c, d = args
    if bad == "ring_shape":
        ring = ring[:, :-1]
    elif bad == "u_dtype":
        u = u.float()
    elif bad == "ab_dtype":
        a = a.double()
    elif bad == "gen_dtype":
        gen_row = gen_row.to(torch.uint8)
    elif bad == "device":
        v, u, ring, gen_row, is_gen, a, b, c, d = (
            x.to("meta") for x in (v, u, ring, gen_row, is_gen, a, b, c, d))
    else:
        a = a.to("meta")
    with pytest.raises(ValueError):
        ops.FusedTickRun(payload, v, u, ring, is_gen, a, b, c, d, gen_row[None])


def test_run_wrapper_rejects_bad_rows():
    net, payload, args = _mini_tick_args()
    v, u, ring, _, is_gen, a, b, c, d = args
    rows = torch.zeros((3, net.static.n), dtype=torch.uint8)
    with pytest.raises(ValueError, match="rows"):
        ops.FusedTickRun(payload, v, u, ring, is_gen, a, b, c, d, rows)
    rows = torch.zeros((3, net.static.n), dtype=torch.bool)
    with pytest.raises(ValueError, match="v_rows"):
        ops.FusedTickRun(payload, v, u, ring, is_gen, a, b, c, d, rows,
                         v_rows=torch.zeros((2, net.static.n)))


# -- the kernel's limits and grid (checked in Python before any launch) -------

def test_kernel_limits_take_synfire4_x100():
    """N up to 262,144 (the spike bitmask in 32 KB of shared memory), at
    most 4 delays and 64 buckets: Synfire4x100's plan (N 120,000, delays 8
    and 10 on an 11-slot ring, 13 buckets) fits."""
    from repro_torch.kernels import fused_tick as ftk

    assert ftk.MAX_N >= 120_000
    ftk.check_limits(120_000, (8, 10), 13, 11)
    ftk.check_limits(ftk.MAX_N, (1, 2, 3, 4), ftk.MAX_BUCKETS, 5)


@pytest.mark.parametrize("bad,match", [
    (dict(n=262_145), "262144"), (dict(delays=(1, 2, 3, 4, 5), ring_len=6), "delays"),
    (dict(n_buckets=65), "buckets"), (dict(delays=(8, 11)), r"\[1, 11\)"),
    (dict(delays=(0, 8)), r"\[1, 11\)")])
def test_kernel_limits_raise(bad, match):
    from repro_torch.kernels import fused_tick as ftk

    kw = dict(n=120_000, delays=(8, 10), n_buckets=13, ring_len=11) | bad
    with pytest.raises(ValueError, match=match):
        ftk.check_limits(kw["n"], kw["delays"], kw["n_buckets"], kw["ring_len"])


def test_grid_is_sized_by_the_work_and_capped_at_residency():
    """One CTA per 256 neurons or per 16 CSR rows, whichever needs more
    (the mini and a one-neuron net on one CTA, Synfire4 packed on 5 and
    sparse on 116, x10 and x100 sparse on every resident CTA), never more
    than the card holds resident; an explicit grid must lie in [1,
    resident]."""
    from repro_torch.kernels import fused_tick as ftk

    assert (ftk.THREADS, ftk.CSR_ROWS_PER_CTA) == (256, 16)
    for n, rows, want in ((1, 0, 1), (186, 0, 1), (1200, 0, 5), (1200, 1850, 116),
                          (12_000, 0, 47), (12_000, 18_500, 1056),
                          (120_000, 185_000, 1056)):
        assert ftk.plan_grid(n, rows, per_sm=8, sms=132) == want, (n, rows)
    assert ftk.plan_grid(ftk.MAX_N, 0, per_sm=2, sms=132) == 264
    assert ftk.plan_grid(120_000, 0, per_sm=8, sms=132, grid=1) == 1
    assert ftk.plan_grid(120_000, 0, per_sm=8, sms=132, grid=1056) == 1056
    with pytest.raises(ValueError, match="resident"):
        ftk.plan_grid(120_000, 0, per_sm=8, sms=132, grid=1057)
    with pytest.raises(ValueError, match="resident"):
        ftk.plan_grid(1200, 0, per_sm=8, sms=132, grid=0)
    with pytest.raises(RuntimeError, match="no CTA"):
        ftk.plan_grid(1200, 0, per_sm=0, sms=132)
    with pytest.raises(RuntimeError, match="cooperative"):
        ftk.plan_grid(1200, 0, per_sm=8, sms=132, cooperative=False)


def test_pack_payload_matches_assemble_kernel():
    """The payload packed from bucket tuples in plan order is the one
    ``assemble_kernel`` builds from the compiled plan."""
    from repro_torch.kernels import fused_tick as ftk

    net = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16", device="cpu",
                             backend="fused", propagation="sparse")
    got = assemble_fused(net.static, net.state0.weights, net.params).kernel
    assert not got.dense and len(got.csr) == len(net.static.buckets)
    want = ftk.pack_payload(got.delays, [
        ("csr", b.pre_start, b.p, b.post_start, b.delay_ms, idx, w)
        for b, (_, _, idx, w) in zip(net.static.buckets, got.csr)], "cpu")
    for name in ("desc", "wd", "wc", "ic"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
