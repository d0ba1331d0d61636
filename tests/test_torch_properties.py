"""The reference's system invariants (``tests/test_properties.py``,
hypothesis) held by the port: delays move charge without making or losing
it, refractoriness bounds spike counts, the CSR drive is the dense dot
(bit for bit in fp32 on an exactly representable grid, close in fp16), the
sparse engine reproduces the loop oracle, the reference's event gating
changes no spike of the port's ungated sparse run, MoE gates stay finite
and a zero capacity drops every token, and TokenStream's steps differ.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import NetworkBuilder as JBuilder, izh4 as jizh4, run as jrun
from repro_torch import configs
from repro_torch.core import NetworkBuilder, izh4, run
from repro_torch.core.synapses import dense_to_csr
from repro_torch.data.synthetic import TokenStream
from repro_torch.kernels import ref
from repro_torch.models.moe import MoE, moe_apply


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@given(st.integers(min_value=1, max_value=9), st.integers(min_value=1, max_value=9))
@settings(max_examples=10, deadline=None)
def test_total_delivered_current_independent_of_delay(d1, d2):
    """Delays reorder delivery, never create or destroy charge: the summed
    synaptic current over a long window is delay-invariant."""
    def total(delay):
        net = NetworkBuilder(seed=0)
        net.add_spike_generator("g", 20, rate_hz=100.0, until_ms=50.0)
        net.add_group("n", izh4(10, a=0.02, b=0.2, c=-65.0, d=8.0))
        net.connect("g", "n", fanin=5, weight=0.05, delay_ms=delay)
        c = net.compile(policy="fp32", device="cpu")
        _, out = run(c.static, c.params, c.state0, 100, record_i=True)
        return float(out["i_syn"][:, 20:].sum())

    t1, t2 = total(d1), total(d2)
    assert abs(t1 - t2) <= 1e-3 * max(abs(t1), 1.0)


@given(st.integers(min_value=0, max_value=2**31 - 1))
@settings(max_examples=5, deadline=None)
def test_spike_counts_bounded_by_refractory(seed):
    """No neuron exceeds one spike per tick."""
    net = NetworkBuilder(seed=seed)
    net.add_spike_generator("g", 10, rate_hz=500.0)
    net.add_group("n", izh4(5, a=0.1, b=0.2, c=-65.0, d=2.0))
    net.connect("g", "n", fanin=5, weight=30.0, delay_ms=1)
    c = net.compile(policy="fp16", device="cpu")
    _, out = run(c.static, c.params, c.state0, 50)
    assert int(out["spikes"].sum(dim=0).max()) <= 50


@given(st.integers(min_value=0, max_value=2**31 - 1), st.integers(min_value=1, max_value=160),
       st.integers(min_value=1, max_value=90), st.floats(min_value=0.05, max_value=0.6))
@settings(max_examples=25, deadline=None)
def test_csr_drive_bitwise_equals_dense_dot_fp32(seed, p, q, density):
    """On weights from an exactly representable grid every f32 sum order
    gives the same bits: the CSR gather sums the dense dot's terms."""
    rng = np.random.default_rng(seed)
    mask = rng.random((p, q)) < density
    w = np.where(mask, rng.integers(-16, 17, (p, q)) * 0.25, 0.0).astype(np.float32)
    spikes = torch.from_numpy((rng.random(p) < 0.3).astype(np.float32))
    csr = dense_to_csr(torch.from_numpy(mask), torch.from_numpy(w))
    dense = spikes @ torch.from_numpy(w)
    assert torch.equal(dense, ref.syn_gather_ref(spikes, csr.idx, csr.weight))


@given(st.integers(min_value=0, max_value=2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_csr_drive_allclose_fp16(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((100, 70)) < 0.3
    w16 = torch.from_numpy(np.where(mask, rng.normal(1.0, 0.5, (100, 70)), 0.0)).to(
        torch.float16)
    spikes = torch.from_numpy((rng.random(100) < 0.3).astype(np.float32))
    csr = dense_to_csr(torch.from_numpy(mask), w16.to(torch.float32),
                       storage_dtype=torch.float16)
    dense = spikes @ w16.to(torch.float32)
    torch.testing.assert_close(ref.syn_gather_ref(spikes, csr.idx, csr.weight), dense,
                               rtol=1e-6, atol=1e-5)


def _random_net(builder, neuron, seed, delay, w, **compile_kw):
    net = builder(seed=seed)
    net.add_spike_generator("g", 24, rate_hz=150.0)
    net.add_group("e", neuron(20, a=0.02, b=0.2, c=-65.0, d=8.0))
    net.add_group("i", neuron(8, a=0.1, b=0.2, c=-65.0, d=2.0))
    net.connect("g", "e", fanin=6, weight=w, delay_ms=delay)
    net.connect("e", "i", fanin=5, weight=2.0 * w, delay_ms=1)
    net.connect("i", "e", fanin=3, weight=-1.5, delay_ms=2)
    return net.compile(**compile_kw)


@given(st.integers(min_value=1, max_value=6), st.integers(min_value=1, max_value=8),
       st.sampled_from([0.5, 1.0, 2.0, 2.5, 4.0]))
@settings(max_examples=6, deadline=None)
def test_sparse_engine_bitwise_equals_loop_fp32(seed, delay, w):
    """Random generator-driven nets: the sparse tick (gather, per-delay ring
    commit, the generators' draws) reproduces the loop oracle's raster."""
    rasters = {}
    for prop in ("loop", "sparse"):
        c = _random_net(NetworkBuilder, izh4, seed, delay, w, policy="fp32",
                        propagation=prop, device="cpu")
        rasters[prop] = run(c.static, c.params, c.state0, 80)[1]["spikes"]
    assert torch.equal(rasters["loop"], rasters["sparse"])


@given(st.integers(min_value=0, max_value=2**31 - 1))
@settings(max_examples=4, deadline=None)
def test_event_gating_neutral_on_sparse_random_net(seed):
    """The reference gates a bucket on its pre spikes; the port runs every
    bucket ungated. Both reference runs, gated and not, equal the port's
    raster."""
    def jnet():
        net = JBuilder(seed=seed)
        net.add_spike_generator("g", 16, rate_hz=60.0, until_ms=40.0)
        net.add_group("n", jizh4(12, a=0.02, b=0.2, c=-65.0, d=8.0))
        net.connect("g", "n", fanin=4, weight=3.0, delay_ms=3)
        return net.compile(policy="fp16", propagation="sparse")

    net = NetworkBuilder(seed=seed)
    net.add_spike_generator("g", 16, rate_hz=60.0, until_ms=40.0)
    net.add_group("n", izh4(12, a=0.02, b=0.2, c=-65.0, d=8.0))
    net.connect("g", "n", fanin=4, weight=3.0, delay_ms=3)
    c = net.compile(policy="fp16", propagation="sparse", device="cpu")
    port = run(c.static, c.params, c.state0, 100)[1]["spikes"].numpy()
    j = jnet()
    for gated in (True, False):
        _, out = jrun(dataclasses.replace(j.static, event_gated=gated), j.params, j.state0, 100)
        np.testing.assert_array_equal(np.asarray(out["spikes"]), port)


def _granite():
    return configs.reduce_arch(configs.get_arch("granite-moe-1b-a400m"))


@given(st.integers(min_value=0, max_value=10_000))
@settings(max_examples=10, deadline=None)
def test_moe_gates_renormalized_and_output_finite(seed):
    cfg = _granite()
    p = MoE(cfg, torch.Generator().manual_seed(seed % 100), torch.float16)
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(seed))
    out, aux = moe_apply(p, x, cfg)
    assert out.shape == x.shape and bool(torch.isfinite(out.float()).all())
    assert float(aux) >= 0.99  # the Switch loss is 1 at balance, above it otherwise


def test_zero_capacity_factor_drops_everything():
    cfg = _granite()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1e-9))
    p = MoE(cfg, torch.Generator().manual_seed(0), torch.float16)
    x = torch.randn((1, 8, cfg.d_model), generator=torch.Generator().manual_seed(1))
    out, _ = moe_apply(p, x, cfg)  # granite has no shared experts: the routed output only
    assert float(out.abs().mean()) < float(x.abs().mean())


def test_different_steps_differ():
    s = TokenStream(vocab_size=1024, seq_len=32, global_batch=4, seed=9)
    a, b = s.batch(0)["tokens"], s.batch(1)["tokens"]
    assert not torch.equal(a, b)


@given(st.integers(min_value=0, max_value=1_000_000))
@settings(max_examples=10, deadline=None)
def test_step_keyed_determinism(step):
    s = TokenStream(vocab_size=1024, seq_len=32, global_batch=4, seed=9)
    a, b = s.batch(step)["tokens"], s.batch(step)["tokens"]
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < 1024


def test_moe_matches_reference_on_a_draw():
    """The port's MoE block on the reference's weights and input: the same
    output and aux loss (the invariants above then hold of the reference's
    numbers too)."""
    from repro.configs import get_arch as jget_arch, reduce_arch as jreduce
    from repro.models.moe import init_moe, moe_apply as jmoe

    jcfg = jreduce(jget_arch("granite-moe-1b-a400m"))
    jp = init_moe(jax.random.key(3), jcfg, jnp.float16)
    x = jax.random.normal(jax.random.key(4), (2, 16, jcfg.d_model))
    jout, jaux = jmoe(jp, x, jcfg)
    cfg = _granite()
    p = MoE(cfg, None, torch.float16)
    for name in ("router", "w_gate", "w_up", "w_down"):
        getattr(p, name).data = torch.from_numpy(np.asarray(jp[name], np.float32)).to(
            torch.float16)
    out, aux = moe_apply(p, torch.from_numpy(np.asarray(x)), cfg)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32),
                               rtol=2e-3, atol=2e-3)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
