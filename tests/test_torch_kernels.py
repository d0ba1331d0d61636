"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the reference: eager ``repro.kernels.ref`` bit for bit, and the
Pallas kernels in interpret mode with the tolerances of
``tests/test_kernels.py`` (bit for bit for the two STDP kernels, which
reduce nothing). Inputs are made with numpy from a seed and handed to both
packages."""
import functools

import jax  # noqa: E402
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.izh_update import izh4_update as pallas_izh4  # noqa: E402
from repro.kernels.stdp_gather import stdp_gather as pallas_stdp_gather  # noqa: E402
from repro.kernels.stdp_update import stdp_update as pallas_stdp_update  # noqa: E402
from repro.kernels.syn_gather import syn_gather as pallas_gather  # noqa: E402
from repro.kernels.syn_matmul import syn_matmul as pallas_matmul  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread keeps PyTorch's thread
    pool from spinning against the other test workers' cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

DTYPES = {"fp32": (np.float32, torch.float32, jnp.float32),
          "fp16": (np.float16, torch.float16, jnp.float16)}


def _izh_inputs(seed, n, storage, a=0.02, b=0.2, c=-65.0, d=8.0, i_scale=20.0,
                v_top=-40.0):
    rng = np.random.default_rng(seed)
    v = (rng.random(n, np.float32) * np.float32(v_top + 80) - 80).astype(storage)
    u = (rng.random(n, np.float32) * 10 - 15).astype(storage)
    i_syn = rng.random(n, np.float32) * np.float32(i_scale)
    params = [np.full(n, x, np.float32) for x in (a, b, c, d)]
    return [v, u, i_syn, *params]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


class TestIzh4:
    @pytest.mark.parametrize("substeps,dt", [(1, 1.0), (2, 1.0), (4, 0.5)])
    @pytest.mark.parametrize("policy", ["fp32", "fp16"])
    def test_bitwise_vs_eager_reference(self, policy, substeps, dt):
        """Eager op-by-op evaluation is what PyTorch does: no FMA
        contraction on either side, so every bit agrees."""
        npd, _, jd = DTYPES[policy]
        args = _izh_inputs(0, 1200, npd, i_scale=25.0, v_top=35.0)
        vo, uo, so = ops.izh4_update(*map(torch.from_numpy, args), dt=dt,
                                     substeps=substeps)
        vr, ur, sr = jref.izh4_ref(*[jnp.asarray(x) for x in args], dt=dt,
                                   substeps=substeps)
        assert vo.dtype == DTYPES[policy][1] and uo.dtype == vo.dtype
        assert so.dtype == torch.bool
        np.testing.assert_array_equal(vo.numpy(), np.asarray(vr))
        np.testing.assert_array_equal(uo.numpy(), np.asarray(ur))
        np.testing.assert_array_equal(so.numpy(), np.asarray(sr))
        assert 0 < int(so.sum()) < 1200  # both branches of the reset ran

    @pytest.mark.parametrize("n", [5, 128, 1200, 4096])
    @pytest.mark.parametrize("policy", ["fp32", "fp16"])
    def test_matches_pallas_interpret(self, policy, n):
        npd, _, _ = DTYPES[policy]
        args = _izh_inputs(1, n, npd)
        vo, uo, so = ops.izh4_update(*map(torch.from_numpy, args))
        vp, up, sp = pallas_izh4(*[jnp.asarray(x) for x in args], interpret=True)
        np.testing.assert_allclose(_np(vo), _np(vp), rtol=2e-3, atol=2e-2)
        np.testing.assert_allclose(_np(uo), _np(up), rtol=2e-3, atol=2e-2)
        np.testing.assert_array_equal(so.numpy(), np.asarray(sp))

    @pytest.mark.parametrize("substeps,dt", [(1, 1.0), (2, 1.0), (4, 0.5)])
    def test_substep_sweep_vs_pallas_interpret(self, substeps, dt):
        args = _izh_inputs(2, 300, np.float32, a=0.1, d=2.0, i_scale=15.0)
        vo, _, so = ops.izh4_update(*map(torch.from_numpy, args), dt=dt,
                                    substeps=substeps)
        vp, _, sp = pallas_izh4(*[jnp.asarray(x) for x in args], dt=dt,
                                substeps=substeps, interpret=True)
        np.testing.assert_allclose(_np(vo), _np(vp), rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(so.numpy(), np.asarray(sp))

    def test_rejects_mixed_storage(self):
        args = [torch.from_numpy(x) for x in _izh_inputs(3, 8, np.float32)]
        args[1] = args[1].half()
        with pytest.raises(ValueError, match="storage dtype"):
            ops.izh4_update(*args)


WDTYPES = {"fp16": (torch.float16, jnp.float16), "bf16": (torch.bfloat16, jnp.bfloat16),
           "fp32": (torch.float32, jnp.float32)}


class TestSynMatmul:
    @pytest.mark.parametrize("shape", [(1, 200, 250), (1, 50, 200), (64, 200, 250),
                                       (3, 1000, 50)])
    @pytest.mark.parametrize("wdtype", ["fp16", "bf16", "fp32"])
    def test_matches_pallas_interpret(self, shape, wdtype):
        m, k, n = shape
        rng = np.random.default_rng(4)
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = rng.standard_normal((k, n)).astype(np.float32)
        td, jd = WDTYPES[wdtype]
        out = ops.syn_matmul(torch.from_numpy(x), torch.from_numpy(w).to(td))
        want = pallas_matmul(jnp.asarray(x), jnp.asarray(w).astype(jd), interpret=True)
        assert out.shape == (m, n) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)

    def test_spike_row_bitwise_on_representable_weights(self):
        """0/1 spikes times Synfire4's weight table: exact sums in any
        order, so the port, the eager reference and the Pallas kernel give
        the same bits."""
        rng = np.random.default_rng(5)
        x = (rng.random((1, 200)) < 0.3).astype(np.float32)
        table = np.array([0.0, 1.0, 3.5, -2.0], np.float32)
        w = table[rng.integers(0, 4, (200, 250))].astype(np.float16)
        out = ops.syn_matmul(torch.from_numpy(x), torch.from_numpy(w))
        np.testing.assert_array_equal(out.numpy(), np.asarray(
            jref.syn_matmul_ref(jnp.asarray(x), jnp.asarray(w))))
        np.testing.assert_array_equal(out.numpy(), np.asarray(
            pallas_matmul(jnp.asarray(x), jnp.asarray(w), interpret=True)))


class TestSynGather:
    def _case(self, seed, p, q, f, ragged=True):
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, p, (q, f))
        w = rng.normal(0.0, 1.0, (q, f))
        if ragged:
            lens = rng.integers(0, f + 1, q)
            valid = np.arange(f)[None, :] < lens[:, None]
            idx = np.where(valid, idx, 0)
            w = np.where(valid, w, 0.0)
        spikes = (rng.random(p) < 0.25).astype(np.float32)
        return spikes, idx, w.astype(np.float32)

    @pytest.mark.parametrize("pqf", [(200, 200, 81), (50, 200, 35),
                                     (2000, 2000, 93), (130, 257, 129)])
    @pytest.mark.parametrize("wdtype", ["fp16", "fp32"])
    @pytest.mark.parametrize("idx_dtype", ["int16", "int32"])
    def test_matches_pallas_interpret(self, pqf, wdtype, idx_dtype):
        spikes, idx, w = self._case(0, *pqf)
        td, jd = WDTYPES[wdtype]
        out = ops.syn_gather(torch.from_numpy(spikes),
                             torch.from_numpy(idx.astype(idx_dtype)),
                             torch.from_numpy(w).to(td))
        want = pallas_gather(jnp.asarray(spikes), jnp.asarray(idx.astype(idx_dtype)),
                             jnp.asarray(w).astype(jd), interpret=True)
        assert out.shape == (pqf[1],) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("wdtype", ["fp16", "fp32"])
    def test_padding_is_exact_zero(self, wdtype):
        spikes = torch.ones(8)
        idx = torch.tensor([[1, 3, 0, 0], [2, 0, 0, 0], [0, 0, 0, 0]], dtype=torch.int16)
        w = torch.tensor([[0.5, 1.5, 0, 0], [2.0, 0, 0, 0], [0, 0, 0, 0]]).to(
            WDTYPES[wdtype][0])
        np.testing.assert_array_equal(ops.syn_gather(spikes, idx, w).numpy(),
                                      np.array([2.0, 2.0, 0.0], np.float32))

    def test_bitwise_vs_eager_reference_and_dense(self):
        from repro.core.synapses import dense_to_csr as jdense_to_csr
        rng = np.random.default_rng(3)
        mask = rng.random((400, 300)) < 0.05
        w = np.where(mask, rng.integers(1, 9, (400, 300)) * 0.25, 0.0).astype(np.float32)
        csr = jdense_to_csr(mask, w)
        spikes = (rng.random(400) < 0.2).astype(np.float32)
        out = ops.syn_gather(torch.from_numpy(spikes),
                             torch.from_numpy(np.array(csr.idx)),
                             torch.from_numpy(np.array(csr.weight)))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jref.syn_gather_ref(
            jnp.asarray(spikes), csr.idx, csr.weight)))
        np.testing.assert_array_equal(out.numpy(), spikes @ w)

    def test_empty_fanin_returns_zeros(self):
        out = ops.syn_gather(torch.ones(10), torch.zeros((4, 0), dtype=torch.int32),
                             torch.zeros((4, 0)))
        np.testing.assert_array_equal(out.numpy(), np.zeros(4, np.float32))

    @pytest.mark.parametrize("bad", [-1, 8])
    @pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32])
    def test_index_outside_pre_raises_on_cpu(self, bad, idx_dtype):
        """The plain side of the wrapper's contract: an index outside
        [0, P) raises instead of wrapping or reading past the row."""
        idx = torch.tensor([[1, 3, 0], [2, bad, 0]], dtype=idx_dtype)
        with pytest.raises(IndexError, match=r"outside \[0, 8\)"):
            ops.syn_gather(torch.ones(8), idx, torch.ones((2, 3)))


def _opt0(fn, *args):
    """``fn`` jitted and compiled without XLA CPU's backend optimizations,
    which contract mul+add into FMAs (eager PyTorch and the CUDA kernels,
    their rounding pinned, never do)."""
    jargs = [jnp.asarray(a) for a in args]
    return jax.jit(fn).lower(*jargs).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*jargs)


STDP_KW = dict(a_plus=0.01, a_minus=0.012, w_min=0.0, w_max=5.0)


def _stdp_vectors(rng, p, q):
    return (rng.random(p).astype(np.float32) * 2, rng.random(q).astype(np.float32) * 2,
            (rng.random(p) < 0.2).astype(np.float32),
            (rng.random(q) < 0.2).astype(np.float32))


def _assert_bitwise_vs_pallas(out, pallas_fn, args, what):
    """``out`` equals the Pallas kernel in interpret mode compiled at
    optimization level 0, bit for bit; its distance from the default
    compile (FMA-contracted in fp32) is printed."""
    want = np.asarray(_opt0(pallas_fn, *args), np.float32)
    got = out.float().numpy()
    np.testing.assert_array_equal(got, want, err_msg=what)
    default = np.asarray(pallas_fn(*[jnp.asarray(a) for a in args]), np.float32)
    print(f"{what}: {int((got != default).sum())} of {got.size} cells differ from "
          "the default-compiled Pallas kernel")


class TestSTDPUpdate:
    @pytest.mark.parametrize("pq", [(50, 60), (200, 200), (1000, 300), (37, 113)])
    @pytest.mark.parametrize("wdtype", ["fp16", "fp32"])
    def test_bitwise_vs_pallas_interpret(self, pq, wdtype):
        p, q = pq
        rng = np.random.default_rng(1)
        mask = rng.random((p, q)) < 0.3
        npd = DTYPES[wdtype][0]
        w = np.where(mask, rng.normal(1.0, 0.4, (p, q)), 0.0).astype(npd)
        args = [w, mask, *_stdp_vectors(rng, p, q)]
        out = ops.stdp_update(*map(torch.from_numpy, args), **STDP_KW)
        assert out.shape == (p, q) and out.dtype == DTYPES[wdtype][1]
        _assert_bitwise_vs_pallas(out, functools.partial(
            pallas_stdp_update, interpret=True, **STDP_KW), args,
            f"stdp_update {p}x{q} {wdtype}")
        np.testing.assert_array_equal(out.float().numpy(), np.asarray(
            _opt0(functools.partial(jref.stdp_update_ref, **STDP_KW), *args), np.float32))

    def test_clip_and_mask(self):
        """Weights pushed past either bound land on it; masked cells hold +0.0."""
        w = torch.tensor([[4.99, 0.001], [1.0, 2.0]])
        mask = torch.tensor([[True, True], [False, True]])
        out = ops.stdp_update(w, mask, torch.tensor([10.0, 0.0]), torch.tensor([0.0, 10.0]),
                              torch.tensor([0.0, 1.0]), torch.tensor([1.0, 0.0]),
                              **STDP_KW)
        np.testing.assert_array_equal(out.numpy(), np.array([[5.0, 0.001], [0.0, 1.88]],
                                                            np.float32))

    def test_rejects_bad_operands(self):
        ones = torch.ones(4)
        with pytest.raises(ValueError, match="bool mask"):
            ops.stdp_update(torch.ones((4, 4)), torch.ones((4, 4)), ones, ones, ones,
                            ones, **STDP_KW)
        with pytest.raises(ValueError, match="w dtype"):
            ops.stdp_update(torch.ones((4, 4), dtype=torch.bfloat16),
                            torch.ones((4, 4), dtype=torch.bool), ones, ones, ones, ones,
                            **STDP_KW)
        with pytest.raises(ValueError, match="float32"):
            ops.stdp_update(torch.ones((4, 4)), torch.ones((4, 4), dtype=torch.bool),
                            ones, ones, ones.bool(), ones, **STDP_KW)


class TestSTDPGather:
    """CSR-row STDP: every op is elementwise per row cell (the gathers read,
    never reduce), so the port matches the Pallas kernel bit for bit."""

    def _case(self, seed, p, q, f, wdtype, idx_dtype):
        rng = np.random.default_rng(seed)
        idx = np.sort(rng.integers(0, p, (q, f)), axis=1)
        lens = rng.integers(0, f + 1, q)
        valid = np.arange(f)[None, :] < lens[:, None]
        idx = np.where(valid, idx, 0).astype(idx_dtype)
        w = np.where(valid, rng.normal(1.0, 0.4, (q, f)), 0.0).astype(DTYPES[wdtype][0])
        pre_t, post_t, pre_s, post_s = _stdp_vectors(rng, p, q)
        return [w, idx, valid, pre_t, post_t, pre_s, post_s]

    @pytest.mark.parametrize("pqf", [
        (200, 200, 80),    # Synfire4 sparse chain projection
        (2000, 2000, 90),  # Synfire4x10 chain projection
        (50, 300, 7),
        (130, 257, 129),
        (40, 10, 15),
    ])
    @pytest.mark.parametrize("wdtype", ["fp16", "fp32"])
    @pytest.mark.parametrize("idx_dtype", ["int16", "int32"])
    def test_bitwise_vs_pallas_interpret(self, pqf, wdtype, idx_dtype):
        p, q, f = pqf
        args = self._case(0, p, q, f, wdtype, idx_dtype)
        out = ops.stdp_gather(*map(torch.from_numpy, args), **STDP_KW)
        assert out.shape == (q, f) and out.dtype == DTYPES[wdtype][1]
        _assert_bitwise_vs_pallas(out, functools.partial(
            pallas_stdp_gather, interpret=True, **STDP_KW), args,
            f"stdp_gather {pqf} {wdtype} {idx_dtype}")
        np.testing.assert_array_equal(out.float().numpy(), np.asarray(
            _opt0(functools.partial(jref.stdp_gather_ref, **STDP_KW), *args), np.float32))

    @pytest.mark.parametrize("wdtype", ["fp16", "fp32"])
    def test_padding_stays_exact_zero(self, wdtype):
        """Padded cells gather pre_trace[0] for their terms, and the
        validity rows pin them at +0.0 (else CSR rows drift from their
        dense twins)."""
        args = self._case(3, 64, 48, 20, wdtype, "int16")
        args[3] = np.full(64, 5.0, np.float32)  # a large pre trace everywhere
        args[6] = np.ones(48, np.float32)  # every post neuron spikes: LTP
        out = ops.stdp_gather(*map(torch.from_numpy, args), **STDP_KW).float().numpy()
        assert np.all(out[~args[2]] == 0.0)
        assert np.all(out[args[2]] > args[0][args[2]].astype(np.float32))

    @pytest.mark.parametrize("bad", [-1, 8])
    @pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32])
    def test_index_outside_pre_raises_on_cpu(self, bad, idx_dtype):
        idx = torch.tensor([[1, 3, 0], [2, bad, 0]], dtype=idx_dtype)
        valid = torch.ones((2, 3), dtype=torch.bool)
        with pytest.raises(IndexError, match=r"outside \[0, 8\)"):
            ops.stdp_gather(torch.ones((2, 3)), idx, valid, torch.ones(8), torch.ones(2),
                            torch.ones(8), torch.ones(2), **STDP_KW)

    def test_rejects_bad_operands(self):
        w = torch.ones((2, 3))
        idx = torch.zeros((2, 3), dtype=torch.int16)
        valid = torch.ones((2, 3), dtype=torch.bool)
        pre, post = torch.ones(8), torch.ones(2)
        with pytest.raises(ValueError, match="one \\[Q, F\\] shape"):
            ops.stdp_gather(w, idx[:, :2], valid, pre, post, pre, post, **STDP_KW)
        with pytest.raises(ValueError, match="int16/int32"):
            ops.stdp_gather(w, idx.long(), valid, pre, post, pre, post, **STDP_KW)
        with pytest.raises(ValueError, match="post_trace"):
            ops.stdp_gather(w, idx, valid, pre, pre, pre, post, **STDP_KW)


class TestWrappers:
    def test_cpu_calls_launch_nothing(self):
        """CPU tensors take the plain versions: no kernel is built, loaded
        or counted."""
        ops.reset_launches()
        args = [torch.from_numpy(x) for x in _izh_inputs(6, 64, np.float16)]
        ops.izh4_update(*args)
        ops.syn_matmul(torch.ones((1, 8)), torch.ones((8, 4), dtype=torch.float16))
        ops.syn_gather(torch.ones(8), torch.zeros((4, 3), dtype=torch.int16),
                       torch.ones((4, 3)))
        kw = dict(a_plus=0.01, a_minus=0.01, w_min=0.0, w_max=1.0)
        ops.stdp_update(torch.ones((8, 4)), torch.ones((8, 4), dtype=torch.bool),
                        torch.ones(8), torch.ones(4), torch.ones(8), torch.ones(4), **kw)
        ops.stdp_gather(torch.ones((4, 3)), torch.zeros((4, 3), dtype=torch.int16),
                        torch.ones((4, 3), dtype=torch.bool), torch.ones(8),
                        torch.ones(4), torch.ones(8), torch.ones(4), **kw)
        ops.attention(torch.ones((1, 2, 4, 8)), torch.ones((1, 3, 2, 8)),
                      torch.ones((1, 3, 2, 8)), torch.ones((1, 2), dtype=torch.int32),
                      torch.ones(3, dtype=torch.int32))
        ops.flash_attention(torch.ones((1, 4, 2, 8)), torch.ones((1, 2, 3, 8)),
                            torch.ones((1, 2, 3, 8)))
        assert ops.LAUNCHES == {"izh4_update": 0, "syn_matmul": 0, "syn_gather": 0,
                                "fused_tick": 0, "stdp_update": 0, "stdp_gather": 0,
                                "flash_attention": 0}
        assert _build._LIBS == {}

    def test_mixed_devices_raise(self):
        with pytest.raises(ValueError, match="different devices"):
            ops.syn_matmul(torch.ones((1, 8)),
                           torch.ones((8, 4), device="meta"))

    def test_rejects_unsupported_dtypes(self):
        with pytest.raises(ValueError, match="idx dtype"):
            ops.syn_gather(torch.ones(8), torch.zeros((4, 3), dtype=torch.int64),
                           torch.ones((4, 3)))
        with pytest.raises(ValueError, match="x must be float32"):
            ops.syn_matmul(torch.ones((1, 8), dtype=torch.float16), torch.ones((8, 4)))

    def test_kernel_sources_and_build_flags(self):
        """Every kernel has its CUDA source, built for sm_90a."""
        for name in _build.KERNELS:
            src = _build.CSRC / f"{name}.cu"
            assert src.exists(), src
            assert "Replaces the Pallas TPU kernel" in src.read_text()
        assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
        assert _build.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")

