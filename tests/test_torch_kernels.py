"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the reference: eager ``repro.kernels.ref`` bit for bit, and the
Pallas kernels in interpret mode with the tolerances of
``tests/test_kernels.py``. Inputs are made with numpy from a seed and
handed to both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.izh_update import izh4_update as pallas_izh4  # noqa: E402
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
        assert ops.LAUNCHES == {"izh4_update": 0, "syn_matmul": 0, "syn_gather": 0,
                                "fused_tick": 0}
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
