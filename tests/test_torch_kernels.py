"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the reference: eager ``repro.kernels.ref`` bit for bit, and the
Pallas kernels in interpret mode with the tolerances of
``tests/test_kernels.py`` (bit for bit for the two STDP kernels, which
reduce nothing). Inputs are made with numpy from a seed and handed to both
packages."""
import functools
import math

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
from repro_torch.kernels import syn_gather as gsyn  # noqa: E402
from repro_torch.kernels.plastic_drive import DriveProjection  # noqa: E402


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


class TestMatmulRun:
    """The engine's per-run ``syn_matmul`` launcher: on the CPU it runs the
    plain version, so it equals ``ops.syn_matmul`` bit for bit, and the
    reference's jitted ``ref.syn_matmul_ref`` on spike rows."""

    @pytest.mark.parametrize("kn", [(200, 250), (50, 200), (1, 1)])
    @pytest.mark.parametrize("wdtype", ["fp16", "bf16", "fp32"])
    def test_bitwise_vs_ops_and_reference(self, kn, wdtype):
        k, n = kn
        rng = np.random.default_rng(k + n)
        td, jd = WDTYPES[wdtype]
        table = np.array([0.0, 1.0, 3.5, -2.0], np.float32)
        spikes = (rng.random(k) < 0.3).astype(np.float32)
        w_syn = table[rng.integers(0, 4, (k, n))]
        w_rnd = rng.standard_normal((k, n)).astype(np.float32)
        x_rnd = rng.standard_normal(k).astype(np.float32)
        images = [torch.from_numpy(w_syn).to(td), None, torch.from_numpy(w_rnd).to(td)]
        ops.reset_launches()
        run = ops.MatmulRun(images)
        jit_ref = jax.jit(jref.syn_matmul_ref)
        for i, x in ((0, spikes), (2, x_rnd)):
            xt = torch.from_numpy(x)
            got = run(i, xt)
            assert got.shape == (n,) and got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(),
                                          ops.syn_matmul(xt[None], images[i])[0].numpy())
            want = np.asarray(jit_ref(jnp.asarray(x[None]),
                                      jnp.asarray(images[i].float().numpy()).astype(jd)))[0]
            if i == 0:
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        assert ops.LAUNCHES["syn_matmul"] == 0 and "syn_matmul" not in _build._LIBS

    @pytest.mark.parametrize("bad", ["one_dim", "int_dtype", "f64", "mixed_devices"])
    def test_checks_raise_at_construction(self, bad):
        images = [torch.ones((8, 4)), None, torch.ones((3, 5), dtype=torch.float16)]
        if bad == "one_dim":
            images[0] = torch.ones(8)
        elif bad == "int_dtype":
            images[2] = torch.ones((3, 5), dtype=torch.int32)
        elif bad == "f64":
            images[0] = torch.ones((8, 4), dtype=torch.float64)
        else:
            images[2] = torch.ones((3, 5), device="meta")
        with pytest.raises(ValueError, match="syn_matmul"):
            ops.MatmulRun(images)

    def test_no_products(self):
        run = ops.MatmulRun([None, None])
        assert run._gemv is None


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

    @pytest.mark.parametrize("idx_dtype", ["int16", "int32"])
    def test_long_spike_row_bitwise_vs_reference(self, idx_dtype):
        """P = 20,000, Synfire4x100's longest pre group (the card stages it
        in opted-in shared memory): the plain version equals the
        reference's jitted ``ref.syn_gather_ref`` bit for bit."""
        rng = np.random.default_rng(20_000)
        p, q, f = 20_000, 500, 120
        idx = rng.integers(0, p, (q, f)).astype(idx_dtype)
        table = np.array([0.0, 1.0, 3.5, -2.0], np.float32)
        w = table[rng.integers(0, 4, (q, f))]
        spikes = (rng.random(p) < 0.3).astype(np.float32)
        out = ops.syn_gather(torch.from_numpy(spikes), torch.from_numpy(idx),
                             torch.from_numpy(w))
        want = jax.jit(jref.syn_gather_ref)(jnp.asarray(spikes), jnp.asarray(idx),
                                            jnp.asarray(w))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        assert float(out.abs().sum()) > 0

    def test_empty_fanin_returns_zeros(self):
        out = ops.syn_gather(torch.ones(10), torch.zeros((4, 0), dtype=torch.int32),
                             torch.zeros((4, 0)))
        np.testing.assert_array_equal(out.numpy(), np.zeros(4, np.float32))

    @pytest.mark.parametrize("bad", [-1, 8])
    @pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32])
    def test_index_outside_pre_raises_on_cpu(self, bad, idx_dtype):
        """The plain side of the wrapper's contract on an index outside
        [0, P): the reference's ``jnp.take`` (``ref.syn_gather_ref``) on the
        same table, -1 counting from the end of the row and 8 giving NaN."""
        spikes = np.arange(1, 9, dtype=np.float32)
        idx = np.array([[1, 3, 0], [2, bad, 0]], np.int16 if idx_dtype == torch.int16
                       else np.int32)
        w = np.array([[1.0, 2.0, 0.5], [1.0, 3.5, -2.0]], np.float32)
        out = ops.syn_gather(torch.from_numpy(spikes), torch.from_numpy(idx),
                             torch.from_numpy(w))
        want = np.asarray(jref.syn_gather_ref(jnp.asarray(spikes), jnp.asarray(idx),
                                              jnp.asarray(w)))
        np.testing.assert_array_equal(out.numpy(), want)
        assert np.isnan(want[1]) == (bad == 8)


class TestGatherRun:
    """The per-run gather launcher's host plan (``syn_gather.GatherPlan``)
    and its plain run on the CPU, against the per-bucket path and the
    reference's ``ref.syn_gather_ref``."""

    @staticmethod
    def _sparse(rng, n, pre, posts, f, delay, wdtype=torch.float32):
        idx = rng.integers(0, len(pre), (len(posts), f)).astype(np.int16)
        w = torch.from_numpy(rng.standard_normal((len(posts), f)).astype(np.float32))
        return gsyn.Bucket(delay, np.asarray(posts), (np.asarray(pre), torch.from_numpy(idx),
                                                      w.to(wdtype)))

    def test_composed_pre_indices(self):
        """Each bucket's rows are composed through its pre ids into global
        ids of the [N] row, int16 where N fits and int32 beyond."""
        rng = np.random.default_rng(1)
        pre_gathered = rng.permutation(300)[:40]
        buckets = [self._sparse(rng, 300, np.arange(100, 150), np.arange(0, 20), 7, 8),
                   self._sparse(rng, 300, pre_gathered, np.arange(20, 30), 5, 8)]
        plan = gsyn.GatherPlan(300, buckets)
        assert plan.idx.dtype == torch.int16
        for (_, _, gidx, _), b in zip(plan.plain[0], buckets):
            pre, idx, _ = b.table
            np.testing.assert_array_equal(gidx.numpy(), pre[idx.numpy().astype(np.int64)])
        flat = np.concatenate([pre[idx.numpy().astype(np.int64)].reshape(-1)
                               for pre, idx, _ in (b.table for b in buckets)])
        np.testing.assert_array_equal(plan.idx.numpy(), flat)
        wide = gsyn.GatherPlan(40_000, [self._sparse(rng, 40_000, np.arange(39_000, 40_000),
                                                     np.arange(5), 3, 1)])
        assert wide.idx.dtype == torch.int32 and int(wide.idx.min()) >= 39_000

    def test_contributions_in_plan_order(self):
        """Per (delay, column), the (bucket, row) contributions in plan
        order, post ids resolved; every other entry of group 0 is a
        zero-fill item, each entry written once."""
        rng = np.random.default_rng(2)
        n = 70
        posts_b = rng.permutation(np.arange(10, 50))[:25]
        buckets = [self._sparse(rng, n, np.arange(n), np.arange(0, 30), 4, 10),
                   self._sparse(rng, n, np.arange(n), posts_b, 6, 10),
                   self._sparse(rng, n, np.arange(n), np.arange(5, 15), 3, 8)]
        plan = gsyn.GatherPlan(n, buckets)
        assert plan.delays == (8, 10) and plan.groups == ((0, 1, 2),) and plan.starts == [0]
        items, contribs = plan.items[0].numpy(), plan.contribs.numpy()
        offsets = np.cumsum([0] + [b.table[1].numel() for b in buckets])
        want = {}
        for bi, b in enumerate(buckets):
            k = plan.delays.index(b.delay)
            f = b.table[1].shape[1]
            for r, col in enumerate(b.posts):
                want.setdefault(k * n + int(col), []).append((offsets[bi] + r * f, f))
        written = []
        for out, begin, end in items:
            if begin < 0:
                written += range(out, out - begin)
                assert -begin <= 32 and out not in want
                continue
            written.append(out)
            assert [tuple(c) for c in contribs[begin:end]] == want[out]
        assert sorted(written) == list(range(2 * n))

    def test_group_split_keeps_plan_order(self):
        """A dense bucket between two sparse ones on one (delay, column)
        of three terms opens a second group where the second sparse bucket
        stands; with two terms, or on other columns, the plan is one
        group; a dense bucket before the first sparse one on a
        three-term entry leaves group 0 with zero fills alone."""
        rng = np.random.default_rng(3)
        n = 40
        s1 = self._sparse(rng, n, np.arange(n), np.arange(0, 10), 3, 5)
        s2 = self._sparse(rng, n, np.arange(n), np.arange(8, 12), 3, 5)
        dense = lambda cols: gsyn.Bucket(5, np.asarray(cols))  # noqa: E731
        assert gsyn.GatherPlan(n, [s1, dense([9]), s2]).starts == [0, 2]
        assert gsyn.GatherPlan(n, [s1, dense([20]), s2]).groups == ((0, 2),)
        assert gsyn.GatherPlan(n, [s1, dense([0]), s2]).groups == ((0, 2),)
        plan = gsyn.GatherPlan(n, [dense([9]), s1, s2])
        assert plan.groups == ((), (1, 2)) and plan.starts == [0, 1]
        assert (plan.items[0][:, 1] < 0).all() and (plan.items[1][:, 1] >= 0).all()
        other = gsyn.Bucket(7, np.arange(9, 10))  # another delay: no conflict
        assert gsyn.GatherPlan(n, [s1, other, s2]).groups == ((0, 2),)

    @pytest.mark.parametrize("order", ["sparse-first", "interleaved"])
    def test_cpu_run_equals_per_bucket_path(self, order):
        """The launcher's rows, with dense drives added where their buckets
        stand, equal the per-bucket path (``ops.syn_gather`` per bucket and
        the dense drives, added in plan order into zeros) bit for bit on
        random weights; each row sum is the reference's ``syn_gather_ref``
        on the composed table, up to its summation order."""
        rng = np.random.default_rng(4)
        n = 90
        s = [self._sparse(rng, n, rng.permutation(n)[:30], rng.permutation(n)[:25], 9, 4)
             for _ in range(3)]
        d = [gsyn.Bucket(4, rng.permutation(n)[:40]) for _ in range(2)]
        plan_buckets = s + d if order == "sparse-first" else [s[0], d[0], s[1], d[1], s[2]]
        drives = {id(b): torch.from_numpy(rng.standard_normal(len(b.posts)).astype(np.float32))
                  for b in d}
        spikes = torch.from_numpy((rng.random(n) < 0.4).astype(np.float32))
        run = ops.GatherRun(n, plan_buckets, "cpu")
        assert run.launcher is None and len(run.starts) == (1 if order == "sparse-first" else 3)
        later = {i: g for g, i in enumerate(run.starts) if g}
        run(0, spikes)
        for i, b in enumerate(plan_buckets):
            if i in later:
                run(later[i], spikes)
            if b.table is None:
                run.rows[0].index_add_(0, torch.from_numpy(b.posts), drives[id(b)])
        want = torch.zeros(n)
        for b in plan_buckets:
            if b.table is None:
                want.index_add_(0, torch.from_numpy(b.posts), drives[id(b)])
                continue
            pre, idx, w = b.table
            drive = ops.syn_gather(spikes[torch.from_numpy(pre)], idx, w)
            want.index_add_(0, torch.from_numpy(b.posts), drive)
            jwant = jref.syn_gather_ref(jnp.asarray(spikes.numpy()),
                                        jnp.asarray(pre[idx.numpy().astype(np.int64)]),
                                        jnp.asarray(w.numpy()))
            # XLA sums the random products in its own order: a few ulp.
            np.testing.assert_allclose(drive.numpy(), np.asarray(jwant), rtol=1e-6, atol=1e-6)
        assert torch.equal(run.rows[0], want)
        assert ops.LAUNCHES["syn_gather"] == 0

    def test_rejects_index_outside_pre(self):
        bucket = gsyn.Bucket(1, np.arange(2), (np.arange(8), torch.tensor(
            [[0, 8], [1, 2]], dtype=torch.int16), torch.ones((2, 2))))
        with pytest.raises(IndexError, match=r"outside \[0, 8\)"):
            ops.GatherRun(10, [bucket], "cpu")


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
        with pytest.raises(ValueError, match="w dtype"):  # bf16 is a storage dtype now
            ops.stdp_update(torch.ones((4, 4), dtype=torch.float64),
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

    @staticmethod
    def _bad_case(bad, idx_dtype, valid):
        rng = np.random.default_rng(8)
        idx = np.array([[1, -1, 3], [2, bad, 0]], np.int16 if idx_dtype == torch.int16
                       else np.int32)
        w = np.array([[1.0, 1.06, 0.5], [1.0, 2.0, 1.0]], np.float32)
        return [w, idx, np.asarray(valid), *_stdp_vectors(rng, 8, 2)]

    @pytest.mark.parametrize("bad", [-1, 8])
    @pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32])
    def test_index_outside_pre_follows_reference(self, bad, idx_dtype):
        """The wrapper's contract on an index outside [0, P), on the CPU: the
        reference's ``jnp.take`` (``ref.stdp_gather_ref``) on the same table,
        -1 counting from the end of the pre row and 8 giving NaN."""
        args = self._bad_case(bad, idx_dtype, np.ones((2, 3), bool))
        out = ops.stdp_gather(*map(torch.from_numpy, args), **STDP_KW)
        want = np.asarray(jref.stdp_gather_ref(*map(jnp.asarray, args), **STDP_KW))
        np.testing.assert_array_equal(out.numpy(), want)
        assert np.isnan(want[1, 1]) == (bad == 8) and not np.isnan(want[0]).any()

    @pytest.mark.parametrize("idx_dtype", [torch.int16, torch.int32])
    def test_invalid_cell_outside_pre_is_zero(self, idx_dtype):
        """A cell whose index lies outside [-P, P) but whose ``valid`` is
        false stays +0.0, as in the reference."""
        args = self._bad_case(-9, idx_dtype, [[True, True, True], [True, False, True]])
        out = ops.stdp_gather(*map(torch.from_numpy, args), **STDP_KW)
        want = np.asarray(jref.stdp_gather_ref(*map(jnp.asarray, args), **STDP_KW))
        np.testing.assert_array_equal(out.numpy(), want)
        assert out[1, 1].item() == 0.0 and not torch.signbit(out[1, 1])
        assert not out.isnan().any()

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


class TestStdpGatherRun:
    """The per-run CSR STDP launcher (``ops.StdpGatherRun``) on the CPU, its
    plain run (``ref.stdp_gather_run_ref``), against the per-call path it
    replaces: each projection's two trace steps
    (``core/plasticity._trace_step``) and one ``ops.stdp_gather`` per
    tick."""

    TAU = (20.0, 15.0)  # tau+ (pre traces), tau- (post traces), dt = 1 ms

    def _projs(self, rng, wdtype, idx_dtype):
        from repro_torch.kernels.stdp_gather import Projection

        out = []
        for p, q, f, ps, qs in ((40, 25, 9, 0, 60), (70, 12, 31, 30, 0)):
            idx = rng.integers(0, p, (q, f)).astype(idx_dtype)
            valid = rng.random((q, f)) < 0.8
            w = np.where(valid, rng.uniform(0, 4, (q, f)), 0).astype(DTYPES[wdtype][0])
            pre, post = (torch.from_numpy(rng.random(x).astype(np.float32) * 2)
                         for x in (p, q))
            out.append(Projection(
                w=torch.from_numpy(w), idx=torch.from_numpy(idx),
                valid=torch.from_numpy(valid), pre_tr=(pre, torch.empty_like(pre)),
                post_tr=(post, torch.empty_like(post)), pre_start=ps, post_start=qs,
                **STDP_KW, decay_pre=math.exp(-1.0 / self.TAU[0]),
                decay_post=math.exp(-1.0 / self.TAU[1])))
        return out

    @pytest.mark.parametrize("wdtype", ["fp16", "fp32"])
    @pytest.mark.parametrize("idx_dtype", ["int16", "int32"])
    def test_matches_per_call_path(self, wdtype, idx_dtype):
        """Two projections of different P, Q and F in one run: weights and
        both traces after every tick equal the per-call path's bit for
        bit, and no launch is counted on the CPU."""
        from repro_torch.core.plasticity import _trace_step

        rng = np.random.default_rng(11)
        projs = self._projs(rng, wdtype, idx_dtype)
        w0 = [p.w.clone() for p in projs]
        w_pc = [p.w.clone() for p in projs]
        tr_pc = [(p.pre_tr[0].clone(), p.post_tr[0].clone()) for p in projs]
        ops.reset_launches()
        run = ops.StdpGatherRun(100, projs, keys=(3, 7))
        assert run.keys == (3, 7) and run.launcher is None
        for _ in range(8):
            spikes = torch.from_numpy((rng.random(100) < 0.3).astype(np.float32))
            run(spikes)
            for k, p in enumerate(projs):
                pre_sp = spikes[p.pre_start:p.pre_start + p.pre_tr[0].shape[0]]
                post_sp = spikes[p.post_start:p.post_start + p.w.shape[0]]
                tr_pc[k] = (_trace_step(tr_pc[k][0], pre_sp, self.TAU[0], 1.0),
                            _trace_step(tr_pc[k][1], post_sp, self.TAU[1], 1.0))
                w_pc[k] = ops.stdp_gather(w_pc[k], p.idx, p.valid, *tr_pc[k], pre_sp,
                                          post_sp, **STDP_KW)
                assert torch.equal(p.w, w_pc[k])
                for got, want in zip(run.traces(k), tr_pc[k]):
                    assert torch.equal(got, want)
        assert ops.LAUNCHES["stdp_gather"] == 0
        assert all(not torch.equal(p.w, w) for p, w in zip(projs, w0))

    def test_adopt_loads_new_tensors_in_place(self):
        rng = np.random.default_rng(2)
        projs = self._projs(rng, "fp16", "int16")
        run = ops.StdpGatherRun(100, projs, keys=(1, 2))
        buffers = [p.w for p in projs]
        new = torch.full_like(projs[1].w, 0.5)
        out = run.adopt((None, projs[0].w, new))
        assert out[1] is buffers[0] and out[2] is buffers[1] and out[0] is None
        assert torch.equal(buffers[1], new) and buffers[1].data_ptr() != new.data_ptr()

    def test_rejects_bad_projections(self):
        rng = np.random.default_rng(3)
        projs = self._projs(rng, "fp32", "int16")
        with pytest.raises(ValueError, match="spike row"):
            ops.StdpGatherRun(80, projs)
        with pytest.raises(ValueError, match="one \\[Q, F\\] shape"):
            ops.StdpGatherRun(100, [projs[0]._replace(idx=projs[0].idx[:, :3])])
        with pytest.raises(ValueError, match="float32"):
            ops.StdpGatherRun(100, [projs[0]._replace(pre_tr=(projs[0].pre_tr[0].half(),
                                                                projs[0].pre_tr[1]))])


class TestStdpUpdateRun:
    """The per-run dense STDP launcher (``ops.StdpUpdateRun``) on the CPU,
    its plain run (``ref.stdp_update_run_ref``), against the per-call path
    it replaces (each projection's two trace steps,
    ``core/plasticity._trace_step``, and one ``ops.stdp_update`` per tick)
    and against the reference's trace steps and Pallas kernel."""

    TAU = (20.0, 15.0)  # tau+ (pre traces), tau- (post traces), dt = 1 ms
    # (P, Q, pre_start, post_start, storage) per projection, per plan
    PLANS = {"fp16": ((40, 25, 0, 60, "fp16"), (70, 12, 30, 0, "fp16")),
             "fp32": ((40, 25, 0, 60, "fp32"), (70, 12, 30, 0, "fp32")),
             "mixed": ((37, 113, 0, 50, "fp32"), (20, 20, 163, 170, "fp16"))}

    def _projs(self, rng, plan):
        from repro_torch.kernels.stdp_update import DenseProjection

        out = []
        for p, q, ps, qs, wdtype in self.PLANS[plan]:
            mask = rng.random((p, q)) < 0.4
            w = np.where(mask, rng.uniform(0, 4, (p, q)), 0).astype(DTYPES[wdtype][0])
            pre, post = (torch.from_numpy(rng.random(x).astype(np.float32) * 2)
                         for x in (p, q))
            out.append(DenseProjection(
                w=torch.from_numpy(w), mask=torch.from_numpy(mask),
                pre_tr=(pre, torch.empty_like(pre)), post_tr=(post, torch.empty_like(post)),
                pre_start=ps, post_start=qs, **STDP_KW,
                decay_pre=math.exp(-1.0 / self.TAU[0]),
                decay_post=math.exp(-1.0 / self.TAU[1])))
        return out

    @pytest.mark.parametrize("plan", list(PLANS))
    def test_matches_per_call_path(self, plan):
        """Two projections of different P and Q in one run (fp16, f32, or
        one of each): weights, both trace buffers and ``parity`` after
        every one of 10 chained ticks equal the per-call path's bit for bit,
        and no launch is counted on the CPU."""
        from repro_torch.core.plasticity import _trace_step

        rng = np.random.default_rng(12)
        projs = self._projs(rng, plan)
        w0 = [p.w.clone() for p in projs]
        w_pc = [p.w.clone() for p in projs]
        tr_pc = [(p.pre_tr[0].clone(), p.post_tr[0].clone()) for p in projs]
        ops.reset_launches()
        run = ops.StdpUpdateRun(200, projs, keys=(3, 7))
        assert run.keys == (3, 7) and run.launcher is None and run.parity == 0
        for t in range(10):
            spikes = torch.from_numpy((rng.random(200) < 0.3).astype(np.float32))
            run(spikes)
            assert run.parity == (t + 1) % 2
            for k, p in enumerate(projs):
                pre_sp = spikes[p.pre_start:p.pre_start + p.w.shape[0]]
                post_sp = spikes[p.post_start:p.post_start + p.w.shape[1]]
                old = tr_pc[k]
                tr_pc[k] = (_trace_step(old[0], pre_sp, self.TAU[0], 1.0),
                            _trace_step(old[1], post_sp, self.TAU[1], 1.0))
                w_pc[k] = ops.stdp_update(w_pc[k], p.mask, *tr_pc[k], pre_sp, post_sp,
                                          **STDP_KW)
                assert torch.equal(p.w, w_pc[k]) and p.w.dtype == w_pc[k].dtype
                now = run.parity
                for bufs, new_tr, old_tr in ((p.pre_tr, tr_pc[k][0], old[0]),
                                             (p.post_tr, tr_pc[k][1], old[1])):
                    assert torch.equal(bufs[now], new_tr)
                    assert torch.equal(bufs[1 - now], old_tr)
                for got, want in zip(run.traces(k), tr_pc[k]):
                    assert torch.equal(got, want)
        assert ops.LAUNCHES["stdp_update"] == 0
        assert all(not torch.equal(p.w, w) for p, w in zip(projs, w0))

    @pytest.mark.parametrize("plan", ["fp16", "fp32"])
    def test_one_tick_matches_pallas_interpret(self, plan):
        """One tick of the plain run equals, per projection, the
        reference's ``_trace_step`` on both traces followed by its Pallas
        kernel in interpret mode, compiled at optimization level 0 (the
        default compile contracts the trace step into an FMA), on the same
        numpy inputs."""
        from repro.core.plasticity import _trace_step as jtrace

        rng = np.random.default_rng(13)
        projs = self._projs(rng, plan)
        before = [[x.numpy().copy() for x in (p.w, p.mask, p.pre_tr[0], p.post_tr[0])]
                  for p in projs]
        spikes = (rng.random(200) < 0.3).astype(np.float32)
        ops.StdpUpdateRun(200, projs)(torch.from_numpy(spikes))
        for p, (w, mask, pre, post) in zip(projs, before):
            pre_sp = spikes[p.pre_start:p.pre_start + w.shape[0]]
            post_sp = spikes[p.post_start:p.post_start + w.shape[1]]

            def tick(w, mask, pre, post, pre_sp, post_sp):
                pre_t = jtrace(pre, pre_sp, self.TAU[0], 1.0)
                post_t = jtrace(post, post_sp, self.TAU[1], 1.0)
                return pallas_stdp_update(w, mask, pre_t, post_t, pre_sp, post_sp,
                                          interpret=True, **STDP_KW), pre_t, post_t

            want = _opt0(tick, w, mask, pre, post, pre_sp, post_sp)
            for got, ref_ in zip((p.w, p.pre_tr[1], p.post_tr[1]), want):
                np.testing.assert_array_equal(got.float().numpy(),
                                              np.asarray(ref_, np.float32))

    def test_nan_weight_follows_reference(self):
        """A NaN weight stays NaN in a masked-in cell and becomes +0.0 in a
        masked-out one: through ``ops.stdp_update`` and the launcher's plain
        run on the CPU, and in the reference's Pallas kernel (interpret
        mode, optimization level 0), whose ``jnp.clip`` keeps a NaN; the
        other cells equal the reference's."""
        from repro_torch.kernels.stdp_update import DenseProjection

        rng = np.random.default_rng(14)
        w = rng.uniform(0, 4, (6, 5)).astype(np.float32)
        mask = np.ones((6, 5), bool)
        w[1, 2] = w[4, 0] = np.nan
        mask[4, 0] = False
        vecs = _stdp_vectors(rng, 6, 5)
        want = np.asarray(_opt0(functools.partial(pallas_stdp_update, interpret=True,
                                                  **STDP_KW), w, mask, *vecs))
        outs = {}
        for storage in (torch.float32, torch.float16):
            args = [torch.from_numpy(w).to(storage), torch.from_numpy(mask),
                    *map(torch.from_numpy, vecs)]
            out = outs[storage] = ops.stdp_update(*args, **STDP_KW)
            pre, post = args[2].clone(), args[3].clone()
            proj = DenseProjection(w=args[0].clone(), mask=args[1],
                                   pre_tr=(pre, torch.empty_like(pre)),
                                   post_tr=(post, torch.empty_like(post)), pre_start=0,
                                   post_start=6, **STDP_KW, decay_pre=0.9, decay_post=0.9)
            ops.StdpUpdateRun(11, [proj])(torch.zeros(11))
            for got in (out, proj.w):
                assert bool(got[1, 2].isnan())
                assert got[4, 0].item() == 0.0 and not torch.signbit(got[4, 0])
                assert int(got.isnan().sum()) == 1
        assert np.isnan(want[1, 2]) and want[4, 0] == 0.0 and not np.signbit(want[4, 0])
        ok = ~np.isnan(want)
        np.testing.assert_array_equal(outs[torch.float32].numpy()[ok], want[ok])

    def test_adopt_loads_new_tensors_in_place(self):
        rng = np.random.default_rng(2)
        projs = self._projs(rng, "mixed")
        run = ops.StdpUpdateRun(200, projs, keys=(1, 2))
        buffers = [p.w for p in projs]
        new = torch.full_like(projs[1].w, 0.5)
        out = run.adopt((None, projs[0].w, new))
        assert out[1] is buffers[0] and out[2] is buffers[1] and out[0] is None
        assert torch.equal(buffers[1], new) and buffers[1].data_ptr() != new.data_ptr()
        assert run.padded == {}

    def test_padded_buffer_keeps_the_drive_zero(self):
        """A projection whose weights start a flat ``[P·Q + 1]`` buffer:
        ``padded`` maps its key to the buffer, updates and ``adopt`` write
        through to it, and its last entry stays +0.0."""
        rng = np.random.default_rng(4)
        p = self._projs(rng, "fp16")[0]
        padded = torch.zeros(p.w.numel() + 1, dtype=p.w.dtype)
        padded[:-1] = p.w.reshape(-1)
        p = p._replace(w=padded[:-1].view(p.w.shape), padded=padded)
        run = ops.StdpUpdateRun(200, [p], keys=(5,))
        assert run.padded == {5: padded}
        run(torch.ones(200))
        run.adopt((None,) * 5 + (torch.full_like(p.w, 2.0),))
        assert torch.equal(padded[:-1], torch.full((p.w.numel(),), 2.0, dtype=p.w.dtype))
        assert padded[-1].item() == 0.0

    def test_rejects_bad_projections(self):
        rng = np.random.default_rng(3)
        projs = self._projs(rng, "fp32")
        p = projs[0]
        with pytest.raises(ValueError, match="spike row"):
            ops.StdpUpdateRun(80, projs)
        with pytest.raises(ValueError, match="bool mask of its shape"):
            ops.StdpUpdateRun(200, [p._replace(mask=p.mask[:, :3])])
        with pytest.raises(ValueError, match="bool mask of its shape"):
            ops.StdpUpdateRun(200, [p._replace(mask=p.mask.float())])
        with pytest.raises(ValueError, match="w dtype"):
            ops.StdpUpdateRun(200, [p._replace(w=p.w.to(torch.float64))])
        with pytest.raises(ValueError, match="pre_tr/post_tr"):
            ops.StdpUpdateRun(200, [p._replace(post_tr=(p.pre_tr[0], p.pre_tr[1]))])
        with pytest.raises(ValueError, match="float32"):
            ops.StdpUpdateRun(200, [p._replace(pre_tr=(p.pre_tr[0].half(), p.pre_tr[1]))])
        with pytest.raises(ValueError, match="spike row"):
            ops.StdpUpdateRun(200, [p._replace(pre_start=-1)])
        with pytest.raises(ValueError, match="padded"):
            ops.StdpUpdateRun(200, [p._replace(padded=torch.zeros(p.w.numel() + 1))])


class TestNeuronRun:
    """The per-run neuron-phase launcher (``ops.NeuronRun``) on the CPU,
    its plain run (``ref.neuron_run_ref``), against the per-op phase it
    replaces (``engine._neuron_phase``: the ring slot read and zero, the
    external current, ``ops.izh4_update``, the generator and refractory
    masks, the generator hold, the refractory countdown and the generator
    merge; then the run's raster, record and count writes), bit for bit,
    tick by tick, from a random state with refractory neurons."""

    @pytest.mark.parametrize("i_ext,records", [(False, False), (True, True), (False, True)])
    @pytest.mark.parametrize("policy", ["fp16", "fp32"])
    def test_matches_per_op_phase(self, policy, i_ext, records):
        from repro_torch.configs import synfire4 as tsyn
        from repro_torch.core import backend as be
        from repro_torch.core import engine
        from repro_torch.core.neurons import NeuronState

        net = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy=policy, device="cpu")
        static, params = net.static, net.params
        n, ticks, f32 = static.n, 15, torch.float32
        dtype = net.state0.neurons.v.dtype
        rng = np.random.default_rng(2 * i_ext + records)
        neurons = NeuronState(
            v=torch.from_numpy(rng.uniform(-80, 35, n).astype(np.float32)).to(dtype),
            u=torch.from_numpy(rng.uniform(-15, -5, n).astype(np.float32)).to(dtype),
            refrac=torch.from_numpy(rng.integers(0, 3, n).astype(np.int16)))
        saved = [x.clone() for x in neurons]
        ring = torch.from_numpy(rng.uniform(0, 12, tuple(net.state0.ring.shape))
                                .astype(np.float32)).to(dtype)
        gen_spk = torch.from_numpy(rng.random((ticks, static.n_gen)) < 0.3)
        cur = (torch.from_numpy(rng.uniform(0, 8, (ticks, n)).astype(np.float32))
               if i_ext else None)
        rows = ({"raster": torch.zeros((ticks, n), dtype=torch.bool),
                 "v_rows": torch.zeros((ticks, n)), "i_rows": torch.zeros((ticks, n)),
                 "counts": torch.zeros(n, dtype=torch.int32)} if records else {})
        run_ring = ring.clone()
        run = be.assemble_neurons(static, params, neurons, run_ring, gen_spk=gen_spk,
                                  i_ext=cur, **rows)
        assert run.launcher is None
        state, counts, spiked = neurons, torch.zeros(n, dtype=torch.int32), 0
        for i in range(ticks):
            t = 30 + i
            run(i, t)
            state, spikes, i_syn, _ = engine._neuron_phase(
                static, params, state, ring, t, gen_spk[i], None if cur is None else cur[i])
            for got, want in ((run.v, state.v), (run.u, state.u), (run.refrac, state.refrac),
                              (run_ring, ring), (run.spikes, spikes.to(f32))):
                assert got.dtype == want.dtype and torch.equal(got, want), f"tick {t}"
            counts += spikes
            spiked += int(spikes[static.n_gen:].sum())
            if records:
                assert torch.equal(rows["raster"][i], spikes)
                assert torch.equal(rows["v_rows"][i], state.v.to(f32))
                assert torch.equal(rows["i_rows"][i], i_syn)
        if records:
            assert torch.equal(rows["counts"], counts)
        assert spiked > 0
        assert all(torch.equal(a, b) for a, b in zip(neurons, saved))

    def test_rejects_bad_operands(self):
        from repro_torch.configs import synfire4 as tsyn
        from repro_torch.core import backend as be

        net = tsyn.build_synfire(tsyn.SYNFIRE4_MINI, policy="fp16", device="cpu")
        static, params, st = net.static, net.params, net.state0
        with pytest.raises(ValueError, match="int16"):
            be.assemble_neurons(static, params, st.neurons._replace(
                refrac=st.neurons.refrac.int()), st.ring)
        with pytest.raises(ValueError, match=r"\[L, N, 1\]"):
            be.assemble_neurons(static, params, st.neurons, st.ring[:, :10])
        with pytest.raises(ValueError, match="one T"):
            be.assemble_neurons(static, params, st.neurons, st.ring,
                                gen_spk=torch.zeros((4, static.n_gen), dtype=torch.bool),
                                raster=torch.zeros((5, static.n), dtype=torch.bool))


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
        out = torch.zeros(4)
        ops.DriveRun(8, [DriveProjection(pre=torch.zeros((4, 3), dtype=torch.int64), rows=None,
                                         out=out, w_dtype=torch.float32)])(
            torch.ones(8), [torch.ones((4, 3))], [None])
        assert torch.equal(out, torch.full((4,), 3.0))
        q, k = torch.ones((1, 2, 4, 8), requires_grad=True), torch.ones((1, 3, 2, 8))
        o = ops.attention(q, k, k, torch.ones((1, 2), dtype=torch.int32),
                          torch.ones(3, dtype=torch.int32))
        o.sum().backward()  # ops.AttentionFn: the plain backward on the CPU
        assert ops.LAUNCHES == {"izh4_update": 0, "syn_matmul": 0, "syn_gather": 0,
                                "fused_tick": 0, "stdp_update": 0, "stdp_gather": 0,
                                "plastic_drive": 0, "flash_attention": 0,
                                "flash_attention_bwd": 0}
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
        """Every kernel has its CUDA source, built for sm_90a, which names
        the Pallas TPU kernel it replaces, or, for the port's own plastic
        drive and attention backward (the reference computes them in XLA),
        says it replaces none."""
        for name in _build.KERNELS:
            src = _build.CSRC / f"{name}.cu"
            assert src.exists(), src
            text = src.read_text()
            if name in ("plastic_drive", "flash_attn_bwd"):
                assert "Replaces no TPU kernel" in text
            else:
                assert "Replaces the Pallas TPU kernel" in text
        assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
        assert _build.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")

