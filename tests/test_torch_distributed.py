"""Device-list meshes and the neuron-sharded SNN
(``repro_torch.core.distributed``) held against the reference's
``repro.core.distributed`` on the CPU.

The reference shards over forced host devices; the port's mesh is a list
of torch devices, so ``["cpu"] * k`` is its counterpart, in this process.
``ShardedSNN`` at mesh size 1 equals the reference's ``build_sharded`` on
one device bit for bit: per-tick spike counts, ring and, in fp16, ``v``
and ``u`` against its jitted run. In fp32 the jitted reference contracts
IZH4's mul+adds into FMAs even at XLA opt level 0 (ROADMAP queue C), so
``v`` and ``u`` are held bit for bit against the reference evaluated op
by op over the first ticks, past the first tick where the two differ, and
within ``rtol=1e-5`` of the jitted run over 300.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.distributed import build_sharded as rbuild  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    DeviceMesh,
    build_sharded,
    core_mesh,
    lane_mesh,
)
from test_distributed import run_with_devices  # noqa: E402

SNN = dict(n_neurons=1024, fanin=32, max_delay=8, seed=3)
DTYPES = {"fp16": (jnp.float16, torch.float16), "fp32": (jnp.float32, torch.float32)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class TestMeshes:
    def test_sizes(self):
        m = lane_mesh(devices=["cpu"] * 4)
        assert isinstance(m, DeviceMesh) and m.shape == {"lanes": 4} and m.size == 4
        assert m.distinct == (torch.device("cpu"),)
        c = core_mesh(2, devices=["cpu"] * 4)
        assert c.shape == {"cores": 2} and c.axis == "cores"
        assert lane_mesh(3, axis="model", devices=["cpu"] * 3).shape["model"] == 3

    def test_errors(self):
        with pytest.raises(ValueError, match="only 4 visible"):
            lane_mesh(5, devices=["cpu"] * 4)
        with pytest.raises(ValueError, match="at least one"):
            core_mesh(0, devices=["cpu"])
        if not torch.cuda.is_available():
            # The default devices are the visible cards: none here.
            with pytest.raises(ValueError):
                lane_mesh()
            with pytest.raises(ValueError, match="requested 2"):
                core_mesh(2)


def _ref_snn(dtype, n_devices=1):
    wdt = DTYPES[dtype][0]
    mesh = jax.make_mesh((n_devices,), ("model",))
    return rbuild(mesh, "model", weight_dtype=wdt, state_dtype=wdt, **SNN)


def _port_snn(dtype, k=1):
    wdt = DTYPES[dtype][1]
    return build_sharded(lane_mesh(k, axis="model", devices=["cpu"] * k), "model",
                         weight_dtype=wdt, state_dtype=wdt, **SNN)


def _bytes(x):
    return np.asarray(x).tobytes()


class TestShardedSNN:
    @pytest.mark.parametrize("dtype", ["fp16", "fp32"])
    def test_mesh1_matches_reference(self, dtype):
        rsnn, tsnn = _ref_snn(dtype), _port_snn(dtype)
        for name in ("a", "b", "c", "d", "is_gen", "gen_rate", "gen_until",
                     "gen_rate_after", "idx", "w", "delay"):
            assert _bytes(getattr(tsnn.params, name).numpy()) == _bytes(
                getattr(rsnn.params, name)), name
        rst, rcounts = rsnn.run(300)
        tst, tcounts = tsnn.run(300)
        np.testing.assert_array_equal(tcounts.numpy(), np.asarray(rcounts))
        assert int(tcounts.sum()) > 0 and tst.t == 300
        assert _bytes(tst.ring.numpy()) == _bytes(rst.ring)
        np.testing.assert_array_equal(tst.key.numpy(),
                                      np.asarray(jax.random.key_data(rst.key)).view(np.int32))
        if dtype == "fp16":
            assert _bytes(tst.v.numpy()) == _bytes(rst.v)
            assert _bytes(tst.u.numpy()) == _bytes(rst.u)
            return
        np.testing.assert_allclose(tst.v.numpy(), np.asarray(rst.v), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(tst.u.numpy(), np.asarray(rst.u), rtol=1e-5, atol=1e-4)
        step = rsnn.step_fn()
        st = rsnn.state
        with jax.disable_jit():
            for _ in range(6):
                st, _ = step(rsnn.params, st)
        short, _ = _port_snn(dtype).run(6)
        for a, b in ((short.v, st.v), (short.u, st.u), (short.ring, st.ring)):
            assert _bytes(a.numpy()) == _bytes(b)

    def test_ring_adds_round_in_storage_dtype(self):
        """fp16 ring adds round one synapse at a time in fan-in order, as
        the reference's scatter-add: a ring entry that collects 2048 and
        then 31 × 1 keeps 2048 (each +1 rounds away at fp16's spacing of 2
        there), where an f32 sum rounded once would give 2080."""
        snn = _port_snn("fp16")
        p = snn.params
        n, f = p.idx.shape
        idx = torch.zeros_like(p.idx)
        w = torch.ones((n, f), dtype=torch.float16)
        w[:, 0] = 2048.0
        delay = torch.ones_like(p.delay)
        is_gen = torch.ones(n, dtype=torch.bool)
        rate = torch.full((n,), 1e9)
        snn.params = p._replace(idx=idx, w=w, delay=delay, is_gen=is_gen, gen_rate=rate,
                                gen_rate_after=rate)
        st, counts = snn.run(1)
        assert int(counts[0]) == n
        assert float(st.ring[1, 0]) == 2048.0
        rsnn = _ref_snn("fp16")
        rsnn.params = rsnn.params._replace(
            idx=jnp.asarray(idx.numpy()), w=jnp.asarray(w.numpy()),
            delay=jnp.asarray(delay.numpy()), is_gen=jnp.asarray(is_gen.numpy()),
            gen_rate=jnp.asarray(rate.numpy()), gen_rate_after=jnp.asarray(rate.numpy()))
        rst, _ = rsnn.run(1)
        assert _bytes(st.ring.numpy()) == _bytes(rst.ring)

    def test_mesh8_vs_mesh1_statistically(self):
        """The per-shard generator fold differs with the mesh size, so
        mesh 8 matches mesh 1 in total spikes within the reference's 20%."""
        c8 = int(_port_snn("fp16", 8).run(300)[1].sum())
        c1 = int(_port_snn("fp16", 1).run(300)[1].sum())
        assert abs(c8 - c1) / max(c1, 1) < 0.2, (c8, c1)

    @pytest.mark.slow
    def test_mesh4_matches_reference_on_four_host_devices(self):
        res = run_with_devices(4, """
        import json
        import jax, jax.numpy as jnp
        import numpy as np
        from repro.core.distributed import build_sharded
        mesh = jax.make_mesh((4,), ("model",))
        snn = build_sharded(mesh, "model", n_neurons=1024, fanin=32, max_delay=8, seed=3)
        st, counts = snn.run(300)
        print(json.dumps({"counts": np.asarray(counts).tolist(),
                          "v": np.asarray(st.v).view(np.uint16).tolist(),
                          "u": np.asarray(st.u).view(np.uint16).tolist(),
                          "ring": np.asarray(st.ring).view(np.uint16).ravel().tolist()}))
        """)
        tst, tcounts = _port_snn("fp16", 4).run(300)
        assert tcounts.tolist() == res["counts"]
        assert tst.v.view(torch.int16).numpy().view(np.uint16).tolist() == res["v"]
        assert tst.u.view(torch.int16).numpy().view(np.uint16).tolist() == res["u"]
        assert tst.ring.view(torch.int16).numpy().view(np.uint16).ravel().tolist() == \
            res["ring"]

    def test_pads_to_shard_multiple(self):
        # 1,024 neurons over 3 shards pad to 1,026, and the numpy draws are
        # made at the padded size, as the reference's are.
        snn = build_sharded(lane_mesh(3, devices=["cpu"] * 3), "lanes", **SNN)
        assert snn.n == 1026 and snn.state.ring.shape == (9, 1026)
        assert snn.params.idx.shape == (1026, 32) and snn.state.v.shape == (1026,)
        idx = np.random.default_rng(SNN["seed"]).integers(0, 1026, size=(1026, 32))
        assert np.array_equal(snn.params.idx.numpy(), idx)

    def test_unknown_axis(self):
        snn = _port_snn("fp16")
        snn.axis = "lanes"
        with pytest.raises(ValueError, match="no axis 'lanes'"):
            snn.run(1)
