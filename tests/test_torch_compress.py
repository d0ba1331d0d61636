"""Compressed all-reduce (``repro_torch/optim/compress.py``) against the
reference's ``repro/optim/compress.py``: ``compress_tree`` and
``decompress_tree`` bit for bit (bf16; int8 with an f32 scale, zero leaves
included), and ``psum_compressed`` over a 4-entry CPU mesh against the
reference under ``jax.vmap(..., axis_name="pod")`` (``psum`` and ``pmax``
work under ``vmap`` on one device): bit for bit for all three methods
(the four entries summed in axis order, as the reference's reduction
sums them here; int8's payload exactly in int32); and the reference
test's bounds, 0.02 and 0.05 of the scale, against the exact mean.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as jc
from repro_torch.core.distributed import COLLECTIVES, reset_collectives
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import compress as pc


def _tree(seed):
    r = np.random.default_rng(seed)
    return {"w": r.normal(size=(16, 8)).astype(np.float32) * 3.0,
            "b": r.normal(size=(8,)).astype(np.float32) * 1e-3,
            "z": np.zeros((5,), np.float32)}


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x.view(np.uint32 if x.dtype.itemsize
                                                                   == 4 else np.uint8)


@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_compress_round_trip_bitwise(method):
    tree = _tree(0)
    want = jc.compress_tree(jax.tree.map(jnp.asarray, tree), method)
    got = pc.compress_tree(_torch(tree), method)
    for k in tree:
        if method == "bf16":
            assert np.array_equal(got[k].view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(want[k]).view(np.uint16))
        else:
            assert np.array_equal(got[k][0].numpy(), np.asarray(want[k][0]))
            assert np.array_equal(_bits(got[k][1].numpy()), _bits(np.float32(want[k][1])))
    if method == "int8":
        assert float(got["z"][1]) == 1.0 and not got["z"][0].any()  # a zero leaf: scale 1
    back = pc.decompress_tree(got, method, _torch(tree))
    jback = jc.decompress_tree(want, method, jax.tree.map(jnp.asarray, tree))
    for k in tree:
        assert back[k].dtype == torch.float32
        assert np.array_equal(_bits(back[k].numpy()), _bits(np.asarray(jback[k])))


def _reference(x, method):
    return np.asarray(jax.vmap(lambda v: jc.psum_compressed(v, "pod", method),
                               axis_name="pod")(jnp.asarray(x)))


@pytest.mark.parametrize("method", [None, "bf16", "int8"])
def test_psum_compressed_matches_reference(method):
    x = np.asarray(jax.random.normal(jax.random.key(0), (4, 64), jnp.float32))
    mesh = make_host_mesh((4,), ("pod",), devices=["cpu"] * 4)
    reset_collectives()
    out = pc.psum_compressed([torch.from_numpy(x[i].copy()) for i in range(4)], mesh, "pod",
                             method)
    got = np.stack([o.numpy() for o in out])
    want = _reference(x, method)
    exact = _reference(x, None)
    assert np.array_equal(_bits(got), _bits(want))
    scale = float(np.abs(exact).max())
    err = float(np.abs(got - exact).max())
    assert err < {None: 1e-6, "bf16": 0.02, "int8": 0.05}[method] * scale
    assert all(np.array_equal(got[0], g) for g in got)  # every entry takes the same mean
    per_elem = {None: 4, "bf16": 2, "int8": 1}[method]
    calls = 2 if method == "int8" else 1  # int8 agrees on the scale first
    assert COLLECTIVES["all-reduce"]["count"] == calls
    assert COLLECTIVES["all-reduce"]["bytes"] == 3 * 64 * per_elem + (3 * 4 if calls == 2 else 0)


def test_psum_compressed_over_one_axis_of_two():
    """On a 2x2 mesh over ``pod``: each line of the other axis reduces on its own."""
    mesh = make_host_mesh((2, 2), ("pod", "data"), devices=["cpu"] * 4)
    xs = [torch.full((3,), float(i)) for i in range(4)]  # row-major: (pod, data)
    out = pc.psum_compressed(xs, mesh, "pod", None)
    assert [float(o[0]) for o in out] == [1.0, 2.0, 1.0, 2.0]
