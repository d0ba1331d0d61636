"""The LM sharding plan (``repro_torch/launch/mesh.py``, A12d) against the
reference's, spec for spec: every leaf of the ten archs' full-size
parameter, train-state and cache trees (the port's ``meta`` trees against
the reference's ``eval_shape`` trees) on 16x16, 2x16x16 and 2x2, both KV
layouts, the batch and the data axes; the meta trees' names, shapes and
dtypes; and the sharded container's layout and collectives.

The reference's rules read only ``mesh.axis_names`` and
``mesh.devices.shape``, so a stand-in holding an empty numpy array of the
mesh's shape serves as its mesh: no forced host devices, no subprocess.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_NAMES, SHAPES as JSHAPES, get_arch as jget_arch
from repro.launch import mesh as jmesh
from repro.models import tasks as jtasks
from repro.models import transformer as jtf
from repro.precision import get_policy as jpolicy
from repro_torch.checkpoint.ckpt import _paths
from repro_torch.configs import SHAPES, get_arch
from repro_torch.core.distributed import COLLECTIVES, reset_collectives
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharded as sh
from repro_torch.launch.mesh import NamedSharding, P
from repro_torch.models import tasks
from repro_torch.models import transformer as tf
from repro_torch.precision import get_policy
from repro_torch.precision.policy import tree_leaves

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model"))]


@pytest.fixture
def kv_layout():
    yield
    meshlib.KV_CACHE_LAYOUT[0] = "headdim"
    jmesh.KV_CACHE_LAYOUT[0] = "headdim"


def _stand_in(shape, axes):
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _meta_mesh(shape, axes):
    return meshlib.make_host_mesh(shape, axes, devices=["meta"] * int(np.prod(shape)))


def _jspecs(tree):
    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))]


def _pspecs(tree):
    return [tuple(s) for s in tree_leaves(tree)]


def _flat_ref(tree):
    return {"||".join(str(p) for p in path): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in _paths(tree)}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_state_plans_match_reference(arch):
    """``param_pspec``/``fit_spec``/``tree_pspecs`` over the full parameter
    tree and ``_state_pspecs`` over the full train state, on the three
    meshes; the meta trees' leaf names, shapes and dtypes."""
    jcfg, pcfg = jget_arch(arch), get_arch(arch)
    jparams = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.key(0), jpolicy("fp16")))
    pparams = tf.params_tree(tf.init_params(pcfg, get_policy("fp16"), device="meta"))
    assert _flat_port(pparams) == _flat_ref(jparams)
    jstate = jtasks.train_state_specs(jcfg, jpolicy("fp16"))
    pstate = tasks.train_state_specs(pcfg, get_policy("fp16"))
    assert _flat_port(pstate) == _flat_ref(jstate)
    assert all(x.device.type == "meta" for x in tree_leaves(pstate))
    for shape, axes in MESHES:
        stand, mesh = _stand_in(shape, axes), _meta_mesh(shape, axes)
        assert _pspecs(meshlib.tree_pspecs(pparams, mesh)) == _jspecs(
            jmesh.tree_pspecs(jparams, stand))
        assert _pspecs(tasks._state_pspecs(pstate, mesh)) == _jspecs(
            jtasks._state_pspecs(jstate, stand))


@pytest.mark.parametrize("layout", ["headdim", "seq"])
def test_cache_plans_match_reference(layout, kv_layout):
    """``cache_pspec`` (fitted) over every arch's decode and long-context
    cache on the three meshes, under both KV layouts."""
    meshlib.KV_CACHE_LAYOUT[0] = jmesh.KV_CACHE_LAYOUT[0] = layout
    for arch in ARCH_NAMES:
        for name in ("decode_32k", "long_500k"):
            s = JSHAPES[name]
            jc = jtf.init_cache(jget_arch(arch), s.global_batch, s.seq_len, jnp.float16,
                                as_specs=True)
            pc = tf.init_cache(get_arch(arch), s.global_batch, s.seq_len, torch.float16, "meta")
            assert _flat_port(pc) == _flat_ref(jc)
            for shape, axes in MESHES:
                got = meshlib.tree_pspecs(pc, _meta_mesh(shape, axes), rule=meshlib.cache_pspec)
                want = jmesh.tree_pspecs(jc, _stand_in(shape, axes), rule=jmesh.cache_pspec)
                assert _pspecs(got) == _jspecs(want), (arch, name, shape)


def test_batch_plans_inputs_and_data_axes():
    for shape, axes in MESHES:
        stand, mesh = _stand_in(shape, axes), _meta_mesh(shape, axes)
        assert meshlib.data_axes(mesh) == jmesh.data_axes(stand)
        for arch in ARCH_NAMES:
            for name in SHAPES:
                pi = tasks.input_specs(get_arch(arch), SHAPES[name])
                ji = jtasks.input_specs(jget_arch(arch), JSHAPES[name])
                assert _flat_port(pi) == _flat_ref(ji)
                assert _pspecs(meshlib.batch_pspecs(pi, mesh)) == _jspecs(
                    jmesh.batch_pspecs(ji, stand))


def test_meshes():
    prod = meshlib.make_production_mesh()
    multi = meshlib.make_production_mesh(multi_pod=True)
    assert prod.shape == {"data": 16, "model": 16} and prod.distinct == (torch.device("meta"),)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    m = meshlib.make_host_mesh((4, 2), devices=["cpu"] * 8)
    assert m.devices.shape == (4, 2) and m.axis_names == ("data", "model")
    assert meshlib.model_axes(multi) == ("model",)
    with pytest.raises(ValueError, match="needs 4 devices"):
        meshlib.make_host_mesh((2, 2), devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no visible card"):
            meshlib.make_host_mesh((2, 2))


def test_sharded_layout_and_collectives():
    """Blocks per spec on each entry (a dim over two axes in their
    row-major order), ``gather`` the inverse of ``shard``, and the three
    collectives' sums and byte counts."""
    mesh = meshlib.make_host_mesh((2, 3), ("data", "model"), devices=["cpu"] * 6)
    x = torch.arange(12 * 6, dtype=torch.float32).reshape(12, 6)
    sx = sh.shard(x, NamedSharding(mesh, P(("data", "model"), None)))
    assert torch.equal(sx.blocks[1, 2], x[10:12]) and torch.equal(sh.gather(sx), x)
    sy = sh.shard(x, NamedSharding(mesh, P("model", "data")))
    assert torch.equal(sy.blocks[1, 0], x[0:4, 3:6]) and len(sy.distinct()) == 6
    reset_collectives()
    whole, region = sh.all_gather(sy, (0, 0), ("data", "model"))
    assert torch.equal(whole, x) and region == (slice(0, 12), slice(0, 6))
    rows, region = sh.all_gather(sy, (1, 0), ("model",))  # the other blocks of data index 1
    assert torch.equal(rows, x[:, 3:6]) and region == (slice(0, 12), slice(3, 6))
    # per device: entry (0, 0) took 5 blocks of 12 f32, entry (1, 0) 2
    assert COLLECTIVES["all-gather"] == {"count": 2, "bytes": 5 * 12 * 4}
    parts = [((0, 0), region_all(x), x), ((1, 0), region_all(x), 2 * x)]
    rs = sh.reduce_scatter(parts, NamedSharding(mesh, P("model", "data")), x.shape,
                                ("data",))
    assert torch.equal(sh.gather(rs), 3 * x)
    # entry (1, 1) takes both parts' [4:8, 3:6] blocks, neither its own
    assert COLLECTIVES["reduce-scatter"] == {"count": 1, "bytes": 2 * 4 * 3 * 4}
    total = sh.all_reduce([((0, 0), torch.tensor(1.5)), ((1, 0), torch.tensor(2.0))])
    assert float(total) == 3.5 and COLLECTIVES["all-reduce"] == {"count": 1, "bytes": 4}
    assert sh.held_bytes({"a": sx, "b": sy}) == {e: (12 + 12) * 4
                                                      for e in sh.entries(mesh)}


def region_all(x):
    return tuple(slice(0, n) for n in x.shape)
