"""Decode over the ``model`` axis (A12e, part 3) on the CPU: the mesh
lowering's decode step split like prefill (each model rank gathers its
ranges, attends at its heads over its KV heads' cache, runs its share of the
MLP, the experts, Mamba's and the RG-LRU's channels and the vocabulary),
the cache laid out per ``cache_pspec`` under both KV layouts and updated in
place, over device-list meshes of ``["cpu"] * n``.

Every model is the reference's (``repro.models.transformer.init_params``,
carried across with ``lm_params_from_numpy``). The split prefill fills the
cache; three decode steps through ``build_task``'s decode cell are then held
against the port's single-device decode and the reference's jitted
``decode_step``, each from that same cache and fed the same tokens.
Tolerances (ROADMAP queue C, slice 23; the largest measured value over the
cases in brackets): the row-parallel outputs (``wo``, ``w_down``, the
expert TP sums, ``out_proj``), Mamba's ``x_proj`` all-reduce and the
vocabulary run in rank order, as the split prefill's do, which moves f32
sums by ulps and under fp16 flips the fp16 rounding of some projection
inputs; so the split prefill's serving bounds hold: logits and caches within
1e-5 under fp32 (5.6e-6, 4.3e-6) and 2e-3 under fp16 (1.47e-3, 1.95e-3:
one fp16 ulp of a value between 2 and 4) of the port's single-device
decode (``SERVE_TOL``). Against the reference (fp32 4.5e-6, fp16 1.94e-3)
the single-device port's bounds (``tests/test_torch_archs.py``: fp32 1e-4,
fp16 2e-3, the hybrid's fp16 4e-3) widened by ``SERVE_TOL`` (``REF_TOL``).
``python tests/test_torch_tp_decode.py`` prints the measured values. A
``model`` axis of one is single-device decode of each data index's rows
bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import tasks as jtasks
from repro.models import transformer as jtf
from repro.precision import get_policy as jpolicy
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import distributed
from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharded as sh
from repro_torch.models import attention, tasks
from repro_torch.models import transformer as tf
from repro_torch.precision import get_policy
from repro_torch.precision.policy import _flatten, tree_leaves

B, S, CAP, STEPS = 4, 16, 24, 3
SERVE_TOL = {"fp32": 1e-5, "fp16": 2e-3}
REF_TOL = {"fp32": 1e-4 + 1e-5, "fp16": 2e-3 + 2e-3, ("recurrentgemma-2b", "fp16"): 4e-3 + 2e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def kv_layout():
    """Sets ``KV_CACHE_LAYOUT`` for a test and puts the default back."""
    yield lambda layout: meshlib.KV_CACHE_LAYOUT.__setitem__(0, layout)
    meshlib.KV_CACHE_LAYOUT[0] = "headdim"


def _mesh(shape):
    return meshlib.make_host_mesh(shape, devices=["cpu"] * int(np.prod(shape)))


@functools.cache
def _pair(arch: str, pol: str):
    """(reference cfg, params, jitted decode step, port cfg, port model),
    reduced."""
    jcfg = jconfigs.reduce_arch(jconfigs.get_arch(arch))
    cfg = configs.reduce_arch(configs.get_arch(arch))
    jp = jtf.init_params(jcfg, jax.random.key(1), jpolicy(pol))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu", pol)
    return jcfg, jp, jax.jit(jtasks.make_decode_step(jcfg, jpolicy(pol))), cfg, model


def _batch(cfg, seed=0) -> dict:
    """Prompt tokens (and under the vision frontend bf16-valued patch
    embeddings and M-RoPE positions whose patch rows repeat t = 0, as the
    reference's ``test_archs._batch``) as port tensors."""
    rng = np.random.default_rng(seed)
    p = cfg.n_patches if cfg.frontend == "vision" else 0
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S - p)))}
    if p:
        pe = np.asarray(jnp.asarray(rng.normal(size=(B, p, cfg.d_model)), jnp.bfloat16))
        batch["patch_embeds"] = torch.from_numpy(pe.astype(np.float32))
        pos = np.zeros((B, S, 3), np.int32)
        for i in range(p):
            pos[:, i] = (0, i // 4, i % 4)
        pos[:, p:] = np.arange(1, S - p + 1)[None, :, None] + 1
        batch["positions"] = torch.from_numpy(pos)
    return batch


def _f32(x) -> np.ndarray:
    return (x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            ).astype(np.float32)


def _clone(tree):
    leaves, rebuild = _flatten(tree)
    return rebuild([x.clone() for x in leaves])


def _rows(cfg, cache, rows: slice):
    """A cache's batch rows ``rows`` (a stacked cache's dim 1, a layer's dim
    0; the slots' ``pos`` whole)."""
    leaves, rebuild = _flatten(cache)
    dim = 1 if cfg.homogeneous else 0
    return rebuild([x if k[-1] == "pos" else x.narrow(dim, rows.start, rows.stop - rows.start)
                    for (k, _), x in zip(meshlib.key_paths(cache), leaves)])


def _serve(arch, pol, shape, steps=STEPS):
    """The split prefill on ``shape``, then ``steps`` decode steps of the
    decode cell, of single-device decode and of the reference from the
    prefill's cache, fed the single-device port's greedy tokens: per step
    the three logits, then the three caches (the split one Sharded)."""
    jcfg, jp, jdecode, cfg, model = _pair(arch, pol)
    mesh, params, pol = _mesh(shape), tf.params_tree(model), get_policy(pol)
    logits, s_cache = tasks.make_prefill_step(cfg, pol, mesh=mesh, collect_cache=True,
                                              cache_len=CAP)(params, _batch(cfg))
    cache = sh.gather_tree(s_cache)
    jc = jax.tree.map(lambda x: jnp.array(x.numpy(), copy=True), cache)  # no shared memory
    task = tasks.build_task(cfg, ShapeConfig("d", CAP, B, "decode"), mesh, pol)
    assert task.model_compute == "megatron"
    split, one = task.sharded(), tasks.make_decode_step(cfg, pol)
    token = torch.argmax(sh.gather(logits), -1)[:, None]
    out = []
    for i in range(steps):
        s_logits, s_cache = split(params, s_cache, token, S + i)
        logits1, cache = one(model, cache, token, S + i)
        jl, jc = jdecode(jp, jc, jnp.asarray(token.numpy().astype(np.int32)), jnp.int32(S + i))
        out.append((sh.gather(s_logits), logits1, jl))
        token = torch.argmax(logits1, -1)[:, None]
    return out, (s_cache, cache, jc), mesh


CASES = [(a, p, s, lay) for a in configs.ARCH_NAMES for p in ("fp32", "fp16")
         for s in ((2, 2), (1, 3)) for lay in ("headdim", "seq")]


@pytest.mark.parametrize("arch,pol,shape,layout", CASES,
                         ids=[f"{a}-{p}-{s[0]}x{s[1]}-{lay}" for a, p, s, lay in CASES])
def test_split_decode_matches_single_device_and_reference(arch, pol, shape, layout, kv_layout):
    kv_layout(layout)
    steps, (s_cache, cache, jc), mesh = _serve(arch, pol, shape)
    ref = REF_TOL.get((arch, pol), REF_TOL[pol])
    for got, one, jl in steps:
        torch.testing.assert_close(got, one, rtol=SERVE_TOL[pol], atol=SERVE_TOL[pol])
        np.testing.assert_allclose(_f32(got), _f32(jl), rtol=ref, atol=ref)
    specs = tree_leaves(meshlib.tree_pspecs(cache, mesh, rule=meshlib.cache_pspec))
    assert [x.spec for x in tree_leaves(s_cache)] == specs
    for (keys, a), b, j in zip(meshlib.key_paths(sh.gather_tree(s_cache)), tree_leaves(cache),
                               tree_leaves(jc)):
        assert a.dtype == b.dtype, keys
        if keys[-1] == "pos":
            assert torch.equal(a, b) and np.array_equal(a.numpy(), np.asarray(j)), keys
            continue
        torch.testing.assert_close(a, b, rtol=SERVE_TOL[pol], atol=SERVE_TOL[pol])
        np.testing.assert_allclose(_f32(a), _f32(j), rtol=ref, atol=ref, err_msg=str(keys))


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m", "qwen2-moe-a2.7b",
                                  "falcon-mamba-7b", "recurrentgemma-2b", "qwen2-vl-2b"])
def test_model_axis_of_one_is_single_device_decode_of_its_rows(arch):
    """On 2x1 each data index's one rank computes everything: bit for bit
    single-device decode of that data index's two rows, logits and cache."""
    _, _, _, cfg, model = _pair(arch, "fp16")
    mesh, params, pol = _mesh((2, 1)), tf.params_tree(model), get_policy("fp16")
    logits, cache = tasks.make_prefill_step(cfg, pol, collect_cache=True, cache_len=CAP)(
        model, _batch(cfg))
    halves = [_clone(_rows(cfg, cache, slice(h * 2, h * 2 + 2))) for h in range(2)]
    split, one = tasks.make_decode_step(cfg, pol, mesh=mesh), tasks.make_decode_step(cfg, pol)
    s_cache, token = _clone(cache), torch.argmax(logits, -1)[:, None]
    for i in range(STEPS):
        s_logits, s_cache = split(params, s_cache, token, S + i)
        want = [one(model, halves[h], token[h * 2:h * 2 + 2], S + i)[0] for h in range(2)]
        assert torch.equal(sh.gather(s_logits), torch.cat(want))
        token = torch.argmax(torch.cat(want), -1)[:, None]
    got = sh.gather_tree(s_cache)
    for h in range(2):
        for a, b in zip(tree_leaves(_rows(cfg, got, slice(h * 2, h * 2 + 2))),
                        tree_leaves(halves[h])):
            assert torch.equal(a, b)


def test_uneven_head_runs_attend_run_by_run_over_the_cache():
    """A rank whose query heads split unevenly over its KV heads (as
    qwen2.5's on 16 ranks) attends over the cache run by run: the same
    output and cache as whole heads over an expanded cache."""
    cfg = configs.reduce_arch(configs.get_arch("smollm-360m"))
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 1, cfg.d_model), generator=g)
    hd, q_dim, cap = cfg.head_dim, 3 * cfg.head_dim, 12
    p = type("P", (), dict(n_heads=3, n_kv_heads=2, head_dim=hd, bq=None, bk=None, bv=None,
                           wq=torch.randn((cfg.d_model, q_dim), generator=g),
                           wk=torch.randn((cfg.d_model, 2 * hd), generator=g),
                           wv=torch.randn((cfg.d_model, 2 * hd), generator=g),
                           wo=torch.randn((q_dim, cfg.d_model), generator=g)))
    kpos = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, -1, -1, -1, -1], dtype=torch.int32)
    kpos[8] = 8  # the new token's slot, set by the caller
    cache = {"k": torch.randn((2, cap, 2, hd), generator=g).half(),
             "v": torch.randn((2, cap, 2, hd), generator=g).half(), "pos": kpos}
    qpos = torch.full((2, 1), 8, dtype=torch.int32)
    mine = {k: v.clone() for k, v in cache.items()}
    got, _ = attention.attend(p, x, qpos, None, cache=mine, pos=8, kv_runs=[(0, 2, 0), (2, 3, 1)])
    expand = [0, 0, 1]
    k = torch.cat([p.wk[:, j * hd:(j + 1) * hd] for j in expand], 1)
    v = torch.cat([p.wv[:, j * hd:(j + 1) * hd] for j in expand], 1)
    mha = type("M", (), dict(vars(p), n_kv_heads=3, wk=k, wv=v))
    whole = {"k": cache["k"][:, :, expand].clone(), "v": cache["v"][:, :, expand].clone(),
             "pos": kpos}
    want, _ = attention.attend(mha, x, qpos, None, cache=whole, pos=8)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(mine["k"], whole["k"][:, :, [0, 2]])
    assert torch.equal(mine["v"], whole["v"][:, :, [0, 2]])


def test_uneven_runs_in_the_split_decode(monkeypatch):
    """10 query heads on 2 KV heads over 3 ranks: rank 1's heads 4-6 read
    KV heads 0 and 1 as runs of 1 and 2, and it attends run by run (one
    attention call per run, one for each other rank); the step matches
    single-device decode."""
    _, _, _, cfg, _ = _pair("smollm-360m", "fp32")
    cfg = dataclasses.replace(cfg, n_heads=10, n_kv_heads=2)
    pol = get_policy("fp32")
    model = tf.init_params(cfg, pol, seed=2, device="cpu")
    plan = meshlib.compute_plan(cfg, 3)
    assert plan[1].q_heads == (4, 7) and plan[1].kv_runs(5) == [(0, 1, 0), (1, 3, 1)]
    logits, cache = tasks.make_prefill_step(cfg, pol, collect_cache=True, cache_len=CAP)(
        model, _batch(cfg))
    calls = []
    real = ops.attention
    monkeypatch.setattr(ops, "attention", lambda *a, **k: calls.append(a[0].shape[2]) or real(
        *a, **k))
    token = torch.argmax(logits, -1)[:, None]
    got, _ = tasks.make_decode_step(cfg, pol, mesh=_mesh((1, 3)))(
        tf.params_tree(model), _clone(cache), token, S)
    assert calls == [4, 1, 2, 3] * cfg.n_layers  # query heads per call, rank by rank
    calls.clear()
    want, _ = tasks.make_decode_step(cfg, pol)(model, _clone(cache), token, S)
    torch.testing.assert_close(sh.gather(got), want, rtol=1e-5, atol=1e-5)


def test_cache_is_updated_in_place():
    """A decode step writes into the cache's blocks: every block keeps its
    storage, the returned leaves are the ones passed, and each entry's
    block equals its slices of the single-device cache."""
    _, _, _, cfg, model = _pair("recurrentgemma-2b", "fp16")
    mesh, params, pol = _mesh((2, 2)), tf.params_tree(model), get_policy("fp16")
    logits, s_cache = tasks.make_prefill_step(cfg, pol, mesh=mesh, collect_cache=True,
                                              cache_len=CAP)(params, _batch(cfg))
    before = [[b.data_ptr() for b in x.blocks.flat] for x in tree_leaves(s_cache)]
    leaves = tree_leaves(s_cache)
    token = torch.argmax(sh.gather(logits), -1)[:, None]
    _, out = tasks.make_decode_step(cfg, pol, mesh=mesh)(params, s_cache, token, S)
    assert all(a is b for a, b in zip(tree_leaves(out), leaves))
    assert [[b.data_ptr() for b in x.blocks.flat] for x in tree_leaves(out)] == before
    whole = sh.gather_tree(out)
    for x, w in zip(tree_leaves(out), tree_leaves(whole)):
        for e in sh.entries(mesh):
            assert torch.equal(x.blocks[e], w[x.slices(e)])


def _share(cfg, params, cache, pl, rows: int) -> int:
    """Bytes a rank assembles: its ranges of the parameters, its KV heads'
    rows of the cache (or its channels of the recurrent states) over every
    layer, and its copy of the int32 token rows."""
    n = 0
    for keys, x in meshlib.key_paths(params):
        for region in tasks._rank_regions(keys, tuple(x.shape), pl, cfg):
            n += int(np.prod([s.stop - s.start for s in region])) * x.element_size()
    for keys, x in meshlib.key_paths(cache):
        name, shape = keys[-1], tuple(x.shape)
        if name == "pos":
            continue
        lead = shape[0] if cfg.homogeneous else 1
        dim = {"k": -2, "v": -2, "ssm": -2}.get(name, -1)  # the dim a rank takes a range of
        have = {"kv": pl.kv_heads, "ssm": pl.inner, "rglru": pl.lru}[keys[-2]]
        per_row = int(np.prod(shape[-{"k": 3, "v": 3, "h": 1}.get(name, 2):]))
        n += lead * rows * per_row // shape[dim] * (have[1] - have[0]) * x.element_size()
    return n + rows * 4


@pytest.mark.parametrize("arch", ["smollm-360m", "musicgen-large", "qwen2-vl-2b",
                                  "granite-moe-1b-a400m", "qwen2-moe-a2.7b", "falcon-mamba-7b",
                                  "recurrentgemma-2b"])
def test_decode_entry_gathers_its_ranges_and_its_kv_heads(arch):
    """On a 2x4 meta mesh each rank of every data index assembles exactly
    its parameter ranges, its KV heads' rows of the cache over every
    attention layer (or its channels of the recurrent states) and its token
    rows; none holds the whole parameters; the cache's new entries are
    written back into its blocks."""
    cfg = configs.reduce_arch(configs.get_arch(arch))
    mesh = meshlib.make_host_mesh((2, 4), devices=["meta"] * 8)
    task = tasks.build_task(cfg, ShapeConfig("d", 40, 4, "decode"), mesh, "fp16")
    assert task.model_compute == "megatron"
    prod = dryrun.count_step(task)
    gathered = dict(distributed.GATHERED)
    params, cache = task.args[0], task.args[1]
    whole = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    plan = meshlib.compute_plan(cfg, 4)
    assert sorted(gathered) == sorted(sh.entries(mesh))
    for e, got in gathered.items():
        assert got == _share(cfg, params, cache, plan[e[1]], 2), e
        assert got < whole, (e, got, whole)
    assert prod["gathered_bytes"] == max(gathered.values())
    assert prod["collectives"]["region-write"]["count"] > 0


def _measure() -> None:
    """The measured values the tolerances above cover: the largest
    differences over the cases, split decode against single-device decode
    and against the reference, logits and caches."""
    worst: dict = {}

    def note(key, value):
        worst[key] = max(worst.get(key, 0.0), value)

    for arch, pol, shape, layout in CASES:
        meshlib.KV_CACHE_LAYOUT[0] = layout
        try:
            steps, (s_cache, cache, jc), _ = _serve(arch, pol, shape)
        finally:
            meshlib.KV_CACHE_LAYOUT[0] = "headdim"
        hyb = " (hybrid)" if arch == "recurrentgemma-2b" else ""
        for got, one, jl in steps:
            note(f"logits {pol}{hyb} vs port", float(np.abs(_f32(got) - _f32(one)).max()))
            note(f"logits {pol}{hyb} vs reference", float(np.abs(_f32(got) - _f32(jl)).max()))
        for a, b, j in zip(tree_leaves(sh.gather_tree(s_cache)), tree_leaves(cache),
                           tree_leaves(jc)):
            note(f"cache {pol}{hyb} vs port", float(np.abs(_f32(a) - _f32(b)).max()))
            note(f"cache {pol}{hyb} vs reference", float(np.abs(_f32(a) - _f32(j)).max()))
    for key, value in sorted(worst.items()):
        print(f"{key}: {value:.3g}")


if __name__ == "__main__":  # PYTHONPATH=src python tests/test_torch_tp_decode.py
    torch.set_num_threads(1)
    _measure()
