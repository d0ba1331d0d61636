"""The port's ten LM architectures on the CPU against the reference:
the registry, and serving for the five families beyond the dense
decoders (MoE, Mamba, the RG-LRU hybrid with local attention, audio and
the VLM).

The reference's parameters (``repro.models.transformer.init_params``) are
carried across with ``lm_params_from_numpy``; prefill logits and caches,
decode logits over several steps from the prefill's cache, the hybrid's
ring across a wrap of its window, and ``launch.serve``'s tokens are held
against the reference's, driven through ``repro.models.tasks`` (which
sets the reference's activation dtype). Tolerances (ROADMAP queue C):
fp32 logits at 1e-4; fp16 logits at 2e-3 (one fp16 ulp of a projection
input, as the dense archs), but the hybrid's at 4e-3, whose RG-LRU gates
and recurrence carry an f32 ulp of XLA's fused sigmoid and exp into
every later position (2.6e-3 measured). MoE routes and capacity drops are
the reference's exactly: a tight capacity (``capacity_factor`` 0.5)
drops tokens, and the logits still agree.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.serve import serve as jserve  # noqa: E402
from repro.models import tasks as jtasks  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.precision import get_policy as jpolicy  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import tasks  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.precision import get_policy  # noqa: E402
from repro_torch.precision.policy import tree_leaves  # noqa: E402

NEW = ("granite-moe-1b-a400m", "qwen2-moe-a2.7b", "falcon-mamba-7b", "recurrentgemma-2b",
       "musicgen-large", "qwen2-vl-2b")
LOGIT_TOL = {"fp32": dict(rtol=1e-4, atol=1e-4), "fp16": dict(rtol=0, atol=2e-3)}
HYBRID_FP16_TOL = dict(rtol=0, atol=4e-3)
S, CAP, B = 24, 32, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tol(arch: str, policy: str) -> dict:
    return HYBRID_FP16_TOL if (arch, policy) == ("recurrentgemma-2b", "fp16") \
        else LOGIT_TOL[policy]


def _cfgs(arch):
    return (jconfigs.reduce_arch(jconfigs.get_arch(arch)),
            configs.reduce_arch(configs.get_arch(arch)))


@functools.cache
def _pair(arch: str, policy: str, cf: float | None = None):
    """(reference cfg, params, port cfg, port model), reduced; ``cf``
    replaces the MoE capacity factor."""
    jcfg, cfg = _cfgs(arch)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    jp = jtf.init_params(jcfg, jax.random.key(1), jpolicy(policy))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu", policy)
    return jcfg, jp, cfg, model


def _batch(cfg, b=B, s=S, seed=0):
    """numpy inputs as the reference's ``test_archs._batch``: tokens, and
    under the vision frontend bf16 patch embeddings and M-RoPE positions
    whose patch rows repeat t = 0."""
    rng = np.random.default_rng(seed)
    p = cfg.n_patches if cfg.frontend == "vision" else 0
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s - p)).astype(np.int32)}
    if p:
        batch["patch_embeds"] = np.asarray(jnp.asarray(rng.normal(size=(b, p, cfg.d_model)),
                                                       jnp.bfloat16))
        pos = np.zeros((b, s, 3), np.int32)
        for i in range(p):
            pos[:, i] = (0, i // 4, i % 4)
        pos[:, p:] = np.arange(1, s - p + 1)[None, :, None] + 1
        batch["positions"] = pos
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pb(batch):
    out = {"tokens": torch.from_numpy(batch["tokens"].astype(np.int64))}
    if "patch_embeds" in batch:
        out["patch_embeds"] = torch.from_numpy(batch["patch_embeds"].astype(np.float32))
        out["positions"] = torch.from_numpy(batch["positions"])
    return out


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _leaves(tree):
    """(path, leaf) of a cache tree, the reference's or the port's."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            for p, x in _leaves(tree[k]):
                yield f"{k}.{p}" if p else k, x
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            for p, x in _leaves(t):
                yield f"{i}.{p}", x
    else:
        yield "", tree


@functools.cache
def _prefill_both(arch, policy, cap=CAP, s=S, cf=None):
    jcfg, jp, cfg, model = _pair(arch, policy, cf)
    batch = _batch(cfg, s=s)
    jl, jc = jax.jit(jtasks.make_prefill_step(jcfg, jpolicy(policy), seq_shard=False,
                                              collect_cache=True, cache_len=cap))(jp, _jb(batch))
    with torch.inference_mode():
        pl, pc = tasks.make_prefill_step(cfg, get_policy(policy), collect_cache=True,
                                         cache_len=cap)(model, _pb(batch))
    return (jl, jc), (pl, pc)


def _check_cache(pc, jc, tol):
    got, want = dict(_leaves(pc)), dict(_leaves(jc))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape, name
        if name.endswith("pos"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        else:
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name
            np.testing.assert_allclose(_f32(g), _f32(w), **tol, err_msg=name)


CELLS = [(a, p) for a in NEW for p in ("fp32", "fp16")]
IDS = [f"{a}-{p}" for a, p in CELLS]


@pytest.mark.parametrize("arch,policy", CELLS, ids=IDS)
def test_prefill_matches_reference(arch, policy):
    (jl, jc), (pl, pc) = _prefill_both(arch, policy)
    assert pl.dtype == torch.float32 and tuple(pl.shape) == jl.shape
    np.testing.assert_allclose(_f32(pl), _f32(jl), **_tol(arch, policy))
    _check_cache(pc, jc, _tol(arch, policy))


@pytest.mark.parametrize("arch,policy", CELLS, ids=IDS)
def test_decode_matches_reference(arch, policy):
    """Four decode steps from the prefill's cache, each fed the reference's
    greedy token: logits within the policy's tolerance, slot positions
    equal, greedy tokens equal."""
    jcfg, jp, cfg, model = _pair(arch, policy)
    (jl, jc), (_, pc) = _prefill_both(arch, policy)
    pc = _clone(pc)  # the cached prefill stays as it was
    jdecode = jax.jit(jtasks.make_decode_step(jcfg, jpolicy(policy)))
    decode = tasks.make_decode_step(cfg, get_policy(policy))
    tok = np.argmax(_f32(jl), -1)[:, None].astype(np.int32)
    for i in range(4):
        jl, jc = jdecode(jp, jc, jnp.asarray(tok), jnp.int32(S + i))
        with torch.inference_mode():
            pl, pc = decode(model, pc, torch.from_numpy(tok.astype(np.int64)), S + i)
        np.testing.assert_allclose(_f32(pl), _f32(jl), **_tol(arch, policy))
        tok = np.argmax(_f32(jl), -1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(pl.argmax(-1).numpy(), tok[:, 0])
    _check_cache(pc, jc, _tol(arch, policy))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone()


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"])
def test_capacity_drops_match_reference(arch):
    """Capacity factor 0.5: a quarter or more of the routed assignments
    overflow their expert and drop; the port drops the reference's (a
    different drop moves a logit by far more than the tolerance)."""
    (jl, _), (pl, _) = _prefill_both(arch, "fp32", cf=0.5)
    np.testing.assert_allclose(_f32(pl), _f32(jl), **LOGIT_TOL["fp32"])
    (jl1, _), _ = _prefill_both(arch, "fp32")
    assert np.abs(_f32(jl) - _f32(jl1)).max() > 1e-2  # the drops moved the logits


def test_hybrid_ring_across_a_wrap():
    """recurrentgemma reduced (window 32): a 40-token prompt packed into a
    32-slot ring (the last 32 tokens, slot = pos mod 32), then 12 decode
    steps that wrap it; the ring's slot positions (not in order after the
    wrap), K/V, recurrent states and logits against the reference's."""
    arch, policy = "recurrentgemma-2b", "fp32"
    jcfg, jp, cfg, model = _pair(arch, policy)
    assert cfg.hybrid.window == 32
    (jl, jc), (pl, pc) = _prefill_both(arch, policy, cap=32, s=40)
    pc = _clone(pc)
    assert pc[2]["kv"]["pos"].tolist() == [32 + i if i < 8 else i for i in range(32)]
    _check_cache(pc, jc, LOGIT_TOL[policy])
    jdecode = jax.jit(jtasks.make_decode_step(jcfg, jpolicy(policy)))
    decode = tasks.make_decode_step(cfg, get_policy(policy))
    tok = np.argmax(_f32(jl), -1)[:, None].astype(np.int32)
    for i in range(12):
        jl, jc = jdecode(jp, jc, jnp.asarray(tok), jnp.int32(40 + i))
        with torch.inference_mode():
            pl, pc = decode(model, pc, torch.from_numpy(tok.astype(np.int64)), 40 + i)
        np.testing.assert_allclose(_f32(pl), _f32(jl), **LOGIT_TOL[policy])
        tok = np.argmax(_f32(jl), -1)[:, None].astype(np.int32)
    _check_cache(pc, jc, LOGIT_TOL[policy])
    # the ring after 52 positions: slots 0..19 hold 32..51, slots 20..31 hold 20..31
    assert pc[2]["kv"]["pos"].tolist() == [32 + i if i < 20 else i for i in range(32)]


def test_hybrid_init_cache_caps_at_the_window():
    jcfg, cfg = _cfgs("recurrentgemma-2b")
    want = jtf.init_cache(jcfg, 2, 100, jnp.float16)
    got = tf.init_cache(cfg, 2, 100, torch.float16, "cpu")
    assert isinstance(got, tuple) and len(got) == 3
    for (gn, g), (wn, w) in zip(_leaves(got), _leaves(want)):
        assert gn == wn and tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype)
        np.testing.assert_array_equal(_f32(g), _f32(w))


ALL = tuple(configs.ARCH_NAMES)


@pytest.mark.parametrize("arch", ALL)
def test_prefill_matches_decode(arch):
    """The reference's ``test_prefill_matches_decode`` on the port's own
    weights: prefill(tokens[0:8]) logits at the last position == decoding
    the same tokens one by one, at its tolerance; MoE at drop-free
    capacity, the VLM skipped (its prefix comes only with prefill), as the
    reference does."""
    cfg = configs.reduce_arch(configs.get_arch(arch))
    if cfg.frontend == "vision":
        pytest.skip("the patch prefix comes with prefill only")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    policy = get_policy("fp16")
    model = tf.init_params(cfg, policy, seed=2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 8)))
    with torch.inference_mode():
        logits_p = tasks.make_prefill_step(cfg, policy)(model, {"tokens": toks})
        cache = tf.init_cache(cfg, 1, 16, policy.state_storage, "cpu")
        step = tasks.make_decode_step(cfg, policy)
        for pos in range(8):
            logits_d, cache = step(model, cache, toks[:, pos:pos + 1], pos)
    assert torch.isfinite(logits_d).all()
    np.testing.assert_allclose(logits_p.numpy(), logits_d.numpy(), rtol=5e-2, atol=5e-2)


# -- registry -------------------------------------------------------------------------


def test_arch_names_are_the_references():
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES and len(configs.ARCH_NAMES) == 10


@pytest.mark.parametrize("arch", NEW)
def test_port_init_matches_reference_layout(arch):
    """The port's own draws: every leaf of the reference's parameter tree,
    in its shape and dtype, seeded (same seed, same weights)."""
    jcfg, cfg = _cfgs(arch)
    want = jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.key(0), jpolicy("fp16")))
    a = tf.params_tree(tf.init_params(cfg, get_policy("fp16"), seed=7, device="cpu"))
    b = tf.params_tree(tf.init_params(cfg, get_policy("fp16"), seed=7, device="cpu"))
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    al, bl = tree_leaves(a), tree_leaves(b)
    assert len(al) == len(wl)
    for x, y, (path, w) in zip(al, bl, wl):
        assert tuple(x.shape) == w.shape and str(x.dtype)[6:] == str(w.dtype), path
        assert torch.equal(x, y)
    assert isinstance(a["layers"], tuple) == (not cfg.homogeneous)


def test_converter_rejects_a_stacked_tree_for_the_hybrid():
    jcfg, jp, cfg, _ = _pair("recurrentgemma-2b", "fp16")
    arrays = jax.tree.map(np.asarray, jp)
    with pytest.raises((KeyError, ValueError)):
        lm_params_from_numpy(cfg, dict(arrays, layers=arrays["layers"][:2]), "cpu", "fp16")
    bad = jax.tree.map(lambda a: a, arrays)
    bad["layers"] = tuple(dict(lay) for lay in arrays["layers"])
    bad["layers"][0]["rglru"] = dict(bad["layers"][0]["rglru"],
                                     lam=arrays["layers"][0]["rglru"]["lam"].astype(np.float16))
    with pytest.raises(ValueError, match="lam"):
        lm_params_from_numpy(cfg, bad, "cpu", "fp16")


# -- entry points ------------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [a for a in NEW if a != "qwen2-vl-2b"])
def test_serve_matches_reference(arch):
    _, jp, _, model = _pair(arch, "fp16")
    want = jserve(arch, batch=2, prompt_len=8, gen=6, policy_name="fp16", params=jp, seed=3)
    got = serve_mod.serve(arch, batch=2, prompt_len=8, gen=6, policy_name="fp16",
                          params=model, seed=3, device="cpu")
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))


def test_entry_points_refuse_the_vlm():
    """Neither the reference's ``serve`` nor its ``train`` makes
    ``patch_embeds``; the port's refuse the VLM with a clear error (it
    serves and trains through the step functions, as the tests above)."""
    with pytest.raises(ValueError, match="patch_embeds"):
        serve_mod.serve("qwen2-vl-2b", batch=1, prompt_len=8, gen=2, device="cpu")
    with pytest.raises(ValueError, match="patch_embeds"):
        train_mod.train("qwen2-vl-2b", steps=1, global_batch=1, seq_len=16, device="cpu")


def test_short_prompt_raises_for_recurrent_caches():
    """A prompt shorter than the conv's history leaves the reference a
    short cache; the port raises instead."""
    for arch in ("falcon-mamba-7b", "recurrentgemma-2b"):
        cfg = configs.reduce_arch(configs.get_arch(arch))
        model = tf.init_params(cfg, get_policy("fp16"), device="cpu")
        step = tasks.make_prefill_step(cfg, get_policy("fp16"), collect_cache=True,
                                       cache_len=8)
        with pytest.raises(ValueError, match="shorter than the conv"):
            step(model, {"tokens": torch.zeros((1, 2), dtype=torch.int64)})
