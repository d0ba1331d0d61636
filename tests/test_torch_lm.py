"""The port's dense LM serving path on the CPU against the reference.

For each of the four dense architectures under ``reduce_arch``, the
reference's parameters (``repro.models.transformer.init_params``) are
carried across with ``lm_params_from_numpy``; then the port's prefill
logits and cache, three decode steps and ``serve`` tokens are held
against the reference's, driven through ``repro.models.tasks`` (which sets
the reference's activation dtype) and ``repro.launch.serve``. Tolerances:
logits at rtol = atol = 1e-4 under the fp32 and bf16 policies; under fp16,
logits at atol = 2e-3 (a projection rounds its input to fp16, and XLA's
rsqrt in RMSNorm rounds differently from PyTorch's, so an input now and
then lands one fp16 ulp apart); under fp16_opt (bf16 activations and
logits) at two bf16 ulps of the logit scale, 2**-4; greedy tokens equal. Layers, configs and the
converter are checked on their own."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.serve import serve as jserve  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import tasks as jtasks  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.precision import get_policy as jpolicy  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import layers, tasks  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.precision import get_policy  # noqa: E402

DENSE = ("smollm-360m", "qwen2.5-14b", "minitron-8b", "stablelm-12b")
# bf16 keeps f32 activations and rounds projection inputs to bf16: on the
# reduced archs no input lands a bf16 ulp apart (2.4e-7 measured), so it
# holds fp32's 1e-4. fp16_opt's activations and logits are bf16: the
# port's and XLA's f32 rsqrt, exp and cos part by an f32 ulp now and then,
# and every bf16 rounding after that can flip, so logits reach about one
# bf16 ulp of their scale apart (3.5e-2 measured at |4|); held at two,
# 2**-4 (ROADMAP queue C).
LOGIT_TOL = {"fp32": dict(rtol=1e-4, atol=1e-4), "fp16": dict(rtol=0, atol=2e-3),
             "bf16": dict(rtol=1e-4, atol=1e-4), "fp16_opt": dict(rtol=0, atol=2**-4)}
PROMPT, CAP = 12, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.cache
def _pair(arch: str, policy: str):
    """(reference cfg, reference params, port cfg, port model on the CPU)."""
    jcfg = jconfigs.reduce_arch(jconfigs.get_arch(arch))
    cfg = configs.reduce_arch(configs.get_arch(arch))
    jp = jtf.init_params(jcfg, jax.random.key(1), jpolicy(policy))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu", policy)
    return jcfg, jp, cfg, model


def _prompts(cfg, b=2, s=PROMPT, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _f32(x) -> np.ndarray:
    """A port tensor or a reference array (bf16 included) as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _act(policy: str) -> torch.dtype:
    """The dtype of a policy's logits: its activation dtype."""
    return torch.bfloat16 if policy == "fp16_opt" else torch.float32


def _prefill_both(arch, policy):
    jcfg, jp, cfg, model = _pair(arch, policy)
    toks = _prompts(cfg)
    jstep = jax.jit(jtasks.make_prefill_step(jcfg, jpolicy(policy), seq_shard=False,
                                             collect_cache=True, cache_len=CAP))
    jl, jc = jstep(jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        pl, pc = tasks.make_prefill_step(cfg, get_policy(policy), collect_cache=True,
                                         cache_len=CAP)(model, {"tokens": torch.from_numpy(toks)})
    return (jl, jc), (pl, pc)


CELLS = [(a, p) for a in DENSE for p in ("fp32", "fp16", "bf16", "fp16_opt")]
IDS = [f"{a}-{p}" for a, p in CELLS]


@pytest.mark.parametrize("arch,policy", CELLS, ids=IDS)
def test_prefill_matches_reference(arch, policy):
    (jl, jc), (pl, pc) = _prefill_both(arch, policy)
    assert pl.dtype == _act(policy)
    np.testing.assert_allclose(_f32(pl), _f32(jl), **LOGIT_TOL[policy])
    sdt = get_policy(policy).state_storage
    for name in ("k", "v"):
        got, want = pc["kv"][name], np.asarray(jc["kv"][name])
        assert got.dtype == sdt and tuple(got.shape) == want.shape
        # K/V before the cast agree as the logits do; the cast may flip one ulp.
        np.testing.assert_allclose(_f32(got), _f32(want), **LOGIT_TOL[policy])
    np.testing.assert_array_equal(pc["kv"]["pos"].numpy(), np.asarray(jc["kv"]["pos"]))


@pytest.mark.parametrize("arch,policy", CELLS, ids=IDS)
def test_decode_matches_reference(arch, policy):
    jcfg, jp, cfg, model = _pair(arch, policy)
    (jl, jc), (pl, pc) = _prefill_both(arch, policy)
    jdecode = jax.jit(jtasks.make_decode_step(jcfg, jpolicy(policy)))
    decode = tasks.make_decode_step(cfg, get_policy(policy))
    tok = np.argmax(_f32(jl), -1)[:, None].astype(np.int32)
    for i in range(3):
        jl, jc = jdecode(jp, jc, jnp.asarray(tok), jnp.int32(PROMPT + i))
        with torch.inference_mode():
            pl, pc = decode(model, pc, torch.from_numpy(tok), PROMPT + i)
        np.testing.assert_allclose(_f32(pl), _f32(jl), **LOGIT_TOL[policy])
        np.testing.assert_array_equal(pc["kv"]["pos"].numpy(), np.asarray(jc["kv"]["pos"]))
        tok = np.argmax(_f32(jl), -1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(pl.argmax(-1).numpy(), tok[:, 0])


@pytest.mark.parametrize("built", ["fp16", "fp16_opt"])
def test_activation_dtype_follows_the_step_policy(built):
    """The activation dtype is the step's policy's, not the model's: fp16
    weights built under ``fp16`` and served by ``fp16_opt`` steps run bf16
    activations, bit for bit as a model built under ``fp16_opt``, as the
    reference's step sets ``act`` from its own policy."""
    _, _, cfg, model = _pair("smollm-360m", built)
    _, _, _, opt = _pair("smollm-360m", "fp16_opt")
    toks = torch.from_numpy(_prompts(cfg))
    step = tasks.make_prefill_step(cfg, get_policy("fp16_opt"), collect_cache=True,
                                   cache_len=CAP)
    decode = tasks.make_decode_step(cfg, get_policy("fp16_opt"))
    with torch.inference_mode():
        (got, gc), (want, wc) = step(model, {"tokens": toks}), step(opt, {"tokens": toks})
        tok = want.argmax(-1)[:, None]
        got_d, want_d = decode(model, gc, tok, PROMPT)[0], decode(opt, wc, tok, PROMPT)[0]
    assert got.dtype == got_d.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got_d, want_d, rtol=0, atol=0)


@pytest.mark.parametrize("arch,policy", CELLS, ids=IDS)
def test_serve_matches_reference(arch, policy):
    _, jp, _, model = _pair(arch, policy)
    want = jserve(arch, batch=2, prompt_len=8, gen=8, policy_name=policy, params=jp, seed=3)
    got = serve_mod.serve(arch, batch=2, prompt_len=8, gen=8, policy_name=policy,
                          params=model, seed=3, device="cpu")
    assert got["tokens"].shape == (2, 8) and got["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    assert got["batch"] == 2 and got["decode_tok_s"] > 0


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_decode(arch):
    """prefill(tokens[0:s]) logits at the last position == decoding the same
    tokens one by one (the reference's ``test_archs.py`` check, on the
    port's own weights and at its tolerance)."""
    cfg = configs.reduce_arch(configs.get_arch(arch))
    policy = get_policy("fp16")
    model = tf.init_params(cfg, policy, seed=2, device="cpu")
    toks = torch.from_numpy(_prompts(cfg, b=1, s=8, seed=3))
    with torch.inference_mode():
        logits_p = tasks.make_prefill_step(cfg, policy)(model, {"tokens": toks})
        cache = tf.init_cache(cfg, 1, 16, policy.state_storage, "cpu")
        step = tasks.make_decode_step(cfg, policy)
        for pos in range(8):
            logits_d, cache = step(model, cache, toks[:, pos:pos + 1], pos)
    assert torch.isfinite(logits_d).all()
    np.testing.assert_allclose(logits_p.numpy(), logits_d.numpy(), rtol=5e-2, atol=5e-2)


# Full width, fp16: the logits reach |4.7|, where one fp16 ulp of a
# projection input moves a logit by up to 2.8e-3 (ROADMAP queue C); the
# reduced configs' 2e-3 does not hold there, so this case is held at 4e-3,
# about one fp16 ulp of its logit scale. fp32 holds 1e-4 at full width.
# bf16 rounds a projection input to 8 bits, not 11: one bf16 ulp moves a
# logit 8 times as far as an fp16 one (1.05e-2 measured), so bf16 is held
# at 8 x 4e-3. fp16_opt's logits are bf16 themselves, held as on the
# reduced archs (queue C).
FULL_WIDTH_TOL = {"fp32": dict(rtol=1e-4, atol=1e-4), "fp16": dict(rtol=0, atol=4e-3),
                  "bf16": dict(rtol=0, atol=3.2e-2), "fp16_opt": dict(rtol=0, atol=2**-4)}


@pytest.mark.parametrize("policy", ["fp32", "fp16", "bf16", "fp16_opt"])
def test_full_width_smollm_two_layers(policy):
    """smollm-360m at its full widths (d 960, 15/5 heads, d_ff 2,560, vocab
    49,152), cut to 2 layers: prefill and two decode steps against the
    reference, greedy tokens equal."""
    jcfg = dataclasses.replace(jconfigs.get_arch("smollm-360m"), n_layers=2)
    cfg = dataclasses.replace(configs.get_arch("smollm-360m"), n_layers=2)
    jp = jtf.init_params(jcfg, jax.random.key(4), jpolicy(policy))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu", policy)
    toks = _prompts(cfg, b=1, s=6, seed=8)
    jl, jc = jax.jit(jtasks.make_prefill_step(jcfg, jpolicy(policy), seq_shard=False,
                                              collect_cache=True, cache_len=8))(
        jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        pl, pc = tasks.make_prefill_step(cfg, get_policy(policy), collect_cache=True,
                                         cache_len=8)(model, {"tokens": torch.from_numpy(toks)})
    jdecode = jax.jit(jtasks.make_decode_step(jcfg, jpolicy(policy)))
    for i in range(3):
        np.testing.assert_allclose(_f32(pl), _f32(jl), **FULL_WIDTH_TOL[policy])
        tok = np.argmax(_f32(jl), -1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(pl.argmax(-1).numpy(), tok[:, 0])
        if i == 2:
            break
        jl, jc = jdecode(jp, jc, jnp.asarray(tok), jnp.int32(6 + i))
        with torch.inference_mode():
            pl, pc = tasks.make_decode_step(cfg, get_policy(policy))(
                model, pc, torch.from_numpy(tok), 6 + i)


# -- layers ---------------------------------------------------------------------------


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind):
    x, s, b = _rand(0, (3, 5, 64)), _rand(1, 64, 0.1), _rand(2, 64, 0.1)
    if kind == "rmsnorm":
        want = jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(s))
        got = layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(s))
    else:
        want = jlayers.layernorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
        got = layers.layernorm(*(torch.from_numpy(a) for a in (x, s, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu2"])
@pytest.mark.parametrize("wdtype", ["fp32", "fp16"])
def test_mlp_matches_reference(kind, wdtype):
    npdt = np.float16 if wdtype == "fp16" else np.float32
    x = _rand(3, (2, 4, 32))
    ws = {n: _rand(i + 4, shape, 0.2).astype(npdt) for i, (n, shape) in enumerate(
        [("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32))])}
    if kind not in ("swiglu", "geglu"):
        del ws["w_gate"]
    want = jlayers.mlp_apply(kind, jnp.asarray(x), {n: jnp.asarray(w) for n, w in ws.items()})
    p = layers.MLP(None, kind, 32, 48, torch.float16 if wdtype == "fp16" else torch.float32)
    for n, w in ws.items():
        getattr(p, n).data.copy_(torch.from_numpy(w))
    got = p(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "relu2", "geglu"])
def test_mlp_bf16_activations_match_reference(kind):
    """``fp16_opt``'s MLP: fp16 weights, bf16 activations. With the
    reference's activation dtype set to bf16, its projections, silu and
    relu2 round where the port's do: bit for bit; the tanh GELU's f32 tanh
    differs now and then, so geglu is held at two bf16 ulps (2**-7
    relative)."""
    x = _rand(3, (2, 4, 32))
    ws = {n: _rand(i + 4, shape, 0.2).astype(np.float16) for i, (n, shape) in enumerate(
        [("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32))])}
    if kind == "relu2":
        del ws["w_gate"]
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jlayers.set_act_dtype(jnp.bfloat16)
    try:
        want = jlayers.mlp_apply(kind, xb, {n: jnp.asarray(w) for n, w in ws.items()})
    finally:
        jlayers.set_act_dtype(None)
    p = layers.MLP(None, kind, 32, 48, torch.float16)
    for n, w in ws.items():
        getattr(p, n).data.copy_(torch.from_numpy(w))
    got = p(torch.from_numpy(x).to(torch.bfloat16), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    if kind == "geglu":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2**-7, atol=2**-7)
    else:
        np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("rotary_pct,theta", [(1.0, 10000.0), (0.5, 10000.0),
                                              (0.25, 10000.0), (1.0, 1_000_000.0)])
def test_rope_matches_reference(rotary_pct, theta):
    x = _rand(7, (2, 9, 3, 16))
    pos = np.broadcast_to(np.arange(500, 509, dtype=np.int32), (2, 9)).copy()
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta=theta, rotary_pct=rotary_pct)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta=theta,
                      rotary_pct=rotary_pct)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_mrope_matches_reference():
    x = _rand(8, (1, 6, 2, 16))
    pos = np.random.default_rng(9).integers(0, 40, (1, 6, 3)).astype(np.int32)
    want = jlayers.mrope(jnp.asarray(x), jnp.asarray(pos), (4, 2, 2))
    got = layers.mrope(torch.from_numpy(x), torch.from_numpy(pos), (4, 2, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# -- configs, policy, converter, entry points -------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_configs_match_reference(arch):
    full, jfull = configs.get_arch(arch), jconfigs.get_arch(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert dataclasses.asdict(configs.reduce_arch(full)) == dataclasses.asdict(
        jconfigs.reduce_arch(jfull))
    assert configs.count_params(full) == jconfigs.count_params(jfull)
    assert (full.q_dim, full.kv_dim, full.homogeneous) == (jfull.q_dim, jfull.kv_dim,
                                                           jfull.homogeneous)


def test_smollm_parameter_count():
    assert configs.count_params(configs.get_arch("smollm-360m")) == 361_820_160


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_registry_matches_reference(arch):
    """All ten of the reference's architectures: each config field for
    field (full and reduced), its layer kinds, ``count_params`` and
    ``count_active_params``."""
    full, jfull = configs.get_arch(arch), jconfigs.get_arch(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    red, jred = configs.reduce_arch(full), jconfigs.reduce_arch(jfull)
    assert dataclasses.asdict(red) == dataclasses.asdict(jred)
    for c, j in ((full, jfull), (red, jred)):
        assert configs.count_params(c) == jconfigs.count_params(j)
        assert configs.count_active_params(c) == jconfigs.count_active_params(j)
        assert c.homogeneous == j.homogeneous
        assert [c.layer_kind(i) for i in range(c.n_layers)] == [
            j.layer_kind(i) for i in range(j.n_layers)]
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES


@pytest.mark.parametrize("name", ["fp32", "fp16", "bf16", "fp16_opt", "fp16_sr"])
def test_policies_compute_in_f32(name):
    """Each policy computes in the reference's dtype: f32, but bf16
    activations under ``fp16_opt``."""
    want = jnp.dtype(jpolicy(name).compute)
    assert get_policy(name).compute == {"float32": torch.float32,
                                        "bfloat16": torch.bfloat16}[want.name]
    assert (want == jnp.float32) == (name != "fp16_opt")


def test_converter_checks_leaves():
    jcfg, jp, cfg, _ = _pair("qwen2.5-14b", "fp16")
    arrays = jax.tree.map(np.asarray, jp)
    model = lm_params_from_numpy(cfg, arrays, "cpu", "fp16")
    assert model.layers[1].attn.bq.dtype == torch.float16
    assert model.layers[0].norm1.scale.dtype == torch.float32
    np.testing.assert_array_equal(model.layers[1].attn.wq.numpy(),
                                  np.asarray(arrays["layers"]["attn"]["wq"][1]))
    bad = jax.tree.map(lambda a: a, arrays)
    bad["embed"] = arrays["embed"].astype(np.float32)
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_numpy(cfg, bad, "cpu", "fp16")
    extra = dict(arrays, bogus=np.zeros((64, 512), np.float16))
    with pytest.raises(ValueError, match="bogus"):
        lm_params_from_numpy(cfg, extra, "cpu", "fp16")
    missing = {k: v for k, v in arrays.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        lm_params_from_numpy(cfg, missing, "cpu", "fp16")


def test_port_init_is_seeded_and_in_storage_dtypes():
    cfg = configs.reduce_arch(configs.get_arch("stablelm-12b"))
    a = tf.init_params(cfg, get_policy("fp16"), seed=7, device="cpu")
    b = tf.init_params(cfg, get_policy("fp16"), seed=7, device="cpu")
    c = tf.init_params(cfg, get_policy("fp16"), seed=8, device="cpu")
    for (n, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), n
        assert pa.dtype == (torch.float32 if "norm" in n else torch.float16), n
    assert not torch.equal(a.embed, c.embed)
    assert a.lm_head is not None and a.final_norm.bias is not None


def test_serve_runs_on_the_card_by_default(monkeypatch):
    """Without ``device`` the serving entry point runs on the card, and
    raises without one rather than drifting onto the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.serve("smollm-360m", batch=1, prompt_len=4, gen=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_params(configs.reduce_arch(configs.get_arch("smollm-360m")),
                       get_policy("fp16"))


def test_cpu_serve_launches_nothing():
    ops.reset_launches()
    serve_mod.serve("minitron-8b", batch=1, prompt_len=4, gen=3, device="cpu")
    assert ops.LAUNCHES["flash_attention"] == 0
