"""The attention backward on the CPU: the plain version
``ref.chunked_attention_bwd_ref`` (the ``flash_attn_bwd`` kernel's oracle)
against autograd through ``ref.chunked_attention_ref`` and against
``jax.grad`` of the reference's ``chunked_attention``; ``ops.AttentionFn``
(what ``ops.attention`` runs when an input requires grad) against autograd
through the plain forward. Shapes: the reduced archs' head dim 16, smollm's
64 with GQA groups of 3, 128 with groups of 4 and 5, stablelm's 160, a
sequence not a multiple of the kernels' tiles, one above 1,024 (where the
reference's KV block pads), a window, invalid slots and rows with no
allowed key. Tolerance: each gradient within 2e-6 of its scale (max abs
difference over max abs value): the plain backward recomputes P from the
log-sum-exp where autograd differentiates the online softmax, which
rounds differently. The CUDA kernel's launch plan (instance, grids, splits,
workspace, shared memory) is tested here too, without a card."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention
from repro_torch.kernels import ops, ref

TOL = 2e-6
CASES = {
    # name: (B, Sq, Hq, Hkv, D, dict(causal, window, qoff, invalid))
    "reduced": (2, 37, 4, 2, 16, {}),
    "smollm_gqa3": (1, 70, 6, 2, 64, {}),
    "group4_d128": (1, 33, 4, 1, 128, {}),
    "group5_d128": (1, 40, 5, 1, 128, {}),
    "stablelm_d160": (1, 29, 4, 1, 160, {}),
    "long_pad": (1, 1100, 2, 1, 16, {}),
    "window": (2, 50, 4, 2, 16, {"window": 7}),
    "invalid_slots": (1, 21, 2, 1, 16, {"invalid": (0, 5, 6)}),
    "no_key_rows": (1, 12, 3, 1, 16, {"qoff": -4}),
    "not_causal": (2, 19, 4, 4, 16, {"causal": False}),
}


def _inputs(b, s, hq, hkv, d, opts, seed=0):
    r = np.random.default_rng(seed)
    q = r.normal(size=(b, s, hq, d)).astype(np.float32)
    k = r.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = r.normal(size=(b, s, hkv, d)).astype(np.float32)
    go = r.normal(size=(b, s, hq, d)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(s, dtype=np.int32) + opts.get("qoff", 0), (b, s)).copy()
    kpos = np.arange(s, dtype=np.int32)
    for i in opts.get("invalid", ()):
        kpos[i] = -1
    return q, k, v, go, qpos, kpos


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(b).max(), 1e-30))


def _autograd(q, k, v, go, qpos, kpos, causal, window):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ref.chunked_attention_ref(qt, kt, vt, torch.from_numpy(qpos), torch.from_numpy(kpos),
                                    causal=causal, window=window)
    return [g.numpy() for g in torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(go))]


def _plain_bwd(q, k, v, go, qpos, kpos, causal, window):
    args = [torch.from_numpy(x) for x in (q, k, v)] + [torch.from_numpy(qpos),
                                                         torch.from_numpy(kpos)]
    out, lse = ref.chunked_attention_ref(*args, causal=causal, window=window, return_lse=True)
    return [g.numpy() for g in ref.chunked_attention_bwd_ref(
        *args, out, lse, torch.from_numpy(go), causal=causal, window=window)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_autograd_and_jax(name):
    b, s, hq, hkv, d, opts = CASES[name]
    causal, window = opts.get("causal", True), opts.get("window", -1)
    q, k, v, go, qpos, kpos = _inputs(b, s, hq, hkv, d, opts)
    plain = _plain_bwd(q, k, v, go, qpos, kpos, causal, window)
    auto = _autograd(q, k, v, go, qpos, kpos, causal, window)

    def f(q_, k_, v_):
        return jnp.vdot(chunked_attention(q_, k_, v_, jnp.asarray(qpos), jnp.asarray(kpos),
                                          causal=causal, window=window), go)

    jgrads = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for p, a, j in zip(plain, auto, jgrads):
        assert _rel(p, a) < TOL, (name, _rel(p, a))
        assert _rel(p, j) < TOL, (name, _rel(p, j))


def test_no_key_rows_gradient_shape():
    """A row with no allowed key: dq = 0 for it, and each dv_j gains its
    dO / (Sk + pad)."""
    q, k, v, go, qpos, kpos = _inputs(1, 12, 3, 1, 16, {"qoff": -4})
    dq, dk, dv = _plain_bwd(q, k, v, go, qpos, kpos, True, -1)
    assert np.all(dq[:, :4] == 0.0)
    go2 = go.copy()
    go2[:, :4] = 0.0
    dv2 = _plain_bwd(q, k, v, go2, qpos, kpos, True, -1)[2]
    extra = go[0, :4].sum(axis=(0, 1)) / 12.0
    np.testing.assert_allclose(dv[0, :, 0] - dv2[0, :, 0], np.broadcast_to(extra, (12, 16)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["reduced", "smollm_gqa3", "window", "no_key_rows"])
def test_attention_fn_backward_on_cpu(name):
    b, s, hq, hkv, d, opts = CASES[name]
    causal, window = opts.get("causal", True), opts.get("window", -1)
    q, k, v, go, qpos, kpos = _inputs(b, s, hq, hkv, d, opts, seed=1)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.attention(qt, kt, vt, torch.from_numpy(qpos), torch.from_numpy(kpos),
                        causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "AttentionFnBackward"
    plain_out = ref.chunked_attention_ref(qt, kt, vt, torch.from_numpy(qpos),
                                          torch.from_numpy(kpos), causal=causal, window=window)
    assert torch.equal(out.detach(), plain_out.detach())
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(go))
    auto = _autograd(q, k, v, go, qpos, kpos, causal, window)
    for g, a in zip(grads, auto):
        assert _rel(g.numpy(), a) < TOL


def test_attention_without_grad_keeps_the_plain_path():
    q, k, v, _, qpos, kpos = _inputs(1, 9, 2, 1, 16, {})
    args = [torch.from_numpy(x) for x in (q, k, v, qpos, kpos)]
    out = ops.attention(*args)
    assert out.grad_fn is None
    qt = args[0].clone().requires_grad_()
    with torch.no_grad():
        assert ops.attention(qt, *args[1:]).grad_fn is None
    assert ops.attention(qt, *args[1:]).grad_fn is not None


def test_lse_marks_rows_with_no_key():
    q, k, v, _, qpos, kpos = _inputs(1, 12, 3, 1, 16, {"qoff": -4})
    args = [torch.from_numpy(x) for x in (q, k, v, qpos, kpos)]
    out, lse = ref.chunked_attention_ref(*args, return_lse=True)
    assert lse.shape == (1, 3, 12)
    assert torch.all(lse[:, :, :4] == ref.NEG_INF) and torch.all(lse[:, :, 4:] > -100)
    torch.testing.assert_close(out, ref.chunked_attention_ref(*args), rtol=0, atol=0)


# The CUDA kernel's launch plan (kernels/flash_attn_bwd.py:plan), tested
# without a card: [B, S, Hq, Hkv, D] with Sq = Sk = S.
PLAN_SHAPES = {
    "smollm": (8, 512, 15, 5, 64),
    "qwen2.5": (1, 512, 10, 2, 128),
    "stablelm": (1, 512, 8, 2, 160),
    "recurrentgemma": (4, 512, 10, 1, 256),
    "qwen2-moe-mha": (4, 512, 16, 16, 128),
    "reduced": (4, 64, 4, 1, 16),
    "group7-d20": (2, 100, 7, 1, 20),
    "decode-sized": (2, 5, 3, 1, 16),
}


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_bwd_plan_covers_every_row_head_and_batch_once_per_split(name):
    """Each dK/dV CTA holds 32 keys of one query head and batch row, each
    dQ CTA 32 query rows; over a grid every (row, head, batch row) is held
    by exactly one CTA of each split."""
    from repro_torch.kernels import flash_attn_bwd as fb

    b, s, hq, hkv, d = PLAN_SHAPES[name]
    p = fb.plan(b, s, s, hq, hkv, d)
    for grid in (p["dkv_grid"], p["dq_grid"]):
        nx, ny, nz = grid
        assert (ny, nz) == (hq, b) and nx % p["splits"] == 0
        blocks = nx // p["splits"]
        seen = np.zeros((p["splits"], s, hq, b), dtype=np.int64)
        for x in range(nx):
            row0, split = (x % blocks) * fb.FIX_ROWS, x // blocks
            seen[split, row0:min(row0 + fb.FIX_ROWS, s)] += 1
        assert np.all(seen == 1)


@pytest.mark.parametrize("d", [16, 20, 32, 64, 100, 128, 129, 160, 161, 200, 256])
def test_bwd_plan_instance_is_the_smallest_at_or_above_d(d):
    from repro_torch.kernels import flash_attn_bwd as fb

    p = fb.plan(1, 64, 64, 4, 2, d)
    assert p["dp"] == min(x for x in fb.INSTANCES if x >= d)
    assert p["threads"] == 32 * p["warps"] == 32 * 2 * p["dp"] // fb.COLS
    if 128 < d <= 160:  # D 160 has its own instance: no 256-wide work
        assert p["dp"] == 160


def test_bwd_plan_fills_the_card_at_qwen25():
    """[1, 512, 10, 2, 128]: at least one CTA per SM (132) in both tile
    kernels (the dK/dV grid was 16 CTAs when one walked a GQA group)."""
    from repro_torch.kernels import flash_attn_bwd as fb

    p = fb.plan(1, 512, 512, 10, 2, 128)
    for grid in (p["dkv_grid"], p["dq_grid"]):
        assert math.prod(grid) >= 132


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_bwd_plan_workspace(name):
    """No workspace for MHA (one query head per KV head: no splits either);
    with a group, per-head and per-split dK and dV, and per-split dQ where
    a block's tiles are split."""
    from repro_torch.kernels import flash_attn_bwd as fb

    b, s, hq, hkv, d = PLAN_SHAPES[name]
    p = fb.plan(b, s, s, hq, hkv, d)
    if hq == hkv:
        assert p["splits"] == 1 and p["workspace_bytes"] == 0
        assert p["reduce_grid"] is None and p["reduce_q_grid"] is None
    else:
        sp = p["splits"]
        assert 1 <= sp <= fb.MAX_SPLITS and p["reduce_grid"] is not None
        want = 4 * (2 * sp * b * s * hq * d + (sp * b * s * hq * d if sp > 1 else 0))
        assert p["workspace_bytes"] == want
        assert (p["reduce_q_grid"] is not None) == (sp > 1)


def test_bwd_plan_shared_memory_fits_the_sm():
    """Every instance fits an H100 CTA (227 KB); D <= 128 two CTAs an SM
    (228 KB of shared memory), D 256 one."""
    from repro_torch.kernels import flash_attn_bwd as fb

    for dp in fb.INSTANCES:
        smem = fb.plan(1, 64, 64, 2, 1, dp)["smem_bytes"]
        assert smem <= 232_448
        if dp <= 128:
            assert 2 * smem <= 233_472


def test_bwd_plan_rejects_what_the_kernel_does_not_take():
    from repro_torch.kernels import flash_attn_bwd as fb

    with pytest.raises(ValueError):
        fb.plan(1, 8, 8, 4, 2, 257)
    with pytest.raises(ValueError):
        fb.plan(1, 8, 8, 5, 2, 64)
