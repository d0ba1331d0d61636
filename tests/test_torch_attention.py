"""The port's attention on the CPU (the plain versions its wrappers run
there) against the reference: ``kernels/ref.chunked_attention_ref`` and
``ops.attention`` against ``repro.models.attention.chunked_attention``,
and ``ops.flash_attention`` (the Pallas signature) against the Pallas
``flash_attention`` in interpret mode and the reference's exact
``kernels/ref.flash_attention_ref``, at rtol = atol = 1e-5. Inputs are
made with numpy from a seed and handed to both packages. The CUDA kernel
runs only on the card: ``chip_smoke.py`` and the ``cuda``-marked case in
``tests/test_torch_kernels.py`` hold it against these plain versions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attn import flash_attention as pallas_flash  # noqa: E402
from repro.models.attention import chunked_attention  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
KV = {"f32": (np.float32, torch.float32, jnp.float32),
      "fp16": (np.float16, torch.float16, jnp.float16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _model_inputs(seed, b, sq, sk, hq, hkv, d, kv, invalid=0):
    """q, k, v in the model's layout, kpos = arange(Sk) with the last
    ``invalid`` slots empty (-1), and queries at the end of the valid keys."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d), np.float32)
    k = rng.standard_normal((b, sk, hkv, d), np.float32).astype(KV[kv][0])
    v = rng.standard_normal((b, sk, hkv, d), np.float32).astype(KV[kv][0])
    kpos = np.arange(sk, dtype=np.int32)
    if invalid:
        kpos[-invalid:] = -1
    qpos = np.broadcast_to(np.arange(sq, dtype=np.int32) + (sk - invalid - sq), (b, sq)).copy()
    return q, k, v, qpos, kpos


# (b, sq, sk, hq, hkv, d, causal, window, kv dtype, invalid slots, block_k)
MODEL_CASES = {
    "causal-g4-d16": (2, 64, 64, 4, 1, 16, True, -1, "f32", 0, 1024),
    "causal-g3-d64-fp16": (1, 96, 96, 6, 2, 64, True, -1, "fp16", 0, 1024),
    "window64-g4-d16": (2, 160, 160, 4, 1, 16, True, 64, "f32", 0, 64),
    "window64-g3-d64-fp16": (1, 130, 130, 15, 5, 64, True, 64, "fp16", 0, 64),
    "decode-g3-d64-fp16-cache": (2, 1, 544, 15, 5, 64, True, -1, "fp16", 32, 1024),
    "decode-g4-d16-f32-cache": (2, 1, 40, 4, 1, 16, True, -1, "f32", 8, 16),
    "noncausal-g4-d16-blocked": (1, 33, 100, 8, 2, 16, False, -1, "f32", 0, 32),
}


@pytest.mark.parametrize("case", MODEL_CASES.values(), ids=MODEL_CASES.keys())
def test_chunked_attention_matches_reference(case):
    b, sq, sk, hq, hkv, d, causal, window, kv, invalid, block_k = case
    arrays = _model_inputs(sq * 1000 + sk + hq, b, sq, sk, hq, hkv, d, kv, invalid)
    want = np.asarray(chunked_attention(*(jnp.asarray(x) for x in arrays), causal=causal,
                                        window=window, block_k=block_k))
    tensors = [torch.from_numpy(x) for x in arrays]
    got = ref.chunked_attention_ref(*tensors, causal=causal, window=window, block_k=block_k)
    assert got.dtype == torch.float32 and got.shape == (b, sq, hq, d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # The wrapper runs the plain version (1,024-key blocks) on CPU tensors:
    # another blocking moves only the last bits.
    ops.reset_launches()
    wrapped = ops.attention(*tensors, causal=causal, window=window)
    assert ops.LAUNCHES["flash_attention"] == 0
    np.testing.assert_allclose(wrapped.numpy(), want, **TOL)


def test_row_without_allowed_key_is_zero():
    """A query before every valid key (causal) has no allowed key: the
    port gives the reference's value there, ``Σ_{j<Sk} v_j / (Sk + pad)``
    (the reference keeps m = -1e30, so every key takes p = 1), and every
    row equals the reference, blocked over KV (pad > 0) or not."""
    q, k, v, _, _ = _model_inputs(3, 2, 6, 8, 4, 2, 16, "f32")
    kpos = np.arange(8, dtype=np.int32) + 10
    qpos = np.array([[5, 10, 11, 12, 13, 30], [17, 9, 14, 15, 16, 17]], np.int32)
    got = ops.attention(*(torch.from_numpy(x) for x in (q, k, v, qpos, kpos))).numpy()
    want = np.asarray(chunked_attention(*(jnp.asarray(x) for x in (q, k, v, qpos, kpos))))
    empty = qpos < 10
    np.testing.assert_allclose(got, want, **TOL)
    mean = np.repeat(v.sum(axis=1) / 8, 2, axis=1)  # [b, hq, d]: KV head h // 2
    np.testing.assert_allclose(got[empty], mean[np.nonzero(empty)[0]], **TOL)
    blocked = [torch.from_numpy(x) for x in (q, k, v, qpos, kpos)]
    for block_k in (3, 8):  # pad 1 and 0
        got = ref.chunked_attention_ref(*blocked, block_k=block_k).numpy()
        want = np.asarray(chunked_attention(*(jnp.asarray(x) for x in (q, k, v, qpos, kpos)),
                                            block_k=block_k))
        np.testing.assert_allclose(got, want, **TOL)


# (b, hq, hkv, sq, sk, d, window, kv dtype)
PALLAS_CASES = {
    "mha-d64": (1, 4, 4, 128, 128, 64, -1, "f32"),
    "g4-d16-fp16": (1, 8, 2, 64, 64, 16, -1, "fp16"),
    "g3-d64-window64-fp16": (1, 6, 2, 96, 96, 64, 64, "fp16"),
    "decode-g4-d16": (2, 4, 1, 1, 200, 16, -1, "f32"),
    "g2-d32-window48-ragged": (1, 4, 2, 64, 160, 32, 48, "fp16"),
}


@pytest.mark.parametrize("case", PALLAS_CASES.values(), ids=PALLAS_CASES.keys())
def test_flash_attention_matches_pallas(case):
    b, hq, hkv, sq, sk, d, window, kv = case
    rng = np.random.default_rng(sq * 1000 + sk)
    q = rng.standard_normal((b, hq, sq, d), np.float32)
    k = rng.standard_normal((b, hkv, sk, d), np.float32).astype(KV[kv][0])
    v = rng.standard_normal((b, hkv, sk, d), np.float32).astype(KV[kv][0])
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    pallas = np.asarray(pallas_flash(jq, jk, jv, causal=True, window=window, interpret=True))
    exact = np.asarray(jref.flash_attention_ref(jq, jk.astype(jnp.float32),
                                                jv.astype(jnp.float32), causal=True,
                                                window=window))
    ops.reset_launches()
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True,
                              window=window)
    assert ops.LAUNCHES["flash_attention"] == 0
    assert got.dtype == torch.float32 and got.shape == (b, hq, sq, d)
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    np.testing.assert_allclose(got.numpy(), exact, **TOL)
    plain = ref.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), causal=True,
                                    window=window)
    assert torch.equal(plain, got)


def _no_key_case(case):
    """q, k, v in the Pallas layout with Sq > Sk, so the first Sq - Sk
    queries of a causal call see no key: the ROADMAP's case (q, k = 1, v =
    arange(16) as [1, 1, 2, 8], Sq 4) and a random one with Sk 130, which
    the Pallas kernel pads to 256 slots."""
    if case == "roadmap":
        v = np.arange(16, dtype=np.float32).reshape(1, 1, 2, 8)
        return np.ones((1, 1, 4, 8), np.float32), np.ones_like(v), v
    rng = np.random.default_rng(130)
    return (rng.standard_normal((2, 4, 140, 16), np.float32),
            *(rng.standard_normal((2, 2, 130, 16), np.float32) for _ in range(2)))


# fp16 q: the outputs round to fp16, one ulp of which is up to 9.8e-4 here.
Q_TOL = {"f32": TOL, "fp16": dict(rtol=0, atol=1e-3)}


@pytest.mark.parametrize("qdtype", ["f32", "fp16"])
@pytest.mark.parametrize("case", ["roadmap", "sk130"])
def test_flash_attention_rows_without_keys_match_pallas(case, qdtype):
    """A causal call with Sq > Sk: the rows that see no key take the Pallas
    kernel's value (every padded slot gets p = 1 there: the sum of v over
    Sk, divided by Sk rounded up to 128), the others its usual one; the
    plain version (``ref.flash_attention_ref``) equals the wrapper."""
    q, k, v = _no_key_case(case)
    q = q.astype(KV[qdtype][0])
    pallas = np.asarray(pallas_flash(*(jnp.asarray(x) for x in (q, k, v)), causal=True,
                                     interpret=True), np.float32)
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    assert got.dtype == KV[qdtype][1]
    np.testing.assert_allclose(got.float().numpy(), pallas, **Q_TOL[qdtype])
    empty = q.shape[2] - k.shape[2]
    want = v.sum(axis=2) / (-(-k.shape[2] // 128) * 128)  # [B, Hkv, D]
    want = np.repeat(want, q.shape[1] // k.shape[1], axis=1)[:, :, None]
    np.testing.assert_allclose(got[:, :, :empty].float().numpy(),
                               np.broadcast_to(want, got[:, :, :empty].shape),
                               **Q_TOL[qdtype])
    if case == "roadmap":
        assert float(got[0, 0, 0, 0]) == 0.0625
    plain = ref.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    assert torch.equal(plain, got)


def test_flash_attention_keeps_q_dtype():
    """Out in q's dtype, as the Pallas kernel's; bf16 K/V decoded to f32."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((1, 4, 16, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 16, 16), np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 2, 16, 16), np.float32))
    out = ops.flash_attention(q.half(), k.bfloat16(), v.bfloat16())
    assert out.dtype == torch.float16
    want = ops.flash_attention(q.half().float(), k.bfloat16().float(), v.bfloat16().float())
    np.testing.assert_allclose(out.float().numpy(), want.half().float().numpy(), rtol=0,
                               atol=0)


BAD = {
    "q-not-f32": lambda q, k, v, qp, kp: (q.half(), k, v, qp, kp),
    "kv-dtypes-differ": lambda q, k, v, qp, kp: (q, k, v.half(), qp, kp),
    "kv-int": lambda q, k, v, qp, kp: (q, k.int(), v.int(), qp, kp),
    "qpos-int64": lambda q, k, v, qp, kp: (q, k, v, qp.long(), kp),
    "qpos-shape": lambda q, k, v, qp, kp: (q, k, v, qp[:, :1], kp),
    "kpos-shape": lambda q, k, v, qp, kp: (q, k, v, qp, kp[:3]),
    "heads-not-multiple": lambda q, k, v, qp, kp: (q[:, :, :3], k, v, qp, kp),
    "head-dim-differs": lambda q, k, v, qp, kp: (q[..., :8], k, v, qp, kp),
}


@pytest.mark.parametrize("bad", BAD.values(), ids=BAD.keys())
def test_attention_rejects_bad_operands(bad):
    arrays = _model_inputs(4, 1, 4, 8, 4, 2, 16, "f32")
    tensors = [torch.from_numpy(x) for x in arrays]
    with pytest.raises(ValueError, match="attention"):
        ops.attention(*bad(*tensors))


@pytest.mark.parametrize("shape,want", [
    ((4, 1, 544, 15, 5, 64), (17, 32)),      # the smollm serve's decode: 340 CTAs
    ((4, 1, 4096, 15, 5, 64), (26, 160)),
    ((4, 1, 32768, 15, 5, 64), (32, 1024)),  # capped at 1,024 keys a split
    ((1, 1, 32768, 15, 5, 64), (103, 320)),
    ((2, 2, 700, 8, 2, 128), (22, 32)),      # 8 query rows per KV head
    ((4, 512, 512, 15, 5, 64), (0, 0)),      # prefill
    ((1, 1, 100, 20, 1, 64), (0, 0)),        # 20 rows per KV head: prefill path
    ((1, 1, 100, 16, 1, 256), (0, 0)),       # 16 x 256 outputs per CTA: prefill path
])
def test_attention_path_and_split_plan(shape, want):
    """The kernel's path and decode split count, chosen from the shapes
    (132 SMs): splits of whole 32-key tiles making about four CTAs per SM,
    at most 1,024 keys a split; the prefill path beyond 16 query rows or
    2,048 outputs per KV head."""
    from repro_torch.kernels import flash_attn as fa

    b, sq, sk, hq, hkv, d = shape
    splits, kps = fa.plan(b, sq, sk, hq, hkv, d, 132)
    assert (splits, kps) == want
    if splits:
        assert kps % fa.TILE == 0 and kps <= fa.MAX_SPLIT and (splits - 1) * kps < sk <= splits * kps


def test_pad_den_is_the_reference_divisor():
    from repro_torch.kernels import flash_attn as fa

    assert [fa.pad_den(sk) for sk in (1, 40, 1024, 1100, 2048, 2049)] == [
        1.0, 40.0, 1024.0, 2048.0, 2048.0, 3072.0]
