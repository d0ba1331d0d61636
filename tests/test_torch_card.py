"""The port's CUDA kernels on the card (``-m cuda``; they skip without
one). This file imports neither JAX nor the reference, so it runs on a
machine with the card and PyTorch alone:

    python -m pytest -q -p no:cacheprovider --noconftest -m cuda tests/test_torch_card.py

(``--noconftest``: ``tests/conftest.py`` resets the reference's flags and
imports JAX.) ``chip_smoke.py`` holds every kernel at the main paths'
shapes; these cases are the attention kernel's (B7) against its plain
version at rtol = atol = 1e-5, and the serving path on the card against
the CPU port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, reduce_arch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.precision import get_policy  # noqa: E402


@pytest.fixture
def card():
    """The first CUDA device; skips where there is none (the CUDA kernels
    build and launch only on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# (b, sq, sk, hq, hkv, d, causal, window, kv dtype, invalid slots, query shift)
CASES = {
    "smollm-prefill": (4, 512, 512, 15, 5, 64, True, -1, torch.float32, 0, 0),
    "smollm-decode-fp16-cache": (4, 1, 544, 15, 5, 64, True, -1, torch.float16, 32, 0),
    "window64-g4-d16-fp16": (2, 160, 160, 8, 2, 16, True, 64, torch.float16, 0, 0),
    "d128-g4-bf16": (1, 100, 100, 8, 2, 128, True, -1, torch.bfloat16, 0, 0),
    "d160-g4-noncausal": (1, 33, 70, 8, 2, 160, False, -1, torch.float32, 0, 0),
    "rows-without-keys": (2, 40, 40, 6, 2, 64, True, -1, torch.float32, 0, -8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_flash_attention_kernel_matches_plain(card, case):
    """One launch per call, and the plain version's result on the same
    inputs; a row with no allowed key is 0 in both."""
    b, sq, sk, hq, hkv, d, causal, window, kvdt, invalid, shift = case
    g = torch.Generator().manual_seed(sq + sk)
    q = torch.randn((b, sq, hq, d), generator=g)
    k = torch.randn((b, sk, hkv, d), generator=g).to(kvdt)
    v = torch.randn((b, sk, hkv, d), generator=g).to(kvdt)
    kpos = torch.arange(sk, dtype=torch.int32)
    if invalid:
        kpos[-invalid:] = -1
    qpos = (torch.arange(sq, dtype=torch.int32) + (sk - invalid - sq + shift)).expand(b, sq)
    args = [x.contiguous().to(card) for x in (q, k, v, qpos, kpos)]
    ops.reset_launches()
    got = ops.attention(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 1
    want = ref.chunked_attention_ref(*args, causal=causal, window=window)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if shift < 0:
        assert bool((got[:, :-shift] == 0).all())


@pytest.mark.cuda
def test_flash_attention_pallas_signature(card):
    g = torch.Generator().manual_seed(1)
    q = torch.randn((1, 4, 256, 64), generator=g).to(card)
    k = torch.randn((1, 2, 256, 64), generator=g).half().to(card)
    v = torch.randn((1, 2, 256, 64), generator=g).half().to(card)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=True, window=64)
    assert ops.LAUNCHES["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, causal=True, window=64)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_flash_attention_rejects_head_dim_above_limit(card):
    q = torch.zeros((1, 2, 2, 264), device=card)
    kv = torch.zeros((1, 2, 1, 264), device=card)
    pos = torch.zeros((1, 2), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="256"):
        ops.attention(q, kv, kv, pos, torch.zeros(2, dtype=torch.int32, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "stablelm-12b"])
def test_serve_on_card_equals_cpu(card, arch):
    """The reduced model served on the card, fp32 policy: the CPU port's
    tokens, and one attention launch per layer per prefill and decode step."""
    cfg = reduce_arch(get_arch(arch))
    policy = get_policy("fp32")
    on_card = tf.init_params(cfg, policy, seed=3, device=card)
    on_cpu = tf.init_params(cfg, policy, seed=3, device="cpu")
    ops.reset_launches()
    got = serve(arch, batch=2, prompt_len=8, gen=5, policy_name="fp32", params=on_card,
                seed=3, device=card)
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers * 5
    want = serve(arch, batch=2, prompt_len=8, gen=5, policy_name="fp32", params=on_cpu,
                 seed=3, device="cpu")
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
