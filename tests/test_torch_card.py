"""The port's CUDA kernels on the card (``-m cuda``; they skip without
one). This file imports neither JAX nor the reference, so it runs on a
machine with the card and PyTorch alone:

    python -m pytest -q -p no:cacheprovider --noconftest -m cuda tests/test_torch_card.py

(``--noconftest``: ``tests/conftest.py`` resets the reference's flags and
imports JAX.) ``chip_smoke.py`` holds every kernel at the main paths'
shapes; these cases are the attention kernel's (B7) against its plain
version at rtol = atol = 1e-5 (its split-K decode path at several split
counts and cache lengths, its split-TF32 prefill path on f32, fp16 and
bf16 K/V), the serving path on the card against the CPU port, and the
Synfire kernels at shapes beside the main paths': ``syn_matmul`` (B3)
through ``ops.syn_matmul`` and the per-run ``ops.MatmulRun``,
``syn_gather`` (B2) through ``ops.syn_gather`` on long spike rows and
bad indices and through the per-run ``ops.GatherRun`` on every compiled
Synfire table (x100 included), ``fused_tick`` (B4) on random nets of
1 to 5,000 neurons, on one CTA and on many, and on a CSR index of -1, and
the per-run launchers of B1 (``ops.NeuronRun``), B5
(``ops.StdpGatherRun``) and B6 (``ops.StdpUpdateRun``) in whole runs
against the per-op and per-call paths, and B6 on a NaN weight; and the
conductance-based (COBA) nets: B1's COBA mode against the per-op COBA
phase, COBA runs (packed, sparse, loop) on the card against the CPU port,
B2 over a two-channel plan on random weights, and ``run``'s
``gen_chunk``, ``gen_base`` and ``active`` on the card against the CPU
port; and lanes: B1-B3 over lanes against their plain versions and the
one-lane launchers, B4 (``FusedTickRun``), B5 (``StdpGatherRun``), B6
(``StdpUpdateRun``) and the plastic drive (``DriveRun``, bit for bit
against ``ref.drive_run_ref`` at fan-ins up to 33,000) over lanes the
same way, ``NeuronRun``'s per-lane spike counts, and static, plastic
(with homeostasis) and fused ``run_batch`` lanes against solo card
runs; and the in-run monitor and watch slots of B1 and B4 against their
plain versions (NaN, inf, silent and fp16-overflow lanes for the watches),
and watched runs on the card against the CPU port; and partitioning: every
core's launchers of a two-core plastic cut (the 50-post core among them)
against their plain versions, and partitioned runs (both lowerings)
against the unpartitioned card run."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, reduce_arch  # noqa: E402
from repro_torch.kernels import fused_tick as ftk  # noqa: E402
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
    inputs, rows with no allowed key included (the reference's mean of v
    there)."""
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
        mean = v.float().sum(dim=1) / sk  # [b, hkv, d]; Sk <= 1024: no pad
        want_empty = mean.repeat_interleave(hq // hkv, dim=1)[:, None].to(card)
        torch.testing.assert_close(got[:, :-shift], want_empty.expand(b, -shift, hq, d),
                                   rtol=1e-5, atol=1e-5)


def _attn_args(card, seed, b, sq, sk, hq, hkv, d, kvdt, invalid=0, shift=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, sq, hq, d), generator=g)
    k = torch.randn((b, sk, hkv, d), generator=g).to(kvdt)
    v = torch.randn((b, sk, hkv, d), generator=g).to(kvdt)
    kpos = torch.arange(sk, dtype=torch.int32)
    if invalid:
        kpos[-invalid:] = -1
    qpos = (torch.arange(sq, dtype=torch.int32) + (sk - invalid - sq + shift)).expand(b, sq)
    return [x.contiguous().to(card) for x in (q, k, v, qpos, kpos)]


# (b, sq, sk, hq, hkv, d, window, kv dtype, invalid slots, query shift)
DECODE = {
    "serve-544-g3": (4, 1, 544, 15, 5, 64, -1, torch.float16, 32, 0),
    "4096-g4-bf16": (2, 1, 4096, 8, 2, 64, -1, torch.bfloat16, 100, 0),
    "32768-g3": (1, 1, 32768, 15, 5, 64, -1, torch.float16, 0, 0),
    "window-g4-f32": (2, 2, 700, 8, 2, 128, 200, torch.float32, 0, 0),
    "empty-rows-1100": (2, 3, 1100, 8, 2, 64, -1, torch.float16, 0, -1200),
    "d36-scalar-copies": (3, 1, 77, 6, 2, 36, -1, torch.float16, 5, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 1, 3, 8], ids=["plan", "s1", "s3", "s8"])
@pytest.mark.parametrize("case", DECODE.values(), ids=DECODE.keys())
def test_flash_decode_split_k_matches_plain(card, case, splits):
    """The split-K decode path (chosen by ``flash_attn.plan`` or forced to
    a split count) against the plain version at rtol = atol = 1e-5, twice
    in a row (the tickets reset), one launch per call; rows with no
    allowed key (the last case, Sk 1,100: pad 948) included."""
    from repro_torch.kernels import flash_attn as fa

    b, sq, sk, hq, hkv, d, window, kvdt, invalid, shift = case
    args = _attn_args(card, sk + d, b, sq, sk, hq, hkv, d, kvdt, invalid, shift)
    n_sm = torch.cuda.get_device_properties(card).multi_processor_count
    assert fa.plan(b, sq, sk, hq, hkv, d, n_sm)[0] > 0
    want = ref.chunked_attention_ref(*args, causal=True, window=window)
    for _ in range(2):
        out = torch.empty_like(args[0])
        fa.launch(*args, out, causal=True, window=window, splits=splits)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    ops.reset_launches()
    ops.attention(*args, causal=True, window=window)
    assert ops.LAUNCHES["flash_attention"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kvdt", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["f32", "fp16", "bf16"])
@pytest.mark.parametrize("d", [16, 36, 64, 128, 256])
def test_flash_prefill_split_tf32_matches_plain(card, kvdt, d):
    """The tensor-core prefill path (split TF32: three MMAs a product on
    f32 K/V, two on fp16/bf16) holds rtol = atol = 1e-5 against the plain
    f32 version, causal and windowed, with ragged query and key tiles."""
    from repro_torch.kernels import flash_attn as fa

    args = _attn_args(card, d, 2, 200, 200, 6, 2, d, kvdt)
    assert fa.plan(2, 200, 200, 6, 2, d, 132) == (0, 0)
    for window in (-1, 48):
        got = ops.attention(*args, causal=True, window=window)
        want = ref.chunked_attention_ref(*args, causal=True, window=window)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


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


# -- Synfire kernels -------------------------------------------------------------

TABLE = torch.tensor([0.0, 1.0, 3.5, -2.0])  # Synfire4's weights: exact sums
MATMUL_SHAPES = [(1, 200, 250), (1, 50, 200), (1, 1, 1), (1, 4096, 4096), (64, 200, 250)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MATMUL_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("wdtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["f32", "fp16", "bf16"])
def test_syn_matmul_kernel_matches_plain(card, shape, wdtype):
    """Bit for bit on 0/1 spikes times Synfire's weights, through
    ``ops.syn_matmul`` and (M = 1) ``ops.MatmulRun``; random normal operands
    within rtol 1e-5 and an atol of 2e-6 per K (f32 sums in another
    order); a zero row times an infinite weight is NaN, as in the plain
    version."""
    m, k, n = shape
    g = torch.Generator().manual_seed(k + n)
    x = (torch.rand((m, k), generator=g) < 0.3).float().to(card)
    w = TABLE[torch.randint(0, 4, (k, n), generator=g)].to(wdtype).to(card)
    ops.reset_launches()
    got = ops.syn_matmul(x, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["syn_matmul"] == 1
    want = ref.syn_matmul_ref(x, w)
    assert torch.equal(got, want)
    if m == 1:
        run = ops.MatmulRun([None, w])
        got = run(1, x[0])
        torch.cuda.synchronize()
        assert ops.LAUNCHES["syn_matmul"] == 2
        assert torch.equal(got, want[0])
    xr = torch.randn((m, k), generator=g).to(card)
    wr = torch.randn((k, n), generator=g).to(wdtype).to(card)
    torch.testing.assert_close(ops.syn_matmul(xr, wr), ref.syn_matmul_ref(xr, wr),
                               rtol=1e-5, atol=2e-6 * k)
    w_inf = w.clone()
    w_inf[0, n - 1] = math.inf
    zero = torch.zeros_like(x)
    got = ops.syn_matmul(zero, w_inf)
    assert bool(got[:, n - 1].isnan().all())
    torch.testing.assert_close(got, ref.syn_matmul_ref(zero, w_inf), equal_nan=True,
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [20_000, 70_000], ids=["P20000-opt-in", "P70000-global"])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.float16], ids=["f32", "fp16"])
def test_syn_gather_long_rows(card, p, wdtype):
    """Long spike rows (Synfire4x100's longest pre group, and one beyond
    what shared memory could stage), read through the read-only path: bit
    for bit on 0/1 spikes and Synfire weights, int16 and int32 indices
    where they fit; an index in [-P, -1] counts from the row's end and any
    other index outside [0, P) gives NaN, as the plain version (the
    reference's ``jnp.take``)."""
    g = torch.Generator().manual_seed(p)
    q, f = 300, 97
    idx = torch.randint(0, p, (q, f), generator=g, dtype=torch.int32)
    w = TABLE[torch.randint(0, 4, (q, f), generator=g)].to(wdtype)
    spikes = (torch.rand(p, generator=g) < 0.3).float()
    idx_types = (torch.int16, torch.int32) if p < 2**15 else (torch.int32,)
    for idt in idx_types:
        args = [spikes.to(card), idx.to(idt).to(card), w.to(card)]
        got = ops.syn_gather(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.syn_gather_ref(*args)), idt
    bad = idx.clone()
    bad[1, 5], bad[2, 0], bad[3, 1] = p, -1, -p - 1
    got = ops.syn_gather(spikes.to(card), bad.to(card), w.to(card))
    want = ref.syn_gather_ref(spikes.to(card), bad.to(card), w.to(card))
    assert bool(got[1].isnan()) and bool(got[3].isnan()) and not bool(got[2].isnan())
    torch.testing.assert_close(got, want, equal_nan=True, rtol=0, atol=0)


def _synfire_gather(card, cfg, policy, seed, random_weights=False):
    """A compiled sparse Synfire net's GatherRun on the card, a random
    spike row, and the plain version's rows on the same tables."""
    from repro_torch.configs import synfire4 as syn
    from repro_torch.core import backend as be

    net = syn.build_synfire(cfg, policy=policy, propagation="sparse", budget=None,
                            monitor_ms_hint=0, device=card)
    weights = net.state0.weights
    if random_weights:
        g = torch.Generator().manual_seed(seed)
        weights = tuple(torch.randn(tuple(w.shape), generator=g).to(w.dtype).to(card)
                        if j in net.static.csr_projs else w for j, w in enumerate(weights))
    packed = be.assemble_packed(net.static, weights)
    run = be.assemble_gather(net.static, net.params, packed)
    g = torch.Generator().manual_seed(seed + 1)
    spikes = (torch.rand(net.static.n, generator=g) < 0.3).float().to(card)
    want = torch.empty_like(run.rows)
    plain = [(k, posts.to(card), idx.to(card), w) for k, posts, idx, w in run.plan.plain[0]]
    ref.gather_run_ref(spikes, want, plain, first=True)
    return run, spikes, want


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_name,policy", [("SYNFIRE4", "fp16"), ("SYNFIRE4", "fp32"),
                                             ("SYNFIRE4_X10", "fp16"), ("X100", "fp16")])
def test_gather_run_on_compiled_tables(card, cfg_name, policy):
    """``ops.GatherRun`` on every compiled Synfire table (13 buckets, one
    launch): bit for bit with its plain version on the compiled weights,
    staged and unstaged where the row fits shared memory, twice in a row
    (every entry rewritten); within rtol = atol = 1e-5 on random weights."""
    from repro_torch.configs import synfire4 as syn
    from repro_torch.kernels import syn_gather as gsyn

    cfg = syn.scale_synfire(syn.SYNFIRE4, 100) if cfg_name == "X100" else getattr(syn, cfg_name)
    run, spikes, want = _synfire_gather(card, cfg, policy, seed=len(cfg_name))
    assert len(run.starts) == 1 and len(run.plan.groups[0]) == 13
    ops.reset_launches()
    for _ in range(2):
        run(0, spikes)
        torch.cuda.synchronize()
        assert torch.equal(run.rows, want)
    assert ops.LAUNCHES["syn_gather"] == 2
    if run.plan.n * 4 <= 200_000:
        staged = gsyn.GatherLauncher(run.plan, card, staged=True)
        staged(0, spikes.data_ptr())
        torch.cuda.synchronize()
        assert torch.equal(staged.rows, want)
    if cfg_name != "X100":
        run, spikes, want = _synfire_gather(card, cfg, policy, seed=5, random_weights=True)
        run(0, spikes)
        torch.cuda.synchronize()
        torch.testing.assert_close(run.rows, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_gather_run_later_group_adds_in_place(card):
    """A plan whose second sparse bucket opens a second launch group:
    group 0 writes every entry, group 1 adds into the entries it covers
    after the dense drive, bit for bit with the plain version."""
    import numpy as np

    from repro_torch.kernels import syn_gather as gsyn

    r = np.random.default_rng(9)
    n = 300

    def sparse(posts, f):
        idx = torch.from_numpy(r.integers(0, n, (len(posts), f)).astype(np.int16))
        return gsyn.Bucket(4, np.asarray(posts), (np.arange(n), idx,
                                                  TABLE[torch.randint(0, 4, idx.shape)]))

    buckets = [sparse(np.arange(0, 100), 40), gsyn.Bucket(4, np.arange(50, 60)),
               sparse(np.arange(55, 120), 33)]
    runs = [ops.GatherRun(n, buckets, dev) for dev in (card, "cpu")]
    assert runs[0].starts == [0, 2]
    spikes = (torch.rand(n) < 0.3).float()
    drive = TABLE[torch.randint(0, 4, (10,))]
    for run, dev in zip(runs, (card, "cpu")):
        run.rows.fill_(7.0)  # group 0 overwrites every entry
        run(0, spikes.to(dev))
        run.rows[0, 50:60] += drive.to(dev)
        run(1, spikes.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(runs[0].rows.cpu(), runs[1].rows)


def _fused_case(n, dtype, exact, seed, device):
    """A random fused-tick case of ``n`` neurons: state, ring (6 slots,
    delays 2 and 5), generator rows and a payload of 3 dense and 2 CSR
    buckets on random spans, two of them sharing a post span and a delay
    (plan order matters there). Exact weights are multiples of 1/8, so
    every sum is exact in f32."""
    r = np.random.default_rng(seed)
    ring_len, delays = 6, (2, 5)
    n_gen = max(1, n // 10)
    idx_n = np.arange(n)
    state = dict(
        v=r.uniform(-75.0, 25.0, n), u=r.uniform(-16.0, -8.0, n),
        ring=r.integers(-24, 40, (ring_len, n)) / 8.0)
    consts = dict(is_gen=idx_n < n_gen, a=np.where(idx_n % 3 == 0, 0.1, 0.02),
                  b=np.full(n, 0.2), c=np.full(n, -65.0),
                  d=np.where(idx_n % 3 == 0, 2.0, 8.0))

    def weights(shape):
        if exact:
            return torch.from_numpy(r.integers(-8, 9, shape) / 8.0).float().to(device)
        return torch.from_numpy(r.standard_normal(shape)).float().to(device)

    def span(cap):
        start = int(r.integers(0, n))
        return start, int(r.integers(1, min(n - start, cap) + 1))

    buckets = []
    for kind in ("dense", "dense", "csr", "dense", "csr"):
        ps, pn = span(300)
        if kind == "dense" and buckets and buckets[-1][0] == "dense":
            qs, qn, dly = buckets[-1][2], buckets[-1][4].shape[1], buckets[-1][3]
        else:
            (qs, qn), dly = span(n), delays[int(r.integers(0, 2))]
        if kind == "dense":
            buckets.append(("dense", ps, qs, dly, weights((pn, qn))))
            continue
        f = int(r.integers(1, 40))
        idx = ps + r.integers(0, pn, (qn, f))
        w = weights((qn, f))
        idx[::3, -1] = ps  # padding: index pre_start, weight +0.0
        w[::3, -1] = 0.0
        buckets.append(("csr", ps, pn, qs, dly, torch.from_numpy(idx).int().to(device), w))
    payload = ftk.pack_payload(delays, buckets, device)
    tensors = {k: torch.from_numpy(x).to(dtype).to(device) for k, x in state.items()}
    tensors.update({k: torch.from_numpy(x).float().to(device) for k, x in consts.items()
                    if k != "is_gen"})
    tensors["is_gen"] = torch.from_numpy(consts["is_gen"]).to(device)
    gen_rows = torch.from_numpy(r.random((12, n)) < 0.3).to(device)
    return payload, tensors, gen_rows


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 1025, 5000])
@pytest.mark.parametrize("grid", [1, None], ids=["one-cta", "by-work"])
@pytest.mark.parametrize("dtype,exact", [(torch.float16, True), (torch.float32, True),
                                         (torch.float32, False)],
                         ids=["fp16-exact", "fp32-exact", "fp32-normal"])
def test_fused_tick_kernel_matches_plain(card, n, grid, dtype, exact):
    """The fused tick against its plain version: twelve chained ticks bit
    for bit with exact weights; one tick with random normal weights, v',
    u', spikes and i_syn bit for bit and the ring at rtol 1e-5, atol 1e-4
    (f32 sums in another order; fp16 rings only with exact weights, where
    one f32 ulp could move a rounded fp16 drive by a whole fp16 ulp). The
    grid is one CTA, or chosen by the work (one CTA per 256 neurons or 16
    CSR rows)."""
    payload, x, gen_rows = _fused_case(n, dtype, exact, seed=n, device=card)
    v, u, ring = x["v"].clone(), x["u"].clone(), x["ring"].clone()
    rows = gen_rows.clone()
    i_rows = torch.empty(rows.shape, dtype=torch.float32, device=card)
    consts = [x[k] for k in ("is_gen", "a", "b", "c", "d")]
    runner = ops.FusedTickRun(payload, v, u, ring, *consts, rows, i_rows=i_rows,
                              grid=grid)
    csr_rows = sum(w.shape[0] for *_, w in payload.csr)
    assert runner.launcher.grid == (1 if grid == 1 else min(
        max(-(-n // ftk.THREADS), -(-csr_rows // ftk.CSR_ROWS_PER_CTA)),
        runner.launcher.resident))
    state = (x["v"], x["u"], x["ring"])
    spiked = 0
    for t in range(12 if exact else 1):
        ops.reset_launches()
        runner.tick(t, t)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["fused_tick"] == 1
        want = ref.fused_tick_ref(*state, gen_rows[t], *consts, t, dense=payload.dense,
                                  csr=payload.csr, ring_len=ring.shape[0])
        got = (v, u, rows[t], ring, i_rows[t])
        for name, g_, w_ in zip(("v", "u", "spikes", "ring", "i_syn"), got, want):
            assert g_.dtype == w_.dtype, name
            if name == "ring" and not exact:
                torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-4)
            else:
                assert torch.equal(g_, w_), f"tick {t}: {name}"
        spiked += int(rows[t][~consts[0]].sum())
        state = (want[0], want[1], want[3])
    if exact and n > 1:
        assert spiked > 0


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [1, None], ids=["one-cta", "by-work"])
def test_fused_tick_corrupt_index_is_nan(card, grid):
    """A CSR index outside [0, N) makes its post neuron's drive NaN in the
    ring (as in the plain version); every other ring entry, v and the
    spikes equal the plain version on the intact table."""
    payload, x, gen_rows = _fused_case(1025, torch.float32, True, seed=7, device=card)
    qs, dly, idx, w = payload.csr[0]
    bad_idx = idx.clone()
    bad_idx[0, 0] = 1025
    buckets = []
    dense, csr = list(payload.dense), list(payload.csr)
    for kind in payload.desc[:, 0].tolist():
        if kind == 0:
            buckets.append(("dense", *dense.pop(0)))
        else:
            c_qs, c_dly, c_idx, c_w = csr.pop(0)
            row = payload.desc[len(buckets)].tolist()
            buckets.append(("csr", row[1], row[3], c_qs, c_dly,
                            bad_idx if c_idx is idx else c_idx, c_w))
    bad = ftk.pack_payload(payload.delays, buckets, card)
    consts = [x[k] for k in ("is_gen", "a", "b", "c", "d")]
    v, u, ring = x["v"].clone(), x["u"].clone(), x["ring"].clone()
    rows = gen_rows[:1].clone()
    ops.FusedTickRun(bad, v, u, ring, *consts, rows, grid=grid).tick(0, 0)
    torch.cuda.synchronize()
    want = ref.fused_tick_ref(x["v"], x["u"], x["ring"], gen_rows[0], *consts, 0,
                              dense=payload.dense, csr=payload.csr, ring_len=ring.shape[0])
    slot = dly % ring.shape[0]
    assert bool(ring[slot, qs].isnan())
    ok = torch.ones_like(ring, dtype=torch.bool)
    ok[slot, qs] = False
    assert torch.equal(ring[ok], want[3][ok])
    assert torch.equal(v, want[0]) and torch.equal(rows[0], want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [1, None], ids=["one-cta", "by-work"])
def test_fused_tick_negative_index_wraps(card, grid):
    """A CSR index of -1 reads the spike row's last entry, as the plain
    version (the reference's ``jnp.take``) reads it: every output bit for
    bit."""
    payload, x, gen_rows = _fused_case(1025, torch.float32, True, seed=9, device=card)
    dense, csr, buckets = list(payload.dense), list(payload.csr), []
    for row in payload.desc.tolist():
        if row[0] == 0:
            buckets.append(("dense", *dense.pop(0)))
            continue
        c_qs, c_dly, c_idx, c_w = csr.pop(0)
        if len(payload.csr) - len(csr) == 1:
            c_idx = c_idx.clone()
            c_idx[0, 0] = -1
        buckets.append(("csr", row[1], row[3], c_qs, c_dly, c_idx, c_w))
    wrapped = ftk.pack_payload(payload.delays, buckets, card)
    consts = [x[k] for k in ("is_gen", "a", "b", "c", "d")]
    v, u, ring = x["v"].clone(), x["u"].clone(), x["ring"].clone()
    rows = gen_rows[:1].clone()
    ops.FusedTickRun(wrapped, v, u, ring, *consts, rows, grid=grid).tick(0, 0)
    want = ref.fused_tick_ref(x["v"], x["u"], x["ring"], gen_rows[0], *consts, 0,
                              dense=wrapped.dense, csr=wrapped.csr, ring_len=ring.shape[0])
    torch.cuda.synchronize()
    assert not ring.isnan().any()
    for name, g_, w_ in zip(("v", "u", "spikes", "ring"), (v, u, rows[0], ring), want):
        assert torch.equal(g_, w_), name


def _neuron_net(policy, device):
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire

    return build_synfire(SYNFIRE4, policy=policy, propagation="sparse", device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["fp16", "fp32"])
def test_neuron_run_matches_per_op_phase(card, policy):
    """``run`` through the neuron-phase launcher (one ``izh4_update``
    launch per tick) against the per-op phase on the card: the same
    raster, v and i_syn records and final state, bit for bit, with an
    external current; one launch per tick."""
    from repro_torch.core import backend as be
    from repro_torch.core.engine import run

    net = _neuron_net(policy, card)
    g = torch.Generator(device="cpu").manual_seed(4)
    gu = torch.rand((200, net.static.n_gen), generator=g).to(card)
    cur = (torch.rand((200, net.static.n), generator=g) * 4).to(card)
    kw = dict(gen_u=gu, i_ext=cur, record_v=True, record_i=True)
    ops.reset_launches()
    final, out = run(net.static, net.params, net.state0, 200, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["izh4_update"] == 200
    built = be.assemble_neurons
    be.assemble_neurons = lambda *a, **k: None
    try:
        final_po, out_po = run(net.static, net.params, net.state0, 200, **kw)
    finally:
        be.assemble_neurons = built
    for name in ("spikes", "v", "i_syn"):
        assert torch.equal(out[name], out_po[name]), name
    for a, b in ((final.ring, final_po.ring), *zip(final.neurons, final_po.neurons)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["fp16", "fp32"])
def test_stdp_gather_run_matches_per_call_path(card, policy):
    """Plastic Synfire4 sparse through the CSR STDP launcher (one
    ``stdp_gather`` launch per tick for the four chain projections) against
    the per-call path on the card: raster, weights and traces bit for
    bit."""
    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, build_synfire
    from repro_torch.core import backend as be
    from repro_torch.core.engine import run

    net = build_synfire(SYNFIRE4, policy=policy, propagation="sparse",
                        stdp_chain=CHAIN_STDP, device=card)
    gu = torch.rand((200, net.static.n_gen),
                    generator=torch.Generator(device="cpu").manual_seed(6)).to(card)
    ops.reset_launches()
    final, out = run(net.static, net.params, net.state0, 200, gen_u=gu)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["stdp_gather"] == 200
    built = be.assemble_stdp_gather
    be.assemble_stdp_gather = lambda *a, **k: None
    try:
        final_pc, out_pc = run(net.static, net.params, net.state0, 200, gen_u=gu)
    finally:
        be.assemble_stdp_gather = built
    assert torch.equal(out["spikes"], out_pc["spikes"])
    for j, cfg in enumerate(net.static.stdp):
        if cfg is not None:
            assert torch.equal(final.weights[j], final_pc.weights[j])
            for a, b in zip(final.stdp[j], final_pc.stdp[j]):
                assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["fp16", "fp32"])
@pytest.mark.parametrize("homeo", [False, True])
def test_stdp_update_run_matches_per_call_path(card, policy, homeo):
    """Plastic Synfire4 packed through the dense STDP launcher (one
    ``stdp_update`` launch per tick for the four chain projections, the
    fan-in drive on its zero-ended weight buffers) against the per-call
    path on the card, with homeostasis every 100 ticks where asked:
    raster, weights, traces, v, u and ring bit for bit."""
    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, build_synfire
    from repro_torch.core import backend as be
    from repro_torch.core.engine import run
    from repro_torch.core.plasticity import HomeostasisConfig

    kw = dict(homeo_chain=HomeostasisConfig(target_hz=10.0, tau_avg_ms=1000.0, beta=2.0),
              homeostasis_period=100) if homeo else {}
    net = build_synfire(SYNFIRE4, policy=policy, propagation="packed",
                        stdp_chain=CHAIN_STDP, device=card, **kw)
    gu = torch.rand((200, net.static.n_gen),
                    generator=torch.Generator(device="cpu").manual_seed(7)).to(card)
    ops.reset_launches()
    final, out = run(net.static, net.params, net.state0, 200, gen_u=gu)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["stdp_update"] == 200
    built = be.assemble_stdp_update
    be.assemble_stdp_update = lambda *a, **k: None
    try:
        ops.reset_launches()
        final_pc, out_pc = run(net.static, net.params, net.state0, 200, gen_u=gu)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["stdp_update"] == 4 * 200
    finally:
        be.assemble_stdp_update = built
    assert torch.equal(out["spikes"], out_pc["spikes"])
    for j, cfg in enumerate(net.static.stdp):
        if cfg is not None:
            assert torch.equal(final.weights[j], final_pc.weights[j])
            for a, b in zip(final.stdp[j], final_pc.stdp[j]):
                assert torch.equal(a, b)
    for a, b in ((final.ring, final_pc.ring), *zip(final.neurons, final_pc.neurons)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_stdp_update_nan_weight_follows_plain(card, dtype):
    """A NaN weight stays NaN in a masked-in cell and becomes +0.0 in a
    masked-out one, through ``ops.stdp_update`` and ``ops.StdpUpdateRun``
    on the card, as in the plain version (``torch.clamp``) and the
    reference (``jnp.clip``); every other cell equals the plain version."""
    from repro_torch.kernels.stdp_update import DenseProjection

    g = torch.Generator(device="cpu").manual_seed(8)
    w = (torch.rand((37, 113), generator=g) * 4).to(dtype)
    mask = torch.rand((37, 113), generator=g) < 0.5
    w[3, 5] = w[20, 100] = float("nan")
    mask[3, 5], mask[20, 100] = True, False
    pre, post = torch.rand(37, generator=g) * 3, torch.rand(113, generator=g) * 3
    spikes = (torch.rand(150, generator=g) < 0.5).float()
    kw = dict(a_plus=0.004, a_minus=0.0033, w_min=0.0, w_max=4.0)
    args = [w, mask, pre, post, spikes[:37], spikes[37:]]
    want = ref.stdp_update_ref(*args, **kw)
    got = ops.stdp_update(*(x.to(card) for x in args), **kw).cpu()

    def proj(device):
        return DenseProjection(
            w=w.clone().to(device), mask=mask.to(device),
            pre_tr=(pre.to(device), torch.empty(37, device=device)),
            post_tr=(post.to(device), torch.empty(113, device=device)), pre_start=0,
            post_start=37, **kw, decay_pre=1.0, decay_post=1.0)

    card_p, cpu_p = proj(card), proj("cpu")
    ops.StdpUpdateRun(150, [card_p])(spikes.to(card))
    ops.StdpUpdateRun(150, [cpu_p])(spikes)
    for out, plain in ((got, want), (card_p.w.cpu(), cpu_p.w)):
        for x in (out, plain):
            assert bool(x[3, 5].isnan()) and int(x.isnan().sum()) == 1
            assert x[20, 100].item() == 0.0 and not torch.signbit(x[20, 100])
        ok = ~plain.isnan()
        assert torch.equal(out[ok], plain[ok])


@pytest.mark.cuda
def test_fused_tick_rejects_grid_beyond_resident(card):
    payload, x, gen_rows = _fused_case(64, torch.float32, True, seed=1, device=card)
    consts = [x[k] for k in ("is_gen", "a", "b", "c", "d")]
    with pytest.raises(ValueError, match="resident"):
        ops.FusedTickRun(payload, x["v"], x["u"], x["ring"], *consts, gen_rows,
                         grid=10**6)


def _coba_net(cfg_name, policy, propagation, device, **kw):
    """Synfire's Table II network compiled with ``conductances=COBAConfig()``."""
    from repro_torch.configs import synfire4 as tsyn
    from repro_torch.core import COBAConfig

    return tsyn._synfire_builder(getattr(tsyn, cfg_name)).compile(
        policy=policy, propagation=propagation, conductances=COBAConfig(), device=device,
        **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["fp16", "fp32"])
def test_coba_neuron_run_matches_per_op_phase(card, policy):
    """A COBA run through the neuron-phase launcher (the conductances in the
    one ``izh4_update`` launch per tick) against the per-op COBA phase on
    the card, with an external current: raster, v and i_syn records and
    final state, conductances included, bit for bit."""
    from repro_torch.core import backend as be
    from repro_torch.core.engine import run

    net = _coba_net("SYNFIRE4", policy, "sparse", card)
    g = torch.Generator(device="cpu").manual_seed(5)
    cur = (torch.rand((200, net.static.n), generator=g) * 4).to(card)
    kw = dict(i_ext=cur, record_v=True, record_i=True)
    ops.reset_launches()
    final, out = run(net.static, net.params, net.state0, 200, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["izh4_update"] == 200 and ops.LAUNCHES["syn_gather"] == 200
    built = be.assemble_neurons
    be.assemble_neurons = lambda *a, **k: None
    try:
        final_po, out_po = run(net.static, net.params, net.state0, 200, **kw)
    finally:
        be.assemble_neurons = built
    for name in ("spikes", "v", "i_syn"):
        assert torch.equal(out[name], out_po[name]), name
    for a, b in ((final.ring, final_po.ring), *zip(final.neurons, final_po.neurons),
                 *zip(final.cond, final_po.cond)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("propagation", ["packed", "sparse", "loop"])
def test_coba_card_equals_cpu(card, propagation):
    """COBA Synfire4-mini fp16 for 300 ticks on the card and on the CPU
    port: raster and final state (v, u, ring, conductances) bit for bit."""
    from repro_torch.core.engine import run

    finals = {}
    for dev in (card, torch.device("cpu")):
        net = _coba_net("SYNFIRE4_MINI", "fp16", propagation, dev)
        final, out = run(net.static, net.params, net.state0, 300)
        finals[dev.type] = (final, out["spikes"].cpu())
    (c, cs), (h, hs) = finals["cuda"], finals["cpu"]
    assert int(hs.sum()) > 1000 and torch.equal(cs, hs)
    for a, b in ((c.ring, h.ring), *zip(c.neurons, h.neurons), *zip(c.cond, h.cond)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.float16])
def test_gather_run_two_channels_random_weights(card, wdtype):
    """``ops.GatherRun`` over a two-channel (COBA) plan on random normal
    weights: within rtol = atol = 1e-5 of its plain version (the row sums'
    order only), every entry a sum of absolute bucket drives."""
    import numpy as np

    from repro_torch.kernels import syn_gather as gsyn

    g = torch.Generator(device="cpu").manual_seed(6)
    n, f = 2000, 33

    def table(q):
        idx = torch.randint(0, 500, (q, f), generator=g, dtype=torch.int16).to(card)
        return (np.arange(1000, 1500), idx, torch.randn((q, f), generator=g).to(wdtype).to(card))

    buckets = [gsyn.Bucket(4, np.arange(0, 600), table(600), 0),
               gsyn.Bucket(4, np.arange(0, 600), table(600), 1),
               gsyn.Bucket(4, np.arange(300, 900), table(600), 0),
               gsyn.Bucket(7, np.arange(1500, 2000), table(500), 1)]
    run = ops.GatherRun(n, buckets, card, channels=2)
    plain = [(k, posts.to(card), idx.to(card), w) for k, posts, idx, w in run.plan.plain[0]]
    spikes = (torch.rand(n, generator=g) < 0.4).float().to(card)
    ops.reset_launches()
    run(0, spikes)
    want = torch.empty_like(run.rows)
    ref.gather_run_ref(spikes, want, plain, first=True, absolute=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["syn_gather"] == 1
    assert bool((run.rows >= 0).all())
    torch.testing.assert_close(run.rows, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_serving_arguments_card_equal_cpu(card):
    """``gen_chunk`` (the launcher's generator rows swapped chunk by chunk),
    ``gen_base`` (call-split invariant) and ``active`` on Synfire4-mini
    fp16 sparse: card rasters and final states equal the CPU port's."""
    from repro_torch.configs.synfire4 import SYNFIRE4_MINI, build_synfire
    from repro_torch.core import rng
    from repro_torch.core.engine import run

    def both(**kw):
        out = {}
        for dev in (card, torch.device("cpu")):
            net = build_synfire(SYNFIRE4_MINI, policy="fp16", propagation="sparse",
                                device=dev)
            args = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
            final, o = run(net.static, net.params, net.state0, 300, **args)
            out[dev.type] = (final, o["spikes"].cpu())
        (c, cs), (h, hs) = out["cuda"], out["cpu"]
        assert torch.equal(cs, hs)
        for a, b in ((c.ring, h.ring), (c.key, h.key), *zip(c.neurons, h.neurons)):
            assert torch.equal(a.cpu(), b)
        return c, cs

    _, chunked = both(gen_chunk=50)
    assert int(chunked.sum()) > 100
    whole, sp = both(gen_base=rng.key(9))
    net = build_synfire(SYNFIRE4_MINI, policy="fp16", propagation="sparse", device=card)
    state, parts = net.state0, []
    for _ in range(3):
        state, o = run(net.static, net.params, state, 100, gen_base=rng.key(9, card))
        parts.append(o["spikes"].cpu())
    assert torch.equal(torch.cat(parts), sp) and torch.equal(state.neurons.v, whole.neurons.v)
    _, idle = both(active=torch.tensor(False))
    assert int(idle.sum()) == 0


def _lane_states(net, lanes, seed, device):
    """``lanes`` lanes of ``net``'s state, each a few random ticks in: v, u
    and the ring from 0-40 ticks of the net's own run on random uniforms,
    so the lanes differ."""
    from repro_torch.core.engine import run
    from repro_torch.core.lanes import stack_states

    g = torch.Generator().manual_seed(seed)
    states = []
    for b in range(lanes):
        ticks = int(torch.randint(1, 41, (1,), generator=g))
        gu = torch.rand((ticks, net.static.n_gen), generator=g).to(device)
        states.append(run(net.static, net.params, net.state0, ticks, gen_u=gu)[0])
    return stack_states(states)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["fp16", "fp32"])
@pytest.mark.parametrize("coba", [False, True], ids=["cuba", "coba"])
def test_neuron_run_lanes_matches_plain_and_one_lane(card, policy, coba):
    """B1 over 16 lanes at their own ticks (spread over the ring) for 12
    chained ticks: bit for bit the plain lane version on the card and the
    one-lane launcher on each lane; one launch per tick."""
    from repro_torch.configs.synfire4 import SYNFIRE4, _synfire_builder, build_synfire
    from repro_torch.core import COBAConfig, NeuronModel
    from repro_torch.core import backend as be
    from repro_torch.core.lanes import lane_state

    net = (_synfire_builder(SYNFIRE4).compile(conductances=COBAConfig(), policy=policy,
                                                propagation="sparse", device=card)
           if coba else build_synfire(SYNFIRE4, policy=policy, propagation="sparse",
                                      device=card))
    lanes = 16
    st = _lane_states(net, lanes, 5, card)
    g = torch.Generator().manual_seed(6)
    ring = (torch.rand(st.ring.shape, generator=g) * 8).to(st.ring.dtype).to(card)
    ring0 = ring.clone()
    gen = torch.rand((lanes, 12, net.static.n_gen), generator=g).lt(0.3).to(card)
    raster = torch.zeros((lanes, 12, net.static.n), dtype=torch.bool, device=card)
    vs = torch.zeros((lanes, 12, net.static.n), device=card)
    args = dict(cond=st.cond, gen_spk=gen, raster=raster, v_rows=vs, t0=st.t)
    ops.reset_launches()
    kernel = be.assemble_neurons(net.static, net.params, st.neurons, ring, **args)
    p = net.params.neuron
    is_gen = p.model == NeuronModel.GENERATOR
    cols = torch.full((net.static.n,), -1, dtype=torch.int64, device=card)
    cols[is_gen] = torch.arange(int(is_gen.sum()), device=card)
    pv, pu, pr = (x.clone() for x in st.neurons)
    pc = None if st.cond is None else tuple(x.clone() for x in st.cond)
    p_ring, p_raster, p_vs = ring.clone(), raster.clone(), vs.clone()
    p_spikes = torch.zeros((lanes, net.static.n), device=card)
    coeffs = be.coba_coeffs(net.static) if coba else None
    for i in range(12):
        kernel(i)
        ref.neuron_lanes_ref(pv, pu, pr, p_ring, [(t + i) % net.static.ring_len for t in st.t],
                             is_gen, p.a, p.b, p.c, p.d, cols, p_spikes, gen_rows=gen[:, i],
                             raster_rows=p_raster[:, i], v_rows=p_vs[:, i], cond=pc,
                             coba=coeffs, dt=net.static.dt, substeps=net.static.substeps)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["izh4_update"] == 12
    for a, b in ((kernel.v, pv), (kernel.u, pu), (kernel.refrac, pr), (ring, p_ring),
                 (raster, p_raster), (vs, p_vs), (kernel.spikes, p_spikes),
                 *zip(kernel.cond or (), pc or ())):
        assert torch.equal(a, b)
    for b in range(0, lanes, 5):
        one = lane_state(st, b)
        ring_b = ring0[b].clone()
        solo_raster = torch.zeros((12, net.static.n), dtype=torch.bool, device=card)
        solo = be.assemble_neurons(net.static, net.params, one.neurons, ring_b,
                                   cond=one.cond, gen_spk=gen[b].contiguous(),
                                   raster=solo_raster)
        for i in range(12):
            solo(i, st.t[b] + i)
        for x, y in ((solo.v, kernel.v[b]), (solo.u, kernel.u[b]), (ring_b, ring[b]),
                     (solo_raster, raster[b]),
                     *zip(solo.cond or (), (c[b] for c in kernel.cond or ()))):
            assert torch.equal(x, y), b


@pytest.mark.cuda
@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "per-lane"])
def test_gather_run_lanes_matches_one_lane(card, per_lane):
    """B2 over 16 lanes on Synfire4's compiled tables with random f32
    weights, shared or one table per lane: each lane bit for bit the
    one-lane launcher on its spike row and weights; one launch."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core import backend as be

    net = build_synfire(SYNFIRE4, policy="fp16", propagation="sparse", device=card)
    lanes = 16
    g = torch.Generator().manual_seed(8)
    lead = (lanes,) if per_lane else ()
    packed = tuple(torch.randn((*lead, *w.shape), generator=g).to(card)
                   for w in be.assemble_packed(net.static, net.state0.weights))
    spikes = (torch.rand((lanes, net.static.n), generator=g) < 0.2).float().to(card)
    run = be.assemble_gather(net.static, net.params, packed, lanes)
    ops.reset_launches()
    run(0, spikes)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["syn_gather"] == 1
    for b in range(lanes):
        one = be.assemble_gather(net.static, net.params,
                                 tuple(w[b] for w in packed) if per_lane else packed)
        one(0, spikes[b].contiguous())
        assert torch.equal(one.rows, run.rows[b]), b


LANE_MATMUL_SHAPES = [(200, 250), (50, 200), (1500, 96), (4096, 512), (7, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LANE_MATMUL_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "per-lane"])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.float16], ids=["f32", "fp16"])
def test_matmul_run_lanes_matches_one_lane(card, shape, per_lane, wdtype):
    """B3 over 37 lanes (rows a strided view of wider spike rows) on random
    normal weights, shared or one image per lane, K below and above the
    cluster split: each lane bit for bit the one-lane GEMV; on Synfire's
    table bit for bit the plain lane version; one launch."""
    k, n = shape
    lanes = 37
    g = torch.Generator().manual_seed(k * n)
    lead = (lanes,) if per_lane else ()
    w = torch.randn((*lead, k, n), generator=g).to(wdtype).to(card)
    rows = torch.randn((lanes, k + 9), generator=g).to(card)
    x = rows[:, 4:4 + k]
    run = ops.MatmulRun([w], lanes)
    ops.reset_launches()
    got = run(0, x).clone()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["syn_matmul"] == 1
    for b in range(lanes):
        one = ops.MatmulRun([w[b] if per_lane else w])
        assert torch.equal(one(0, x[b].contiguous()), got[b]), b
    wt = TABLE[torch.randint(0, 4, (*lead, k, n), generator=g)].to(wdtype).to(card)
    xs = (torch.rand((lanes, k), generator=g) < 0.3).float().to(card)
    assert torch.equal(ops.MatmulRun([wt], lanes)(0, xs), ref.syn_matmul_lanes_ref(xs, wt))


@pytest.mark.cuda
@pytest.mark.parametrize("propagation", ["sparse", "packed"])
def test_run_batch_lanes_equal_solo_runs(card, propagation):
    """``run_batch(200, 64)`` on Synfire4 fp16: one ``izh4_update`` per tick
    for all lanes and one ``syn_gather`` (sparse) or 8 ``syn_matmul``
    (packed) per tick; lanes 0, 21 and 63 equal solo card runs on
    ``split(key, 64)[b]`` in raster and state."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core import lane_state, rng, run, run_batch

    net = build_synfire(SYNFIRE4, policy="fp16", propagation=propagation, device=card,
                        budget=None)
    ops.reset_launches()
    final, out = run_batch(net.static, net.params, net.state0, 200, 64)
    torch.cuda.synchronize()
    want = {"izh4_update": 200, "syn_gather": 200 if propagation == "sparse" else 0,
            "syn_matmul": 0 if propagation == "sparse" else 1600}
    assert {k: ops.LAUNCHES[k] for k in want} == want
    keys = rng.split(net.state0.key, 64)
    for b in (0, 21, 63):
        solo, o = run(net.static, net.params, net.state0._replace(key=keys[b]), 200)
        assert torch.equal(o["spikes"], out["spikes"][b]), b
        lane = lane_state(final, b)
        for x, y in ((lane.ring, solo.ring), (lane.key, solo.key),
                     *zip(lane.neurons, solo.neurons)):
            assert torch.equal(x, y), b


@pytest.mark.cuda
@pytest.mark.parametrize("propagation", ["sparse", "packed"])
def test_scheduler_lane_with_weights_of_its_own(card, propagation):
    """A ``LaneScheduler`` on Synfire4-mini fp16 keeps its launchers across
    chunks: a tenant admitted after the first chunk with weights of its
    own (every weight x1.25) equals its solo card session, and so does the
    tenant admitted into the lane it freed, on the net's weights."""
    from repro_torch.configs.synfire4 import SYNFIRE4_MINI, build_synfire
    from repro_torch.core import lane_state
    from repro_torch.serve import LaneScheduler, Session

    net = build_synfire(SYNFIRE4_MINI, policy="fp16", propagation=propagation, device=card)

    def solo(seed, ticks, state=None):
        sess = Session.create(net, seed=seed, state=state)
        sess.run(ticks, record="none")
        return sess.state

    def same(a, b):
        for x, y in ((a.ring, b.ring), *zip(a.neurons, b.neurons), *zip(a.weights, b.weights)):
            assert torch.equal(x, y)
        assert a.t == b.t

    sched = LaneScheduler(net, capacity=4, record="none")
    sched.admit("a", seed=1)
    sched.step(30)
    own = net.state0._replace(weights=tuple((w.float() * 1.25).to(w.dtype)
                                            for w in net.state0.weights))
    lane = sched.admit("b", seed=2, state=own)
    sched.step(40)
    same(lane_state(sched.states, lane), solo(2, 40, own))
    sched.evict("b")
    assert sched.admit("c", seed=3) == lane
    sched.step(30)
    same(lane_state(sched.states, sched.lane_of("a")), solo(1, 100))
    same(lane_state(sched.states, lane), solo(3, 30))


# -- plastic, STP and fused lanes (B4, B5, B6 and the plastic drive over lanes) --------


def _plastic_mini(propagation, device, **kw):
    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4_MINI, build_synfire

    return build_synfire(SYNFIRE4_MINI, policy="fp16", propagation=propagation, device=device,
                         stdp_chain=CHAIN_STDP, **kw)


def _lane_spikes(g, lanes, n, device):
    """Random 0/1 f32 spike rows, a third of the lanes silent."""
    s = (torch.rand((lanes, n), generator=g) < 0.3).float()
    s[2::3] = 0.0
    return s.to(device)


def _lane_tables(net, g, lanes, device):
    """Each lane's own random off-grid plastic weights and traces."""
    weights = tuple(torch.where(net.params.masks[j].cpu(),
                                torch.rand((lanes, *w.shape), generator=g) * 4, 0.0
                                ).to(w.dtype).to(device)
                    if net.static.projections[j].plastic else w
                    for j, w in enumerate(net.state0.weights))
    stdp = tuple(None if s is None else type(s)(*(
        (torch.rand((lanes, *x.shape), generator=g) * 2).to(device) for x in s))
        for s in net.state0.stdp)
    return weights, stdp


def _one_lane(tree, b):
    """Lane ``b`` of a tuple of per-lane tensors (shared ones kept)."""
    return tuple(None if x is None else type(x)(*(y[b] for y in x)) if isinstance(x, tuple)
                 else x[b] if x.dim() == 3 else x for x in tree)


@pytest.mark.cuda
@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_stdp_lanes_match_plain_and_one_lane(card, propagation):
    """``StdpUpdateRun`` (packed) or ``StdpGatherRun`` (sparse) over 48 lanes
    of the plastic mini's chain on random off-grid weights and traces, a
    third of the lanes silent: bit for bit their plain lane versions after
    every tick, and every lane its one-lane launch; one launch a tick."""
    from repro_torch.core import backend as be

    net = _plastic_mini(propagation, card)
    g = torch.Generator().manual_seed(21)
    lanes = 48
    weights, stdp = _lane_tables(net, g, lanes, card)
    build = be.assemble_stdp_update if propagation == "packed" else be.assemble_stdp_gather
    runs = build(net.static, net.params, weights, stdp, lanes)
    plain = build(net.static, net.params, weights, stdp, lanes)  # its buffers, run plain
    plain_fn = (ref.stdp_update_lanes_ref if propagation == "packed"
                else ref.stdp_gather_lanes_ref)
    ones = [build(net.static, net.params, _one_lane(weights, b), _one_lane(stdp, b))
            for b in range(lanes)]
    assert runs.launcher is not None
    name = "stdp_update" if propagation == "packed" else "stdp_gather"
    ops.reset_launches()
    for t in range(6):
        spikes = _lane_spikes(g, lanes, net.static.n, card)
        runs(spikes)
        plain_fn(spikes, plain.projs, t % 2)
        for b, one in enumerate(ones):
            one(spikes[b].contiguous())
        torch.cuda.synchronize()
        for k in range(len(runs.keys)):
            assert torch.equal(runs.projs[k].w, plain.projs[k].w), k
            for x, y in zip(runs.traces(k), (plain.projs[k].pre_tr[(t + 1) % 2],
                                              plain.projs[k].post_tr[(t + 1) % 2])):
                assert torch.equal(x, y), k
    assert ops.LAUNCHES[name] == 6 + 6 * lanes
    for b, one in enumerate(ones):
        for k in range(len(runs.keys)):
            assert torch.equal(one.projs[k].w, runs.projs[k].w[b]), (b, k)
            for x, y in zip(one.traces(k), runs.traces(k)):
                assert torch.equal(x, y[b]), (b, k)


@pytest.mark.cuda
@pytest.mark.parametrize("net_name", ["packed", "sparse", "stp", "x10-sparse"])
def test_drive_kernel_matches_plain_bitwise(card, net_name):
    """``DriveRun`` over 16 lanes on random off-grid weights (and STP state)
    lands bit for bit what ``ref.drive_run_ref`` lands, on the card and on
    the CPU, and every lane its one-lane launch: the kernel sums each row
    in XLA CPU's order (the x10 chain's fan-in rows are wider than 32)."""
    from repro_torch.core import NetworkBuilder, backend as be, izh4
    from repro_torch.core.synapses import STPConfig
    from repro_torch.kernels.plastic_drive import DriveProjection

    if net_name == "stp":
        b_ = NetworkBuilder(seed=0)
        b_.add_spike_generator("g", 50, rate_hz=200.0)
        b_.add_group("n", izh4(20, a=0.02, b=0.2, c=-65.0, d=8.0))
        b_.connect("g", "n", fanin=20, weight=0.3, delay_ms=1,
                   stp=STPConfig(u0=0.45, tau_f=50.0, tau_d=750.0))
        net = b_.compile(policy="fp16", device=card)
    elif net_name == "x10-sparse":
        from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4_X10, build_synfire

        net = build_synfire(SYNFIRE4_X10, policy="fp16", propagation="sparse", device=card,
                            stdp_chain=CHAIN_STDP, monitor_ms_hint=0, budget=None)
    else:
        net = _plastic_mini(net_name, card)
    g = torch.Generator().manual_seed(22)
    lanes = 16
    fanin = be.assemble_fanin(net.static, net.params)
    keys = [j for j, s in enumerate(net.static.projections) if s.plastic or s.stp is not None]
    acc = torch.rand((lanes, net.static.n), generator=g).to(card)
    before = acc.clone()
    accs = {"plain": acc.clone(), "one": acc.clone(), "cpu": acc.cpu()}
    projs = {k: [] for k in ("card", "plain", "cpu")}
    ones = [[] for _ in range(lanes)]
    weights, stp = [], []
    for j in keys:
        spec, fr = net.static.projections[j], fanin[j]
        w0 = net.state0.weights[j]
        weights.append((torch.rand((lanes, *w0.shape), generator=g) * 3).to(w0.dtype).to(card))
        st = None
        if spec.stp is not None:
            u0 = net.state0.stp[j].u
            st = tuple(torch.rand((lanes, *u0.shape), generator=g).to(u0.dtype).to(card)
                       for _ in range(2))
        stp.append(st)
        kw = dict(w_dtype=w0.dtype, stp=spec.stp is not None, pre_start=spec.pre_start,
                  n_pre=spec.pre_size, stp_dtype=st[0].dtype if st else torch.float32,
                  sentinel=spec.pre_size * spec.post_size if fr.rows is not None else -1)
        cols = slice(spec.post_start, spec.post_start + spec.post_size)
        for name, out in (("card", acc), ("plain", accs["plain"]), ("cpu", accs["cpu"])):
            dev = out.device
            projs[name].append(DriveProjection(
                pre=fr.pre.to(dev), rows=None if fr.rows is None else fr.rows.to(dev),
                out=out[:, cols], **kw))
        for b in range(lanes):
            ones[b].append(DriveProjection(pre=fr.pre, rows=fr.rows,
                                           out=accs["one"][b, cols], **kw))
    spikes = _lane_spikes(g, lanes, net.static.n, card)
    run = ops.DriveRun(net.static.n, projs["card"], lanes=lanes)
    assert run.launcher is not None
    ops.reset_launches()
    run(spikes, weights, stp)
    ref.drive_run_ref(spikes, projs["plain"], weights, stp)
    ops.DriveRun(net.static.n, projs["cpu"], lanes=lanes)(
        spikes.cpu(), [w.cpu() for w in weights],
        [None if s is None else tuple(x.cpu() for x in s) for s in stp])
    for b in range(lanes):
        ops.DriveRun(net.static.n, ones[b])(
            spikes[b].contiguous(), [w[b] for w in weights],
            [None if s is None else (s[0][b], s[1][b]) for s in stp])
    torch.cuda.synchronize()
    assert ops.LAUNCHES["plastic_drive"] == 1 + lanes
    assert torch.equal(acc, accs["plain"]) and torch.equal(acc.cpu(), accs["cpu"])
    assert torch.equal(acc, accs["one"])
    assert not torch.equal(acc, before)


@pytest.mark.cuda
def test_neuron_run_lane_counts_match_one_lane(card):
    """``NeuronRun`` over 64 lanes at their own ticks counts every lane's
    spikes (``[B, N]``) as its one-lane launch counts them."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core import backend as be
    from repro_torch.core.lanes import lane_state

    net = build_synfire(SYNFIRE4, policy="fp16", propagation="sparse", device=card,
                        budget=None)
    st = _lane_states(net, 64, 23, card)
    g = torch.Generator().manual_seed(23)
    gen = (torch.rand((64, 20, net.static.n_gen), generator=g) < 0.3)
    gen[2::3] = False
    gen = gen.to(card)
    counts = torch.zeros((64, net.static.n), dtype=torch.int32, device=card)
    runs = be.assemble_neurons(net.static, net.params, st.neurons, st.ring.clone(),
                               gen_spk=gen, counts=counts, t0=st.t)
    for i in range(20):
        runs(i)
    for b in (0, 31, 63):
        one = lane_state(st, b)
        c1 = torch.zeros((net.static.n,), dtype=torch.int32, device=card)
        solo = be.assemble_neurons(net.static, net.params, one.neurons, one.ring,
                                   gen_spk=gen[b].contiguous(), counts=c1)
        for i in range(20):
            solo(i, st.t[b] + i)
        torch.cuda.synchronize()
        assert torch.equal(c1, counts[b]), b
    assert int(counts.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("per_lane", [False, True], ids=["shared", "per-lane"])
@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_fused_tick_lanes_match_plain_and_one_lane(card, propagation, per_lane):
    """``FusedTickRun`` over 64 lanes of Synfire4 fp16 at their own ring
    slots (random v, u, ring and generator rows, a third of the lanes
    silent; weights shared, or each lane's own Synfire-valued table, which
    keeps every sum exact): bit for bit its plain lane version and every
    lane its one-lane launch over 12 ticks, one launch a tick."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core import backend as be
    from repro_torch.core.neurons import NeuronModel
    from repro_torch.kernels.fused_tick import assemble_kernel

    net = build_synfire(SYNFIRE4, policy="fp16", propagation=propagation, device=card,
                        backend="fused", budget=None)
    g = torch.Generator().manual_seed(24)
    lanes, ticks, n = 64, 12, net.static.n
    packed = be.assemble_packed(net.static, net.state0.weights)
    if per_lane:  # each lane its table scaled by a power of two: sums stay exact
        scale = (2.0 ** torch.randint(-2, 3, (lanes,), generator=g)).to(card)
        packed = tuple(w[None] * scale.view(-1, *[1] * w.dim()) for w in packed)
    payload = assemble_kernel(net.static, net.params, packed)
    dtype = net.state0.neurons.v.dtype
    v = (torch.rand((lanes, n), generator=g) * 100 - 75).to(dtype).to(card)
    u = (torch.rand((lanes, n), generator=g) * 10 - 15).to(dtype).to(card)
    ring = (torch.rand((lanes, net.static.ring_len, n), generator=g) * 10).to(dtype).to(card)
    rows = torch.rand((lanes, ticks, n), generator=g) < 0.2
    rows[2::3] = False
    rows = rows.to(card)
    t0 = tuple(100 + 7 * b for b in range(lanes))
    p = net.params.neuron
    is_gen = p.model == NeuronModel.GENERATOR
    state = [x.clone() for x in (v, u, ring, rows)]
    plain = [x.clone() for x in (v, u, ring, rows)]
    runs = ops.FusedTickRun(payload, *state[:3], is_gen, p.a, p.b, p.c, p.d, state[3], t0=t0)
    assert runs.launcher is not None
    ops.reset_launches()
    for i in range(ticks):
        runs.tick(i)
        pv, pu, pring, prows = plain
        v2, u2, spikes, ring2, _ = ref.fused_tick_lanes_ref(
            pv, pu, pring, prows[:, i], is_gen, p.a, p.b, p.c, p.d, [t + i for t in t0],
            dense=payload.dense, csr=payload.csr, ring_len=net.static.ring_len)
        pv.copy_(v2)
        pu.copy_(u2)
        pring.copy_(ring2)
        prows[:, i] = spikes
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_tick"] == ticks
    for x, y in zip(state, plain):
        assert torch.equal(x, y)
    for b in (0, 1, 2, 33, 63):
        one = assemble_kernel(net.static, net.params, tuple(
            w[b] if per_lane else w for w in packed))
        ov, ou, oring, orows = (x[b].clone() for x in (v, u, ring, rows))
        solo = ops.FusedTickRun(one, ov, ou, oring, is_gen, p.a, p.b, p.c, p.d, orows)
        for i in range(ticks):
            solo.tick(i, t0[b] + i)
        torch.cuda.synchronize()
        for x, y in zip((ov, ou, oring, orows), state):
            assert torch.equal(x, y[b]), b
    assert int(state[3][:, :, ~is_gen].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plastic-packed", "plastic-sparse-homeo", "fused-sparse"])
def test_widened_run_batch_lanes_equal_solo_runs(card, case):
    """``run_batch(200, 16)`` on the plastic mini (packed; sparse with
    homeostasis every 40 ticks) and the fused Synfire4: one launch per
    kernel per tick for every lane, and lanes 0, 7 and 15 equal solo card
    runs in raster, weights, traces, rates and state."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core import lane_state, rng, run, run_batch
    from repro_torch.core.plasticity import HomeostasisConfig

    if case == "fused-sparse":
        net = build_synfire(SYNFIRE4, policy="fp16", propagation="sparse", device=card,
                            backend="fused", budget=None)
        want = {"fused_tick": 200}
    elif case == "plastic-packed":
        net = _plastic_mini("packed", card)
        want = {"izh4_update": 200, "stdp_update": 200, "plastic_drive": 200}
    else:
        net = _plastic_mini("sparse", card, homeo_chain=HomeostasisConfig(
            target_hz=10.0, tau_avg_ms=1000.0, beta=2.0), homeostasis_period=40)
        want = {"izh4_update": 200, "stdp_gather": 200, "plastic_drive": 200,
                "syn_gather": 200}
    ops.reset_launches()
    final, out = run_batch(net.static, net.params, net.state0, 200, 16)
    torch.cuda.synchronize()
    assert {k: ops.LAUNCHES[k] for k in want} == want
    keys = rng.split(net.state0.key, 16)
    for b in (0, 7, 15):
        solo, o = run(net.static, net.params, net.state0._replace(key=keys[b]), 200)
        assert torch.equal(o["spikes"], out["spikes"][b]), b
        lane = lane_state(final, b)
        for x, y in ((lane.ring, solo.ring), *zip(lane.neurons, solo.neurons),
                     *zip(lane.weights, solo.weights)):
            assert torch.equal(x, y), b
        for x, y in zip(lane.stdp, solo.stdp):
            assert (x is None) == (y is None) and (x is None or all(
                torch.equal(a, c) for a, c in zip(x, y))), b
        for x, y in zip(lane.homeo, solo.homeo):
            assert (x is None and y is None) or torch.equal(x, y), b


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 7, 32, 33, 65, 80, 96, 1025, 1100, 2049, 33000])
@pytest.mark.parametrize("dense", [False, True], ids=["csr", "dense"])
def test_drive_kernel_row_order(card, f, dense):
    """The drive kernel's row sums in XLA CPU's order at fan-ins below, at
    and just above a window of 32, the plastic chain's 80 and 96, and past
    1,024 (windows two and three levels deep), fp16 and f32 weights, three
    lanes, against its plain version on the card and on the CPU, bit for
    bit."""
    from repro_torch.kernels.plastic_drive import DriveProjection

    g = torch.Generator().manual_seed(f)
    lanes, n, q = 3, 500, 5
    for wdtype in (torch.float32, torch.float16):
        pre = torch.randint(0, n + 1, (q, f), generator=g)  # id n: the sentinel
        rows, sentinel = None, -1
        if dense:
            p_ = 40
            sentinel = p_ * q
            rows = torch.randint(0, sentinel + 1, (q, f), generator=g)
            w = torch.randn((lanes, p_, q), generator=g).to(wdtype)
        else:
            w = torch.randn((lanes, q, f), generator=g).to(wdtype)
        spikes = (torch.rand((lanes, n), generator=g) < 0.4).float()
        outs = {}
        for name, dev in (("card", card), ("plain", card), ("cpu", torch.device("cpu"))):
            acc = torch.zeros((lanes, n), device=dev)
            proj = DriveProjection(pre=pre.to(dev), rows=None if rows is None else rows.to(dev),
                                   out=acc[:, 10:10 + q], w_dtype=wdtype, sentinel=sentinel)
            if name == "plain":
                ref.drive_run_ref(spikes.to(dev), [proj], [w.to(dev)], [None])
            else:
                ops.DriveRun(n, [proj], lanes=lanes)(spikes.to(dev), [w.to(dev)], [None])
            outs[name] = acc.cpu()
        torch.cuda.synchronize()
        assert torch.equal(outs["card"], outs["plain"]) and torch.equal(outs["card"],
                                                                        outs["cpu"])
        assert bool(outs["card"].ne(0).any())


def _same_bits(got, want) -> bool:
    """NaN at the same places and equal f32 bits everywhere else."""
    nan = want.isnan()
    return torch.equal(got.isnan(), nan) and torch.equal(
        got.masked_fill(nan, 0.0).view(torch.int32), want.masked_fill(nan, 0.0).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("coba", [False, True], ids=["cuba", "coba"])
def test_drive_kernel_lands_projections_in_order(card, coba):
    """Three projections landing on overlapping columns (CSR fp16 at F =
    80, dense f32 at F = 37, CSR f32 at F = 96) add in projection order,
    ``|drive|`` each on a conductance-based net, and a NaN weight on a
    silent pre makes its column NaN (the kernel never gates on a silent
    pre): bit for bit the plain version on the card and the CPU port, NaN
    at the same places."""
    from repro_torch.kernels.plastic_drive import DriveProjection

    g = torch.Generator().manual_seed(23 + coba)
    lanes, n, q, p_ = 3, 300, 20, 50
    tables = [
        dict(pre=torch.randint(0, n + 1, (q, 80), generator=g), rows=None, cols=(10, 30),
             w=torch.randn((lanes, q, 80), generator=g).half()),
        dict(pre=torch.randint(0, n + 1, (q, 37), generator=g),
             rows=torch.randint(0, p_ * q + 1, (q, 37), generator=g), cols=(10, 30),
             w=torch.randn((lanes, p_, q), generator=g)),
        dict(pre=torch.randint(0, n + 1, (q, 96), generator=g), rows=None, cols=(20, 40),
             w=torch.randn((lanes, q, 96), generator=g)),
    ]
    spikes = (torch.rand((lanes, n), generator=g) < 0.4).float()
    silent = int(tables[0]["pre"][2, 5])
    spikes[:, silent % n] = 0.0
    tables[0]["w"][:, 2, 5] = float("nan")
    outs = {}
    for name, dev in (("card", card), ("plain", card), ("cpu", torch.device("cpu"))):
        acc = (torch.rand((lanes, n), generator=torch.Generator().manual_seed(5)) * 2).to(dev)
        projs = [DriveProjection(pre=t["pre"].to(dev),
                                 rows=None if t["rows"] is None else t["rows"].to(dev),
                                 out=acc[:, t["cols"][0]:t["cols"][1]], w_dtype=t["w"].dtype,
                                 sentinel=-1 if t["rows"] is None else p_ * q)
                 for t in tables]
        w = [t["w"].to(dev) for t in tables]
        if name == "plain":
            ref.drive_run_ref(spikes.to(dev), projs, w, [None] * 3, coba=coba)
        else:
            ops.DriveRun(n, projs, lanes=lanes, coba=coba)(spikes.to(dev), w, [None] * 3)
        outs[name] = acc.cpu()
    torch.cuda.synchronize()
    assert _same_bits(outs["card"], outs["plain"]) and _same_bits(outs["card"], outs["cpu"])
    assert bool(outs["card"][:, 12].isnan().all())
    assert int(outs["card"].isnan().sum()) == lanes


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True], ids=["csr", "dense"])
def test_drive_kernel_64_lanes_two_levels(card, dense):
    """64 lanes at F = 1,025 (windows two levels deep), fp16 weights each
    lane's own, a third of the lanes silent: bit for bit the plain version
    and every lane its one-lane launch."""
    from repro_torch.kernels.plastic_drive import DriveProjection

    g = torch.Generator().manual_seed(64)
    lanes, n, q, f, p_ = 64, 2000, 12, 1025, 1100
    pre = torch.randint(0, n + 1, (q, f), generator=g).to(card)
    rows, sentinel = None, -1
    if dense:
        sentinel = p_ * q
        rows = torch.randint(0, sentinel + 1, (q, f), generator=g).to(card)
        w = torch.randn((lanes, p_, q), generator=g).half().to(card)
    else:
        w = torch.randn((lanes, q, f), generator=g).half().to(card)
    spikes = _lane_spikes(g, lanes, n, card)
    accs = {k: torch.zeros((lanes, n), device=card) for k in ("card", "plain", "one")}

    def proj(out):
        return DriveProjection(pre=pre, rows=rows, out=out, w_dtype=torch.float16,
                               sentinel=sentinel)

    ops.reset_launches()
    ops.DriveRun(n, [proj(accs["card"][:, 7:7 + q])], lanes=lanes)(spikes, [w], [None])
    ref.drive_run_ref(spikes, [proj(accs["plain"][:, 7:7 + q])], [w], [None])
    for b in range(lanes):
        ops.DriveRun(n, [proj(accs["one"][b, 7:7 + q])])(spikes[b].contiguous(), [w[b]], [None])
    torch.cuda.synchronize()
    assert ops.LAUNCHES["plastic_drive"] == 1 + lanes
    assert torch.equal(accs["card"], accs["plain"]) and torch.equal(accs["card"], accs["one"])
    assert bool(accs["card"][0].ne(0).any()) and not bool(accs["card"][2].ne(0).any())


@pytest.mark.cuda
def test_drive_kernel_uses_no_local_memory(card):
    """The loaded drive kernel, built now or cached, has no stack frame and
    spills nothing: the runtime reports 0 bytes of local memory a thread."""
    from repro_torch.kernels.plastic_drive import kernel_resources

    res = kernel_resources()
    assert res["local_bytes"] == 0 and 0 < res["registers"] <= 255


def _monitor_slots(g, shape, device):
    """A SpikeCount count and a GroupRate level of ``shape`` (random, so the
    filter rounds off its grid), and the constants of a 100 ms GroupRate
    at dt = 1 ms."""
    count = torch.randint(0, 50, shape, generator=g, dtype=torch.int32).to(device)
    level = (torch.rand(shape, generator=g) * 40).to(device)
    return count, level, (float(np.float32(1.0 / 100.0)), 1000.0)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, 64], ids=["one-lane", "64-lanes"])
@pytest.mark.parametrize("policy", ["fp16", "fp32"])
def test_neuron_run_monitor_slots_match_plain(card, policy, lanes):
    """B1 with the in-run monitor slots (a SpikeCount's count, a GroupRate's
    level folded in the launch) over 20 chained Synfire4 ticks: bit for bit
    its plain version (``ref.neuron_run_ref`` / ``neuron_lanes_ref`` with
    the same slots) on random levels, at one lane and over 64 lanes at
    their own ticks (every lane then equal to its one-lane launch); one
    launch a tick."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core import NeuronModel
    from repro_torch.core import backend as be
    from repro_torch.core.lanes import lane_state

    net = build_synfire(SYNFIRE4, policy=policy, propagation="sparse", device=card,
                        budget=None)
    n, ticks = net.static.n, 20
    g = torch.Generator().manual_seed(31)
    st = _lane_states(net, lanes or 1, 32, card)
    if lanes is None:
        st = lane_state(st, 0)
    lead = () if lanes is None else (lanes,)
    ring = (torch.rand(st.ring.shape, generator=g) * 8).to(st.ring.dtype).to(card)
    gen = (torch.rand((*lead, ticks, net.static.n_gen), generator=g) < 0.3).to(card)
    count, level, rate = _monitor_slots(g, (*lead, n), card)
    t0 = st.t if lanes else None
    p = net.params.neuron
    is_gen = p.model == NeuronModel.GENERATOR
    cols = torch.full((n,), -1, dtype=torch.int64, device=card)
    cols[is_gen] = torch.arange(int(is_gen.sum()), device=card)
    plain = [x.clone() for x in (*st.neurons, ring, count, level)]
    c0, l0, ring0 = count.clone(), level.clone(), ring.clone()
    ops.reset_launches()
    kernel = be.assemble_neurons(net.static, net.params, st.neurons, ring, gen_spk=gen,
                                 t0=t0, tel=dict(tel_count=count, tel_rate=level, rate=rate))
    assert kernel.launcher is not None
    spikes = torch.zeros((*lead, n), device=card)
    for i in range(ticks):
        if lanes is None:
            kernel(i, st.t + i)
            ref.neuron_run_ref(*plain[:4], (st.t + i) % net.static.ring_len, is_gen, p.a,
                               p.b, p.c, p.d, cols, spikes, gen_row=gen[i],
                               tel_count=plain[4], tel_rate=plain[5], rate=rate)
        else:
            kernel(i)
            ref.neuron_lanes_ref(*plain[:4], [(t + i) % net.static.ring_len for t in st.t],
                                 is_gen, p.a, p.b, p.c, p.d, cols, spikes,
                                 gen_rows=gen[:, i], tel_count=plain[4], tel_rate=plain[5],
                                 rate=rate)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["izh4_update"] == ticks
    for a, b in zip((kernel.v, kernel.u, kernel.refrac, ring, count, level), plain):
        assert torch.equal(a, b)
    assert not torch.equal(level, l0) and int((count - c0).sum()) > 0
    for b in range(0, lanes or 0, 21):
        one = lane_state(st, b)
        c1, l1 = c0[b].clone(), l0[b].clone()
        solo = be.assemble_neurons(net.static, net.params, one.neurons, ring0[b].clone(),
                                   gen_spk=gen[b].contiguous(),
                                   tel=dict(tel_count=c1, tel_rate=l1, rate=rate))
        for i in range(ticks):
            solo(i, st.t[b] + i)
        torch.cuda.synchronize()
        assert torch.equal(c1, count[b]) and torch.equal(l1, level[b]), b


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, 64], ids=["one-lane", "64-lanes"])
@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_fused_tick_monitor_slots_match_plain(card, propagation, lanes):
    """B4 with the in-run monitor slots over 12 ticks of Synfire4 fp16
    (random v, u, ring, generator rows and levels): bit for bit its plain
    version with the same slots, at one lane and over 64 lanes at their own
    ring slots; still one launch a tick."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core import backend as be
    from repro_torch.core.neurons import NeuronModel
    from repro_torch.kernels.fused_tick import assemble_kernel

    net = build_synfire(SYNFIRE4, policy="fp16", propagation=propagation, device=card,
                        backend="fused", budget=None)
    g = torch.Generator().manual_seed(33)
    ticks, n = 12, net.static.n
    lead = () if lanes is None else (lanes,)
    payload = assemble_kernel(net.static, net.params,
                              be.assemble_packed(net.static, net.state0.weights))
    dtype = net.state0.neurons.v.dtype
    v = (torch.rand((*lead, n), generator=g) * 100 - 75).to(dtype).to(card)
    u = (torch.rand((*lead, n), generator=g) * 10 - 15).to(dtype).to(card)
    ring = (torch.rand((*lead, net.static.ring_len, n), generator=g) * 10).to(dtype).to(card)
    rows = (torch.rand((*lead, ticks, n), generator=g) < 0.2).to(card)
    count, level, rate = _monitor_slots(g, (*lead, n), card)
    t0 = tuple(100 + 7 * b for b in range(lanes)) if lanes else None
    p = net.params.neuron
    is_gen = p.model == NeuronModel.GENERATOR
    state = [x.clone() for x in (v, u, ring, rows, count, level)]
    plain = [x.clone() for x in state]
    runs = ops.FusedTickRun(payload, *state[:3], is_gen, p.a, p.b, p.c, p.d, state[3], t0=t0,
                            tel_count=state[4], tel_rate=state[5], rate=rate)
    assert runs.launcher is not None
    ops.reset_launches()
    kw = dict(dense=payload.dense, csr=payload.csr, ring_len=net.static.ring_len,
              tel_count=plain[4], tel_rate=plain[5], rate=rate)
    for i in range(ticks):
        pv, pu, pring, prows = plain[:4]
        if lanes is None:
            runs.tick(i, 100 + i)
            v2, u2, spikes, ring2, _ = ref.fused_tick_ref(
                pv, pu, pring, prows[i], is_gen, p.a, p.b, p.c, p.d, 100 + i, **kw)
        else:
            runs.tick(i)
            v2, u2, spikes, ring2, _ = ref.fused_tick_lanes_ref(
                pv, pu, pring, prows[:, i], is_gen, p.a, p.b, p.c, p.d,
                [t + i for t in t0], **kw)
        pv.copy_(v2)
        pu.copy_(u2)
        pring.copy_(ring2)
        prows[..., i, :] = spikes
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_tick"] == ticks
    for x, y in zip(state, plain):
        assert torch.equal(x, y)
    assert not torch.equal(state[5], level) and int((state[4] - count).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("backend", [None, "fused"], ids=["default", "fused"])
@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_monitored_runs_card_equal_cpu(card, propagation, backend):
    """``record="both"`` on Synfire4-mini fp16 (300 ticks): the card's
    telemetry equals the CPU port's bit for bit, its raster the
    ``"raster"`` run's, and ``run_batch(300, 4, record="monitors")``'s lanes
    each its solo run's."""
    from repro_torch.configs.synfire4 import SYNFIRE4_MINI, build_synfire
    from repro_torch.core import rng
    from repro_torch.core.engine import run, run_batch

    nets = [build_synfire(SYNFIRE4_MINI, policy="fp16", propagation=propagation,
                          backend=backend, device=dev) for dev in (card, "cpu")]
    outs = [run(net.static, net.params, net.state0, 300, record="both")[1] for net in nets]
    _, raster = run(nets[0].static, nets[0].params, nets[0].state0, 300)
    assert torch.equal(outs[0]["spikes"], raster["spikes"])
    for name in ("spike_count", "group_rate"):
        assert torch.equal(outs[0]["telemetry"][name], outs[1]["telemetry"][name]), name
    net = nets[0]
    _, batch = run_batch(net.static, net.params, net.state0, 300, 4, record="monitors")
    keys = rng.split(net.state0.key, 4)
    for b in (0, 3):
        _, solo = run(net.static, net.params, net.state0._replace(key=keys[b]), 300,
                      record="monitors")
        for name in ("spike_count", "group_rate"):
            assert torch.equal(solo["telemetry"][name], batch["telemetry"][name][b]), name


def _same_bits(a, b):
    """Equal bit for bit, NaNs in the same places included."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan])


def _watch_slots(g, lead, n, device):
    """Random watch slots: a RateBand count, a Silent's {last, gap, flags}
    words and a NonFinite's {ticks, 0, flags} words (flags clear)."""
    count = torch.randint(0, 50, (*lead, n), generator=g, dtype=torch.int32)
    zero = torch.zeros(lead, dtype=torch.int32)
    silent = torch.stack([-1 - torch.randint(0, 30, lead, generator=g, dtype=torch.int32),
                          torch.randint(0, 60, lead, generator=g, dtype=torch.int32),
                          zero, zero], -1)
    bad = torch.stack([torch.randint(0, 5, lead, generator=g, dtype=torch.int32),
                       zero, zero, zero], -1)
    return [x.to(torch.int32).contiguous().to(device) for x in (count, silent, bad)]


@pytest.mark.cuda
@pytest.mark.parametrize("substeps", [2, 1])
@pytest.mark.parametrize("lanes", [None, 64], ids=["one-lane", "64-lanes"])
@pytest.mark.parametrize("policy", ["fp16", "fp32"])
def test_neuron_run_watch_slots_match_plain(card, policy, lanes, substeps):
    """B1 with the in-run watch slots (a RateBand's count, a Silent's and a
    NonFinite's words) over 12 chained Synfire4 ticks on random state: bit
    for bit its plain version with the same slots, NaNs in place, with lane
    0's membrane NaN and, over lanes, lane 1's stored as inf, lane 2 at rest
    (it never spikes) and lane 3's ring at -65,504 (with one substep its f32
    membrane lands finite past -65,504, which fp16 stores as -inf: counted,
    the check is on the stored value)."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core import NeuronModel

    net = build_synfire(SYNFIRE4, policy=policy, propagation="sparse", device=card,
                        budget=None)
    static, n, ticks = net.static, net.static.n, 12
    g = torch.Generator().manual_seed(41)
    lead = () if lanes is None else (lanes,)
    dtype = net.state0.neurons.v.dtype
    v = (torch.rand((*lead, n), generator=g) * 115 - 80).to(dtype)
    u = (torch.rand((*lead, n), generator=g) * 10 - 15).to(dtype)
    ring = (torch.rand((*lead, *net.state0.ring.shape), generator=g) * 12).to(dtype)
    gen = torch.rand((*lead, ticks, static.n_gen), generator=g) < 0.3
    (v[0] if lanes else v)[-7] = float("nan")  # a neuron, not a generator
    if lanes:
        v[1, -20] = float("inf")
        v[2], u[2], ring[2], gen[2] = -70.0, -14.0, 0.0, False
        ring[3] = -65504.0
    v, u, ring, gen = v.to(card), u.to(card), ring.to(card), gen.to(card)
    refrac = torch.zeros((*lead, n), dtype=torch.int16, device=card)
    slots = _watch_slots(g, lead, n, card)
    w0 = [x.clone() for x in slots]
    plain = [x.clone() for x in slots]
    p = net.params.neuron
    is_gen = p.model == NeuronModel.GENERATOR
    cols = torch.full((n,), -1, dtype=torch.int64, device=card)
    cols[is_gen] = torch.arange(int(is_gen.sum()), device=card)
    t0 = tuple(100 + 7 * b for b in range(lanes)) if lanes else None
    k_ring = ring.clone()
    kernel = ops.NeuronRun(v, u, refrac, k_ring, is_gen, p.a, p.b, p.c, p.d, gen_spk=gen,
                           gen_cols=cols, dt=static.dt, substeps=substeps, t0=t0,
                           w_count=slots[0], w_silent=slots[1], w_bad=slots[2])
    assert kernel.launcher is not None
    pv, pu, pr, p_ring = v.clone(), u.clone(), refrac.clone(), ring.clone()
    spikes = torch.zeros((*lead, n), device=card)
    kw = dict(w_count=plain[0], w_silent=plain[1], w_bad=plain[2], dt=static.dt,
              substeps=substeps)
    ops.reset_launches()
    for i in range(ticks):
        if lanes:
            kernel(i)
            ref.neuron_lanes_ref(pv, pu, pr, p_ring, [(t + i) % static.ring_len for t in t0],
                                 is_gen, p.a, p.b, p.c, p.d, cols, spikes, gen_rows=gen[:, i],
                                 step=i, **kw)
        else:
            kernel(i, 100 + i)
            ref.neuron_run_ref(pv, pu, pr, p_ring, (100 + i) % static.ring_len, is_gen, p.a,
                               p.b, p.c, p.d, cols, spikes, gen_row=gen[i], step=i, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["izh4_update"] == ticks
    for a, b in zip((kernel.v, kernel.u, kernel.refrac, k_ring, *slots),
                    (pv, pu, pr, p_ring, *plain)):
        assert _same_bits(a, b)
    bad = (slots[2] - w0[2])[..., 0].reshape(-1)  # the ticks folded: all but the last
    assert int(bad[0]) >= ticks - 2
    if lanes:
        assert int(bad[1]) > 0 and torch.equal(slots[1][2], w0[1][2])  # lane 2 never spiked
        assert int(bad[3]) > 0 if (substeps == 1 and policy == "fp16") else int(bad[3]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, 64], ids=["one-lane", "64-lanes"])
@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_fused_tick_watch_slots_match_plain(card, propagation, lanes):
    """B4 with the in-run watch slots over 12 ticks of Synfire4 fp16 (random
    state, lane 0's membrane NaN and, over lanes, lane 1's stored as inf
    and lane 2 at rest with no input): bit for bit its plain version with
    the same slots, still one launch a tick."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core import backend as be
    from repro_torch.core.neurons import NeuronModel
    from repro_torch.kernels.fused_tick import assemble_kernel

    net = build_synfire(SYNFIRE4, policy="fp16", propagation=propagation, device=card,
                        backend="fused", budget=None)
    g = torch.Generator().manual_seed(43)
    ticks, n = 12, net.static.n
    lead = () if lanes is None else (lanes,)
    payload = assemble_kernel(net.static, net.params,
                              be.assemble_packed(net.static, net.state0.weights))
    dtype = net.state0.neurons.v.dtype
    v = (torch.rand((*lead, n), generator=g) * 100 - 75).to(dtype)
    u = (torch.rand((*lead, n), generator=g) * 10 - 15).to(dtype)
    ring = (torch.rand((*lead, net.static.ring_len, n), generator=g) * 10).to(dtype)
    rows = torch.rand((*lead, ticks, n), generator=g) < 0.2
    (v[0] if lanes else v)[-7] = float("nan")  # a neuron, not a generator
    if lanes:
        v[1, -20] = float("inf")
        v[2], u[2], ring[2], rows[2] = -70.0, -14.0, 0.0, False
    v, u, ring, rows = v.to(card), u.to(card), ring.to(card), rows.to(card)
    slots = _watch_slots(g, lead, n, card)
    t0 = tuple(100 + 7 * b for b in range(lanes)) if lanes else None
    p = net.params.neuron
    is_gen = p.model == NeuronModel.GENERATOR
    state = [x.clone() for x in (v, u, ring, rows, *slots)]
    plain = [x.clone() for x in state]
    runs = ops.FusedTickRun(payload, *state[:3], is_gen, p.a, p.b, p.c, p.d, state[3], t0=t0,
                            w_count=state[4], w_silent=state[5], w_bad=state[6])
    assert runs.launcher is not None
    ops.reset_launches()
    kw = dict(dense=payload.dense, csr=payload.csr, ring_len=net.static.ring_len,
              w_count=plain[4], w_silent=plain[5], w_bad=plain[6])
    for i in range(ticks):
        pv, pu, pring, prows = plain[:4]
        if lanes is None:
            runs.tick(i, 100 + i)
            v2, u2, spikes, ring2, _ = ref.fused_tick_ref(
                pv, pu, pring, prows[i], is_gen, p.a, p.b, p.c, p.d, 100 + i, step=i, **kw)
        else:
            runs.tick(i)
            v2, u2, spikes, ring2, _ = ref.fused_tick_lanes_ref(
                pv, pu, pring, prows[:, i], is_gen, p.a, p.b, p.c, p.d,
                [t + i for t in t0], step=i, **kw)
        pv.copy_(v2)
        pu.copy_(u2)
        pring.copy_(ring2)
        prows[..., i, :] = spikes
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_tick"] == ticks
    for x, y in zip(state, plain):
        assert _same_bits(x, y)
    bad = (state[6] - slots[2])[..., 0].reshape(-1)  # the ticks folded: all but the last
    assert int(bad[0]) >= ticks - 2
    if lanes:
        assert int(bad[1]) > 0 and torch.equal(state[5][2], slots[1][2])  # lane 2 never spiked


@pytest.mark.cuda
@pytest.mark.parametrize("backend", [None, "fused"], ids=["default", "fused"])
@pytest.mark.parametrize("propagation", ["packed", "sparse"])
def test_watched_runs_card_equal_cpu(card, propagation, backend):
    """Synfire4-mini fp16 with the default watches (300 ticks): the card's
    watch carry equals the CPU port's bit for bit, its raster and state the
    unwatched card run's, and ``run_batch(300, 4)``'s carries each lane's
    solo run's."""
    from repro_torch.configs.synfire4 import SYNFIRE4_MINI, build_synfire
    from repro_torch.core import rng
    from repro_torch.core.engine import run, run_batch

    nets = [build_synfire(SYNFIRE4_MINI, policy="fp16", propagation=propagation,
                          backend=backend, device=dev, watches=w)
            for dev, w in ((card, "default"), ("cpu", "default"), (card, None))]
    outs = [run(net.static, net.params, net.state0, 300) for net in nets]
    for x, y in zip(outs[0][1]["watch_carry"], outs[1][1]["watch_carry"]):
        for a, b in zip(x, y):
            assert torch.equal(a.cpu(), b)
    assert torch.equal(outs[0][1]["spikes"], outs[2][1]["spikes"])
    assert torch.equal(outs[0][0].neurons.v, outs[2][0].neurons.v)
    net = nets[0]
    _, batch = run_batch(net.static, net.params, net.state0, 300, 4, record="none")
    keys = rng.split(net.state0.key, 4)
    for b in (0, 3):
        _, solo = run(net.static, net.params, net.state0._replace(key=keys[b]), 300,
                      record="none")
        for x, y in zip(solo["watch_carry"], batch["watch_carry"]):
            for a, c in zip(x, y):
                assert torch.equal(a, c[b])


def _partition_nets(card, spec, **kw):
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire

    return [build_synfire(SYNFIRE4, device=dev, partition=spec, **kw) for dev in (card, "cpu")]


@pytest.mark.cuda
@pytest.mark.parametrize("policy,propagation", [("fp32", "sparse"), ("fp16", "packed")])
def test_partition_core_launchers_match_plain(card, policy, propagation):
    """Plastic Synfire4 cut at two cores, ``[0, 1150)`` (the STDP cluster,
    its drive and its STDP launcher) and the 50-post ``[1150, 1200)``:
    every core's launchers on the card against the CPU port's (their plain
    versions) over 12 chained ticks, each core's spikes, v, u, ring, gather
    rows and plastic weights and traces bit for bit after every phase."""
    from repro_torch.configs.synfire4 import CHAIN_STDP
    from repro_torch.core import partition as part

    nets = _partition_nets(card, part.PartitionSpec(n_cores=2), policy=policy,
                           propagation=propagation, stdp_chain=CHAIN_STDP)
    assert [(c.lo, c.hi) for c in nets[0].partition.cores] == [(0, 1150), (1150, 1200)]
    sets = [part._sequential_cores(n.static, n.partition, n.partition.run_params, n.state0,
                                   12, True)[2] for n in nets]
    owner, small = sets[0]
    assert owner.neuron_run.launcher is not None and small.neuron_run.launcher is not None
    assert owner.drive.run.launcher is not None
    assert owner.stdp_runs and all(r.launcher is not None for r in owner.stdp_runs)
    ops.reset_launches()
    for i in range(12):
        for phase in ("phase_a", "phase_b"):
            for cores in sets:
                for c in cores:
                    if phase == "phase_a":
                        c.phase_a(i, i)
                    else:
                        c.phase_b(i)
            for a, b in zip(*sets):
                pairs = [(a.spikes, b.spikes), (a.ring, b.ring),
                         (a.neuron_run.v, b.neuron_run.v), (a.neuron_run.u, b.neuron_run.u),
                         (a.gather.rows, b.gather.rows)]
                for ra, rb in zip(a.stdp_runs, b.stdp_runs):
                    pairs += [(pa.w, pb.w) for pa, pb in zip(ra.projs, rb.projs)]
                    pairs += list(zip(ra.traces(0), rb.traces(0)))
                for x, y in pairs:
                    assert torch.equal(x.cpu(), y), (i, phase, a.cp.index)
    assert ops.LAUNCHES["izh4_update"] == 24 and ops.LAUNCHES["plastic_drive"] == 12


@pytest.mark.cuda
@pytest.mark.parametrize("lowering", ["sequential", "mesh"])
def test_partitioned_card_run_equals_unpartitioned(card, lowering):
    """Synfire4 fp16 sparse cut at 4 cores, 300 ticks on the card (the mesh
    lowering on ``[card] * 4``): raster and state equal the unpartitioned
    card run's and the CPU port's partitioned run's."""
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire
    from repro_torch.core import partition as part
    from repro_torch.core.distributed import core_mesh
    from repro_torch.core.engine import Engine

    spec = part.PartitionSpec(n_cores=4, lowering=lowering)
    net, cpu = _partition_nets(card, spec, policy="fp16", propagation="sparse")
    base = build_synfire(SYNFIRE4, policy="fp16", propagation="sparse", device=card)
    s0, o0 = Engine(base).run(300)
    plan = net.partition
    if lowering == "mesh":
        s1, o1 = part.run_partitioned_mesh(net.static, plan, plan.run_params, net.state0, 300,
                                           mesh=core_mesh(devices=[card] * 4))
    else:
        s1, o1 = Engine(net).run(300)
    s2, o2 = part.run_partitioned(cpu.static, cpu.partition, cpu.partition.run_params,
                                  cpu.state0, 300)
    assert torch.equal(o1["spikes"], o0["spikes"]) and torch.equal(o1["spikes"].cpu(),
                                                                   o2["spikes"])
    for a, b, c in ((s1.ring, s0.ring, s2.ring), *zip(s1.neurons, s0.neurons, s2.neurons)):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
