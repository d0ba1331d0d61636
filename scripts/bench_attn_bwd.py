"""Check and time the attention backward (``flash_attn_bwd``) on the card,
kernel by kernel.

    python3 scripts/bench_attn_bwd.py [--root DIR] [--json PATH] [--reps N] [--check-only]

For each training shape of ``chip_smoke.py``'s phases 13a and 14a, and a few
edge cases (Sk not a multiple of 32, a head dim that takes 4-byte copies, an
odd GQA group): B7's forward with the log-sum-exp, then
``ops.attention_bwd`` twice, bit for bit, against the plain version
(``ref.chunked_attention_bwd_ref``; each output within 2e-4 of its scale).
Unless ``--check-only``, also: the call's device time split by sub-kernel
(delta, dK/dV, the head reduction, dQ, the dQ splits' sum) from a
``torch.profiler`` trace of ``--reps`` calls, and the span from the first
kernel's start to the last one's end (dQ runs beside dK/dV on a second
stream, so the span is less than the sum); its time per call (CUDA
events); and the backward of one
``scaled_dot_product_attention`` on the same f32 inputs (``is_causal`` where
the mask is the index-causal one, an explicit boolean ``attn_mask``
otherwise), on the device, with the names of the kernels it ran. Bounds: the
inputs read and the gradients written once at 3.35 TB/s, or five f32
products (2 operations each) of D per allowed (query, key) pair and head,
at 67 TFLOP/s (f32) and at 165 TFLOP/s (split TF32: three passes at 495).
``--root`` imports ``repro_torch`` from another checkout (a ``git archive``
of the parent under ``build/``), so two versions compare in one chip call,
each in its own process. Prints ptxas' registers and spills of each kernel
when this process built the library. The last line is one JSON object. The
port does not use this script.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
BWD_TOL = 2e-4
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SPLIT_TF32_OPS_PER_S = 495e12 / 3
PARTS = ("delta_kernel", "dkv_kernel", "reduce_kernel", "dq_kernel", "reduce_q_kernel")
# name: (B, S, Hq, Hkv, D, window, invalid trailing slots, query shift, M-RoPE t positions)
CASES = {
    "smollm [8,512,15,5,64]": (8, 512, 15, 5, 64, -1, 0, 0, False),
    "reduced [4,64,4,1,16]": (4, 64, 4, 1, 16, -1, 0, 0, False),
    "decode-sized [2,5,3,1,16]": (2, 5, 3, 1, 16, -1, 0, 0, False),
    "window 64 [2,160,8,2,16]": (2, 160, 8, 2, 16, 64, 0, 0, False),
    "invalid slots, no-key rows [2,40,6,2,64]": (2, 40, 6, 2, 64, -1, 5, -8, False),
    "qwen2.5 [1,512,10,2,128]": (1, 512, 10, 2, 128, -1, 0, 0, False),
    "minitron [1,512,8,2,128]": (1, 512, 8, 2, 128, -1, 0, 0, False),
    "stablelm [1,512,8,2,160]": (1, 512, 8, 2, 160, -1, 0, 0, False),
    "Sk 1,536 [1,1536,15,5,64]": (1, 1536, 15, 5, 64, -1, 0, 0, False),
    "recurrentgemma [4,512,10,1,256]": (4, 512, 10, 1, 256, -1, 0, 0, False),
    "recurrentgemma windowed [1,2560,10,1,256]": (1, 2560, 10, 1, 256, 2048, 0, 0, False),
    "qwen2-vl M-RoPE [4,512,12,2,128]": (4, 512, 12, 2, 128, -1, 0, 0, True),
    "qwen2-moe [4,512,16,16,128]": (4, 512, 16, 16, 128, -1, 0, 0, False),
    "musicgen [4,512,32,32,64]": (4, 512, 32, 32, 64, -1, 0, 0, False),
    "granite [4,512,16,8,64]": (4, 512, 16, 8, 64, -1, 0, 0, False),
    "D 20, group 7, Sk 100 [2,100,7,1,20]": (2, 100, 7, 1, 20, -1, 0, 0, False),
    "D 160, Sk 70, invalid slots [1,70,8,2,160]": (1, 70, 8, 2, 160, -1, 3, 0, False),
}


def log(*a) -> None:
    print(*a, flush=True)


def inputs(case, seed: int, dev):
    b, s, hq, hkv, d, window, invalid, shift, mrope = case
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, s, hq, d), generator=g)
    k = torch.randn((b, s, hkv, d), generator=g)
    v = torch.randn((b, s, hkv, d), generator=g)
    dout = torch.randn((b, s, hq, d), generator=g)
    kpos = torch.arange(s, dtype=torch.int32)
    if invalid:
        kpos[-invalid:] = -1
    qpos = (torch.arange(s, dtype=torch.int32) + shift).expand(b, s)
    if mrope:  # the VLM's t positions: an image's 256 tokens share position 0
        kpos = torch.cat([torch.zeros(256), torch.arange(s - 256) + 2]).to(torch.int32)
        qpos = kpos.expand(b, s)
    return [x.contiguous().to(dev) for x in (q, k, v, qpos, kpos, dout)], window


def allowed(qpos, kpos, causal: bool, window: int):
    kp, qp = kpos[None, None, :], qpos[:, :, None]
    mask = (kp >= 0).expand(qpos.shape[0], qpos.shape[1], kpos.shape[0])
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & (kp > qp - window)
    return mask


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us(fn, reps: int) -> dict:
    """Microseconds per call on the device by kernel name, from a
    ``torch.profiler`` trace of ``reps`` calls (traced again, up to four
    times, while it holds fewer than ``reps`` kernel records); under
    ``"_span"`` the first kernel's start to the last one's end over the
    calls, per call (kernels that overlap count once)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best: dict = {}
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans: dict = {}
        n, first, last = 0, float("inf"), float("-inf")
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                spans[e.name] = spans.get(e.name, 0.0) + e.time_range.elapsed_us()
                first, last = min(first, e.time_range.start), max(last, e.time_range.end)
                n += 1
        if n > best.get("_n", -1):
            best = {"_n": n, "spans": spans, "span": last - first}
        if n >= reps:
            break
    return {**{k: v / reps for k, v in best["spans"].items()}, "_span": best["span"] / reps}


def run_case(name, case, seed, dev, reps, check_only, ops, ref) -> dict:
    (q, k, v, qpos, kpos, dout), window = inputs(case, seed, dev)
    causal = True
    out, lse = ops._attention_fwd(q, k, v, qpos, kpos, causal, window, with_lse=True)
    bwd = lambda: ops.attention_bwd(q, k, v, qpos, kpos, out, lse, dout, causal=causal,  # noqa: E731
                                    window=window)
    ops.reset_launches()
    got, again = bwd(), bwd()
    torch.cuda.synchronize()
    launches = ops.LAUNCHES["flash_attention_bwd"]
    w_out, w_lse = ref.chunked_attention_ref(q, k, v, qpos, kpos, causal=causal, window=window,
                                             return_lse=True)
    want = ref.chunked_attention_bwd_ref(q, k, v, qpos, kpos, w_out, w_lse, dout, causal=causal,
                                         window=window)
    rel = {}
    for what, x, y in zip(("dq", "dk", "dv"), got, want):
        rel[what] = float((x - y).abs().max()) / max(float(y.abs().max()), 1.0)
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    ok = same and launches == 2 and all(r <= BWD_TOL for r in rel.values())
    row = {"case": name, "shape": list(case[:5]), "window": window, "ok": ok,
           "bit_for_bit": same, "launches_per_2_calls": launches, "errs_of_scale": rel}
    if check_only or not ok:
        log(f"[bwd] {name}: ok={ok} two calls equal={same} launches={launches} of scale {rel}")
        return row
    mask = allowed(qpos, kpos, causal, window)
    pairs = int(mask.sum())
    b, s, hq, d = q.shape
    moved = sum(t.numel() * t.element_size() for t in (q, k, v, out, lse, dout, qpos, kpos, *got))
    flops = 10 * hq * d * pairs
    t_bytes = moved / HBM_BYTES_PER_S * 1e6
    kernels = device_us(bwd, reps)
    span = kernels.pop("_span")
    split = {p: sum(us for n, us in kernels.items() if p in n) for p in PARTS}
    row.update({
        "allowed_pairs": pairs, "us": cuda_ms(bwd, reps) * 1e3, "span_us": span,
        "device_us": sum(kernels.values()), "parts_us": split,
        "bound_f32_us": max(t_bytes, flops / FP32_OPS_PER_S * 1e6),
        "bound_split_tf32_us": max(t_bytes, flops / SPLIT_TF32_OPS_PER_S * 1e6)})
    # SDPA's backward on the same inputs and mask.
    tril = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    index_causal = torch.equal(mask, tril.expand_as(mask))
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        if index_causal:
            ot = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            ot = sdpa(qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)
        gt = dout.transpose(1, 2).contiguous()
        lib = lambda: torch.autograd.grad(ot, (qt, kt, vt), gt, retain_graph=True)  # noqa: E731
        lk = device_us(lib, reps)
        row["sdpa_span_us"] = lk.pop("_span")
        top = sorted(lk.items(), key=lambda kv: -kv[1])
        row.update({"sdpa_mask": "is_causal" if index_causal else "attn_mask (bool)",
                    "sdpa_us": cuda_ms(lib, reps) * 1e3, "sdpa_device_us": sum(lk.values()),
                    "sdpa_kernels_us": {n[:120]: us for n, us in top[:6]},
                    "sdpa_finite": bool(all(torch.isfinite(x).all() for x in lib()))})
    except RuntimeError as e:  # SDPA refuses the case
        row.update({"sdpa_mask": "refused", "sdpa_error": str(e)[:300]})
    log(f"[bwd] {name}: ok, of scale {rel}; {row['us']:.2f} us per call, "
        f"{row['device_us']:.2f} on the device ({ {p[:-7]: round(u, 2) for p, u in split.items()} }"
        f", span {span:.2f}); "
        f"bound {row['bound_f32_us']:.2f} (f32) / {row['bound_split_tf32_us']:.2f} (split TF32); "
        f"SDPA {row.get('sdpa_device_us', float('nan')):.2f} on the device (span "
        f"{row.get('sdpa_span_us', float('nan')):.2f}) "
        f"({row['sdpa_mask']}): {list(row.get('sdpa_kernels_us', {}))[:3]}")
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="checkout whose repro_torch to import")
    ap.add_argument("--json", default=None, help="write the result here too")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--only", default=None, help="run the cases whose name contains this")
    args = ap.parse_args()
    root = Path(args.root).resolve() if args.root else ROOT
    sys.path.insert(0, str(root / "src"))
    if not torch.cuda.is_available():
        log("no CUDA card: this script times the kernel on the card")
        return 1
    from repro_torch.kernels import _build, ops, ref

    t0 = time.perf_counter()
    built = _build.build(("flash_attn", "flash_attn_bwd"))
    log(f"[build] {root}: {time.perf_counter() - t0:.2f} s; "
        f"flash_attn_bwd.cu {built['flash_attn_bwd']['seconds']:.2f} s")
    ptxas = {}
    for line in built["flash_attn_bwd"]["log"].splitlines():
        if "registers" in line or "spill" in line or "Function properties" in line:
            log(f"[build]   {line.strip()}")
    entries = getattr(_build, "ptxas_entries", None)
    if entries is not None:
        ptxas = entries(built["flash_attn_bwd"]["log"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rows = []
    for i, (name, case) in enumerate(CASES.items()):
        if args.only and args.only not in name:
            continue
        rows.append(run_case(name, case, 100 + i, dev, args.reps, args.check_only, ops, ref))
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    log(smi)
    result = {"root": str(root), "device": torch.cuda.get_device_name(0), "smi": smi,
              "ptxas": ptxas, "ok": all(r["ok"] for r in rows), "rows": rows}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    log(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
