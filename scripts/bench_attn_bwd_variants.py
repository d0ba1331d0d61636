"""Where the attention backward's tile kernels spend their time, on the card.

    python3 scripts/bench_attn_bwd_variants.py [--reps N] [--variants a,b,...] [--json PATH]

Builds copies of ``src/repro_torch/kernels/csrc/flash_attn_bwd.cu`` into
``build/torch_kernels/``, each with one change, and times the dK/dV and dQ
kernels of each (``torch.profiler``, the mean per call) at eight training
shapes of ``scripts/bench_attn_bwd.py``. ``base`` is the shipped source and
is checked against the plain version first; ``splits1`` runs it with one
CTA per block of fixed rows (``flash_attn_bwd.MAX_SPLITS`` = 1),
``splits-x4`` with splits that aim at 4 CTAs an SM
(``SPLIT_CTAS_PER_SM``), ``min1``
asks ptxas for one CTA an SM (no register cap below 255: no spills),
``min2-d160`` for two CTAs of the D 160 instance (at most 102 registers a
thread), ``min3-d64`` for three of the D 64 one (at most 170); these
compute what ``base`` computes and are checked too. The
others leave a step out, so their outputs are wrong by design and not
checked: ``no-exchange`` reads only the warp's own score partial,
``no-exp`` takes s - lse for exp(s - lse), ``no-split`` computes from the
landed tile without splitting it, ``no-score`` and ``no-accumulate`` skip
the score or the accumulating products. The port does not use this script.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

SHAPES = ("qwen2.5 [1,512,10,2,128]", "minitron [1,512,8,2,128]", "stablelm [1,512,8,2,160]",
          "recurrentgemma [4,512,10,1,256]", "qwen2-vl M-RoPE [4,512,12,2,128]",
          "granite [4,512,16,8,64]", "smollm [8,512,15,5,64]", "musicgen [4,512,32,32,64]")
SUM = ("            x = c ? x + p[q * 32] : p[q * 32];\n"
       "            y = c ? y + p[(kNT * 4 + q) * 32] : p[(kNT * 4 + q) * 32];\n")
OWN = ("            if (c == cg) x = p[q * 32];\n"
       "            if (c == cg) y = p[(kNT * 4 + q) * 32];\n")
EXP = "ok ? expf(x - l) : 0.0f"
SPLIT = "      split_tile<DP, kDQ>(a, s, sm);\n"
SCORE = "      for (int kk = 0; kk < kKK; ++kk) {\n        const int o = lm + cg * kCols + kk * 8;\n"
ACC = "      for (int kk = 0; kk < kNT; ++kk) {\n        unsigned sh[4], sl[4];\n"
MINB = "static constexpr int kMinBlocks = 512 / kThreads > 1 ? 512 / kThreads : 1;"
VARIANTS = {  # name: ([(old, new)], checked)
    "base": ([], True),
    "splits1": ([], True),  # the shipped source, every block of fixed rows one CTA
    "splits-x4": ([], True),  # the shipped source, splits up to 4 CTAs an SM
    "min1": ([(MINB, "static constexpr int kMinBlocks = 1;")], True),
    "min2-d160": ([(MINB, "static constexpr int kMinBlocks = DP == 160 ? 2 : 512 / kThreads > 1 ? "
                          "512 / kThreads : 1;")], True),
    "min3-d64": ([(MINB, "static constexpr int kMinBlocks = DP == 64 ? 3 : 512 / kThreads > 1 ? "
                         "512 / kThreads : 1;")], True),
    "no-exchange": ([(SUM, OWN)], False),
    "no-exp": ([(EXP, "ok ? (x - l) : 0.0f")], False),
    "no-split": ([(SPLIT, "")], False),
    "no-score": ([(SCORE, SCORE.replace("kk < kKK", "kk < 0"))], False),
    "no-accumulate": ([(ACC, ACC.replace("kk < kNT", "kk < 0"))], False),
}


def build(name: str, patches, src: str, build_dir: Path, nvcc: str, flags, csrc: Path):
    for old, new in patches:
        if old not in src:
            raise RuntimeError(f"variant {name}: patch target not in the source: {old!r}")
        src = src.replace(old, new)
    cu = build_dir / f"flash_attn_bwd_variant_{name}.cu"
    so = build_dir / f"libflash_attn_bwd_variant_{name}.so"
    cu.write_text(src)
    return subprocess.Popen([nvcc, *flags, "-I", str(csrc), "-o", str(so), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", default=None)
    ap.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated names")
    args = ap.parse_args()
    chosen = args.variants.split(",")
    if not torch.cuda.is_available():
        print("no CUDA card: this script times the kernel on the card")
        return 1
    import bench_attn_bwd as bench
    from repro_torch.kernels import _build, flash_attn_bwd, ops, ref

    _build.build(("flash_attn",))
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "flash_attn_bwd.cu").read_text()
    procs = {n: build(n, p, src, _build.BUILD_DIR, _build._nvcc(), _build.NVCC_FLAGS, _build.CSRC)
             for n, (p, _) in VARIANTS.items() if n in chosen}
    libs, ptxas = {}, {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc variant {name} failed:\n{out}")
        ptxas[name] = {k: v for k, v in _build.ptxas_entries(out).items()
                       if "dkv" in k or "dq_" in k}
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in flash_attn_bwd._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        libs[name] = lib
    dev = torch.device("cuda")
    max_splits, per_sm = flash_attn_bwd.MAX_SPLITS, flash_attn_bwd.SPLIT_CTAS_PER_SM
    rows = []
    for shape in SHAPES:
        (q, k, v, qpos, kpos, dout), window = bench.inputs(bench.CASES[shape], 7, dev)
        out, lse = ops._attention_fwd(q, k, v, qpos, kpos, True, window, with_lse=True)
        w_out, w_lse = ref.chunked_attention_ref(q, k, v, qpos, kpos, causal=True, window=window,
                                                 return_lse=True)
        want = ref.chunked_attention_bwd_ref(q, k, v, qpos, kpos, w_out, w_lse, dout,
                                             causal=True, window=window)
        for name, lib in libs.items():
            _build._LIBS["flash_attn_bwd"] = lib
            flash_attn_bwd.MAX_SPLITS = 1 if name == "splits1" else max_splits
            flash_attn_bwd.SPLIT_CTAS_PER_SM = 4 if name == "splits-x4" else per_sm
            bwd = lambda: ops.attention_bwd(q, k, v, qpos, kpos, out, lse, dout,  # noqa: E731
                                            window=window)
            try:
                got = bwd()
            except RuntimeError as e:  # e.g. more shared memory than an SM has
                print(f"[variant] {shape} {name:14s} refused: {e}", flush=True)
                rows.append({"shape": shape, "variant": name, "refused": str(e)})
                continue
            rel = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1.0)
                      for x, y in zip(got, want))
            if VARIANTS[name][1] and rel > bench.BWD_TOL:
                raise AssertionError(f"variant {name} at {shape}: {rel} of scale")
            us = bench.device_us(bwd, args.reps)
            parts = {p: sum(t for n, t in us.items() if p in n) for p in bench.PARTS}
            rows.append({"shape": shape, "variant": name, "device_us": sum(us.values()),
                         "parts_us": parts, "err_of_scale": rel})
            print(f"[variant] {shape} {name:14s} {sum(us.values()):9.2f} us: dK/dV "
                  f"{parts['dkv_kernel']:8.2f}, dQ {parts['dq_kernel']:8.2f}"
                  f"{'' if VARIANTS[name][1] else ' (not checked)'}", flush=True)
    _build._LIBS.pop("flash_attn_bwd", None)
    flash_attn_bwd.MAX_SPLITS, flash_attn_bwd.SPLIT_CTAS_PER_SM = max_splits, per_sm
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    result = {"smi": smi, "ptxas": ptxas, "rows": rows}
    if args.json:
        Path(args.json).write_text(json.dumps(result, indent=1))
    print(json.dumps({"smi": smi, "ptxas": ptxas}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
