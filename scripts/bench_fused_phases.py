"""Where a fused tick's time goes, on the card: the kernel with one of its
phases switched off.

    python3 scripts/bench_fused_phases.py

Builds patched copies of ``src/repro_torch/kernels/csrc/fused_tick.cu``
into ``build/torch_kernels/`` (each variant removes one part of the
tick; their outputs are wrong by design and are not checked) and times
200 ticks of each, per call between CUDA events, on Synfire4 fp16 packed
and sparse and Synfire4x100 fp16 sparse states: ``full`` (the kernel as
shipped), ``no_csr`` (no CSR row drives), ``no_cols`` (no per-column
drives or ring commits), ``barriers_only`` (phase 1, the barriers and the
bitmask staging), ``csr_no_w`` (CSR rows without the weight loads),
``csr_idx_only`` (CSR rows reading the index tables only). Each line
prints the grid the launcher chose for that build. The port does not use
it.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

NO_CSR = ("  if (n_csr > 0) {", "  if (false) {")
NO_COLS = ("for (int q = blockIdx.x * kThreads + threadIdx.x; q < n;", "for (int q = n; q < n;")
W_LOAD = "spiked(s_words, j[r][u]) ? wrow[r][k] : 0.0f"
VARIANTS = {
    "full": [], "no_csr": [NO_CSR], "no_cols": [NO_COLS], "barriers_only": [NO_CSR, NO_COLS],
    "csr_no_w": [(W_LOAD, "spiked(s_words, j[r][u]) ? 1.0f : 0.0f")],
    "csr_idx_only": [(W_LOAD, "static_cast<float>(j[r][u])")],
}


def _build_variants() -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_tick as ftk

    src = (_build.CSRC / "fused_tick.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in fused_tick.cu")
            text = text.replace(old, new)
        cu = _build.BUILD_DIR / f"fused_phase_{name}.cu"
        so = _build.BUILD_DIR / f"libfused_phase_{name}.so"
        cu.write_text(text)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-I", str(_build.CSRC),
                        "-o", str(so), str(cu)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in ftk._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_fused_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs.synfire4 import SYNFIRE4, build_synfire, scale_synfire
    from repro_torch.kernels import _build, ops

    libs = _build_variants()
    dev = torch.device("cuda", 0)
    print(f"[phases] {torch.cuda.get_device_name(0)}")
    x100 = dict(budget=None, monitor_ms_hint=0)
    for label, cfg, prop, kw in (("synfire4 packed", SYNFIRE4, "packed", {}),
                                 ("synfire4 sparse", SYNFIRE4, "sparse", {}),
                                 ("x100 sparse", scale_synfire(SYNFIRE4, 100), "sparse", x100)):
        net = build_synfire(cfg, policy="fp16", propagation=prop, device=dev,
                            backend="fused", **kw)
        net, _, payload, args = cs._fused_state(None, None, None, dev, {}, net=net)
        n = net.static.n
        for name, lib in libs.items():
            _build._LIBS["fused_tick"] = lib
            rows = torch.zeros((230, n), dtype=torch.bool, device=dev)
            v, u, ring = args[0].clone(), args[1].clone(), args[2].clone()
            runner = ops.FusedTickRun(payload, v, u, ring, *args[4:], rows)
            counter = iter(range(10**9))

            def tick():
                i = next(counter)
                runner.tick(i % 230, 60 + i)

            t = min(cs.cuda_ms(tick, reps=200) for _ in range(2))
            print(f"[phases] {label:16s} {name:14s} grid {runner.launcher.grid:4d}: "
                  f"{t * 1e3:.2f} us per tick", flush=True)
        _build._LIBS.pop("fused_tick", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
