"""Time GEMV layouts for the M = 1 ``syn_matmul`` on the card.

    python3 scripts/bench_gemv_layouts.py

Builds ``scripts/gemv_layouts.cu`` with nvcc for sm_90a into
``build/torch_kernels/`` and, for the engine's shapes ([1, 200] x [200,
250] and [1, 50] x [50, 200]) and a large one ([1, 4096] x [4096,
4096]), f32, checks each layout against ``torch.matmul`` (bit for bit on
0/1 rows and integer weights) and prints its mean device time per launch
from a ``torch.profiler`` trace of 200 launches. It measures the choice
``csrc/syn_matmul.cu`` makes (a cluster only for long K); the port does
not use it.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

NAMES = {0: "first port, 32x8 scalar", 1: "cluster split-K, 8 warps",
         2: "no cluster, 8 warps", 3: "no cluster, 32 warps", 4: "no cluster, 16 warps",
         5: "empty kernel", 6: "cluster split-K, 32 warps"}


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_gemv_layouts: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _build.BUILD_DIR / "libgemv_layouts.so"
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(_build.CSRC), "-o",
                    str(lib_path), str(ROOT / "scripts" / "gemv_layouts.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.variant.argtypes = [i32, ptr, ptr, ptr, i32, i32, i32, ptr]
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"[gemv] {torch.cuda.get_device_name(0)}")
    for k, n in ((200, 250), (50, 200), (4096, 4096)):
        x = (torch.rand(k, device=dev) < 0.3).float()
        w = torch.randint(-4, 5, (k, n), device=dev).float()
        want = x @ w
        for v, name in NAMES.items():
            for ranks in ((1, 2, 4, 8) if v in (1, 6) else (1,)):
                out = torch.zeros(n, device=dev)

                def call():
                    err = lib.variant(v, x.data_ptr(), w.data_ptr(), out.data_ptr(), k, n,
                                      ranks, stream)
                    if err:
                        raise RuntimeError(f"variant {v}: CUDA error {err}")

                call()
                torch.cuda.synchronize()
                ok = v == 5 or torch.equal(out, want)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(200):
                        call()
                    torch.cuda.synchronize()
                spans = [e.time_range.elapsed_us() for e in prof.events()
                         if e.device_type == DeviceType.CUDA]
                print(f"[gemv] [1,{k}]x[{k},{n}] {name:26s} ranks={ranks}: equal={ok}, "
                      f"{sum(spans) / len(spans):.3f} us on the device "
                      f"({len(spans)} launches traced)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
