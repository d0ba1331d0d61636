"""The plastic fan-in drive kernel's layout, on the card.

    python3 scripts/bench_drive_layouts.py

Builds copies of ``src/repro_torch/kernels/csrc/plastic_drive.cu`` into
``build/torch_kernels/`` with other layouts: ``{w}w-b{b}{s}`` runs ``w``
warps a block (one accumulator entry and group of lanes each) and keeps
``b`` windows' loads in flight together, ``s`` on an STP row (the
shipped source: 4w-b42; 8w-b42 the larger block); ``min5`` asks ptxas for 5 blocks an SM (at most
102 registers a thread); ``fit-unchecked`` drops the kernel's test that a
row's lanes fit the warp side by side (the launcher's group makes it true);
``group1`` is the shipped source with one lane a
warp (the launcher's ``group`` set to 1: one warp per (entry, lane));
``shuffle`` sums each staged window with one chain of 32 ``__shfl_sync``
adds over the warp, window after window, in place of one thread per
window summing its staged row, window beside window; ``empty`` returns
at once, the same grid's bare launch (its output is wrong by design and
not checked). Each of the others lands, bit for bit, what the plain version
(``ref.drive_run_ref``) lands, on the plastic chain of Synfire4 fp16
sparse (one lane and 64 lanes) and packed, of plastic x10 fp16 sparse,
and on an STP net (F = 20). Prints ptxas' report of each build and the
kernel's time alone on the device (``torch.profiler``, 100 launches, the
mean) for every variant and case. The port does not use it.
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

WARPS = "constexpr int kWarps = 4;"
BATCH = "constexpr int kBatch = 4;"
SIDE_SUM = "      const float s = window_sum(stage, lane);\n      const int from"
DEEP_SUM = "      const float s = window_sum(stage, lane);\n      const bool in"
BEFORE = "  // The row's drive on lanes b0"
SHUFFLE = """  __device__ __forceinline__ float shuffle_sum(const float* stage, int count,
                                               int lane) const {
    __syncwarp();
    float s = 0.0f;
    for (int i = 0; i < count; ++i) {
      const float si = warp_chain(stage[i * kStride + lane], 0, kWindow);
      if (lane == i) s = si;
    }
    __syncwarp();
    return s;
  }

"""
BOUNDS = "__global__ void __launch_bounds__(kWarps * 32)"
ENTRY = "  const int t = blockIdx.x * kWarps + warp;\n"
BATCH_STP = "constexpr int kBatchStp = 2;"
FIT = "    if (p.levels <= 1 && lanes * n1 <= kWindow) {"
# name -> (patches, checked against the plain version, lanes a warp: None the launcher's)
VARIANTS = {
    **{f"{w}w-b{b}{s}": ([(WARPS, f"constexpr int kWarps = {w};"),
                          (BATCH, f"constexpr int kBatch = {b};"),
                          (BATCH_STP, f"constexpr int kBatchStp = {s};")], True, None)
       for w, b, s in ((4, 4, 2), (8, 4, 2))},
    "min5": ([(BOUNDS, BOUNDS.replace("kWarps * 32)", "kWarps * 32, 5)"))], True, None),
    "fit-unchecked": ([(FIT, "    if (p.levels <= 1) {")], True, None),
    "group1": ([], True, 1),
    "shuffle": ([(SIDE_SUM, SIDE_SUM.replace("window_sum(stage, lane)",
                                             "shuffle_sum(stage, lanes * n1, lane)")),
                 (DEEP_SUM, DEEP_SUM.replace("window_sum(stage, lane)",
                                             "shuffle_sum(stage, hi - lo, lane)")),
                 (BEFORE, SHUFFLE + BEFORE)], True, None),
    "empty": ([(ENTRY, ENTRY + "  if (t >= 0) return;\n")], False, None),
}


def _build_variants() -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels import plastic_drive as pd

    src = (_build.CSRC / "plastic_drive.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (patches, _, _) in VARIANTS.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in plastic_drive.cu")
            text = text.replace(old, new)
        cu = _build.BUILD_DIR / f"plastic_drive_variant_{name}.cu"
        so = _build.BUILD_DIR / f"libplastic_drive_variant_{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc variant {name} failed:\n{out.decode()}")
        for line in out.decode().splitlines():
            if "stack frame" in line or "registers" in line:
                print(f"[layouts] {name:13s} {line.strip()}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in pd._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def _cases(dev, g) -> list:
    """``(what, net, lanes)`` for each timed case."""
    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, SYNFIRE4_X10, build_synfire
    from repro_torch.core import NetworkBuilder, izh4
    from repro_torch.core.synapses import STPConfig

    def synfire(cfg, propagation):
        return build_synfire(cfg, policy="fp16", propagation=propagation, stdp_chain=CHAIN_STDP,
                             device=dev, budget=None, monitor_ms_hint=0)

    b_ = NetworkBuilder(seed=0)
    b_.add_spike_generator("g", 50, rate_hz=200.0)
    b_.add_group("n", izh4(20, a=0.02, b=0.2, c=-65.0, d=8.0))
    b_.connect("g", "n", fanin=20, weight=0.3, delay_ms=1,
               stp=STPConfig(u0=0.45, tau_f=50.0, tau_d=750.0))
    sparse = synfire(SYNFIRE4, "sparse")
    return [("Synfire4 sparse", sparse, None), ("Synfire4 sparse, 64 lanes", sparse, 64),
            ("Synfire4 packed", synfire(SYNFIRE4, "packed"), None),
            ("x10 sparse", synfire(SYNFIRE4_X10, "sparse"), None),
            ("STP net", b_.compile(policy="fp16", device=dev), None)]


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_drive_layouts: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops, ref

    libs = _build_variants()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(f"[layouts] {smi}")
    g = torch.Generator(device="cpu").manual_seed(22)
    for what, net, lanes in _cases(dev, g):
        n = net.static.n
        projs_on, acc, weights, stp, _ = cs._drive_case(net, g, dev, lanes)
        if lanes is None:
            spikes = (torch.rand(n, generator=g) < 0.3).float().to(dev)
        else:
            spikes = cs._lane_spike_rows(g, n, dev)
        want = acc.clone()
        ref.drive_run_ref(spikes, projs_on(want), weights, stp)
        for name, lib in libs.items():
            _build._LIBS["plastic_drive"] = lib
            got = acc.clone()
            run = ops.DriveRun(n, projs_on(got), lanes=lanes)
            group = VARIANTS[name][2]
            if group is not None:
                run.launcher._plan.group = group
            run(spikes, weights, stp)
            torch.cuda.synchronize()
            checked = VARIANTS[name][1]
            if checked:
                cs._require_bitwise(got, want, f"variant {name} on {what}")
            device = cs.device_ms(lambda: run(spikes, weights, stp), "plastic_drive_kernel")
            print(f"[layouts] {what:26s} {name:13s} {device * 1e3:8.2f} us on the device "
                  f"({run.launcher.group if group is None else group} lanes a warp)"
                  + (" (bitwise against the plain version)" if checked else " (not checked)"),
                  flush=True)
    _build._LIBS.pop("plastic_drive", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
