"""The dense STDP run launcher's tile shape and latency chain, on the card.

    python3 scripts/bench_stdp_update_tiles.py

Builds copies of ``src/repro_torch/kernels/csrc/stdp_update.cu`` into
``build/torch_kernels/`` with other tile shapes (``kRows`` rows per CTA,
one thread per column of ``kThreads``) and two variants of the shipped
shape: ``no_lookup`` finds a CTA's projection by arithmetic instead of
loading the projections' first tiles (right only for projections of one
shape, as here), and ``no_weight_io`` stores no weight, so the compiler
drops the weight and mask loads too, and ``empty`` returns at once, the
same grid's bare launch (the outputs of these two are wrong by design
and not checked). Each of the others is checked against the plain version
(``ref.stdp_update_run_ref``) on one tick of the plastic Synfire4 packed
fp16 chain (four [200, 200] projections). Prints the kernel's time alone
on the device (``torch.profiler``, 100 launches, the mean) and per call
(CUDA events, host enqueue included). The port does not use it.
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

ROWS = "constexpr int kRows = 4;  // rows per tile"
COLS = "constexpr int kThreads = 256;  // columns per tile, one thread each"
LOOKUP = "__ldg(plan.begins + j) <= tile_id"
ENTRY = "  const int tile_id = static_cast<int>(blockIdx.x);\n"
STORE = "    if (r < rows) {\n      w[static_cast<long long>(r) * p.Q]"
# name -> (patches, checked against the plain version)
VARIANTS = {
    **{f"{r}x{c}": ([(ROWS, f"constexpr int kRows = {r};"),
                     (COLS, f"constexpr int kThreads = {c};")], True)
       for r, c in ((1, 128), (2, 128), (4, 128), (8, 128), (16, 128), (8, 64), (8, 256),
                    (4, 256))},
    "no_lookup": ([(LOOKUP, "j * (plan.n_tiles / plan.n_projs) <= tile_id")], True),
    "no_weight_io": ([(STORE, STORE.replace("r < rows", "r < rows && pre_s[r] > 2.0f"))],
                     False),
    "empty": ([(ENTRY, ENTRY + "  if (tile_id >= 0) return;\n")], False),
}


def _build_variants() -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels import stdp_update as sup

    src = (_build.CSRC / "stdp_update.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (patches, _) in VARIANTS.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in stdp_update.cu")
            text = text.replace(old, new)
        cu = _build.BUILD_DIR / f"stdp_update_variant_{name}.cu"
        so = _build.BUILD_DIR / f"libstdp_update_variant_{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-I", str(_build.CSRC), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc variant {name} failed:\n{out.decode()}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in sup._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_stdp_update_tiles: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs.synfire4 import CHAIN_STDP, SYNFIRE4, build_synfire
    from repro_torch.core import backend as be
    from repro_torch.kernels import _build, ref

    libs = _build_variants()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(f"[tiles] {smi}")
    net = build_synfire(SYNFIRE4, policy="fp16", propagation="packed", stdp_chain=CHAIN_STDP,
                        device=dev)
    g = torch.Generator(device="cpu").manual_seed(3)
    weights, stdp = cs._plastic_tables(net, g, dev)
    spikes = (torch.rand(net.static.n, generator=g) < 0.3).float().to(dev)
    for name, lib in libs.items():
        _build._LIBS["stdp_update"] = lib
        run = be.assemble_stdp_update(net.static, net.params, weights, stdp)
        plain = cs._dense_plain_copy(run.projs)
        run(spikes)
        ref.stdp_update_run_ref(spikes, plain, 0)
        torch.cuda.synchronize()
        checked = VARIANTS[name][1]
        if checked:
            cs._require_same_dense(run.projs, plain, f"variant {name}")
        device = cs.device_ms(lambda: run(spikes), "stdp_update_run_kernel")
        per_call = cs.cuda_ms(lambda: run(spikes))
        print(f"[tiles] {name:12s} {run.launcher.items:4d} CTAs: {device * 1e3:.2f} us on "
              f"the device, {per_call * 1e3:.2f} us per call"
              + (" (bitwise against the plain version)" if checked else " (not checked)"),
              flush=True)
    _build._LIBS.pop("stdp_update", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
