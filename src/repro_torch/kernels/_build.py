"""Build the CUDA kernels at first use and load them through ctypes.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). The library's file name carries a hash of its source and flags,
so an edited source never loads a stale build. Libraries land in
``build/torch_kernels/`` at the root of the checkout, which ``.gitignore``
lists. Every exported launcher returns the launch's ``cudaError_t``;
:func:`check` turns a non-zero code into a ``RuntimeError``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["KERNELS", "BUILD_DIR", "STORAGE_CODE", "build", "load", "check",
           "ptxas_entries"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
KERNELS = ("izh_update", "syn_matmul", "syn_gather", "fused_tick", "stdp_update",
           "stdp_gather", "plastic_drive", "flash_attn", "flash_attn_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The storage-type code a launch plan passes for a tensor's dtype (wtype,
# stype, the occupancy query's type; csrc/common.cuh round_to decodes it).
STORAGE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels build with the CUDA "
                       "toolkit's nvcc (on PATH or under /usr/local/cuda/bin)")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = KERNELS) -> dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, all
    ``nvcc`` processes at once. Returns per name ``{"seconds", "log"}``
    (``log`` holds ptxas' register and spill report; a cached library has
    seconds 0.0 and an empty log). Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    out: dict[str, dict] = {}
    for name in names:
        lib = _library_path(name)
        if lib.exists():
            out[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    failures = []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
        out[name] = {"seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with
    ``argtypes`` set from ``signatures`` and ``restype`` int on each
    launcher."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA launch failed with error {err} "
            f"({lib.error_string(err).decode()})")


def _entry_name(mangled: str) -> str:
    """A kernel entry's identifier and integer template arguments from its
    mangled name (``_ZN12_GLOBAL__N_110dkv_kernelILi128EEEvNS_4ArgsE`` ->
    ``dkv_kernel<128>``); an unmangled name as it is."""
    if not mangled.startswith("_Z"):
        return mangled
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    ident = None
    while rest[:1].isdigit():
        digits = re.match(r"\d+", rest).group(0)
        n = int(digits)
        ident, rest = rest[len(digits):len(digits) + n], rest[len(digits) + n:]
    if ident is None:
        return mangled
    if rest.startswith("I"):
        args = re.findall(r"L[a-z](-?\d+)E", rest[:rest.find("EE") + 1])
        return f"{ident}<{', '.join(args)}>"
    return ident


def ptxas_entries(log: str) -> dict[str, str]:
    """ptxas' report per kernel entry in one build's ``-v`` log: the
    entry's name (:func:`_entry_name`, e.g. ``dkv_kernel<128>``) to its
    stack/spill and register lines, joined. Empty for a cached build's
    empty log."""
    out: dict[str, str] = {}
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line:
            name = _entry_name(line.rsplit(" ", 1)[-1])
            out[name] = "; ".join(x.strip().removeprefix("ptxas info    : ")
                                  for x in lines[i + 1:i + 3])
    return out
