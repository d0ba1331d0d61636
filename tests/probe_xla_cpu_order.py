"""Where the port's CPU arithmetic and the reference's compiled arithmetic
part, on the CPU: two probes of XLA CPU against PyTorch.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/probe_xla_cpu_order.py

1. The plastic fan-in drive's f32 row sum, ``x.sum(axis=1)`` over ``[200,
   F]`` random products, compiled at ``xla_backend_optimization_level=0``
   (how the plastic engine tests compile the reference): per F, the rows
   where a left-to-right sum, ``torch.sum`` and the port's
   ``core/backend.xla_cpu_row_sum`` (XLA CPU's tree reduction rewriter:
   windows of 32) differ from it.
2. RMSNorm's ``jax.lax.rsqrt`` against ``torch.rsqrt`` and ``1 /
   torch.sqrt`` over 10^6 f32 inputs in [1e-3, 1e3): the inputs where they
   differ.

Prints one JSON object. Imports both packages, as the tests do; the port
does not use it.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.core.backend import xla_cpu_row_sum  # noqa: E402

FANINS = (20, 40, 60, 76, 81, 100, 200)


def _left_to_right(x: np.ndarray) -> np.ndarray:
    acc = np.zeros(x.shape[0], np.float32)
    for k in range(x.shape[1]):
        acc = (acc + x[:, k]).astype(np.float32)
    return acc


def row_sums(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    fn = jax.jit(lambda a: a.sum(axis=1))
    out = {}
    for f in FANINS:
        x = (rng.random((200, f), dtype=np.float32)
             * (rng.random((200, f), dtype=np.float32) * 3)).astype(np.float32)
        j = jnp.asarray(x)
        want = np.asarray(fn.lower(j).compile(
            compiler_options={"xla_backend_optimization_level": 0})(j))
        t = torch.from_numpy(x)
        out[f] = {name: int((got != want).sum()) for name, got in (
            ("left_to_right", _left_to_right(x)),
            ("torch_sum", t.sum(dim=1).numpy()),
            ("xla_cpu_row_sum", xla_cpu_row_sum(t).numpy()))}
    return out


def rsqrt(seed: int = 1, n: int = 1_000_000) -> dict:
    rng = np.random.default_rng(seed)
    x = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), n)).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(x)))
    t = torch.from_numpy(x)
    return {"inputs": n,
            "torch_rsqrt": int((torch.rsqrt(t).numpy() != want).sum()),
            "one_over_torch_sqrt": int(((1.0 / torch.sqrt(t)).numpy() != want).sum())}


def main() -> None:
    print(json.dumps({"jax": jax.__version__, "torch": torch.__version__,
                      "rows_differing_of_200": row_sums(), "rsqrt_differing": rsqrt()}))


if __name__ == "__main__":
    main()
