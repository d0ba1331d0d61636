"""Serving entry point: batched prefill → greedy decode with per-layer caches.

The reference's ``repro/launch/serve.py`` on the port: prefill builds the
decode cache in the policy's storage dtype (fp16 KV under the paper's
policy), then each decode step feeds back the argmax token. Attention runs
the hand-written kernel on the card. Parameters are random, drawn from
``seed`` (no published weights are read); prompts come from numpy
``default_rng(seed)`` exactly as in the reference, so both packages serve
the same prompts.

  python -m repro_torch.launch.serve --arch smollm-360m --full \\
      --batch 4 --prompt-len 512 --gen 32
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduce_arch
from repro_torch.core.network import _resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.tasks import make_decode_step, make_prefill_step
from repro_torch.precision import get_policy

__all__ = ["serve"]


def _clock(device: torch.device) -> float:
    """Host seconds, after the card has finished what was enqueued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@torch.inference_mode()
def serve(arch: str, *, batch: int = 4, prompt_len: int = 32, gen: int = 32,
          policy_name: str = "fp16", reduced: bool = True, seed: int = 0,
          capacity: int | None = None, params: tf.Transformer | None = None,
          device=None) -> dict:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens and decode
    ``gen`` tokens greedily (the first from the prefill's logits). Runs on
    the card unless ``device`` says otherwise (``params``, when given,
    must lie there). Returns the generated ``tokens`` ``[batch, gen]``
    (numpy), ``prefill_s``, ``decode_s`` (the ``gen - 1`` decode steps),
    ``decode_tok_s`` and ``batch``."""
    device = _resolve_device(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = reduce_arch(cfg)
    policy = get_policy(policy_name)
    capacity = capacity or (prompt_len + gen)
    if params is None:
        params = tf.init_params(cfg, policy, seed=seed, device=device)

    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int64)).to(device)

    prefill = make_prefill_step(cfg, policy, collect_cache=True, cache_len=capacity)
    decode = make_decode_step(cfg, policy)

    t0 = _clock(device)
    logits, cache = prefill(params, {"tokens": prompts})
    t_prefill = _clock(device) - t0

    token = torch.argmax(logits, dim=-1)[:, None]
    generated = [token]
    t0 = _clock(device)
    for i in range(gen - 1):
        logits, cache = decode(params, cache, token, prompt_len + i)
        token = torch.argmax(logits, dim=-1)[:, None]
        generated.append(token)
    t_decode = _clock(device) - t0

    tokens = torch.cat(generated, dim=1)
    return {
        "tokens": tokens.cpu().numpy().astype(np.int32),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_s": batch * (gen - 1) / t_decode if t_decode else 0.0,
        "batch": batch,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--policy", default="fp16")
    ap.add_argument("--full", action="store_true",
                    help="serve the architecture at its published widths and depth "
                         "(default: its reduced smoke-test variant)")
    args = ap.parse_args()
    out = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                policy_name=args.policy, reduced=not args.full)
    print(f"{torch.cuda.get_device_name()}: prefill {out['prefill_s'] * 1e3:.1f} ms, "
          f"decode {out['decode_tok_s']:.1f} tok/s (batch {out['batch']})")
    print("sample tokens:", out["tokens"][0, :16])


if __name__ == "__main__":
    main()
