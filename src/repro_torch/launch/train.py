"""Training driver: config-driven, checkpointed, resumable.

The reference's ``repro/launch/train.py`` on the port: random weights from
``seed``, batches from the step-keyed :class:`TokenStream` (a restart sees
the same data), periodic atomic checkpoints in the reference's format with
automatic resume from the latest step, and a per-step wall-clock watchdog
that flags stragglers. Runs on the card unless ``device`` says otherwise;
attention runs the hand-written forward and backward kernels there. Every
architecture but the VLM trains here: like the reference's ``train``, this
one makes no patch embeddings (``qwen2-vl-2b`` trains through
``models.tasks.make_train_step``).

  python -m repro_torch.launch.train --arch smollm-360m --reduced \\
      --steps 200 --global-batch 8 --seq-len 128 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.checkpoint.ckpt import latest_step, restore, save_every
from repro_torch.configs import get_arch, reduce_arch
from repro_torch.core.network import _resolve_device
from repro_torch.data.synthetic import TokenStream
from repro_torch.models.tasks import init_train_state, make_train_step
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.precision import POLICIES, get_policy

__all__ = ["train"]


def train(arch: str, *, steps: int = 200, global_batch: int = 8, seq_len: int = 128,
          policy_name: str = "fp16", reduced: bool = True, ckpt_dir: str | None = None,
          ckpt_interval: int = 50, lr: float = 1e-3, seed: int = 0, log_every: int = 10,
          straggler_factor: float = 3.0, device=None, mesh=None) -> dict:
    """Train ``steps`` steps (resuming from ``ckpt_dir``'s latest step) and
    return ``first_loss``, ``final_loss``, ``losses`` (the steps run here),
    ``times`` (host seconds per step, each ending with the loss read back)
    and ``state``. ``device`` None is the card, raising without one (with
    ``mesh``: its first device). With ``mesh`` (a device-list mesh,
    ``launch/mesh.make_host_mesh``) the step runs over the mesh's lowering
    (``models/tasks.make_train_step(mesh=)``) and ``state`` comes back
    sharded; checkpoints gather it into the same file format."""
    if device is None and mesh is not None:
        device = mesh.devices.flat[0]
    device = _resolve_device(device)
    cfg = get_arch(arch)
    if cfg.frontend == "vision":
        raise ValueError(f"{arch}: train makes no patch_embeds for the vision "
                         "frontend; run it through models.tasks' step functions")
    if reduced:
        cfg = reduce_arch(cfg)
    policy = get_policy(policy_name)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(10, steps // 20))

    state = init_train_state(cfg, policy, seed=seed, opt_cfg=opt_cfg, device=device)
    start = 0
    if ckpt_dir:
        last = latest_step(ckpt_dir)
        if last is not None:
            state = restore(ckpt_dir, last, state)
            start = last
            print(f"resumed from step {last}")

    step_fn = make_train_step(cfg, policy, mesh=mesh, seq_shard=mesh is not None,
                              opt_cfg=opt_cfg, ce_chunk=min(512, seq_len))
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=seq_len,
                         global_batch=global_batch, seed=seed)

    losses, times = [], []
    for step in range(start, steps):
        t0 = time.time()
        batch = {"tokens": stream.batch(step)["tokens"].to(device)}
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        losses.append(loss)
        times.append(dt)
        if len(times) > 3:  # straggler watchdog (post-warmup median)
            med = float(np.median(times[3:]))
            if dt > straggler_factor * med and med > 0:
                print(f"[watchdog] step {step} took {dt:.2f}s "
                      f"(median {med:.2f}s) — straggler suspected")
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"scale {float(metrics['loss_scale']):8.0f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} {dt * 1e3:7.1f} ms",
                  flush=True)
        if ckpt_dir:
            save_every(ckpt_dir, step + 1, state, interval=ckpt_interval)

    return {"final_loss": losses[-1] if losses else None,
            "first_loss": losses[0] if losses else None,
            "losses": losses, "times": times, "state": state}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    help="any architecture of repro_torch.configs.ARCH_NAMES but the VLM")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--policy", default="fp16", choices=sorted(POLICIES))
    ap.add_argument("--reduced", action="store_true", default=False)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-3)
    args = ap.parse_args()
    out = train(args.arch, steps=args.steps, global_batch=args.global_batch,
                seq_len=args.seq_len, policy_name=args.policy, reduced=args.reduced,
                ckpt_dir=args.ckpt_dir, ckpt_interval=args.ckpt_interval, lr=args.lr)
    if out["losses"]:
        print(f"loss {out['first_loss']:.4f} -> {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
