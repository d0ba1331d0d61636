"""Checkpoints in the reference's npz format (``repro.checkpoint.ckpt``)."""
from repro_torch.checkpoint.ckpt import latest_step, restore, save, save_every, step_path

__all__ = ["latest_step", "restore", "save", "save_every", "step_path"]
