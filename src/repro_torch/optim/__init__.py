"""Optimizers (``repro/optim``)."""
