"""repro_torch: the SNN simulator of ``repro`` on PyTorch and CUDA.

The port mirrors ``src/repro/`` path for path and imports neither JAX nor
``repro``. Its entry points (``configs.synfire4.build_synfire``,
``core.NetworkBuilder.compile``, ``core.engine.run``) run on the card,
through the hand-written kernels under ``kernels/csrc``; ``device="cpu"``
runs the kernels' plain PyTorch versions instead.
"""
