"""Hand-written Hopper kernels (CUDA C++, ``csrc/``) and their plain
PyTorch versions (``ref``); ``ops`` holds the wrappers the engine calls."""
