"""Hand-written CUDA kernels for Hopper, their launchers, and their plain
PyTorch versions (``ref``)."""
