"""Hand-written CUDA kernels for Hopper (``csrc/``), their ``ctypes``
wrappers, and their plain PyTorch versions (``ref``)."""
