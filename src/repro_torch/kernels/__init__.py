"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers and
their plain PyTorch versions (``ref.py``); ``ops.py`` is the public
entry point."""
