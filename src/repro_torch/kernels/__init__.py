"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), their
launch wrappers, and their plain PyTorch versions (``ref``). Nothing is
compiled or loaded from CUDA at import time."""
