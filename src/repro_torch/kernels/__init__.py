"""The port's kernels: CUDA C++ for Hopper (``csrc/``), their ctypes
wrappers with launch counters (``ops``), and their plain PyTorch versions
(``ref``).  Nothing is built or loaded at import time."""
