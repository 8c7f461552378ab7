"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
PyTorch versions.  A wrapper takes the plain version for a tensor on the
CPU and launches its kernel for a tensor on a CUDA device."""
