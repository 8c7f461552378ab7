"""PyTorch and CUDA port of the CNNdroid engine (``repro``'s JAX package).

The same networks, plans and fused layer groups as ``repro``, run with
PyTorch on an NVIDIA Hopper GPU.  Each TPU kernel on the engine's main
path is a CUDA C++ kernel in ``csrc/``, built with ``nvcc`` at first use;
each has a plain PyTorch version beside it, which runs when the tensors
lie on the CPU.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
