"""Plain PyTorch version of the fused bias+activation matmul (K3)."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import ACC_DTYPE

_ACTS = {
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "silu": lambda x: x * (1.0 / (1.0 + torch.exp(-x))),
    "gelu": lambda x: 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 *
                                                  (x + 0.044715 * x ** 3))),
    "none": lambda x: x,
}


def matmul_fused_ref(x, w, b=None, act: str = "none"):
    """y = act(x @ w + b) with fp32 accumulation.  x: [M, K]; w: [K, N].
    A bf16 operand is upcast, the sums, bias and activation are fp32, and
    the result is cast once to x's dtype."""
    y = x.to(ACC_DTYPE) @ w.to(ACC_DTYPE)
    if b is not None:
        y = y + b.to(ACC_DTYPE)
    return _ACTS[act](y).to(x.dtype)
