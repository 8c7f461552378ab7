"""Linear / projection layers: the port of ``repro.nn.linear``.

Model code routes every projection through :func:`dense`, which calls the
fused bias+activation matmul (K3): its kernel for a CUDA tensor, its
plain version for a CPU tensor.  Both accumulate in fp32 and apply the
bias and activation (gelu in its tanh form, as ``repro.nn.linear``)
before the one cast to x's dtype, where the JAX package's jnp path
applies them after its matmul's cast.

:func:`act_fn` is the port's copy of the JAX package's ``_ACTS``, for the
products that do not run K3 (the MoE experts, ``nn/moe.py``), with its
dtype rules: silu multiplies x by an fp32 sigmoid cast to x's dtype, gelu
(tanh form) and relu compute in x's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.matmul_fused.ops import matmul_fused
from repro_torch.nn.param import Param

_ACTS = {
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "silu": lambda x: x * (1.0 / (1.0 + torch.exp(-x.float()))).to(x.dtype),
    "gelu": lambda x: 0.5 * x * (1.0 + torch.tanh(
        0.7978845608028654 * (x + 0.044715 * x ** 3))),
    "none": lambda x: x,
}


def act_fn(name: str):
    return _ACTS[name]


def linear_spec(
    d_in: int,
    d_out: int,
    in_axis: str = "embed",
    out_axis: str = "ff",
    bias: bool = False,
    init: str = "fan_in",
    scale: float = 1.0,
) -> dict:
    spec = {"w": Param((d_in, d_out), (in_axis, out_axis), init=init,
                       scale=scale)}
    if bias:
        spec["b"] = Param((d_out,), (out_axis,), init="zeros", dtype="float32")
    return spec


def dense(params, x, act: str = "none"):
    """y = act(x @ w + b) through K3 (``kernels.matmul_fused``)."""
    return matmul_fused(x, params["w"], params.get("b"), act=act)
