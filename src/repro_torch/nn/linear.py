"""Linear / projection layers: the port of ``repro.nn.linear``.

Model code routes every projection through :func:`dense`, which calls the
fused bias+activation matmul (K3): its kernel for a CUDA tensor, its
plain version for a CPU tensor.  Both accumulate in fp32 and apply the
bias and activation (gelu in its tanh form, as ``repro.nn.linear``)
before the one cast to x's dtype, where the JAX package's jnp path
applies them after its matmul's cast.
"""
from __future__ import annotations

from repro_torch.kernels.matmul_fused.ops import matmul_fused
from repro_torch.nn.param import Param


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
