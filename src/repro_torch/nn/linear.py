"""Linear / projection layers: the port of ``repro.nn.linear``.

Model code routes every projection through :func:`dense`, which calls the
fused bias+activation matmul (K3): its kernel for a CUDA tensor, its
plain version for a CPU tensor.  Both accumulate in fp32 and apply the
bias and activation (gelu in its tanh form, as ``repro.nn.linear``)
before the one cast to x's dtype, where the JAX package's jnp path
applies them after its matmul's cast.

On a mesh (``sharding.ctx``) a column-parallel product (``wq``, ``wk``,
``wv``, ``w_gate``, ``w_up``: the output axis sharded) runs on the local
weight as on one card.  A row-parallel one (``wo``, ``w_down``: the
contraction axis ``k_axis`` sharded) has K3 store the fp32 partial, as
the TPU kernel stores it; ``sum_over`` adds the ranks' partials in rank
order, and then the bias, the activation and the one cast follow, so the
product is rounded once, as the whole one is.  A replicated activation
enters column-parallel products through :func:`column_input`, whose
backward sums the ranks' parts of its cotangent.

:func:`act_fn` is the port's copy of the JAX package's ``_ACTS``, for the
products that do not run K3 (the MoE experts, ``nn/moe.py``), with its
dtype rules: silu multiplies x by an fp32 sigmoid cast to x's dtype, gelu
(tanh form) and relu compute in x's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import ACC_DTYPE
from repro_torch.kernels.matmul_fused import ref as mm_ref
from repro_torch.kernels.matmul_fused.ops import matmul_fused
from repro_torch.nn.param import Param
from repro_torch.sharding.collectives import copy_to, sum_over
from repro_torch.sharding.ctx import shard_of

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


def dense(params, x, act: str = "none", k_axis=None):
    """y = act(x @ w + b) through K3 (``kernels.matmul_fused``).
    ``k_axis``: the logical axis of w's contraction (input) dimension;
    where the active sharding cuts it, the product is row-parallel."""
    if k_axis is not None:
        _, n, axes = shard_of(k_axis)
        if n > 1:
            y = sum_over(axes, matmul_fused(x, params["w"],
                                            out_dtype=ACC_DTYPE))
            if "b" in params:
                y = y + params["b"].to(ACC_DTYPE)
            return mm_ref._ACTS[act](y).to(x.dtype)
    return matmul_fused(x, params["w"], params.get("b"), act=act)


def column_input(x, out_axis: str):
    """``x`` as the input of column-parallel products whose output axis is
    the logical ``out_axis``: through ``copy_to`` where the active sharding
    cuts that axis (each rank's product then gives a part of x's
    cotangent, summed over the ranks in rank order), else ``x``."""
    _, n, axes = shard_of(out_axis)
    return copy_to(axes, x) if n > 1 else x
