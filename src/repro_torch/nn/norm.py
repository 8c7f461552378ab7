"""Normalization layers (RMSNorm, LayerNorm) with fp32 statistics: the
port of ``repro.nn.norm``."""
from __future__ import annotations

import torch

from repro_torch.nn.param import Param


def rmsnorm_spec(dim: int) -> dict:
    return {"scale": Param((dim,), ("embed",), init="ones", dtype="float32")}


def rmsnorm_apply(params, x, eps: float = 1e-6, plus_one: bool = False):
    """RMSNorm.  ``plus_one=True`` uses the gemma convention scale=(1+w)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * (var + eps) ** -0.5
    w = params["scale"].float()
    if plus_one:
        w = 1.0 + w
    return (xf * w).to(x.dtype)


def layernorm_spec(dim: int) -> dict:
    return {
        "scale": Param((dim,), ("embed",), init="ones", dtype="float32"),
        "bias": Param((dim,), ("embed",), init="zeros", dtype="float32"),
    }


def layernorm_apply(params, x, eps: float = 1e-6):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * (var + eps) ** -0.5
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)
