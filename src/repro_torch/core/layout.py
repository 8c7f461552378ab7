"""Dimension swapping — the paper's §4.3 layout transformation (NCHW ⇄
NHWC, OIHW ⇄ HWIO) and zero padding of one axis.  Public functions of the
port keep the JAX package's layouts (NCHW activations, OIHW weights)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def oihw_to_hwio(k: torch.Tensor) -> torch.Tensor:
    """Kernel layout swap: [out_c, in_c, kh, kw] -> [kh, kw, in_c, out_c]."""
    return k.permute(2, 3, 1, 0)


def pad_axis(x: torch.Tensor, axis: int, multiple: int):
    """Zero-pad ``axis`` up to the next multiple; returns (padded, orig_size)."""
    axis = axis % x.ndim
    size = x.shape[axis]
    pad = (-size) % multiple
    if pad == 0:
        return x, size
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]  # F.pad: last dim first
    return F.pad(x, widths), size
