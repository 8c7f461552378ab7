"""Kernel-wide constants and the device rule of the port.

``ACC_DTYPE`` is the accumulation type of every kernel and plain version:
operands are read as fp32, sums are fp32, and there is one cast at the
store.  The CUDA kernels take fp32 tensors only.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

ACC_DTYPE = torch.float32


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  With no GPU present and no device given it raises,
    rather than carrying on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def check_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """What every kernel wrapper requires of its CUDA inputs."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
