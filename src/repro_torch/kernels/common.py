"""Kernel-wide constants and the device rule of the port.

``ACC_DTYPE`` is the accumulation type of every kernel and plain version:
operands are read as fp32 (a bf16 operand is converted on load, or, on
K3's wgmma path, multiplied on the tensor cores, where the product of two
bf16 values is exact in fp32), sums are fp32, and there is one cast at
the store, to the operands' type.  The CNN kernels (K1, K2, K4-K9) take
fp32 tensors; K3 and K10 take fp32 or bf16, the same type for all their
operands.
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


def check_cuda(name: str, *tensors: torch.Tensor,
               dtypes=(torch.float32, torch.bfloat16)) -> None:
    """What every kernel wrapper requires of its CUDA inputs: one CUDA
    device, contiguous, a type the kernel takes, the same for all."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: the kernel takes {dtypes}, got {t.dtype}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: operands of one type, got {dtype} and "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def check_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """What the fp32-only kernel wrappers require of their CUDA inputs."""
    check_cuda(name, *tensors, dtypes=(torch.float32,))
