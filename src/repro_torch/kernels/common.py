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

import functools
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
    device, contiguous, a type the kernel takes, the same for all.  The
    wrappers call it on every launch, so it reads each tensor's device,
    type and layout once."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if dtype not in dtypes:
        raise TypeError(f"{name}: the kernel takes {dtypes}, got {dtype}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{name}: operands of one type, got {dtype} and "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def check_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """What the fp32-only kernel wrappers require of their CUDA inputs."""
    check_cuda(name, *tensors, dtypes=(torch.float32,))


def sm_count(dev: torch.device) -> int:
    """SMs of CUDA device ``dev`` (its index, or the current device)."""
    return _sm_count_of(dev.index if dev.index is not None
                        else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sm_count_of(index: int) -> int:
    """SMs of CUDA device ``index``, read once: the wrappers ask on every
    call."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_handle(dev: torch.device) -> int:
    """The ``cudaStream_t`` of the current stream on CUDA device ``dev``,
    as the C entries take it: read raw, without building a
    ``torch.cuda.Stream`` (the public call takes several microseconds, a
    good part of a small kernel's host time)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
