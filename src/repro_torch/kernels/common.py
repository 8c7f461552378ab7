"""Kernel-wide constants, the device rule of the port and the record of
a wrapper's launch geometry (``Launch``, ``LaunchGeometryError``).

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
from typing import NamedTuple, Optional, Union

import torch

ACC_DTYPE = torch.float32

#: the guard pass's run while guard mode is on
#: (``repro_torch.analysis.guard.guarded``), else None
_guard = None


class LaunchGeometryError(ValueError):
    """A launch geometry the kernel cannot take.  ``kind`` names what
    does not fit: ``"smem"`` (a block's shared memory), ``"scratch"``
    (the stage-major scratch's 32-bit offsets) or ``"floor"`` (even the
    smallest geometry of the launch: K7 at one tile group, K8 at one
    channel)."""

    def __init__(self, msg: str, kind: str):
        super().__init__(msg)
        self.kind = kind


class Launch(NamedTuple):
    """A wrapper's launch geometry for one call signature: the function
    that computed it (``chain_launch``, ``k7_launch`` and ``k8_launch``,
    memoized, or K9's ``pool_launch``), its arguments and what it
    returned."""
    fn: str
    args: tuple
    geometry: tuple


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


def alloc(spec, dtype=None, device=None, *, scratch: bool = False):
    """A wrapper's output or scratch tensor: ``torch.empty(spec, dtype=,
    device=)`` for a shape, ``torch.empty_like(spec)`` for a tensor.
    Under guard mode, a tensor inside a guarded buffer, prefilled."""
    g = _guard
    if g is not None:
        return g.alloc(spec, dtype, device, scratch)
    if isinstance(spec, torch.Tensor):
        return torch.empty_like(spec)
    return torch.empty(spec, dtype=dtype, device=device)


def operand(t):
    """What a wrapper hands its C entry for input ``t`` (a tensor or a
    host array): ``t`` itself, or under guard mode a staged copy in a
    guarded buffer."""
    g = _guard
    return t if g is None or t is None else g.stage_operand(t)


def operand_ptrs(arrays, ptrs):
    """The addresses of the read-only host arrays ``arrays`` a C entry
    reads: ``ptrs``, memoized beside them, or under guard mode those of
    their staged copies (``operand``)."""
    if _guard is None:
        return ptrs
    return tuple(operand(a).ctypes.data for a in arrays)


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
