"""Wrapper of the fused bias+activation matmul kernel (K3,
``csrc/matmul_fused.cu``): the port of ``repro.kernels.matmul_fused``.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
(x and w both fp32 or both bf16, read as they are; the bias fp32) or
raises.  The path is chosen from the type, the shape and the pointers
alone, before the launch (``k3_path``): the weight stream below
``TILED_MIN_M`` rows, TMA + wgmma tiles for bf16 from there on when TMA
can describe both operands, CUDA-core tiles otherwise.  A refused launch
raises; nothing retries on another path.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_cuda
from repro_torch.kernels.matmul_fused.ref import _ACTS, matmul_fused_ref

ACT_CODES = {"none": 0, "relu": 1, "silu": 2, "gelu": 3}
COLS_PER_BLOCK = 512  # BN in csrc/matmul_fused.cu
KCHUNK_MAX = 512      # KMAX in csrc/matmul_fused.cu
BLOCKS_PER_SM = 4
PARTIAL_SHARE = 0.1   # partial sums may add at most this share of w's bytes
TILED_MIN_M = 64      # from this M on, a tiled path (no partials)
#: the C entry's path codes
PATH_CODES = {"stream": 0, "tiles": 1, "wgmma": 2}
TMA_ALIGN = 16        # bytes: TMA's base alignment and stride multiple


def tma_ok(k: int, n: int, x_ptr: int = 0, w_ptr: int = 0) -> bool:
    """True when TMA can describe bf16 ``x [m, k]`` and ``w [k, n]``: row
    strides ``2 k`` and ``2 n`` bytes multiples of 16 and both bases
    16-byte aligned."""
    return ((2 * k) % TMA_ALIGN == 0 and (2 * n) % TMA_ALIGN == 0
            and x_ptr % TMA_ALIGN == 0 and w_ptr % TMA_ALIGN == 0)


def k3_path(dtype, m: int, k: int, n: int, x_ptr: int = 0,
            w_ptr: int = 0) -> str:
    """The path of an ``[m, k] x [k, n]`` product of ``dtype`` operands at
    ``x_ptr``, ``w_ptr``: ``"stream"`` below ``TILED_MIN_M`` rows,
    ``"wgmma"`` for bf16 that TMA can describe, ``"tiles"`` otherwise."""
    if m < TILED_MIN_M:
        return "stream"
    if dtype == torch.bfloat16 and tma_ok(k, n, x_ptr, w_ptr):
        return "wgmma"
    return "tiles"


def split_k(m: int, n: int, k: int, sms: int):
    """``(splits, kchunk)`` of the weight-stream path (``m`` below
    ``TILED_MIN_M``) for an ``[m, k] x [k, n]`` product on a card with
    ``sms`` SMs: enough K slices for about ``BLOCKS_PER_SM`` blocks an SM,
    no more than keeps the ``[splits, m, n]`` partials under
    ``PARTIAL_SHARE`` of the weights, and slices of at most
    ``KCHUNK_MAX`` rows (the kernel's shared-memory x slice)."""
    tiles = math.ceil(n / COLS_PER_BLOCK) * math.ceil(m / 16)
    splits = math.ceil(BLOCKS_PER_SM * sms / tiles)
    splits = min(splits, max(1, int(PARTIAL_SHARE * k / m)))
    splits = max(1, min(splits, k))
    kchunk = math.ceil(k / splits)
    kchunk = min(KCHUNK_MAX, -(-kchunk // 4) * 4)
    return math.ceil(k / kchunk), kchunk


def _launch(x, w, b, act, path=None):
    """Launch K3 on CUDA tensors; ``path`` (default: ``k3_path``'s choice)
    may name another path, for timing one beside the other."""
    check_cuda("matmul_fused", x, w)
    m, k = x.shape
    n = w.shape[1]
    if b is not None:
        check_cuda("matmul_fused bias", b, dtypes=(torch.float32,))
        if b.shape != (n,) or b.device != x.device:
            raise ValueError(f"matmul_fused: bias {tuple(b.shape)} on "
                             f"{b.device}, expected ({n},) on {x.device}")
    chosen = k3_path(x.dtype, m, k, n, x.data_ptr(), w.data_ptr())
    path = chosen if path is None else path
    if path not in PATH_CODES or (path == "wgmma" and chosen != "wgmma"):
        raise ValueError(f"matmul_fused: path {path!r} cannot take "
                         f"{x.dtype} [{m}, {k}] x [{k}, {n}]")
    splits, kchunk, part = 0, 0, None
    if path == "stream":
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        splits, kchunk = split_k(m, n, k, sms)
        part = torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    entry = ("matmul_fused_bf16" if x.dtype == torch.bfloat16
             else "matmul_fused_f32")
    rc = getattr(_build.library(), entry)(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        None if part is None else part.data_ptr(), y.data_ptr(), m, n, k,
        PATH_CODES[path], splits, kchunk, ACT_CODES[act],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, entry)
    matmul_fused.launches += 1
    matmul_fused.path_launches[path] += 1
    return y


def matmul_fused(x, w, b=None, act: str = "none"):
    """y = act(x @ w + b).  Leading dims of x are flattened to M.  fp32
    accumulation, bias and activation; one cast to x's dtype."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"matmul_fused: x {tuple(x.shape)} vs w "
                         f"{tuple(w.shape)}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type == "cpu":
        y = matmul_fused_ref(x2, w, b, act)
    elif x2.device.type == "cuda":
        y = _launch(x2, w, b, act)
    else:
        raise ValueError(f"matmul_fused: unsupported device {x.device}")
    return y.reshape(*lead, w.shape[-1])


#: kernel launches since the count was last set to 0, in all and by path
matmul_fused.launches = 0
matmul_fused.path_launches = dict.fromkeys(PATH_CODES, 0)
