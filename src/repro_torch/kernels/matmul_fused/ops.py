"""Wrapper of the fused bias+activation matmul kernel (K3,
``csrc/matmul_fused.cu``): the port of ``repro.kernels.matmul_fused``.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
(fp32 only) or raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_cuda_f32
from repro_torch.kernels.matmul_fused.ref import _ACTS, matmul_fused_ref

ACT_CODES = {"none": 0, "relu": 1, "silu": 2, "gelu": 3}
COLS_PER_BLOCK = 512  # BN in csrc/matmul_fused.cu
KCHUNK_MAX = 512      # KMAX in csrc/matmul_fused.cu
BLOCKS_PER_SM = 4
PARTIAL_SHARE = 0.1   # partial sums may add at most this share of w's bytes


def split_k(m: int, n: int, k: int, sms: int):
    """``(splits, kchunk)`` for an ``[m, k] x [k, n]`` product on a card
    with ``sms`` SMs: enough K slices for about ``BLOCKS_PER_SM`` blocks an
    SM, no more than keeps the ``[splits, m, n]`` partials under
    ``PARTIAL_SHARE`` of the weights, and slices of at most
    ``KCHUNK_MAX`` rows (the kernel's shared-memory x slice)."""
    tiles = math.ceil(n / COLS_PER_BLOCK) * math.ceil(m / 16)
    splits = math.ceil(BLOCKS_PER_SM * sms / tiles)
    splits = min(splits, max(1, int(PARTIAL_SHARE * k / m)))
    splits = max(1, min(splits, k))
    kchunk = math.ceil(k / splits)
    kchunk = min(KCHUNK_MAX, -(-kchunk // 4) * 4)
    return math.ceil(k / kchunk), kchunk


def _launch(x, w, b, act):
    check_cuda_f32("matmul_fused", x, w, *(() if b is None else (b,)))
    m, k = x.shape
    n = w.shape[1]
    if b is not None and b.shape != (n,):
        raise ValueError(f"matmul_fused: bias shape {tuple(b.shape)} != ({n},)")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, kchunk = split_k(m, n, k, sms)
    part = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    lib = _build.library()
    rc = lib.matmul_fused_f32(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        part.data_ptr(), y.data_ptr(), m, n, k, splits, kchunk,
        ACT_CODES[act], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "matmul_fused_f32")
    matmul_fused.launches += 1
    return y


def matmul_fused(x, w, b=None, act: str = "none"):
    """y = act(x @ w + b).  Leading dims of x are flattened to M.  fp32
    accumulation; the result has x's dtype."""
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
        y = _launch(x2, w, b, act).to(x.dtype)
    else:
        raise ValueError(f"matmul_fused: unsupported device {x.device}")
    return y.reshape(*lead, w.shape[-1])


#: kernel launches since the count was last set to 0
matmul_fused.launches = 0
