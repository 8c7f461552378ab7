"""Wrapper of the flash-attention kernel (K10, ``csrc/flash_attention.cu``):
the port of ``repro.kernels.attention``.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
(fp32 or bf16, head_dim 64, 128 or 256) or raises.  The path is chosen
from the type and the shape alone, before the launch (``k10_path``): TMA +
wgmma on the tensor cores for bf16, CUDA-core FMAs for fp32.  A refused
launch raises; nothing retries on another path.  The kernel reads kv head
``h // (h / kvh)`` for query head ``h`` instead of repeating the kv heads
as the TPU wrapper does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention.ref import flash_attention_ref
from repro_torch.kernels.common import check_cuda
from repro_torch.kernels.common import stream_handle as _stream

HEAD_DIMS = (64, 128, 256)
#: the C entry's path codes
PATH_CODES = {"simt": 0, "wgmma": 1}
TMA_ALIGN = 16  # bytes: TMA's base alignment


def k10_path(dtype, sq: int, skv: int, hd: int) -> str:
    """The path of a launch on ``dtype`` tensors with ``sq`` query rows,
    ``skv`` keys and head_dim ``hd``: ``"wgmma"`` (TMA + wgmma,
    ``flash_wgmma``) for bf16, ``"simt"`` (CUDA-core FMAs, ``flash_fwd``)
    for fp32.  The lengths do not change the choice: the wgmma path is the
    faster one from 16 tokens on."""
    del sq, skv
    if dtype == torch.bfloat16 and hd in HEAD_DIMS:
        return "wgmma"
    return "simt"


def _launch(q, k, v, causal, window, cap, scale, path=None):
    """Launch K10 on CUDA tensors; ``path`` (default: ``k10_path``'s
    choice) may name the CUDA-core kernel for bf16 too, for timing one
    path beside the other."""
    check_cuda("flash_attention", q, k, v)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    chosen = k10_path(q.dtype, sq, skv, hd)
    path = chosen if path is None else path
    if path not in PATH_CODES or (path == "wgmma" and chosen != "wgmma"):
        raise ValueError(f"flash_attention: path {path!r} cannot take "
                         f"{q.dtype} q {tuple(q.shape)}")
    if path == "wgmma" and any(t.data_ptr() % TMA_ALIGN for t in (q, k, v)):
        raise ValueError("flash_attention: the wgmma path needs q, k and v "
                         f"{TMA_ALIGN}-byte aligned")
    out = torch.empty_like(q)
    rc = _build.library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
        h, kvh, hd, int(causal), int(window), scale, float(cap or 0.0),
        int(q.dtype == torch.bfloat16), PATH_CODES[path], _stream(q.device))
    _build.check(rc, "flash_attention_fwd")
    flash_attention.launches += 1
    flash_attention.path_launches[path] += 1
    return out


def flash_attention(q, k, v, *, causal=True, window=0, attn_softcap=0.0,
                    scale=None):
    """q: [b, sq, h, hd]; k/v: [b, skv, kvh, hd] -> [b, sq, h, hd], in
    q's dtype."""
    b, sq, h, hd = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd
            or h % k.shape[2]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   attn_softcap=attn_softcap, scale=scale)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window, attn_softcap, scale)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


#: kernel launches since the count was last set to 0, in all and by path
flash_attention.launches = 0
flash_attention.path_launches = dict.fromkeys(PATH_CODES, 0)
