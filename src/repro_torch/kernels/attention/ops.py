"""Wrapper of the flash-attention kernel (K10, ``csrc/flash_attention.cu``):
the port of ``repro.kernels.attention``.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
(fp32 or bf16, head_dim 64, 128 or 256) or raises.  The kernel reads kv
head ``h // (h / kvh)`` for query head ``h`` instead of repeating the kv
heads as the TPU wrapper does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention.ref import flash_attention_ref
from repro_torch.kernels.common import check_cuda

HEAD_DIMS = (64, 128, 256)


def _launch(q, k, v, causal, window, cap, scale):
    check_cuda("flash_attention", q, k, v)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    rc = _build.library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv,
        h, kvh, hd, int(causal), int(window), scale, float(cap or 0.0),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention_fwd")
    flash_attention.launches += 1
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


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
