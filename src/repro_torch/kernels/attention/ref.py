"""Plain PyTorch version of the flash-attention kernel (K10): the same
function, materialized (one [sq, skv] score tile per head)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import ACC_DTYPE

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0, attn_softcap=0.0,
                        scale=None, return_ml=False):
    """q: [b, sq, h, hd]; k/v: [b, skv, kvh, hd] -> [b, sq, h, hd], and
    with ``return_ml`` each row's fp32 max ``m`` and sum ``l`` [b, h, sq]
    (the residuals of the backward: ``p = exp(s - m) / l``).

    The TPU kernel's semantics: fp32 scores ``q.k * scale``, then the
    optional ``cap * tanh(s / cap)``; masked keys (causal, window) get
    ``NEG_INF``; ``p = 0`` on a row with no visible key; ``p.v`` in fp32
    (``p`` is not cast to the input type); ``out = acc / max(l, 1e-30)``,
    cast once to q's dtype."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kvh, h // kvh, hd).to(ACC_DTYPE)
    s = torch.einsum("bqjgd,bkjd->bjgqk", qg, k.to(ACC_DTYPE)) * scale
    if attn_softcap and attn_softcap > 0.0:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * (m > NEG_INF / 2)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bjgqk,bkjd->bjgqd", p, v.to(ACC_DTYPE))
    out = (acc / torch.clamp_min(l, 1e-30)).permute(0, 3, 1, 2, 4)
    out = out.reshape(b, sq, h, hd).to(q.dtype)
    if return_ml:
        return out, m.reshape(b, h, sq), l.reshape(b, h, sq)
    return out
