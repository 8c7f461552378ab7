"""Attention: GQA, RoPE, sliding window, softcap, cross-attention and the
KV cache — the port of the paths of ``repro.nn.attention`` that serving a
model runs.

* Full mode (prefill) calls K10's wrapper,
  ``repro_torch.kernels.attention.ops.flash_attention``: the kernel for a
  CUDA tensor, its plain version for a CPU tensor.  With a cache it then
  writes k/v into the cache's rows (a ring buffer keeps the last S).
* Decode mode writes one k/v per request into the cache and runs
  :func:`decode_attention`, plain PyTorch on every device, as the JAX
  package's jnp is on every backend.
* Cross-attention (``context`` given: ``models/vision_lm.py``,
  ``models/encdec.py``) reads k/v from the context stream, without RoPE,
  and runs K10 with ``causal=False``; with a cache it writes those k/v
  there, rounded to the cache's dtype.  A decode step reads them back
  through :func:`cross_attention_cached`, plain PyTorch.

Unlike the JAX package, the cache is updated in place: ``attention_apply``
writes into the tensors of ``cache`` (views of the model's stacked cache)
and returns only its output.  The int8 cache (``quantize_kv`` /
``dequantize_kv``) and the backward are not ported yet (ROADMAP.md,
"Modules still to port").
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.nn.linear import dense, linear_spec
from repro_torch.nn.norm import rmsnorm_apply, rmsnorm_spec
from repro_torch.nn.rope import apply_rope

NEG_INF = -1e30


def attention_spec(cfg: ModelConfig, cross: bool = False,
                   kv_dim: Optional[int] = None) -> dict:
    """QKV + output projections.  ``cross=True`` reads K/V from a context
    stream of width ``kv_dim`` (defaults to d_model)."""
    d = cfg.d_model
    kv_in = kv_dim or d
    spec = {
        "wq": linear_spec(d, cfg.q_dim, "embed", "heads", bias=cfg.use_qkv_bias),
        "wk": linear_spec(kv_in, cfg.kv_dim, "embed", "kv_heads",
                          bias=cfg.use_qkv_bias),
        "wv": linear_spec(kv_in, cfg.kv_dim, "embed", "kv_heads",
                          bias=cfg.use_qkv_bias),
        "wo": linear_spec(cfg.q_dim, d, "heads", "embed"),
    }
    if cfg.qk_norm:
        spec["q_norm"] = rmsnorm_spec(cfg.head_dim)
        spec["k_norm"] = rmsnorm_spec(cfg.head_dim)
    return spec


def softcap(x, cap: float):
    if cap and cap > 0.0:
        return cap * torch.tanh(x / cap)
    return x


def _grouped(q, kvh):
    """[b, s, h, hd] -> [b, s, kvh, group, hd]: query head ``h`` reads kv
    head ``h // group``, as the JAX package's ``jnp.repeat`` of the kv
    heads gives, without the copy."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, kvh, h // kvh, hd)


def decode_attention(
    q,  # [b, 1, h, hd]
    k_cache,  # [b, S, kvh, hd]   (S = full seq or ring-buffer window)
    v_cache,
    positions,  # [b] int: index of the *current* token
    *,
    window: int = 0,  # >0 -> cache is a ring buffer of size S == window
    attn_softcap: float = 0.0,
    scale: Optional[float] = None,
):
    """One token per request against its cache, as the JAX package's
    ``decode_attention``: fp32 scores of the upcast operands, a softmax
    over the valid slots, ``p`` cast to the cache dtype before the fp32
    PV product."""
    b, _, h, hd = q.shape
    S, kvh = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    s = torch.einsum("bqjgd,bkjd->bjgqk", _grouped(q, kvh).float(),
                     k_cache.float())
    s = softcap(s * scale, attn_softcap)
    idx = torch.arange(S, device=q.device)[None, :]  # [1, S]
    pos = positions.to(q.device).long()[:, None]  # [b, 1]
    if window > 0:
        # slot i holds absolute position p_i = pos - ((pos - i) mod S);
        # the modulo is floored (torch.remainder), as jnp.mod
        p_slot = pos - torch.remainder(pos - idx, S)
        valid = (p_slot >= 0) & (p_slot >= pos - window + 1)
    else:
        valid = idx <= pos
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bjgqk,bkjd->bqjgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def cache_update(k_cache, v_cache, k_new, v_new, positions, window: int = 0):
    """Write one new (k, v) per request into the cache, in place.

    k_new/v_new: [b, 1, kvh, hd]; positions: [b] absolute token index.
    With ``window>0`` the cache is a ring buffer and the slot is pos % S.
    """
    S = k_cache.shape[1]
    pos = positions.to(k_cache.device).long()
    slots = torch.remainder(pos, S) if window > 0 else pos
    bidx = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[bidx, slots] = k_new[:, 0].to(k_cache.dtype)
    v_cache[bidx, slots] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache


def _prefill_cache(cache: dict, k, v) -> None:
    """Write a prompt's k/v into the cache rows.  For a ring buffer
    (S < s) position p lives in slot p % S, so the last S tokens are
    written rolled by (s - S) % S."""
    s = k.shape[1]
    for name, src in (("k", k), ("v", v)):
        c = cache[name]
        S = c.shape[1]
        if S >= s:
            c[:, :s] = src.to(c.dtype)
        else:
            c.copy_(torch.roll(src[:, -S:], (s - S) % S, dims=1).to(c.dtype))


def cross_kv(params, context, cfg: ModelConfig):
    """K/V of the stream [b, t, d_ctx] that the keys come from (a
    cross-attention's context, or ``attention_apply``'s own input): each
    [b, t, kvh, hd], k after ``k_norm`` where the config has QK-norm."""
    b, t, _ = context.shape
    k = dense(params["wk"], context).reshape(b, t, cfg.num_kv_heads,
                                             cfg.head_dim)
    v = dense(params["wv"], context).reshape(b, t, cfg.num_kv_heads,
                                             cfg.head_dim)
    if cfg.qk_norm:
        k = rmsnorm_apply(params["k_norm"], k, cfg.norm_eps)
    return k, v


def cross_attention_cached(params, x, ck, cv, cfg: ModelConfig):
    """Decode-time cross-attention against precomputed K/V, every slot
    visible: :func:`decode_attention` at position ``t - 1``.  x: [b, s,
    d]; ck/cv: [b, t, kvh, hd]."""
    b, s, _ = x.shape
    q = dense(params["wq"], x).reshape(b, s, cfg.num_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm_apply(params["q_norm"], q, cfg.norm_eps)
    pos = torch.full((b,), ck.shape[1] - 1, dtype=torch.long,
                     device=x.device)
    out = decode_attention(q, ck, cv, pos, window=0,
                           attn_softcap=cfg.attn_softcap,
                           scale=cfg.attn_logit_scale or None)
    return dense(params["wo"], out.reshape(b, s, cfg.q_dim))


def attention_apply(
    params,
    x,  # [b, s, d]
    cfg: ModelConfig,
    *,
    causal: bool = True,
    window: int = 0,
    positions=None,  # [b, s] or None -> arange; [b] in decode
    mode: str = "full",  # "full" | "decode"
    cache: Optional[dict] = None,  # {"k","v"} for decode / cache prefill
    context=None,  # [b, t, d_ctx] for cross-attention (no rope on q or k)
    use_rope: bool = True,
):
    """Returns out [b, s, d]; k/v go into ``cache`` in place.  With a
    ``context`` it is cross-attention whatever ``mode`` is: k/v from the
    context, no RoPE, no causal mask or window, K10 over every key; a
    ``cache`` then takes those k/v whole (``cache_spec``'s cross leaves,
    [b, t, kvh, hd]), rounded to its dtype."""
    b, s, _ = x.shape
    q = dense(params["wq"], x).reshape(b, s, cfg.num_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm_apply(params["q_norm"], q, cfg.norm_eps)
    k, v = cross_kv(params, x if context is None else context, cfg)
    scale = cfg.attn_logit_scale or None

    if context is not None:
        out = flash_attention(q, k, v, causal=False, window=0,
                              attn_softcap=cfg.attn_softcap, scale=scale)
        if cache is not None:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
    elif mode == "full":
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        if use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        out = flash_attention(q, k, v, causal=causal, window=window,
                              attn_softcap=cfg.attn_softcap, scale=scale)
        if cache is not None:
            _prefill_cache(cache, k, v)
    elif mode == "decode":
        assert cache is not None and positions is not None
        pos = positions if positions.ndim == 1 else positions[:, 0]
        if use_rope:
            q = apply_rope(q, pos[:, None], cfg.rope_theta)
            k = apply_rope(k, pos[:, None], cfg.rope_theta)
        kc, vc = cache_update(cache["k"], cache["v"], k, v, pos, window)
        out = decode_attention(q, kc, vc, pos, window=window,
                               attn_softcap=cfg.attn_softcap, scale=scale)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    return dense(params["wo"], out.reshape(b, s, cfg.q_dim))
