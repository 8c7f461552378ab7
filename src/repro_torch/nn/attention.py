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

The int8 cache (``cfg.kv_quant``: int8 ``k``/``v`` and fp16
``k_scale``/``v_scale``, one scale a (slot, kv head)) takes the prefill's
k/v through :func:`quantize_kv` and a decode step's through
:func:`cache_update_quant`, and a decode step attends over it with
:func:`decode_attention_quant`: plain PyTorch on every device, as the JAX
package's jnp is on every backend (it has no kernel for any of it).

Unlike the JAX package, the cache is updated in place: ``attention_apply``
writes into the tensors of ``cache`` (views of the model's stacked cache)
and returns only its output.  Training passes no cache, so no in-place
write ever touches a tensor that autograd saved.
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


def quantize_kv(x):
    """x: [b, s, kvh, hd] -> (int8 values, fp16 scales [b, s, kvh]), as
    the JAX package's ``quantize_kv``: the scale max|x| / 127 is floored
    at 1e-8 and rounded to fp16 *before* the division, so the
    dequantization error is at most scale / 2; then ``round`` (half to
    even, as ``jnp.round``) and a clip to [-127, 127].  The floor itself
    rounds to 0 in fp16, so an all-zero row has a zero scale; its 0 / 0
    is taken as 0 and a nonzero x / 0 clips to +-127, as JAX's
    conversion gives them."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8).to(
        torch.float16)
    y = torch.round(xf / scale.float()[..., None])
    q = torch.nan_to_num(y, nan=0.0).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q, scale):
    return q.to(torch.bfloat16) * scale[..., None].to(torch.bfloat16)


def decode_attention_quant(
    q,  # [b, 1, h, hd]
    k_q, k_s, v_q, v_s,  # int8 caches [b, S, kvh, hd] + fp16 scales [b, S, kvh]
    positions,  # [b]
    *,
    window: int = 0,
    attn_softcap: float = 0.0,
    scale: Optional[float] = None,
    block: int = 4096,
):
    """One token per request against an int8 cache, as the JAX package's
    ``decode_attention_quant``: an online softmax over ``block``-row
    blocks of the cache (``S`` a multiple of the block), the int8 values
    upcast to fp32 as dot operands, and each slot's scales folded into the
    fp32 score (k) and probability (v) vectors."""
    b, _, h, hd = q.shape
    S, kvh = k_q.shape[1], k_q.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    blk = min(block, S)
    assert S % blk == 0, (S, blk)
    qf = _grouped(q, kvh)[:, 0].float()  # [b, kvh, group, hd]
    pos = positions.to(q.device).long()[:, None]  # [b, 1]
    group = h // kvh
    m = torch.full((b, kvh, group), NEG_INF, device=q.device)
    l = torch.zeros((b, kvh, group), device=q.device)
    acc = torch.zeros((b, kvh, group, hd), device=q.device)
    for j in range(S // blk):
        rows = slice(j * blk, (j + 1) * blk)
        ks = k_s[:, rows].float().permute(0, 2, 1)[:, :, None]  # [b,kvh,1,k]
        vs = v_s[:, rows].float().permute(0, 2, 1)[:, :, None]
        s = torch.einsum("bjgd,bkjd->bjgk", qf, k_q[:, rows].float()) * ks
        s = softcap(s * scale, attn_softcap)
        idx = j * blk + torch.arange(blk, device=q.device)[None, :]
        if window > 0:
            p_slot = pos - torch.remainder(pos - idx, S)
            valid = (p_slot >= 0) & (p_slot >= pos - window + 1)
        else:
            valid = idx <= pos
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        row_ok = m_new > NEG_INF / 2
        p = torch.exp(s - m_new[..., None]) * row_ok[..., None]
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bjgk,bkjd->bjgd", p * vs, v_q[:, rows].float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def cache_update_quant(cache: dict, k_new, v_new, positions,
                       window: int = 0) -> dict:
    """Quantize one new (k, v) per request and write values and scales
    into the int8 cache in place (the slot as :func:`cache_update`)."""
    S = cache["k"].shape[1]
    pos = positions.to(cache["k"].device).long()
    slots = torch.remainder(pos, S) if window > 0 else pos
    bidx = torch.arange(cache["k"].shape[0], device=cache["k"].device)
    for name, new in (("k", k_new), ("v", v_new)):
        vals, scales = quantize_kv(new)
        cache[name][bidx, slots] = vals[:, 0]
        cache[name + "_scale"][bidx, slots] = scales[:, 0]
    return cache


def _prefill_cache(cache: dict, k, v) -> None:
    """Write a prompt's k/v into the cache rows, quantized first for an
    int8 cache.  For a ring buffer (S < s) position p lives in slot p % S,
    so the last S tokens are written rolled by (s - S) % S."""
    s = k.shape[1]
    srcs = {"k": k, "v": v}
    if "k_scale" in cache:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        srcs = {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
    for name, src in srcs.items():
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
                              attn_softcap=cfg.attn_softcap, scale=scale,
                              chunk=cfg.attn_chunk)
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
                              attn_softcap=cfg.attn_softcap, scale=scale,
                              chunk=cfg.attn_chunk)
        if cache is not None:
            _prefill_cache(cache, k, v)
    elif mode == "decode":
        assert cache is not None and positions is not None
        pos = positions if positions.ndim == 1 else positions[:, 0]
        if use_rope:
            q = apply_rope(q, pos[:, None], cfg.rope_theta)
            k = apply_rope(k, pos[:, None], cfg.rope_theta)
        if "k_scale" in cache:  # int8 cache
            cache_update_quant(cache, k, v, pos, window)
            out = decode_attention_quant(
                q, cache["k"], cache["k_scale"], cache["v"],
                cache["v_scale"], pos, window=window,
                attn_softcap=cfg.attn_softcap, scale=scale)
        else:
            kc, vc = cache_update(cache["k"], cache["v"], k, v, pos, window)
            out = decode_attention(q, kc, vc, pos, window=window,
                                   attn_softcap=cfg.attn_softcap,
                                   scale=scale)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    return dense(params["wo"], out.reshape(b, s, cfg.q_dim))
