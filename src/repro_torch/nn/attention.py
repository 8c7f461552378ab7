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

The head counts are read from the projections' widths, so on a mesh
(``sharding.ctx``) a rank attends over its local q and kv heads, its
cache shard laid out by the leaves' logical axes ("batch", "kv_seq",
"kv_heads", None), and ``wo`` is row-parallel over "heads"; x enters the
column-parallel q, k and v through ``nn.linear.column_input``.

**Kv heads whole, q heads cut** (kv heads that "model" does not divide):
every rank computes every kv head, and its local q head i (global
``g = r * h + i``) reads kv head ``g // (H / kvh)``, JAX's ``jnp.repeat``;
:func:`_local_kv` selects those kv heads for K10.  k and v enter the
selection through ``copy_to``, so that their cotangents, each rank's
from its own q heads, are summed over "model" in rank order and the
replicated ``wk`` and ``wv`` get the same gradient on every rank.  The
QK-norm scales (qwen3) enter the norm of cut heads through ``copy_to``
for the same reason (:func:`_head_norm`).

**The cache cut by sequence** ("kv_seq": kv heads that do not divide
"model", or a batch below dp): a rank holds the rows ``[off, off +
S_local)`` of the global ``S`` (``sharding.ctx.shard_rows``).  A ring
buffer rolls by the global ``S`` (position p in slot ``p % S``), and a
token is written by the rank that owns its slot.  A decode step's
softmax spans the shards: the global max (``max_over``), the sum of the
exps in rank order (``sum_over``), then ``p`` normalised and rounded to
the cache dtype, as JAX's, and the partial outputs summed in rank order;
the int8 cache merges the ranks' online-softmax states ``(m, l, acc)`` in
rank order.  Where q heads are cut, q is gathered over "model" first,
every head attends over the rank's rows, and the rank keeps its own
heads for ``wo``.  No cache is gathered to one rank.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.nn.linear import column_input, dense, linear_spec
from repro_torch.nn.norm import rmsnorm_apply, rmsnorm_spec
from repro_torch.nn.rope import apply_rope
from repro_torch.sharding.collectives import (axis_index, copy_to,
                                              gather_over, max_over, sum_over)
from repro_torch.sharding.ctx import shard_act, shard_of, shard_rows

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


def _valid(positions, rows, S_l: int, window: int, device):
    """[b, S_l] bool: the cache slots of the rows ``rows`` (``(offset,
    global S, axes)``) that hold a visible position for each request."""
    off, S, _ = rows
    idx = off + torch.arange(S_l, device=device)[None, :]  # [1, S_l]
    pos = positions.to(device).long()[:, None]  # [b, 1]
    if window > 0:
        # slot i holds absolute position p_i = pos - ((pos - i) mod S);
        # the modulo is floored (torch.remainder), as jnp.mod
        p_slot = pos - torch.remainder(pos - idx, S)
        return (p_slot >= 0) & (p_slot >= pos - window + 1)
    return idx <= pos


def _local_kv(k, h: int):
    """The kv heads that this rank's ``h`` q heads read, of ``k`` [b, s,
    kvh, hd] holding every kv head while "heads" is cut: local q head i is
    global head ``g = r * h + i`` and reads kv head ``g // (H / kvh)``.
    Where the local heads read equal runs of consecutive kv heads (one kv
    head, as every rules_for case of the registered archs gives), those
    kv heads, so that K10's own ``h // (h / kvh)`` holds; else one kv head
    a q head.  A contiguous copy of slices, as K10 takes them; their
    backward adds no two cotangents in an order of the device's
    choosing."""
    r, n, _ = shard_of("heads")
    group = h * n // k.shape[2]
    idx = [(r * h + i) // group for i in range(h)]
    runs = idx[-1] - idx[0] + 1
    if h % runs == 0 and all(j == idx[0] + i // (h // runs)
                             for i, j in enumerate(idx)):
        return k.narrow(2, idx[0], runs).contiguous()
    return torch.cat([k.narrow(2, j, 1) for j in idx], dim=2)


def decode_attention(
    q,  # [b, 1, h, hd]
    k_cache,  # [b, S, kvh, hd]   (S = full seq or ring-buffer window)
    v_cache,
    positions,  # [b] int: index of the *current* token
    *,
    window: int = 0,  # >0 -> cache is a ring buffer of size S == window
    attn_softcap: float = 0.0,
    scale: Optional[float] = None,
    rows=None,  # (offset, global S, mesh axes) of a cache cut by sequence
):
    """One token per request against its cache, as the JAX package's
    ``decode_attention``: fp32 scores of the upcast operands, a softmax
    over the valid slots (``exp(s - max) / sum``, as ``jax.nn.softmax``),
    ``p`` cast to the cache dtype before the fp32 PV product.  With
    ``rows`` the cache holds the rows ``[offset, offset + S_local)`` of a
    global ``S`` over the mesh axes, and the max, the sum and the partial
    outputs are exchanged over them (the sums in rank order)."""
    b, _, h, hd = q.shape
    S_l, kvh = k_cache.shape[1], k_cache.shape[2]
    rows = rows or (0, S_l, ())
    axes = rows[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    s = torch.einsum("bqjgd,bkjd->bjgqk", _grouped(q, kvh).float(),
                     k_cache.float())
    s = softcap(s * scale, attn_softcap)
    valid = _valid(positions, rows, S_l, window, q.device)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    # a shard without a valid slot: exp(NEG_INF - m) is exactly 0
    e = torch.exp(s - max_over(axes, s.amax(dim=-1, keepdim=True)))
    p = e / sum_over(axes, e.sum(dim=-1, keepdim=True))
    out = torch.einsum("bjgqk,bkjd->bqjgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return sum_over(axes, out).reshape(b, 1, h, hd).to(q.dtype)


def _write_slots(c, new, positions, window: int, rows=None) -> None:
    """Write ``new`` [b, ...] (one row a request) into the cache leaf ``c``
    [b, S_l, ...] at each request's slot, in place: ``pos % S`` (the
    global S) for a ring buffer, else ``pos``; with ``rows`` only the
    rank that holds the slot writes it."""
    S_l = c.shape[1]
    off, S, axes = rows or (0, S_l, ())
    pos = positions.to(c.device).long()
    slots = torch.remainder(pos, S) if window > 0 else pos
    bidx = torch.arange(c.shape[0], device=c.device)
    new = new.to(c.dtype)
    if not axes:
        c[bidx, slots] = new
        return
    local = slots - off
    mine = (local >= 0) & (local < S_l)
    local = local.clamp(0, S_l - 1)
    mine = mine.reshape(-1, *([1] * (new.dim() - 1)))
    c[bidx, local] = torch.where(mine, new, c[bidx, local])


def cache_update(k_cache, v_cache, k_new, v_new, positions, window: int = 0,
                 rows=None):
    """Write one new (k, v) per request into the cache, in place.

    k_new/v_new: [b, 1, kvh, hd]; positions: [b] absolute token index.
    With ``window>0`` the cache is a ring buffer and the slot is pos % S;
    ``rows``: as :func:`decode_attention`'s.
    """
    _write_slots(k_cache, k_new[:, 0], positions, window, rows)
    _write_slots(v_cache, v_new[:, 0], positions, window, rows)
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
    rows=None,  # (offset, global S, mesh axes) of a cache cut by sequence
):
    """One token per request against an int8 cache, as the JAX package's
    ``decode_attention_quant``: an online softmax over ``block``-row
    blocks of the cache (``S`` a multiple of the block), the int8 values
    upcast to fp32 as dot operands, and each slot's scales folded into the
    fp32 score (k) and probability (v) vectors.  With ``rows`` the blocks
    are the rank's rows (``min(block, S_local)`` each), and the ranks'
    states ``(m, l, acc)`` are merged over the mesh axes in rank order."""
    b, _, h, hd = q.shape
    S_l, kvh = k_q.shape[1], k_q.shape[2]
    rows = rows or (0, S_l, ())
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    blk = min(block, S_l)
    assert S_l % blk == 0, (S_l, blk)
    qf = _grouped(q, kvh)[:, 0].float()  # [b, kvh, group, hd]
    group = h // kvh
    m = torch.full((b, kvh, group), NEG_INF, device=q.device)
    l = torch.zeros((b, kvh, group), device=q.device)
    acc = torch.zeros((b, kvh, group, hd), device=q.device)
    for j in range(S_l // blk):
        blk_rows = slice(j * blk, (j + 1) * blk)
        # [b, kvh, 1, k]
        ks = k_s[:, blk_rows].float().permute(0, 2, 1)[:, :, None]
        vs = v_s[:, blk_rows].float().permute(0, 2, 1)[:, :, None]
        s = torch.einsum("bjgd,bkjd->bjgk", qf,
                         k_q[:, blk_rows].float()) * ks
        s = softcap(s * scale, attn_softcap)
        valid = _valid(positions, (rows[0] + j * blk,) + rows[1:], blk,
                       window, q.device)
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        row_ok = m_new > NEG_INF / 2
        p = torch.exp(s - m_new[..., None]) * row_ok[..., None]
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bjgk,bkjd->bjgd", p * vs,
                          v_q[:, blk_rows].float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    axes = rows[2]
    if axes:  # the ranks' states merged; a rank without a valid slot adds 0
        alpha = torch.exp(m - max_over(axes, m))
        l = sum_over(axes, l * alpha)
        acc = sum_over(axes, acc * alpha[..., None])
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def cache_update_quant(cache: dict, k_new, v_new, positions,
                       window: int = 0, rows=None) -> dict:
    """Quantize one new (k, v) per request and write values and scales
    into the int8 cache in place (the slot as :func:`cache_update`)."""
    for name, new in (("k", k_new), ("v", v_new)):
        vals, scales = quantize_kv(new)
        _write_slots(cache[name], vals[:, 0], positions, window, rows)
        _write_slots(cache[name + "_scale"], scales[:, 0], positions,
                     window, rows)
    return cache


def _prefill_cache(cache: dict, k, v, rows=None) -> None:
    """Write a prompt's k/v into the cache rows, quantized first for an
    int8 cache.  For a ring buffer (S < s) position p lives in slot p % S,
    so the last S tokens are written rolled by (s - S) % S.  With ``rows``
    (as :func:`decode_attention`'s) the rank writes its rows of that
    global cache alone."""
    s = k.shape[1]
    srcs = {"k": k, "v": v}
    if "k_scale" in cache:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        srcs = {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
    for name, src in srcs.items():
        c = cache[name]
        S_l = c.shape[1]
        off, S, _ = rows or (0, S_l, ())
        if S >= s:
            hi = min(off + S_l, s)
            if hi > off:
                c[:, :hi - off] = src[:, off:hi].to(c.dtype)
        else:
            # global slot j holds row (j - shift) mod S of the last S
            # tokens rolled by shift = (s - S) % S
            j = torch.arange(off, off + S_l, device=src.device)
            idx = s - S + torch.remainder(j - (s - S) % S, S)
            c.copy_(src.index_select(1, idx).to(c.dtype))


def _head_norm(params, x, cfg: ModelConfig, heads: str):
    """QK-norm of ``x`` [b, s, h, hd], whose heads axis is the logical
    ``heads``.  Its scale is replicated where the active sharding cuts the
    heads, and each rank norms only its own: the scale enters through
    ``copy_to``, so its gradient sums every rank's heads' in rank order,
    the same bits on each rank."""
    _, n, axes = shard_of(heads)
    if n > 1:
        params = {"scale": copy_to(axes, params["scale"])}
    return rmsnorm_apply(params, x, cfg.norm_eps)


def cross_kv(params, context, cfg: ModelConfig):
    """K/V of the stream [b, t, d_ctx] that the keys come from (a
    cross-attention's context, or ``attention_apply``'s own input): each
    [b, t, kvh, hd] (kvh: the local kv heads on a mesh), k after
    ``k_norm`` where the config has QK-norm."""
    b, t, _ = context.shape
    k = dense(params["wk"], context).reshape(b, t, -1, cfg.head_dim)
    v = dense(params["wv"], context).reshape(b, t, -1, cfg.head_dim)
    k = shard_act(k, ("batch", "seq", "kv_heads", None))
    v = shard_act(v, ("batch", "seq", "kv_heads", None))
    if cfg.qk_norm:
        k = _head_norm(params["k_norm"], k, cfg, "kv_heads")
    return k, v


def cross_attention_cached(params, x, ck, cv, cfg: ModelConfig):
    """Decode-time cross-attention against precomputed K/V, every slot
    visible: :func:`decode_attention` at position ``t - 1``.  x: [b, s,
    d]; ck/cv: [b, t, kvh, hd]."""
    b, s, _ = x.shape
    q = dense(params["wq"], x).reshape(b, s, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = _head_norm(params["q_norm"], q, cfg, "heads")
    pos = torch.full((b,), ck.shape[1] - 1, dtype=torch.long,
                     device=x.device)
    out = decode_attention(q, ck, cv, pos, window=0,
                           attn_softcap=cfg.attn_softcap,
                           scale=cfg.attn_logit_scale or None)
    return dense(params["wo"], out.reshape(b, s, -1), k_axis="heads")


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
    _, n_h, h_axes = shard_of("heads")
    # q heads cut over kv heads that every rank holds whole
    whole_kv = n_h > 1 and shard_of("kv_heads")[1] == 1
    xq = column_input(x, "heads")  # q, k, v are column-parallel
    q = dense(params["wq"], xq).reshape(b, s, -1, cfg.head_dim)
    q = shard_act(q, ("batch", "seq", "heads", None))
    if cfg.qk_norm:
        q = _head_norm(params["q_norm"], q, cfg, "heads")
    k, v = cross_kv(params, column_input(context, "kv_heads")
                    if context is not None else x if whole_kv else xq, cfg)
    scale = cfg.attn_logit_scale or None
    rows = None if cache is None or context is not None else shard_rows(
        "kv_seq", cache["k"].shape[1])

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
        kq, vq = k, v
        if whole_kv:  # the cotangents of every rank's heads summed
            kq, vq = (_local_kv(copy_to(h_axes, t), q.shape[2])
                      for t in (k, v))
        out = flash_attention(q, kq, vq, causal=causal, window=window,
                              attn_softcap=cfg.attn_softcap, scale=scale,
                              chunk=cfg.attn_chunk)
        if cache is not None:
            _prefill_cache(cache, k, v, rows)
    elif mode == "decode":
        assert cache is not None and positions is not None
        pos = positions if positions.ndim == 1 else positions[:, 0]
        if use_rope:
            q = apply_rope(q, pos[:, None], cfg.rope_theta)
            k = apply_rope(k, pos[:, None], cfg.rope_theta)
        for name, c in cache.items():
            shard_act(c, ("batch", "kv_seq", "kv_heads", None)[:c.dim()])
        h = q.shape[2]
        if whole_kv:  # every head over the rank's rows, then its own
            q = gather_over(h_axes, q, 2)
        if "k_scale" in cache:  # int8 cache
            cache_update_quant(cache, k, v, pos, window, rows)
            out = decode_attention_quant(
                q, cache["k"], cache["k_scale"], cache["v"],
                cache["v_scale"], pos, window=window,
                attn_softcap=cfg.attn_softcap, scale=scale, rows=rows)
        else:
            kc, vc = cache_update(cache["k"], cache["v"], k, v, pos, window,
                                  rows)
            out = decode_attention(q, kc, vc, pos, window=window,
                                   attn_softcap=cfg.attn_softcap,
                                   scale=scale, rows=rows)
        if whole_kv:  # contiguous, as K3 takes wo's input
            out = out.narrow(2, axis_index(h_axes) * h, h).contiguous()
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    out = shard_act(out, ("batch", "seq", "heads", None))
    o = dense(params["wo"], out.reshape(b, s, -1), k_axis="heads")
    return shard_act(o, ("batch", "seq", "embed_act"))
