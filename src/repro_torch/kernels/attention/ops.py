"""Wrapper of the flash-attention kernel (K10, ``csrc/flash_attention.cu``):
the port of ``repro.kernels.attention``.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
(fp32 or bf16, head_dim 64, 128 or 256) or raises.  The path is chosen
from the type and the shape alone, before the launch (``k10_path``): TMA +
wgmma on the tensor cores for bf16, CUDA-core FMAs for fp32.  A refused
launch raises; nothing retries on another path.  The kernel reads kv head
``h // (h / kvh)`` for query head ``h`` instead of repeating the kv heads
as the TPU wrapper does.

Under autograd (grad enabled and q, k or v requiring grad) the call goes
through :class:`FlashAttentionFn`: its forward launches K10 with each
row's fp32 ``m`` and ``l`` written beside the output (the plain version
returns them on the CPU), and its backward is plain PyTorch by design,
:func:`flash_attention_bwd`, as the JAX package's is jnp under a
``custom_vjp`` (``_flash_bwd_scan``).  A call under ``no_grad`` launches
exactly what it launched before.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention.ref import NEG_INF, flash_attention_ref
from repro_torch.kernels.common import ACC_DTYPE, check_cuda
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


def _launch(q, k, v, causal, window, cap, scale, path=None, ml=False):
    """Launch K10 on CUDA tensors; ``path`` (default: ``k10_path``'s
    choice) may name the CUDA-core kernel for bf16 too, for timing one
    path beside the other.  With ``ml`` it returns (out, m, l), each row's
    fp32 max and sum [b, h, sq] written by the same launch."""
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
    args = (b, sq, skv, h, kvh, hd, int(causal), int(window), scale,
            float(cap or 0.0), int(q.dtype == torch.bfloat16),
            PATH_CODES[path], _stream(q.device))
    if ml:
        m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        rc = _build.library().flash_attention_fwd_ml(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            m.data_ptr(), l.data_ptr(), *args)
        _build.check(rc, "flash_attention_fwd_ml")
        flash_attention.ml_launches += 1
    else:
        rc = _build.library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *args)
        _build.check(rc, "flash_attention_fwd")
    flash_attention.launches += 1
    flash_attention.path_launches[path] += 1
    return (out, m, l) if ml else out


def _visible_pairs(n_q, n_kv, cq, ck, causal, window):
    """The (q chunk, kv chunk) pairs with any visible key, as the JAX
    package's ``_visible_pairs`` at ``q_start`` 0."""
    pairs = []
    for i in range(n_q):
        q_lo, q_hi = i * cq, (i + 1) * cq - 1
        for j in range(n_kv):
            k_lo, k_hi = j * ck, (j + 1) * ck - 1
            if causal and k_lo > q_hi:
                continue
            if window > 0 and k_hi < q_lo - window + 1:
                continue
            pairs.append((i, j))
    return pairs


def flash_attention_bwd(q, k, v, out, m, l, do, *, causal, window,
                        attn_softcap, scale, chunk):
    """The plain backward of K10, the port of the JAX package's
    ``_flash_bwd_scan``: over the visible (q chunk, kv chunk) pairs at
    chunks of ``min(chunk, s)`` rows (the sequences zero-padded to whole
    chunks), recompute each pair's scores and ``p = exp(s - m) / l``, with
    ``D = rowsum(do * out)``, ``ds = p (dp - D)``, the softcap's ``1 -
    tanh^2`` factor and the scale; fp32 throughout, each gradient cast
    once to its input's dtype.  The query heads of a kv head are summed
    into its dk and dv (K10 reads kv head ``h // group``).  q, out, do:
    [b, sq, h, hd]; k, v: [b, skv, kvh, hd]; m, l: fp32 [b, h, sq]."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    cq, ck = min(chunk, sq), min(chunk, skv)
    sq_p, skv_p = -(-sq // cq) * cq, -(-skv // ck) * ck
    f32 = ACC_DTYPE

    def pad(x, rows):  # [b, s, ...] -> [b, rows, ...], fp32
        x = x.to(f32)
        return torch.cat([x, x.new_zeros((b, rows - x.shape[1])
                                         + x.shape[2:])], 1)

    # queries grouped by kv head: [b, s, kvh, g, hd]; m, l, D: [b, kvh, g, s]
    qf = pad(q, sq_p).reshape(b, sq_p, kvh, g, hd)
    dof = pad(do, sq_p).reshape(b, sq_p, kvh, g, hd)
    kf, vf = pad(k, skv_p), pad(v, skv_p)
    D = (do.to(f32) * out.to(f32)).sum(-1).permute(0, 2, 1)  # [b, h, sq]

    def rows(x, fill):  # [b, h, sq] -> [b, kvh, g, sq_p]
        x = x.reshape(b, kvh, g, sq)
        return torch.cat([x, x.new_full((b, kvh, g, sq_p - sq), fill)], -1)

    mr, lr, Dr = rows(m, NEG_INF), rows(torch.clamp_min(l, 1e-30), 1.0), \
        rows(D, 0.0)
    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for i, j in _visible_pairs(sq_p // cq, skv_p // ck, cq, ck, causal,
                               window):
        qs, ks = slice(i * cq, (i + 1) * cq), slice(j * ck, (j + 1) * ck)
        qb, dob = qf[:, qs], dof[:, qs]
        kb, vb = kf[:, ks], vf[:, ks]
        s_pre = torch.einsum("bqjgd,bkjd->bjgqk", qb, kb) * scale
        t = None
        if attn_softcap and attn_softcap > 0.0:
            t = torch.tanh(s_pre / attn_softcap)
            s = attn_softcap * t
        else:
            s = s_pre
        q_pos = torch.arange(i * cq, (i + 1) * cq, device=q.device)[:, None]
        k_pos = torch.arange(j * ck, (j + 1) * ck, device=q.device)[None, :]
        mask = k_pos < skv
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window > 0:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask, s, NEG_INF)
        mb = mr[..., qs][..., None]
        # rows that saw no visible key (and the padding rows) keep p == 0
        p = torch.where(mb > NEG_INF / 2, torch.exp(s - mb), 0.0) \
            / lr[..., qs][..., None]
        dp = torch.einsum("bqjgd,bkjd->bjgqk", dob, vb)
        ds = p * (dp - Dr[..., qs][..., None])
        if t is not None:
            ds = ds * (1.0 - t * t)
        ds = ds * scale
        dq[:, qs] += torch.einsum("bjgqk,bkjd->bqjgd", ds, kb)
        dk[:, ks] += torch.einsum("bjgqk,bqjgd->bkjd", ds, qb)
        dv[:, ks] += torch.einsum("bjgqk,bqjgd->bkjd", p, dob)
    return (dq[:, :sq].reshape(b, sq, h, hd).to(q.dtype),
            dk[:, :skv].to(k.dtype), dv[:, :skv].to(v.dtype))


class FlashAttentionFn(torch.autograd.Function):
    """K10 (or its plain version on the CPU) with ``m`` and ``l`` saved,
    and :func:`flash_attention_bwd`, plain by design, as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, scale, chunk):
        if q.device.type == "cuda":
            out, m, l = _launch(q, k, v, causal, window, cap, scale, ml=True)
        else:
            out, m, l = flash_attention_ref(
                q, k, v, causal=causal, window=window, attn_softcap=cap,
                scale=scale, return_ml=True)
        ctx.meta = dict(causal=causal, window=window, attn_softcap=cap,
                        scale=scale, chunk=chunk)
        ctx.save_for_backward(q, k, v, out, m, l)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, m, l, do, **ctx.meta)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, attn_softcap=0.0,
                    scale=None, chunk=512):
    """q: [b, sq, h, hd]; k/v: [b, skv, kvh, hd] -> [b, sq, h, hd], in
    q's dtype.  ``chunk`` is the backward's chunk (``cfg.attn_chunk``)."""
    b, sq, h, hd = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd
            or h % k.shape[2]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if q.device.type in ("cpu", "cuda") and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, attn_softcap,
                                      scale, chunk)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   attn_softcap=attn_softcap, scale=scale)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window, attn_softcap, scale)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


#: kernel launches since the count was last set to 0, in all, by path,
#: and those that also wrote m and l (under autograd)
flash_attention.launches = 0
flash_attention.path_launches = dict.fromkeys(PATH_CODES, 0)
flash_attention.ml_launches = 0
