"""Plain PyTorch convolutions and channel LRN (NCHW at every function):
the port of ``repro.kernels.conv2d.ref``, plus the plain versions of the
§4.2 and §4.3 conv kernels in the arithmetic of the JAX package's jnp
forms of those methods (``repro.core.methods``).

* ``conv2d_ref`` — direct convolution by explicit kernel-position
  accumulation, fp32 sums: the paper's §4.1 sequential semantics;
* ``conv2d_basic_parallel_ref`` — plain version of K8: NCHW patches, then
  one fp32 contraction with the channels as the outer index;
* ``conv2d_basic_simd_ref`` — plain version of K7: NHWC, one
  ``[rows, C] x [C, OC]`` fp32 dot per kernel position, with the optional
  pool → ReLU → LRN tail of the fused super-layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.layout import nchw_to_nhwc, nhwc_to_nchw, oihw_to_hwio
from repro_torch.kernels.common import ACC_DTYPE
from repro_torch.kernels.pool2d.ref import pool2d_ref


def conv2d_ref(x, w, b, stride=(1, 1), padding=(0, 0), relu=False):
    """x: [N, C, H, W]; w: [OC, C, KH, KW]; b: [OC] -> [N, OC, OH, OW]."""
    n, c, h, wd = x.shape
    oc, _, kh, kw = w.shape
    sy, sx = stride
    py, px = padding
    xp = F.pad(x.to(ACC_DTYPE), (px, px, py, py))
    oh = (h + 2 * py - kh) // sy + 1
    ow = (wd + 2 * px - kw) // sx + 1
    wf = w.to(ACC_DTYPE)
    out = torch.zeros((n, oc, oh, ow), dtype=ACC_DTYPE, device=x.device)
    for i in range(kh):
        for j in range(kw):
            patch = xp[:, :, i:i + (oh - 1) * sy + 1:sy,
                       j:j + (ow - 1) * sx + 1:sx]
            out = out + torch.einsum("nchw,oc->nohw", patch, wf[:, :, i, j])
    out = out + b.to(ACC_DTYPE)[None, :, None, None]
    if relu:
        out = out.clamp_min(0.0)
    return out.to(x.dtype)


def lrn_ref(x, n: int, alpha: float, beta: float, k: float):
    """AlexNet-style LRN across the channels of an NCHW tensor:
    ``x / (k + alpha * sum(x^2 over [c - n//2, c + (n-1)//2]))^beta``.
    ``alpha`` is not divided by ``n`` (unlike
    ``torch.nn.functional.local_response_norm``), and the window is
    asymmetric for even ``n``, so the output keeps C channels."""
    xf = x.to(ACC_DTYPE)
    sq = F.pad(xf * xf, (0, 0, 0, 0, n // 2, n - 1 - n // 2))
    c = x.shape[1]
    acc = torch.zeros_like(xf)
    for i in range(n):
        acc = acc + sq[:, i:i + c]
    return (xf / (k + alpha * acc) ** beta).to(x.dtype)


def _out_hw(h, w, kh, kw, stride, padding):
    return ((h + 2 * padding[0] - kh) // stride[0] + 1,
            (w + 2 * padding[1] - kw) // stride[1] + 1)


def conv2d_basic_parallel_ref(x, w, b, stride=(1, 1), padding=(0, 0),
                              relu=False):
    """§4.2 basic parallel, plain: every output's receptive field as NCHW
    patches ``[n, c*kh*kw, oh*ow]`` (channels the outer index of the
    reduction), contracted with the OIHW kernel in fp32 (JAX
    ``methods.conv2d_basic_parallel`` without Pallas)."""
    n, c, h, wd = x.shape
    oc, _, kh, kw = w.shape
    oh, ow = _out_hw(h, wd, kh, kw, stride, padding)
    cols = F.unfold(x.to(ACC_DTYPE), (kh, kw), padding=tuple(padding),
                    stride=tuple(stride))              # [n, c*kh*kw, oh*ow]
    out = torch.einsum("nkp,ok->nop", cols,
                       w.reshape(oc, c * kh * kw).to(ACC_DTYPE))
    out = out.reshape(n, oc, oh, ow) + b.to(ACC_DTYPE)[None, :, None, None]
    if relu:
        out = out.clamp_min(0.0)
    return out.to(x.dtype)


def pool_lrn_tail(out, pool_kernel=None, pool_stride=None,
                  pool_kind: str = "max", pool_relu: bool = False,
                  lrn_n=None, lrn_alpha: float = 1e-4, lrn_beta: float = 0.75,
                  lrn_k: float = 1.0):
    """The fused super-layer's tail on an NCHW conv output: VALID pool
    (``pool_stride`` defaults to the window) → [ReLU] → [LRN]; no pool
    means no tail."""
    if pool_kernel is None:
        if lrn_n is not None:
            raise ValueError("fused LRN epilogue requires a fused pool "
                             "epilogue")
        return out
    stride = pool_kernel if pool_stride is None else pool_stride
    out = pool2d_ref(out, pool_kernel, stride, pool_kind, relu=pool_relu)
    if lrn_n is not None:
        out = lrn_ref(out, lrn_n, lrn_alpha, lrn_beta, lrn_k)
    return out


def conv2d_basic_simd_ref(x, w, b, stride=(1, 1), padding=(0, 0),
                          relu=False, **tail):
    """§4.3 basic SIMD, plain: dimension swap to NHWC and HWIO, then per
    kernel position one fp32 dot of the strided ``[rows, C]`` input slice
    with the ``[C, OC]`` weight slice (channels innermost), bias and
    [ReLU]; ``tail`` (``pool_kernel``, ``pool_stride``, ``pool_kind``,
    ``pool_relu``, ``lrn_*``) adds the fused pool → [ReLU] → [LRN] tail
    (JAX ``methods._conv_positions_nhwc`` and ``conv2d_pool_fused`` with
    ``BASIC_SIMD``, without Pallas)."""
    n, _, h, wd = x.shape
    oc, c, kh, kw = w.shape
    sy, sx = stride
    py, px = padding
    oh, ow = _out_hw(h, wd, kh, kw, stride, padding)
    xp = F.pad(nchw_to_nhwc(x.to(ACC_DTYPE)), (0, 0, px, px, py, py))
    wh = oihw_to_hwio(w.to(ACC_DTYPE))                 # [kh, kw, c, oc]
    out = torch.zeros((n * oh * ow, oc), dtype=ACC_DTYPE, device=x.device)
    for i in range(kh):
        for j in range(kw):
            patch = xp[:, i:i + (oh - 1) * sy + 1:sy,
                       j:j + (ow - 1) * sx + 1:sx, :]  # [n, oh, ow, c]
            out = out + patch.reshape(n * oh * ow, c) @ wh[i, j]
    out = out + b.to(ACC_DTYPE)
    if relu:
        out = out.clamp_min(0.0)
    out = nhwc_to_nchw(out.reshape(n, oh, ow, oc)).contiguous()
    return pool_lrn_tail(out, **tail).to(x.dtype)
