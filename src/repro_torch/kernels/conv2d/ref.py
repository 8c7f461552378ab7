"""Plain PyTorch convolution and channel LRN (NCHW): the port of
``repro.kernels.conv2d.ref``.

Direct convolution by explicit kernel-position accumulation, fp32 sums —
the paper's §4.1 sequential semantics.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import ACC_DTYPE


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
