"""Wrapper of the standalone pooling kernel (K9, ``csrc/pool2d.cu``): the
port of ``repro.kernels.pool2d.ops``.

``pool2d`` runs every pool of an unfused plan.  A CPU tensor goes to the
plain version ``pool2d_ref``; a CUDA tensor launches the kernel (fp32
only) or raises; any other device raises.  The kernel works on the port's
NCHW activations directly, so no layout swap and no channel padding
surround it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_cuda_f32
from repro_torch.kernels.pool2d.ref import pool2d_ref

KIND_CODES = {"max": 1, "avg": 2}


def pool_out_hw(h: int, w: int, kernel, stride):
    """VALID pooling's output size; raises when the window exceeds the
    input."""
    oh = (h - kernel[0]) // stride[0] + 1
    ow = (w - kernel[1]) // stride[1] + 1
    if h < kernel[0] or w < kernel[1] or oh < 1 or ow < 1:
        raise ValueError(f"pool window {tuple(kernel)} larger than input "
                         f"{h}x{w}")
    return oh, ow


def pool2d(x, kernel=(2, 2), stride=(2, 2), kind: str = "max",
           relu: bool = False):
    """x: [N, C, H, W].  VALID max/avg pooling then the optional ReLU, as
    one launch of K9 (CUDA) or its plain version (CPU)."""
    if kind not in KIND_CODES:
        raise ValueError(kind)
    if x.device.type == "cpu":
        return pool2d_ref(x, kernel, stride, kind, relu)
    if x.device.type != "cuda":
        raise ValueError(f"pool2d: unsupported device {x.device}")
    check_cuda_f32("pool2d", x)
    n, c, h, w = x.shape
    oh, ow = pool_out_hw(h, w, kernel, stride)
    y = torch.empty((n, c, oh, ow), dtype=torch.float32, device=x.device)
    rc = _build.library().pool2d_f32(
        x.data_ptr(), y.data_ptr(), n * c, h, w, oh, ow, kernel[0],
        kernel[1], stride[0], stride[1], KIND_CODES[kind], int(relu),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "pool2d_f32")
    pool2d.launches += 1
    return y


#: kernel launches since the count was last set to 0
pool2d.launches = 0
