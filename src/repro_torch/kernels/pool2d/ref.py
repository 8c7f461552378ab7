"""Plain VALID max/avg pooling (NCHW): the port of
``repro.kernels.pool2d.ref``.  The standalone pool kernel of the JAX
package (``pool2d_nhwc``) has no CUDA port yet."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels.common import ACC_DTYPE


def pool2d_ref(x, kernel=(2, 2), stride=(2, 2), kind: str = "max",
               relu: bool = False):
    """x: [N, C, H, W]; VALID windows (no padding); max starts from -inf,
    avg divides by the full ``kh * kw`` window."""
    if kind == "max":
        out = F.max_pool2d(x, tuple(kernel), tuple(stride))
    elif kind == "avg":
        out = F.avg_pool2d(x.to(ACC_DTYPE), tuple(kernel), tuple(stride))
    else:
        raise ValueError(kind)
    if relu:
        out = out.clamp_min(0.0)
    return out.to(x.dtype)
