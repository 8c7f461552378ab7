"""Wrapper of the WKV6 chunked kernel (K11, ``csrc/wkv6.cu``): the port of
``repro.kernels.wkv6`` with the contract of ``repro.nn.rwkv._wkv6_chunked``
(an initial state in, the final state out), which is where the model
calls it.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
(r, k and v both fp32 or both bf16, logw, u and the state fp32, head
width 64, chunks of at most 64 steps) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_cuda, check_cuda_f32
from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref

HEAD_DIM = 64   # E in csrc/wkv6.cu
MAX_CHUNK = 64  # LMAX in csrc/wkv6.cu


def _launch(r, k, v, logw, u, L, state):
    check_cuda("wkv6", r, k, v)
    check_cuda_f32("wkv6 logw, u, state", logw, u,
                   *([] if state is None else [state]))
    if logw.device != r.device:
        raise ValueError("wkv6: all tensors must be on one CUDA device")
    b, s, h, e = r.shape
    if e != HEAD_DIM or not 1 <= L <= MAX_CHUNK:
        raise ValueError(f"wkv6: the kernel takes head width {HEAD_DIM} and "
                         f"chunks of 1 to {MAX_CHUNK} steps, got {e} and {L}")
    o = torch.empty_like(r)
    s_out = torch.empty((b, h, e, e), dtype=torch.float32, device=r.device)
    entry = "wkv6_bf16" if r.dtype == torch.bfloat16 else "wkv6_f32"
    rc = getattr(_build.library(), entry)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), None if state is None else state.data_ptr(),
        o.data_ptr(), s_out.data_ptr(), b, s, h, L,
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(rc, entry)
    wkv6.launches += 1
    return o, s_out


def wkv6(r, k, v, logw, u, *, chunk: int, state=None):
    """r, k, v, logw: [b, s, h, e]; u: [h, e]; state: [b, h, e, e] or None
    (zero) -> (o [b, s, h, e] in r's dtype, final state [b, h, e, e] fp32),
    over chunks of ``min(chunk, s)`` steps."""
    b, s, h, e = r.shape
    if (k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape
            or tuple(u.shape) != (h, e) or chunk < 1 or s < 1
            or (state is not None and tuple(state.shape) != (b, h, e, e))):
        raise ValueError(
            f"wkv6: r {tuple(r.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, logw {tuple(logw.shape)}, u {tuple(u.shape)}"
            f", state {None if state is None else tuple(state.shape)}, "
            f"chunk {chunk}")
    if r.device.type == "cpu":
        return wkv6_chunked_ref(r, k, v, logw, u, chunk, state)
    if r.device.type == "cuda":
        return _launch(r, k, v, logw, u, min(chunk, s), state)
    raise ValueError(f"wkv6: unsupported device {r.device}")


#: kernel launches since the count was last set to 0
wkv6.launches = 0
