"""Wrapper of the fused bias+activation matmul kernel (K3,
``csrc/matmul_fused.cu``): the port of ``repro.kernels.matmul_fused``.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
(x and w both fp32 or both bf16, read as they are; the bias fp32) or
raises.  The path is chosen from the type, the shape and the pointers
alone, before the launch (``k3_path``): the weight stream below
``TILED_MIN_M`` rows (one launch a call, its K slicing ``split_k`` a
function of K, N and the SM count, memoized), TMA + wgmma tiles for bf16
from there on when TMA can describe both operands, CUDA-core tiles
otherwise.  A refused launch raises; nothing retries on another path.

Under autograd (grad enabled and x, w or b requiring grad) the call goes
through :class:`MatmulFusedFn`, whose backward is K3 too, on transposed
operands: ``dz = dy * act'(z)``, ``dx = dz w^T`` and ``dw = x^T dz``, each
one K3 call (the kernel on the card, the plain version on the CPU), and
``db`` the fp32 column sum of dz.  ``z`` (before the activation) is
recomputed by one more K3 call with ``act="none"`` where the activation
needs it (silu, gelu); relu reads its mask from y.  The first version
passes ``w.t().contiguous()`` and ``x.t().contiguous()``: K3 reads
row-major ``[K, N]`` only.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import ACC_DTYPE, check_cuda, sm_count
from repro_torch.kernels.common import stream_handle as _stream
from repro_torch.kernels.matmul_fused.ref import _ACTS, matmul_fused_ref

ACT_CODES = {"none": 0, "relu": 1, "silu": 2, "gelu": 3}
TILED_MIN_M = 64      # from this M on, a tiled path (the stream below)
#: the C entry's path codes
PATH_CODES = {"stream": 0, "tiles": 1, "wgmma": 2}
TMA_ALIGN = 16        # bytes: TMA's base alignment and stride multiple
#: the weight stream's slicing constants (``SW_*`` in csrc/matmul_fused.cu):
#: output columns of a block, K rows of a ring stage by type, the most K
#: slices (the blocks of one cluster) and the blocks an SM the slicing
#: aims at
STREAM_BN = 64
STREAM_BK = {torch.bfloat16: 64, torch.float32: 32}
STREAM_CLUSTER = 8
STREAM_BLOCKS_PER_SM = 2


def tma_ok(k: int, n: int, x_ptr: int = 0, w_ptr: int = 0) -> bool:
    """True when TMA can describe bf16 ``x [m, k]`` and ``w [k, n]``: row
    strides ``2 k`` and ``2 n`` bytes multiples of 16 and both bases
    16-byte aligned."""
    return ((2 * k) % TMA_ALIGN == 0 and (2 * n) % TMA_ALIGN == 0
            and x_ptr % TMA_ALIGN == 0 and w_ptr % TMA_ALIGN == 0)


def k3_path(dtype, m: int, k: int, n: int, x_ptr: int = 0,
            w_ptr: int = 0) -> str:
    """The path of an ``[m, k] x [k, n]`` product of ``dtype`` operands at
    ``x_ptr``, ``w_ptr``: ``"stream"`` below ``TILED_MIN_M`` rows,
    ``"wgmma"`` for bf16 that TMA can describe, ``"tiles"`` otherwise."""
    if m < TILED_MIN_M:
        return "stream"
    if dtype == torch.bfloat16 and tma_ok(k, n, x_ptr, w_ptr):
        return "wgmma"
    return "tiles"


@functools.lru_cache(maxsize=None)
def split_k(dtype, k: int, n: int, sms: int) -> Tuple[int, int]:
    """``(splits, kchunk)`` of the weight stream for ``dtype`` operands
    ``[m, k] x [k, n]`` on a card with ``sms`` SMs, whatever ``m``: K cut
    into ``splits`` slices of ``kchunk`` rows, whole ring stages, none
    empty, so that the ``ceil(n / STREAM_BN)`` column blocks times the
    slices come to about ``STREAM_BLOCKS_PER_SM`` blocks an SM, with at
    most ``STREAM_CLUSTER`` slices (one cluster).  A function of the type,
    K, N and the SM count only, so a row's sums never depend on how many
    rows share the call.  Memoized: the wrapper asks on every call."""
    return split_k_aimed(dtype, k, n, sms, STREAM_BLOCKS_PER_SM)


def split_k_aimed(dtype, k: int, n: int, sms: int,
                  blocks_per_sm: int) -> Tuple[int, int]:
    """``split_k``'s rule aimed at ``blocks_per_sm`` blocks an SM (the
    stream's aim is ``STREAM_BLOCKS_PER_SM``; ``tools/k3_stream_probe.py``
    times others)."""
    bk = STREAM_BK[dtype]
    steps = math.ceil(k / bk)
    want = math.ceil(blocks_per_sm * sms / math.ceil(n / STREAM_BN))
    per = math.ceil(steps / max(1, min(STREAM_CLUSTER, steps, want)))
    return math.ceil(steps / per), per * bk


def _launch(x, w, b, act, path=None, role="forward"):
    """Launch K3 on CUDA tensors: one call of the C entry, which launches
    one kernel, with nothing allocated but y.  ``path`` (default:
    ``k3_path``'s choice) may name another path, for timing one beside the
    other; ``role`` names what the launch computes for the counters
    (``forward``, or a backward's ``z``, ``dx``, ``dw``)."""
    check_cuda("matmul_fused", x, w)
    m, k = x.shape
    n = w.shape[1]
    if b is not None:
        check_cuda("matmul_fused bias", b, dtypes=(torch.float32,))
        if b.shape != (n,) or b.device != x.device:
            raise ValueError(f"matmul_fused: bias {tuple(b.shape)} on "
                             f"{b.device}, expected ({n},) on {x.device}")
    chosen = k3_path(x.dtype, m, k, n, x.data_ptr(), w.data_ptr())
    path = chosen if path is None else path
    if (path not in PATH_CODES or (path == "wgmma" and chosen != "wgmma")
            or (path == "stream" and chosen != "stream")):
        raise ValueError(f"matmul_fused: path {path!r} cannot take "
                         f"{x.dtype} [{m}, {k}] x [{k}, {n}]")
    splits, kchunk = (split_k(x.dtype, k, n, sm_count(x.device))
                      if path == "stream" else (0, 0))
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    entry = ("matmul_fused_bf16" if x.dtype == torch.bfloat16
             else "matmul_fused_f32")
    rc = getattr(_build.library(), entry)(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), m, n, k, PATH_CODES[path], splits, kchunk,
        ACT_CODES[act], _stream(x.device))
    _build.check(rc, entry)
    matmul_fused.launches += 1
    matmul_fused.path_launches[path] += 1
    matmul_fused.role_launches[role] += 1
    return y


def _call(x, w, b, act, role="forward"):
    """One K3 call on 2-D operands: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type == "cuda":
        return _launch(x, w, b, act, role=role)
    if x.device.type == "cpu":
        return matmul_fused_ref(x, w, b, act)
    raise ValueError(f"matmul_fused: unsupported device {x.device}")


def act_grad(act: str, z):
    """act'(z) in the accumulation type (fp32), for the activations of
    ``_ACTS`` (gelu in its tanh form)."""
    z = z.to(ACC_DTYPE)
    if act == "silu":
        sg = torch.sigmoid(z)
        return sg * (1.0 + z * (1.0 - sg))
    if act == "gelu":
        c = 0.7978845608028654
        t = torch.tanh(c * (z + 0.044715 * z ** 3))
        return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * c * (
            1.0 + 3 * 0.044715 * z * z)
    raise ValueError(f"act_grad: {act!r}")


class MatmulFusedFn(torch.autograd.Function):
    """K3 with its backward on K3: ``dx = dz w^T`` and ``dw = x^T dz`` on
    copies of the transposed operands, ``dz = dy act'(z)`` in fp32 cast to
    x's dtype, ``db`` its fp32 column sum.  x is 2-D."""

    @staticmethod
    def forward(ctx, x, w, b, act):
        ctx.act = act
        y = _call(x, w, b, act)
        # relu's act'(z) is y > 0 (y and z share their sign)
        ctx.save_for_backward(x, w, b, y if act == "relu" else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, b, y = ctx.saved_tensors
        act = ctx.act
        dy = dy.contiguous()
        if act == "none":
            dz = dy
        elif act == "relu":
            dz = dy * (y > 0).to(dy.dtype)
        else:
            z = _call(x, w, b, "none", role="z")
            dz = (dy.to(ACC_DTYPE) * act_grad(act, z)).to(x.dtype)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _call(dz, w.t().contiguous(), None, "none", role="dx")
        if ctx.needs_input_grad[1]:
            dw = _call(x.t().contiguous(), dz, None, "none", role="dw")
        if b is not None and ctx.needs_input_grad[2]:
            db = dz.to(ACC_DTYPE).sum(dim=0)
        return dx, dw, db, None


def matmul_fused(x, w, b=None, act: str = "none"):
    """y = act(x @ w + b).  Leading dims of x are flattened to M.  fp32
    accumulation, bias and activation; one cast to x's dtype.  Under
    autograd it goes through :class:`MatmulFusedFn`."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"matmul_fused: x {tuple(x.shape)} vs w "
                         f"{tuple(w.shape)}")
    if x.dim() != 2:
        return matmul_fused(x.reshape(-1, x.shape[-1]), w, b, act).reshape(
            *x.shape[:-1], w.shape[-1])
    if torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad
            or (b is not None and b.requires_grad)):
        return MatmulFusedFn.apply(x, w, b, act)
    return _call(x, w, b, act)


#: kernel launches since the count was last set to 0, in all, by path and
#: by role (``forward``: a forward or a remat recompute; a backward's
#: ``z``, ``dx`` and ``dw``)
matmul_fused.launches = 0
matmul_fused.path_launches = dict.fromkeys(PATH_CODES, 0)
matmul_fused.role_launches = dict.fromkeys(("forward", "z", "dx", "dw"), 0)
