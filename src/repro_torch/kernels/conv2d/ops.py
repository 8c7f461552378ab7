"""Wrappers of the fused convolution kernels: the port of
``repro.kernels.conv2d.ops``.

* ``conv2d_pool_fused`` — K1 (``csrc/conv_pool_lrn.cu``): conv → bias →
  [ReLU] → [VALID max/avg pool → [ReLU] → [LRN]] in one launch; without a
  pool it is the per-layer conv of the advanced SIMD method.
* ``conv2d_chain`` — K2 (``csrc/conv_chain.cu``): a chain of convs with
  the same optional pool/LRN tail in one launch.

NCHW activations and OIHW weights at every public function, as in the
JAX package.  A CPU tensor goes to the plain version beside each wrapper
(``conv2d_pool_fused_ref``, ``conv2d_chain_ref``); a CUDA tensor launches
the kernel (fp32 only) or raises.  The kernels write NCHW, so the fc
layer after a chain flattens their output as the JAX engine does.

The band geometry (which rows each block computes, how much scratch the
chain needs, how many final rows a block owns) is computed here in
Python and mirrored by ``band_rows`` in ``csrc/conv_common.cuh``, so it
is checked on the CPU too.
"""
from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.common import ACC_DTYPE, check_cuda_f32
from repro_torch.kernels.conv2d.ref import lrn_ref
from repro_torch.kernels.pool2d.ref import pool2d_ref

POOL_CODES = {"max": 1, "avg": 2}
MAX_STAGES = 8            # csrc/conv_common.cuh
GEMM_TILE = 64            # TP and TO in csrc/conv_common.cuh
GEMM_GROUPS = 4           # GROUPS in csrc/conv_common.cuh: tiles run 4 at a time
SMEM_LIMIT = 190 * 1024   # dynamic shared memory a block may take (bytes):
                          # 227 KB less the 33 KB of static GEMM tiles


class Stage(NamedTuple):
    """One conv stage of a band kernel, with its input and output sizes."""
    C: int
    H: int
    W: int
    OC: int
    KH: int
    KW: int
    sy: int
    sx: int
    py: int
    px: int
    relu: bool
    OH: int
    OW: int


class Pool(NamedTuple):
    kh: int
    kw: int
    sy: int
    sx: int
    kind: str


def make_stages(in_chw, ws, strides, paddings, relus) -> List[Stage]:
    """Stage geometry of a conv chain entering at ``in_chw = (C, H, W)``;
    ``ws`` are the stages' OIHW weight shapes (or tensors)."""
    c, h, w = in_chw
    out = []
    for wt, (sy, sx), (py, px), relu in zip(ws, strides, paddings, relus):
        oc, ci, kh, kw = tuple(wt.shape) if hasattr(wt, "shape") else wt
        if ci != c:
            raise ValueError(f"stage input channels {ci} != {c}")
        oh = (h + 2 * py - kh) // sy + 1
        ow = (w + 2 * px - kw) // sx + 1
        if oh < 1 or ow < 1:
            raise ValueError("conv output is empty")
        out.append(Stage(c, h, w, oc, kh, kw, sy, sx, py, px, bool(relu),
                         oh, ow))
        c, h, w = oc, oh, ow
    return out


def final_rows(stages: Sequence[Stage], pool: Optional[Pool]):
    """``(total, out_h, out_w)``: final rows the blocks split, and the
    output's spatial size."""
    last = stages[-1]
    if pool is None:
        return last.OH, last.OH, last.OW
    ph = (last.OH - pool.kh) // pool.sy + 1
    pw = (last.OW - pool.kw) // pool.sx + 1
    if ph < 1 or pw < 1:
        raise ValueError("pool window larger than the conv output")
    return ph, ph, pw


def band_rows(stages: Sequence[Stage], pool: Optional[Pool], blk: int,
              t: int) -> List[Tuple[int, int]]:
    """Rows ``[a, b)`` of every stage's output that the block owning final
    rows ``[t*blk, (t+1)*blk)`` computes: walked back from the last stage,
    each clipped to the stage's valid output (rows outside it are the next
    stage's zero padding).  Same arithmetic as ``band_rows`` in
    ``csrc/conv_common.cuh``."""
    total = final_rows(stages, pool)[0]
    f0 = t * blk
    f1 = min(f0 + blk, total)
    if pool is not None:
        a, b = f0 * pool.sy, (f1 - 1) * pool.sy + pool.kh
    else:
        a, b = f0, f1
    rows = [(a, b)]
    for st in reversed(stages[1:]):
        a, b = max(0, a * st.sy - st.py), min(st.H, (b - 1) * st.sy - st.py
                                              + st.KH)
        rows.insert(0, (a, b))
    return rows


def _stage_time(st: Stage, rows: int) -> int:
    """Time of one block on ``rows`` output rows of a stage, in units of
    one 64 x 64 GEMM tile's TK slice: the block's GEMM_GROUPS groups take
    the tiles in rounds, and a tile costs its reduction depth."""
    tiles = (math.ceil(rows * st.OW / GEMM_TILE)
             * math.ceil(st.OC / GEMM_TILE))
    return math.ceil(tiles / GEMM_GROUPS) * st.C * st.KH * st.KW


def block_time(stages, pool, blk) -> int:
    """The slowest block's time when each block owns ``blk`` final rows."""
    total = final_rows(stages, pool)[0]
    return max(sum(_stage_time(st, b - a) for st, (a, b)
                   in zip(stages, band_rows(stages, pool, blk, t)))
               for t in range(math.ceil(total / blk)))


def k1_smem(stages, pool, lrn: bool, blk: int) -> int:
    """K1's dynamic shared memory: the conv band plus, with LRN, the
    pooled band."""
    if pool is None:
        return 0
    st = stages[0]
    a, b = band_rows(stages, pool, blk, 0)[0]
    out_w = final_rows(stages, pool)[2]
    return 4 * (st.OC * (b - a) * st.OW + (st.OC * blk * out_w if lrn else 0))


def k2_smem(stages, pool, lrn: bool, blk: int) -> int:
    """K2's dynamic shared memory: the pooled band (LRN only)."""
    if pool is None or not lrn:
        return 0
    return 4 * stages[-1].OC * blk * final_rows(stages, pool)[2]


def rows_per_block(stages, pool, n: int, sms: int, smem_fn) -> int:
    """Final rows a block owns.  Fewer rows make more blocks but
    recompute more halo rows.  A block of 1024 threads at 64 registers
    fills an SM, so the grid runs in waves of ``sms`` blocks and the time
    model is waves × the slowest block's time.  ``smem_fn(blk)`` must stay
    within ``SMEM_LIMIT``."""
    total = final_rows(stages, pool)[0]
    best, best_cost = None, None
    for blk in range(1, total + 1):
        if smem_fn(blk) > SMEM_LIMIT:
            break
        waves = math.ceil(n * math.ceil(total / blk) / sms)
        cost = waves * block_time(stages, pool, blk)
        if best_cost is None or cost < best_cost:
            best, best_cost = blk, cost
    if best is None:
        raise ValueError(f"band of one final row needs {smem_fn(1)} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    return best


def chain_scratch_stride(stages, pool, blk: int) -> int:
    """Floats of one scratch band: the largest band any block writes to
    scratch (every stage but a pool-less last one, which goes straight to
    the output)."""
    total = final_rows(stages, pool)[0]
    n_scratch = len(stages) if pool is not None else len(stages) - 1
    stride = 1
    for t in range(math.ceil(total / blk)):
        rows = band_rows(stages, pool, blk, t)
        for st, (a, b) in list(zip(stages, rows))[:n_scratch]:
            stride = max(stride, st.OC * (b - a) * st.OW)
    return stride


def pack_geo(n: int, stages, pool: Optional[Pool], pool_relu: bool,
             lrn, blk: int):
    """The ``geo`` int array and ``lrn`` float array of
    ``csrc/conv_common.cuh``."""
    total, out_h, out_w = final_rows(stages, pool)
    hdr = [n, len(stages),
           POOL_CODES[pool.kind] if pool is not None else 0,
           *(pool[:4] if pool is not None else (1, 1, 1, 1)),
           int(pool_relu), lrn[0] if lrn is not None else 0, blk,
           math.ceil(total / blk), total, out_h, out_w]
    body = [v for st in stages for v in (*st[:10], int(st.relu), st.OH,
                                         st.OW)]
    geo = np.asarray(hdr + body, dtype=np.int32)
    lrn_f = np.asarray(lrn[1:] if lrn is not None else (0.0, 0.0, 1.0),
                       dtype=np.float32)
    return geo, lrn_f


def _pool_lrn(pool_kernel, pool_stride, pool_kind, lrn_n, lrn_alpha,
              lrn_beta, lrn_k):
    if lrn_n is not None and pool_kernel is None:
        raise ValueError("fused LRN epilogue requires a fused pool epilogue")
    pool = None
    if pool_kernel is not None:
        if pool_kind not in POOL_CODES:
            raise ValueError(pool_kind)
        ps = tuple(pool_stride) if pool_stride is not None else tuple(
            pool_kernel)
        pool = Pool(*pool_kernel, *ps, pool_kind)
    lrn = (lrn_n, lrn_alpha, lrn_beta, lrn_k) if lrn_n is not None else None
    return pool, lrn


# -- plain versions -----------------------------------------------------------


def _conv_im2col(x, w, b, stride, padding, relu):
    """Full-width im2col conv in fp32 (the §4.4 advanced SIMD arithmetic)."""
    n, _, h, wd = x.shape
    oc, _, kh, kw = w.shape
    oh = (h + 2 * padding[0] - kh) // stride[0] + 1
    ow = (wd + 2 * padding[1] - kw) // stride[1] + 1
    cols = F.unfold(x.to(ACC_DTYPE), (kh, kw), padding=tuple(padding),
                    stride=tuple(stride))              # [n, c*kh*kw, oh*ow]
    out = w.reshape(oc, -1).to(ACC_DTYPE) @ cols       # [n, oc, oh*ow]
    out = out.reshape(n, oc, oh, ow) + b.to(ACC_DTYPE)[None, :, None, None]
    return out.clamp_min(0.0) if relu else out


def _tail(out, pool: Optional[Pool], pool_relu, lrn):
    if pool is None:
        return out
    out = pool2d_ref(out, (pool.kh, pool.kw), (pool.sy, pool.sx), pool.kind,
                     relu=pool_relu)
    if lrn is not None:
        out = lrn_ref(out, *lrn)
    return out


def conv2d_pool_fused_ref(x, w, b, stride=(1, 1), padding=(0, 0),
                          relu=False, pool_kernel=None, pool_stride=None,
                          pool_kind: str = "max", pool_relu: bool = False,
                          lrn_n=None, lrn_alpha: float = 1e-4,
                          lrn_beta: float = 0.75, lrn_k: float = 1.0):
    """Plain version of K1: conv → bias → [ReLU] → [pool → [ReLU] →
    [LRN]] (the JAX package's ``methods.conv2d_pool_fused`` without
    Pallas)."""
    pool, lrn = _pool_lrn(pool_kernel, pool_stride, pool_kind, lrn_n,
                          lrn_alpha, lrn_beta, lrn_k)
    out = _conv_im2col(x, w, b, stride, padding, relu)
    return _tail(out, pool, pool_relu, lrn).to(x.dtype)


def conv2d_chain_ref(x, ws, bs, strides, paddings, relus, pool_kernel=None,
                     pool_stride=None, pool_kind: str = "max",
                     pool_relu: bool = False, lrn_n=None,
                     lrn_alpha: float = 1e-4, lrn_beta: float = 0.75,
                     lrn_k: float = 1.0):
    """Plain version of K2: each stage's conv (zero padding between
    stages) with bias and [ReLU], then the optional pool/LRN tail."""
    pool, lrn = _pool_lrn(pool_kernel, pool_stride, pool_kind, lrn_n,
                          lrn_alpha, lrn_beta, lrn_k)
    out = x.to(ACC_DTYPE)
    for w, b, s, p, r in zip(ws, bs, strides, paddings, relus):
        out = _conv_im2col(out, w, b, s, p, r)
    return _tail(out, pool, pool_relu, lrn).to(x.dtype)


# -- kernel wrappers ----------------------------------------------------------


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=256)
def k1_launch(n, in_chw, w_shape, stride, padding, relu, pool, pool_relu, lrn,
              sms):
    """K1's launch geometry for one call signature (hashable arguments):
    ``(stages, smem, geo, lrn_f)``.  Memoized, so that a forward does not
    repeat the ``rows_per_block`` search; the arrays are read-only."""
    stages = make_stages(in_chw, [w_shape], [stride], [padding], [relu])
    blk = rows_per_block(stages, pool, n, sms,
                         lambda k: k1_smem(stages, pool, lrn is not None, k))
    geo, lrn_f = pack_geo(n, stages, pool, pool_relu, lrn, blk)
    geo.setflags(write=False)
    lrn_f.setflags(write=False)
    return stages, k1_smem(stages, pool, lrn is not None, blk), geo, lrn_f


@functools.lru_cache(maxsize=256)
def k2_launch(n, in_chw, w_shapes, strides, paddings, relus, pool, pool_relu,
              lrn, sms):
    """K2's launch geometry for one call signature: ``(stages, smem,
    scratch_stride, geo, lrn_f)``; memoized like ``k1_launch``."""
    stages = make_stages(in_chw, w_shapes, strides, paddings, relus)
    blk = rows_per_block(stages, pool, n, sms,
                         lambda k: k2_smem(stages, pool, lrn is not None, k))
    geo, lrn_f = pack_geo(n, stages, pool, pool_relu, lrn, blk)
    geo.setflags(write=False)
    lrn_f.setflags(write=False)
    return (stages, k2_smem(stages, pool, lrn is not None, blk),
            chain_scratch_stride(stages, pool, blk), geo, lrn_f)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def conv2d_pool_fused(x, w, b, stride=(1, 1), padding=(0, 0), relu=False,
                      pool_kernel=None, pool_stride=None,
                      pool_kind: str = "max", pool_relu: bool = False,
                      lrn_n=None, lrn_alpha: float = 1e-4,
                      lrn_beta: float = 0.75, lrn_k: float = 1.0):
    """x: [N, C, H, W]; w: [OC, C, KH, KW]; b: [OC].  conv → bias →
    [ReLU] → [VALID pool → [ReLU] → [LRN]] as one launch of K1 (CUDA) or
    its plain version (CPU).  ``pool_stride`` defaults to the window."""
    kwargs = dict(pool_kernel=pool_kernel, pool_stride=pool_stride,
                  pool_kind=pool_kind, pool_relu=pool_relu, lrn_n=lrn_n,
                  lrn_alpha=lrn_alpha, lrn_beta=lrn_beta, lrn_k=lrn_k)
    if x.device.type == "cpu":
        return conv2d_pool_fused_ref(x, w, b, stride, padding, relu, **kwargs)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_pool_fused: unsupported device {x.device}")
    check_cuda_f32("conv2d_pool_fused", x, w, b)
    pool, lrn = _pool_lrn(pool_kernel, pool_stride, pool_kind, lrn_n,
                          lrn_alpha, lrn_beta, lrn_k)
    n = x.shape[0]
    stages, smem, geo, lrn_f = k1_launch(
        n, tuple(x.shape[1:]), tuple(w.shape), tuple(stride), tuple(padding),
        bool(relu), pool, bool(pool_relu), lrn, _sms(x.device))
    if tuple(b.shape) != (stages[0].OC,):
        raise ValueError(f"bias shape {tuple(b.shape)} != ({stages[0].OC},)")
    _, out_h, out_w = final_rows(stages, pool)
    out = torch.empty((n, stages[0].OC, out_h, out_w), dtype=torch.float32,
                      device=x.device)
    rc = _build.library().conv_pool_lrn_f32(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        geo.ctypes.data, lrn_f.ctypes.data, smem, _stream(x.device))
    _build.check(rc, "conv_pool_lrn_f32")
    conv2d_pool_fused.launches += 1
    return out


def conv2d_chain(x, ws, bs, strides, paddings, relus, pool_kernel=None,
                 pool_stride=None, pool_kind: str = "max",
                 pool_relu: bool = False, lrn_n=None,
                 lrn_alpha: float = 1e-4, lrn_beta: float = 0.75,
                 lrn_k: float = 1.0):
    """A chain of consecutive convs (``ws``/``bs``: per-stage OIHW
    weights and biases; ``strides``/``paddings``/``relus``: per-stage
    tuples) with the optional pool/LRN tail, as one launch of K2 (CUDA)
    or its plain version (CPU)."""
    kwargs = dict(pool_kernel=pool_kernel, pool_stride=pool_stride,
                  pool_kind=pool_kind, pool_relu=pool_relu, lrn_n=lrn_n,
                  lrn_alpha=lrn_alpha, lrn_beta=lrn_beta, lrn_k=lrn_k)
    if x.device.type == "cpu":
        return conv2d_chain_ref(x, ws, bs, strides, paddings, relus, **kwargs)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_chain: unsupported device {x.device}")
    if not 1 <= len(ws) <= MAX_STAGES:
        raise ValueError(f"a chain takes 1 to {MAX_STAGES} stages")
    check_cuda_f32("conv2d_chain", x, *ws, *bs)
    pool, lrn = _pool_lrn(pool_kernel, pool_stride, pool_kind, lrn_n,
                          lrn_alpha, lrn_beta, lrn_k)
    n = x.shape[0]
    stages, smem, stride, geo, lrn_f = k2_launch(
        n, tuple(x.shape[1:]), tuple(tuple(w.shape) for w in ws),
        tuple(map(tuple, strides)), tuple(map(tuple, paddings)),
        tuple(map(bool, relus)), pool, bool(pool_relu), lrn, _sms(x.device))
    for st, b in zip(stages, bs):
        if tuple(b.shape) != (st.OC,):
            raise ValueError(f"bias shape {tuple(b.shape)} != ({st.OC},)")
    n_tiles = int(geo[10])
    _, out_h, out_w = final_rows(stages, pool)
    out = torch.empty((n, stages[-1].OC, out_h, out_w), dtype=torch.float32,
                      device=x.device)
    scratch = torch.empty(n * n_tiles * 2 * stride, dtype=torch.float32,
                          device=x.device)
    w_ptrs = np.asarray([w.data_ptr() for w in ws], dtype=np.uint64)
    b_ptrs = np.asarray([b.data_ptr() for b in bs], dtype=np.uint64)
    rc = _build.library().conv_chain_f32(
        x.data_ptr(), w_ptrs.ctypes.data, b_ptrs.ctypes.data, out.data_ptr(),
        scratch.data_ptr(), stride, geo.ctypes.data, lrn_f.ctypes.data, smem,
        _stream(x.device))
    _build.check(rc, "conv_chain_f32")
    conv2d_chain.launches += 1
    return out


#: kernel launches since the count was last set to 0
conv2d_pool_fused.launches = 0
conv2d_chain.launches = 0
