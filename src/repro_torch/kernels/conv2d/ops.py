"""Wrappers of the fused convolution kernels: the port of
``repro.kernels.conv2d.ops``.

* ``conv2d_pool_fused`` — K1 (``csrc/conv_chain.cu``): conv → bias →
  [ReLU] → [VALID max/avg pool → [ReLU] → [LRN]] in one cooperative
  launch of the stage-major kernel (``csrc/conv_stage_major.cuh``) with
  one stage; without a pool it is the per-layer conv of the advanced SIMD
  method.
* ``conv2d_chain`` — K2 (``csrc/conv_chain.cu``): a chain of convs with
  the same optional pool/LRN tail in one cooperative launch of the same
  kernel (every stage one implicit GEMM over the whole batch, spread
  over every SM; ``chain_plan``).
* ``conv2d_basic_simd`` — K7 (``csrc/conv_basic_simd.cu``): the §4.3
  conv, NHWC with a channel dot per kernel position, on the register-tiled
  core of ``csrc/conv_simt_tile.cuh``; with a pool it is the fused conv →
  pool → LRN super-layer of that rung.
* ``conv2d_basic_parallel`` — K8 (``csrc/conv_basic_parallel.cu``): the
  §4.2 conv, NCHW, channels the outer loop, on the same register-tiled
  core over shared-memory halos of a chunk of channels.
* ``conv2d_pool_lrn_halo`` — K4 (``csrc/conv_chain.cu``): K1's conv →
  pool → LRN group, which the TPU kernel splits into channel tiles widened
  by the LRN window's halo, as a one-stage launch of the stage-major
  kernel on K1's plan: its LRN tail runs after a grid barrier and sees
  every channel of a pixel, so no halo is left to compute, and the two
  give the same bits.
* ``conv2d_pool_carry`` — K5 (``csrc/conv_chain.cu``): K1's conv →
  pool group (no LRN) as a one-stage launch of the stage-major kernel,
  where each conv row is computed once, which the TPU kernel's carry
  buys; on the same plan as K1, so the two give the same bits.
* ``conv2d_chain_ocb`` — K6 (``csrc/conv_chain.cu``, K2's kernel and
  schedule): K2's chain with the final stage's items at least
  ``oc_block_final`` channels wide.

Which of K1, K4 and K5 a fused group runs on, and whether a chain runs on
K2 or K6, is decided by the resolvers ``resolve_lrn_ocb``,
``resolve_pool_carry`` and ``resolve_oc_block_final`` (the JAX package's
rules, read against the port's own tiling), which the method dispatch and
the plan's ``fusion_report`` share.

NCHW activations and OIHW weights at every public function, as in the
JAX package.  A CPU tensor goes to the plain version beside each wrapper
(``conv2d_pool_fused_ref`` for K1, K4 and K5, ``conv2d_chain_ref`` for K2
and K6, and
``conv2d_basic_simd_ref`` / ``conv2d_basic_parallel_ref`` from ``ref.py``);
a CUDA tensor launches the kernel (fp32 only) or raises; any other device
raises ``ValueError``.  The kernels write NCHW, so the fc layer after a
conv flattens their output as the JAX engine does.

The launch geometry (which rows K7's band block computes; the
stage-major items, partials and scratch) is computed here in Python and
handed to the kernels (the band by ``band_rows`` in
``csrc/conv_common.cuh``, the stage-major schedule by ``plan[]``), so it
is checked on the CPU too.  Each wrapper reads it from shapes alone
through one function (``stage_major_geometry``, ``k7_geometry``,
``k8_geometry``), which the plan verifier
(``repro_torch.analysis.verifier``) calls too, so the geometry it proves
is the one the wrapper launches.  A geometry the kernel cannot take
raises ``LaunchGeometryError``.
"""
from __future__ import annotations

import ctypes
import functools
import math
import weakref
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.layout import nchw_to_nhwc, oihw_to_hwio, pad_axis
from repro_torch.kernels import _build
from repro_torch.kernels.common import (ACC_DTYPE, Launch,
                                        LaunchGeometryError, alloc,
                                        check_cuda_f32, operand,
                                        operand_ptrs,
                                        sm_count as _sms,
                                        stream_handle as _stream)
from repro_torch.kernels.conv2d.ref import (
    conv2d_basic_parallel_ref,
    conv2d_basic_simd_ref,
    pool_lrn_tail,
)

POOL_CODES = {"max": 1, "avg": 2}
MAX_STAGES = 8            # csrc/conv_common.cuh
K7_SMEM_LIMIT = 227 * 1024  # K7 and K8 have no static tiles: the whole 227 KB
K7_ALIGN = 4              # K7's channels: zero-padded to whole float4s
#: the register-tiled core of K7 and K8 (csrc/conv_simt_tile.cuh): a group
#: of threads owns ST_TP output pixels x ST_TO output channels; a weight
#: tile's rows are ST_BROW floats
ST_TP, ST_TO, ST_BROW = 128, 64, 72
#: K7's stage (csrc/conv_basic_simd.cu): K7_CK reduction rows, input pixel
#: rows of K7_AROW floats; two stages a group, at most K7_MAX_GROUPS groups
#: in a fused block
K7_CK, K7_AROW, K7_MAX_GROUPS = 16, 20, 2
K7_RING = 2 * (ST_TP * K7_AROW + K7_CK * ST_BROW)   # floats
#: K8's stage budget in floats: its chunk of input channels (``cc``) is the
#: most whose halos and weights fit it (a 64 KB ring of two stages)
K8_STAGE_FLOATS = 8192
#: the JAX package's oc tile of each advanced method (the paper's 4 or 8
#: output channels a thread): the width its LRN blocking rule compares with
#: the layer's channels
ADVANCED_OC_BLOCK = {"advanced_simd_4": 4, "advanced_simd_8": 8}
#: the stage-major schedule (csrc/conv_stage_major.cuh: K1, K2, K4-K6):
#: blocks of CH_THREADS threads on the register-tiled core, at least
#: CH_MIN_BLOCKS of them resident an SM (its launch bounds), so the
#: cooperative grid is CH_MIN_BLOCKS x the SMs; a ring slot holds CH_CK
#: reduction rows, pixel rows of CH_AROW floats, a chunk of a tap at most
#: CH_CHUNK_SLOTS slots; the dynamic shared memory is the two-slot ring,
#: the fold (64 floats a thread) and three ints a tile pixel
CH_THREADS, CH_MIN_BLOCKS, CH_CK, CH_AROW = 128, 3, 16, 20
CH_CHUNK_SLOTS = 8
CH_RING = 2 * (ST_TP * CH_AROW + CH_CK * ST_BROW)   # floats
CH_SMEM = 4 * (CH_RING + ST_TP * ST_TO + 3 * ST_TP)  # bytes
#: the most partial bytes a stage may write for items of one chunk or one
#: tap; past it the items take a whole kernel row or the whole reduction
#: (fewer, larger partials, or none)
CH_PARTIAL_BYTES = 24 * 2 ** 20
#: the stage-major kernel addresses its scratch with 32-bit float offsets
CH_SCRATCH_LIMIT = 2 ** 31


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


def k1_smem(stages, pool, lrn: bool, blk: int) -> int:
    """A band block's dynamic shared memory (the layout of K7's fused
    block): the conv band plus, with LRN, the pooled band."""
    if pool is None:
        return 0
    st = stages[0]
    a, b = band_rows(stages, pool, blk, 0)[0]
    out_w = final_rows(stages, pool)[2]
    return 4 * (st.OC * (b - a) * st.OW + (st.OC * blk * out_w if lrn else 0))


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


# -- the second-generation cells: resolvers and geometry ---------------------


def resolve_lrn_ocb(oc: int, oc_block: int, lrn,
                    lrn_oc_block) -> Tuple[int, int]:
    """``(ocb, oc_halo)`` of a fused conv → pool → LRN group, in the JAX
    package's terms (``repro.kernels.conv2d.kernels.resolve_lrn_ocb``):
    ``oc_halo > 0`` routes the group to K4.  ``lrn`` is ``(n, alpha, beta,
    k)`` or None; ``oc_block`` the method's tile (``ADVANCED_OC_BLOCK``).
    ``True`` blocks whenever the tile is narrower than the layer; ``False``
    and ``None`` keep K1's full width (the JAX auto rule blocks only when
    its one-pooled-row floor cell overflows the TPU's VMEM, which no net of
    the repository does).  ``ocb`` is the JAX tile; K4, stage-major,
    takes K1's items.  Only the advanced (im2col) methods reach it, so
    the JAX rule's ``im2col`` argument is always true here."""
    blocked = min(oc_block, oc)
    if lrn is None:
        return blocked, 0
    if blocked >= oc or lrn_oc_block is not True:
        return oc, 0
    return blocked, lrn[0] - 1


def resolve_pool_carry(pool_carry, lrn, pool, phb: int, n_tiles: int) -> bool:
    """Whether a fused conv → pool group of an advanced (im2col) method
    runs the sliding-window carry cell (K5): requested (``True``), no LRN,
    pool windows that overlap by ``K = pkh - psy >= 1`` rows, no more than
    a band's fresh rows (``K <= phb*psy``), and more than one band.  ``pool``
    is ``(pkh, pkw, psy, psx)``; ``phb``/``n_tiles`` are the port's band
    (``k5_bands``).  The JAX package's rule, but ``None`` is off: the
    JAX auto rule turns the carry on wherever it is feasible on the TPU;
    the port keeps K1 unless asked.  An infeasible request stays on K1, a
    planning decision, not a fallback."""
    if pool_carry is not True or pool is None or lrn is not None:
        return False
    pkh, _, psy, _ = pool
    k_rows = pkh - psy
    return 1 <= k_rows <= phb * psy and n_tiles > 1


def resolve_oc_block_final(oc_f: int, oc_block_final, lrn) -> Optional[int]:
    """The final-stage oc block a chain runs with, or None for K2's full
    width: a request at or above the stage's ``oc_f`` channels keeps K2;
    with an LRN tail any request raises (the window reads every channel),
    as the JAX package's chain dispatch does."""
    if oc_block_final is None:
        return None
    if lrn is not None:
        raise ValueError("oc-blocked final stage requires no LRN epilogue "
                         "(the LRN window reads every output channel)")
    return None if oc_block_final >= oc_f else int(oc_block_final)


def _tile(ocb: int, oc: int):
    """The ``tile`` int array of the oc-blocked kernels
    (``csrc/conv_common.cuh``): ``{ocb, oc_tiles}``."""
    tile = np.asarray([ocb, math.ceil(oc / ocb)], dtype=np.int32)
    tile.setflags(write=False)
    return tile


def k5_bands(stages, pool) -> Tuple[int, int]:
    """The band the pool-carry rule reads (``resolve_pool_carry``):
    ``(phb, n_bands)``, the fewest pooled rows whose ``phb*psy`` fresh
    conv rows hold the ``K = pkh - psy`` rows a carry keeps (at least one),
    and the bands of that height a frame has.  K5 itself walks no band:
    stage-major, each conv row is computed once by construction.  The
    band only decides, as the JAX package's rule does on its own band,
    where the carry applies: overlapping windows and a frame of more than
    one band."""
    total = final_rows(stages, pool)[0]
    phb = max(1, math.ceil((pool.kh - pool.sy) / pool.sy))
    return phb, math.ceil(total / phb)


# -- the stage-major schedule (K1, K2, K4, K5, K6) -----------------------------


def _round4(v: int) -> int:
    return -(-v // 4) * 4


def k6_ocb(requested: int) -> int:
    """K6's final-stage channel tile: ``requested`` (the JAX knob, read
    as a lower bound) rounded up to whole ``ST_TO``-wide core tiles."""
    return ST_TO * math.ceil(max(1, requested) / ST_TO)


def tap_walk(st: Stage) -> Tuple[int, int]:
    """``(tw, tpr)``: the floats of one tap's run and the taps of a kernel
    row in a stage's reduction walk (``stage_walk`` in
    ``csrc/conv_stage_major.cuh``).  A tap is one kernel position of
    ``Cp`` channels (``KW`` taps a row) or, where ``Cp < CH_CK``, one
    kernel row: its ``KW * Cp`` floats lie side by side in NHWC for one
    output pixel (one tap a row), so the ring slots fill with real rows."""
    cp = _round4(st.C)
    return (st.KW * cp, 1) if cp < CH_CK else (cp, st.KW)


def tap_split(tw: int) -> int:
    """Chunks of a tap of ``tw`` floats: the fewest runs of at most
    ``CH_CHUNK_SLOTS`` ring slots of ``CH_CK`` rows.  A function of the
    shape alone, so each output's sum order is too."""
    return math.ceil(math.ceil(tw / CH_CK) / CH_CHUNK_SLOTS)


def whole_run(split: int, tpr: int, kh: int) -> int:
    """Chunks that one fold of a whole-reduction item sums: the inner
    level of a stage's sum tree (a tap's chunks, else a kernel row's taps,
    else every row), whose folds the item adds up in its own partial; 0
    where the tree has three levels of more than one member (no item then
    takes the whole reduction)."""
    if split > 1 and tpr > 1 and kh > 1:
        return 0
    return split if split > 1 else tpr if tpr > 1 else kh


class ChainStagePlan(NamedTuple):
    """One stage of the stage-major schedule.  Its GEMM is ``m`` output
    pixels (every frame's) x ``ocp`` channels (OC padded to a float4) over
    ``KH * tpr`` taps of ``tw`` floats each (``tap_walk``), each tap cut
    into ``split`` chunks of ``chunk_slots`` ring slots; an item is a
    pixel tile of ``ST_TP``, ``ot_item`` channel tiles of ``ST_TO`` and
    ``unit`` chunks (1, ``split``: a tap, ``tpr * split``: a kernel row,
    or every chunk: ``whole``), writing partial ``q`` of ``n_partials``
    for its outputs, which the reduce adds; a whole item writes the
    outputs itself, adding its folds in ``part`` floats of its own."""
    m: int
    ocp: int
    tiles_m: int
    o_items: int
    ot_item: int
    tw: int
    tpr: int
    split: int
    chunk_slots: int
    unit: int
    n_partials: int
    items: int
    whole: bool
    part: int      # floats of partials the stage writes
    act_off: int   # floats into scratch of the NHWC output, -1: NCHW out


class ChainPlan(NamedTuple):
    """A stage-major launch: a cooperative grid of ``grid`` blocks of
    ``CH_THREADS``, ``barriers`` grid-wide barriers, ``scratch`` floats of
    scratch (the NHWC input at 0, each stage's NHWC output, the partials at
    ``part_off``), ``tail_items`` pooled pixels (0 without a pool)."""
    grid: int
    stages: Tuple[ChainStagePlan, ...]
    part_off: int
    scratch: int
    barriers: int
    tail_items: int


def chain_plan(stages, pool, n: int, sms: int, ocb: Optional[int] = None
               ) -> ChainPlan:
    """The stage-major schedule of K1, K4 and K5 (one stage), K2 (``ocb``
    None) or K6 (final-stage items ``ocb`` channels wide, ``k6_ocb``) for
    ``n`` frames on ``sms`` SMs.  Per stage the host picks the unit: the
    whole reduction (where ``whole_run`` allows it), a kernel row, a tap
    or one chunk.  Smaller units make more items and write more partials;
    the unit of fewer rounds of the grid × chunks an item wins, the larger
    on a tie, and a tap or a chunk only while its partials stay within
    ``CH_PARTIAL_BYTES``.  Every unit sums every output in the same order
    (``csrc/conv_stage_major.cuh``), so the unit follows the batch and the
    bits do not."""
    grid = CH_MIN_BLOCKS * sms
    last = len(stages) - 1
    off = _round4(n * stages[0].H * stages[0].W * _round4(stages[0].C))
    plans, part, barriers = [], 0, 0
    for s, st in enumerate(stages):
        m = n * st.OH * st.OW
        ocp = _round4(st.OC)
        tiles_m = math.ceil(m / ST_TP)
        n_ot = math.ceil(ocp / ST_TO)
        ot_item = (math.ceil(ocb / ST_TO) if ocb is not None and s == last
                   else 1)
        o_items = math.ceil(n_ot / ot_item)
        tw, tpr = tap_walk(st)
        split = tap_split(tw)
        row = tpr * split
        chunks = st.KH * row
        run = whole_run(split, tpr, st.KH)
        best = None
        for unit in dict.fromkeys(((chunks,) if run else ())
                                  + (row, split, 1)):  # larger first: ties
            q = chunks // unit
            items = tiles_m * o_items * q
            whole = unit == chunks
            floats = (m * ocp if chunks > run else 0) if whole else q * m * ocp
            if unit not in (row, chunks) and 4 * floats > CH_PARTIAL_BYTES:
                continue
            cost = math.ceil(items / grid) * unit
            if best is None or cost < best[0]:
                best = (cost, unit, q, items, whole, floats)
        _, unit, q, items, whole, floats = best
        part = max(part, floats)
        barriers += 1 if whole else 2
        if s == last and pool is None:
            act = -1
        else:
            act, off = off, off + _round4(m * ocp)
        plans.append(ChainStagePlan(
            m, ocp, tiles_m, o_items, ot_item, tw, tpr, split,
            math.ceil(math.ceil(tw / CH_CK) / split), unit, q, items, whole,
            floats, act))
    if off + part >= CH_SCRATCH_LIMIT:
        raise LaunchGeometryError(f"chain scratch of {off + part} floats is "
                                  "past the kernel's 32-bit offsets",
                                  "scratch")
    _, out_h, out_w = final_rows(stages, pool)
    return ChainPlan(grid, tuple(plans), off, off + part,
                     barriers + (pool is not None),
                     n * out_h * out_w if pool is not None else 0)


def pack_chain_plan(plan: ChainPlan) -> np.ndarray:
    """The ``plan`` int array of ``csrc/conv_stage_major.cuh``: grid,
    partials' offset, then per stage unit (chunks an item), channel tiles
    an item, output offset."""
    arr = np.asarray([plan.grid, plan.part_off]
                     + [v for sp in plan.stages
                        for v in (sp.unit, sp.ot_item, sp.act_off)],
                     dtype=np.int32)
    arr.setflags(write=False)
    return arr


def chain_weights(w: torch.Tensor) -> torch.Tensor:
    """A chain stage's OIHW weights as the kernel reads them: HWIO with
    C and OC zero-padded to multiples of 4, contiguous.  Converted once
    per weight tensor and kept while it lives and is not written in place
    (its version counter); an inference tensor, which has no counter, is
    converted on every call."""
    if w.is_inference():
        return _hwio_padded(w)
    hit = _CHAIN_WEIGHTS.get(id(w))
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    out = _hwio_padded(w)
    key = id(w)
    _CHAIN_WEIGHTS[key] = (
        weakref.ref(w, lambda _, k=key: _CHAIN_WEIGHTS.pop(k, None)),
        w._version, out)
    return out


def _hwio_padded(w: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        hwio, _ = pad_axis(oihw_to_hwio(w), 2, 4)
        return pad_axis(hwio, 3, 4)[0].contiguous()


#: id(weight) -> (weakref to it, its version, chain_weights' copy)
_CHAIN_WEIGHTS: dict = {}


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


def conv2d_pool_fused_ref(x, w, b, stride=(1, 1), padding=(0, 0),
                          relu=False, pool_kernel=None, pool_stride=None,
                          pool_kind: str = "max", pool_relu: bool = False,
                          lrn_n=None, lrn_alpha: float = 1e-4,
                          lrn_beta: float = 0.75, lrn_k: float = 1.0):
    """Plain version of K1: conv → bias → [ReLU] → [pool → [ReLU] →
    [LRN]] (the JAX package's ``methods.conv2d_pool_fused`` without
    Pallas)."""
    out = _conv_im2col(x, w, b, stride, padding, relu)
    return pool_lrn_tail(out, pool_kernel, pool_stride, pool_kind, pool_relu,
                         lrn_n, lrn_alpha, lrn_beta, lrn_k).to(x.dtype)


def conv2d_chain_ref(x, ws, bs, strides, paddings, relus, pool_kernel=None,
                     pool_stride=None, pool_kind: str = "max",
                     pool_relu: bool = False, lrn_n=None,
                     lrn_alpha: float = 1e-4, lrn_beta: float = 0.75,
                     lrn_k: float = 1.0):
    """Plain version of K2: each stage's conv (zero padding between
    stages) with bias and [ReLU], then the optional pool/LRN tail."""
    out = x.to(ACC_DTYPE)
    for w, b, s, p, r in zip(ws, bs, strides, paddings, relus):
        out = _conv_im2col(out, w, b, s, p, r)
    return pool_lrn_tail(out, pool_kernel, pool_stride, pool_kind, pool_relu,
                         lrn_n, lrn_alpha, lrn_beta, lrn_k).to(x.dtype)


# -- kernel wrappers ----------------------------------------------------------


@functools.lru_cache(maxsize=256)
def chain_launch(n, in_chw, w_shapes, strides, paddings, relus, pool,
                 pool_relu, lrn, sms, oc_block_final=None):
    """The launch geometry of a stage-major kernel (K1, K4 and K5: one stage;
    K2; K6 with ``oc_block_final``, its final stage's items ``k6_ocb``
    channels wide) for one call signature: ``(stages, plan, arrays,
    ptrs)``, ``arrays`` the read-only ``(geo, lrn_f, plan_arr)`` and, for
    K6, ``tile``, ``ptrs`` their addresses (they live as long as the
    memo).  ``geo`` describes the whole frame as one band (``blk`` = the
    final rows).  Memoized, so that a forward does not repeat the plan's
    search; the arrays are read-only."""
    stages = make_stages(in_chw, w_shapes, strides, paddings, relus)
    tile, ocb = None, None
    if oc_block_final is not None:
        ocb = k6_ocb(oc_block_final)
        tile = _tile(ocb, stages[-1].OC)
    plan = chain_plan(stages, pool, n, sms, ocb)
    if lrn is not None and stages[-1].OC > CH_SMEM // 4:
        raise LaunchGeometryError(f"the LRN tail holds {stages[-1].OC} "
                                  f"channels of a pixel, more than "
                                  f"{CH_SMEM // 4}", "smem")
    geo, lrn_f = pack_geo(n, stages, pool, pool_relu, lrn,
                          final_rows(stages, pool)[0])
    geo.setflags(write=False)
    lrn_f.setflags(write=False)
    arrays = (geo, lrn_f, pack_chain_plan(plan)) + (
        (tile,) if tile is not None else ())
    return stages, plan, arrays, tuple(a.ctypes.data for a in arrays)


def stage_major_geometry(n, in_chw, w_shapes, strides, paddings, relus,
                         pool, pool_relu, lrn, sms,
                         oc_block_final=None) -> Launch:
    """The launch geometry of a stage-major kernel (K1, K2, K4, K5, K6) for
    ``n`` frames of ``in_chw`` on ``sms`` SMs, from shapes alone: what
    ``_launch_stage_major`` launches (``chain_launch``'s memo)."""
    if not 1 <= len(w_shapes) <= MAX_STAGES:
        raise ValueError(f"a chain takes 1 to {MAX_STAGES} stages")
    args = (n, tuple(in_chw), tuple(tuple(w) for w in w_shapes),
            tuple(map(tuple, strides)), tuple(map(tuple, paddings)),
            tuple(map(bool, relus)), pool, bool(pool_relu), lrn, sms,
            oc_block_final)
    return Launch("chain_launch", args, chain_launch(*args))


def _launch_stage_major(wrapper, entry: str, x, ws, bs, strides, paddings,
                        relus, pool, pool_relu, lrn, oc_block_final=None):
    """One launch of the stage-major C entry ``entry`` (K1, K2, K4, K5 or, with
    ``oc_block_final``, K6) on CUDA tensors; counts it on
    ``wrapper.launches``."""
    n = x.shape[0]
    stages, plan, arrays, ptrs = stage_major_geometry(
        n, x.shape[1:], [w.shape for w in ws], strides, paddings, relus,
        pool, pool_relu, lrn, _sms(x.device), oc_block_final).geometry
    for st, b in zip(stages, bs):
        if tuple(b.shape) != (st.OC,):
            raise ValueError(f"bias shape {tuple(b.shape)} != ({st.OC},)")
    _, out_h, out_w = final_rows(stages, pool)
    out = alloc((n, stages[-1].OC, out_h, out_w), torch.float32, x.device)
    scratch = alloc(plan.scratch, torch.float32, x.device, scratch=True)
    # host arrays of the stages' device pointers; ``wts`` keeps the
    # converted weights alive until the launch is queued (an inference
    # tensor's copy is not cached, and a freed block may be reused by the
    # next stage's conversion before the kernel reads it)
    wts = [operand(chain_weights(w)) for w in ws]
    bs = [operand(b) for b in bs]
    w_ptrs = (ctypes.c_void_p * len(wts))(*[w.data_ptr() for w in wts])
    b_ptrs = (ctypes.c_void_p * len(bs))(*[b.data_ptr() for b in bs])
    rc = getattr(_build.library(), entry)(
        operand(x).data_ptr(), w_ptrs, b_ptrs, out.data_ptr(),
        scratch.data_ptr(), *operand_ptrs(arrays, ptrs), _stream(x.device))
    _build.check(rc, entry)
    wrapper.launches += 1
    return out


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
    return _launch_stage_major(conv2d_pool_fused, "conv_pool_lrn_f32", x,
                               (w,), (b,), (stride,), (padding,), (relu,),
                               pool, pool_relu, lrn)


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
    check_cuda_f32("conv2d_chain", x, *ws, *bs)
    pool, lrn = _pool_lrn(pool_kernel, pool_stride, pool_kind, lrn_n,
                          lrn_alpha, lrn_beta, lrn_k)
    return _launch_stage_major(conv2d_chain, "conv_chain_f32", x, ws, bs,
                               strides, paddings, relus, pool, pool_relu, lrn)


def k7_ring_off(stages, pool, lrn: bool) -> int:
    """Float offset of the fused K7 block's tile rings in shared memory:
    the conv rows of its one pooled row at full channel width plus, with
    LRN, that pooled row (``k1_smem``'s layout at one final row a
    block), rounded up to a float4."""
    return _round4(k1_smem(stages, pool, lrn, 1) // 4)


def k7_smem(stages, pool, lrn: bool, groups: int) -> int:
    """K7's fused kernel's dynamic shared memory: the band (and pooled
    row) and ``groups`` tile rings of ``K7_RING`` floats."""
    return 4 * (k7_ring_off(stages, pool, lrn) + groups * K7_RING)


def k7_groups(stages, pool, lrn: bool) -> int:
    """Tile groups of a fused K7 block: one for each of its band's
    ``ST_TP`` x ``ST_TO`` tiles, at most ``K7_MAX_GROUPS``, and no more
    than fit ``K7_SMEM_LIMIT`` beside the band."""
    st = stages[0]
    a, b = band_rows(stages, pool, 1, 0)[0]
    tiles = math.ceil((b - a) * st.OW / ST_TP) * math.ceil(st.OC / ST_TO)
    groups = min(K7_MAX_GROUPS, tiles)
    while groups and k7_smem(stages, pool, lrn, groups) > K7_SMEM_LIMIT:
        groups -= 1
    if not groups:
        raise LaunchGeometryError(
            f"K7 band of one pooled row and one tile ring need "
            f"{k7_smem(stages, pool, lrn, 1)} bytes of shared memory, more "
            f"than {K7_SMEM_LIMIT}", "floor")
    return groups


@functools.lru_cache(maxsize=256)
def k7_launch(n, in_chw, w_shape, stride, padding, relu, pool, pool_relu,
              lrn):
    """K7's launch geometry for one call signature: ``(stages, smem, geo,
    lrn_f)``, ``in_chw`` and ``w_shape`` with the channels padded to
    ``K7_ALIGN``; ``geo`` ends in the fused kernel's tile groups and ring
    offset.  The per-layer kernel takes one ring (``smem`` is its bytes);
    the fused kernel gives each block one pooled row of one frame."""
    stages = make_stages(in_chw, [w_shape], [stride], [padding], [relu])
    if pool is None:
        groups, ring_off, smem = 1, 0, 4 * K7_RING
    else:
        groups = k7_groups(stages, pool, lrn is not None)
        ring_off = k7_ring_off(stages, pool, lrn is not None)
        smem = k7_smem(stages, pool, lrn is not None, groups)
    geo, lrn_f = pack_geo(n, stages, pool, pool_relu, lrn, 1)
    geo = np.append(geo, np.int32([groups, ring_off]))
    geo.setflags(write=False)
    lrn_f.setflags(write=False)
    return stages, smem, geo, lrn_f


def k7_geometry(n, in_chw, w_shape, stride, padding, relu, pool, pool_relu,
                lrn) -> Launch:
    """K7's launch geometry from the unpadded NCHW/OIHW shapes: the
    channels padded to ``K7_ALIGN``, as ``conv2d_basic_simd`` pads the
    tensors, then ``k7_launch``'s memo."""
    c, h, w = in_chw
    cp = -(-c // K7_ALIGN) * K7_ALIGN
    args = (n, (cp, h, w), (w_shape[0], cp, *w_shape[2:]), tuple(stride),
            tuple(padding), bool(relu), pool, bool(pool_relu), lrn)
    return Launch("k7_launch", args, k7_launch(*args))


def k8_halo_rows(st: Stage) -> int:
    """Input rows the tallest of K8's tiles reads: a tile is ``ST_TP``
    consecutive output pixels (row-major) of one frame, and reads its
    output rows' span times the stride plus the kernel's height (mirrors
    ``k8_halo_rows`` in ``csrc/conv_basic_parallel.cu``)."""
    p_all = st.OH * st.OW
    return max((min(p0 + ST_TP, p_all) - 1) // st.OW - p0 // st.OW
               for p0 in range(0, p_all, ST_TP)) * st.sy + st.KH


def k8_stage(st: Stage, cc: int) -> int:
    """Floats of one K8 stage with ``cc`` input channels: their halos
    (``k8_halo_rows`` x the padded width) and their weight rows, each
    rounded up to a float4."""
    wp = (st.OW - 1) * st.sx + st.KW
    return (_round4(cc * k8_halo_rows(st) * wp)
            + _round4(cc * st.KH * st.KW) * ST_BROW)


@functools.lru_cache(maxsize=256)
def k8_launch(n, in_chw, w_shape, stride, padding, relu):
    """K8's launch geometry for one call signature: ``(stage, dims, smem,
    grid)``.  ``cc``, the input channels a stage holds, is the most whose
    stage fits ``K8_STAGE_FLOATS`` (at least one); two stages make the
    dynamic shared memory; the grid is (pixel tiles x N, channel
    tiles)."""
    st = make_stages(in_chw, [w_shape], [stride], [padding], [relu])[0]
    cc = 1
    while cc < st.C and k8_stage(st, cc + 1) <= K8_STAGE_FLOATS:
        cc += 1
    smem = 2 * 4 * k8_stage(st, cc)
    if smem > K7_SMEM_LIMIT:
        raise LaunchGeometryError(f"K8 stage of one channel needs {smem} "
                                  f"bytes of shared memory, more than "
                                  f"{K7_SMEM_LIMIT}", "floor")
    dims = np.asarray([n, *st[:10], st.OH, st.OW, int(relu), cc],
                      dtype=np.int32)
    dims.setflags(write=False)
    grid = (math.ceil(st.OH * st.OW / ST_TP) * n, math.ceil(st.OC / ST_TO))
    return st, dims, smem, grid


def k8_geometry(n, in_chw, w_shape, stride, padding, relu) -> Launch:
    """K8's launch geometry from shapes: ``k8_launch``'s memo."""
    args = (n, tuple(in_chw), tuple(w_shape), tuple(stride), tuple(padding),
            bool(relu))
    return Launch("k8_launch", args, k8_launch(*args))


def conv2d_basic_simd(x, w, b, stride=(1, 1), padding=(0, 0), relu=False,
                      pool_kernel=None, pool_stride=None,
                      pool_kind: str = "max", pool_relu: bool = False,
                      lrn_n=None, lrn_alpha: float = 1e-4,
                      lrn_beta: float = 0.75, lrn_k: float = 1.0):
    """x: [N, C, H, W]; w: [OC, C, KH, KW]; b: [OC].  The §4.3 conv →
    bias → [ReLU] and, with ``pool_kernel``, the fused → VALID pool →
    [ReLU] → [LRN] tail, as one launch of K7 (CUDA) or its plain version
    (CPU).  On CUDA the dimension swap (NHWC, HWIO, channels zero-padded
    to ``K7_ALIGN``) happens here, outside the kernel, as the JAX package
    does it outside its Pallas kernel."""
    kwargs = dict(pool_kernel=pool_kernel, pool_stride=pool_stride,
                  pool_kind=pool_kind, pool_relu=pool_relu, lrn_n=lrn_n,
                  lrn_alpha=lrn_alpha, lrn_beta=lrn_beta, lrn_k=lrn_k)
    if x.device.type == "cpu":
        return conv2d_basic_simd_ref(x, w, b, stride, padding, relu,
                                     **kwargs)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_basic_simd: unsupported device {x.device}")
    check_cuda_f32("conv2d_basic_simd", x, w, b)
    pool, lrn = _pool_lrn(pool_kernel, pool_stride, pool_kind, lrn_n,
                          lrn_alpha, lrn_beta, lrn_k)
    if tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"bias shape {tuple(b.shape)} != ({w.shape[0]},)")
    n, oc = x.shape[0], w.shape[0]
    stages, smem, geo, lrn_f = k7_geometry(
        n, x.shape[1:], w.shape, stride, padding, relu, pool, pool_relu,
        lrn).geometry
    xh, _ = pad_axis(nchw_to_nhwc(x), 3, K7_ALIGN)
    wh, _ = pad_axis(oihw_to_hwio(w), 2, K7_ALIGN)
    xh, wh = xh.contiguous(), wh.contiguous()
    _, out_h, out_w = final_rows(stages, pool)
    out = alloc((n, oc, out_h, out_w), torch.float32, x.device)
    rc = _build.library().conv_basic_simd_f32(
        operand(xh).data_ptr(), operand(wh).data_ptr(),
        operand(b).data_ptr(), out.data_ptr(), operand(geo).ctypes.data,
        operand(lrn_f).ctypes.data, smem, _stream(x.device))
    _build.check(rc, "conv_basic_simd_f32")
    conv2d_basic_simd.launches += 1
    return out


def conv2d_basic_parallel(x, w, b, stride=(1, 1), padding=(0, 0),
                          relu=False):
    """x: [N, C, H, W]; w: [OC, C, KH, KW]; b: [OC].  The §4.2 conv →
    bias → [ReLU] (no pool) as one launch of K8 (CUDA) or its plain
    version (CPU)."""
    if x.device.type == "cpu":
        return conv2d_basic_parallel_ref(x, w, b, stride, padding, relu)
    if x.device.type != "cuda":
        raise ValueError(
            f"conv2d_basic_parallel: unsupported device {x.device}")
    check_cuda_f32("conv2d_basic_parallel", x, w, b)
    n = x.shape[0]
    oc = w.shape[0]
    if tuple(b.shape) != (oc,):
        raise ValueError(f"bias shape {tuple(b.shape)} != ({oc},)")
    st, dims, _, _ = k8_geometry(n, x.shape[1:], w.shape, stride, padding,
                                 relu).geometry
    out = alloc((n, oc, st.OH, st.OW), torch.float32, x.device)
    rc = _build.library().conv_basic_parallel_f32(
        operand(x).data_ptr(), operand(w).data_ptr(), operand(b).data_ptr(),
        out.data_ptr(), operand(dims).ctypes.data, _stream(x.device))
    _build.check(rc, "conv_basic_parallel_f32")
    conv2d_basic_parallel.launches += 1
    return out


def conv2d_pool_lrn_halo(x, w, b, stride=(1, 1), padding=(0, 0), relu=False,
                         pool_kernel=None, pool_stride=None,
                         pool_kind: str = "max", pool_relu: bool = False,
                         lrn_n=None, lrn_alpha: float = 1e-4,
                         lrn_beta: float = 0.75, lrn_k: float = 1.0):
    """x: [N, C, H, W]; w: [OC, C, KH, KW]; b: [OC].  conv → bias →
    [ReLU] → VALID pool → [ReLU] → LRN, the oc-blocked LRN cell, as one
    launch of K4 (CUDA) or its plain version, K1's (CPU).  ``pool_kernel``
    and ``lrn_n`` are required.  K4 runs K1's schedule and plan, whose LRN
    tail sees every channel of a pixel, so the halo channels the TPU
    kernel's tiles recompute are not needed and the two give the same
    bits."""
    if pool_kernel is None or lrn_n is None:
        raise ValueError("conv2d_pool_lrn_halo needs a pool and an LRN")
    kwargs = dict(pool_kernel=pool_kernel, pool_stride=pool_stride,
                  pool_kind=pool_kind, pool_relu=pool_relu, lrn_n=lrn_n,
                  lrn_alpha=lrn_alpha, lrn_beta=lrn_beta, lrn_k=lrn_k)
    if x.device.type == "cpu":
        return conv2d_pool_fused_ref(x, w, b, stride, padding, relu, **kwargs)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_pool_lrn_halo: unsupported device {x.device}")
    check_cuda_f32("conv2d_pool_lrn_halo", x, w, b)
    pool, lrn = _pool_lrn(pool_kernel, pool_stride, pool_kind, lrn_n,
                          lrn_alpha, lrn_beta, lrn_k)
    return _launch_stage_major(conv2d_pool_lrn_halo, "conv_pool_lrn_halo_f32",
                               x, (w,), (b,), (stride,), (padding,), (relu,),
                               pool, pool_relu, lrn)


def conv2d_pool_carry(x, w, b, stride=(1, 1), padding=(0, 0), relu=False,
                      pool_kernel=None, pool_stride=None,
                      pool_kind: str = "max", pool_relu: bool = False):
    """x: [N, C, H, W]; w: [OC, C, KH, KW]; b: [OC].  conv → bias →
    [ReLU] → VALID pool → [ReLU] (no LRN) as one launch of K5 (CUDA) or
    its plain version, K1's (CPU).  ``pool_kernel`` is required.  K5 runs
    K1's schedule and plan, where each conv row that neighbouring pool
    windows share is computed once, so the two give the same bits."""
    if pool_kernel is None:
        raise ValueError("conv2d_pool_carry needs a pool")
    kwargs = dict(pool_kernel=pool_kernel, pool_stride=pool_stride,
                  pool_kind=pool_kind, pool_relu=pool_relu)
    if x.device.type == "cpu":
        return conv2d_pool_fused_ref(x, w, b, stride, padding, relu, **kwargs)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_pool_carry: unsupported device {x.device}")
    check_cuda_f32("conv2d_pool_carry", x, w, b)
    pool, _ = _pool_lrn(pool_kernel, pool_stride, pool_kind, None, 0, 0, 0)
    return _launch_stage_major(conv2d_pool_carry, "conv_pool_carry_f32", x,
                               (w,), (b,), (stride,), (padding,), (relu,),
                               pool, pool_relu, None)


def conv2d_chain_ocb(x, ws, bs, strides, paddings, relus, pool_kernel=None,
                     pool_stride=None, pool_kind: str = "max",
                     pool_relu: bool = False, oc_block_final: int = 64):
    """A conv chain with the optional pool tail (no LRN) and the final
    stage's output channels split across blocks, as one launch of K6
    (CUDA) or its plain version, K2's (CPU).  ``oc_block_final`` is the
    narrowest channel tile the kernel may use (``k6_ocb`` rounds it up to
    whole core tiles)."""
    kwargs = dict(pool_kernel=pool_kernel, pool_stride=pool_stride,
                  pool_kind=pool_kind, pool_relu=pool_relu)
    if x.device.type == "cpu":
        return conv2d_chain_ref(x, ws, bs, strides, paddings, relus, **kwargs)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_chain_ocb: unsupported device {x.device}")
    if oc_block_final < 1:
        raise ValueError(f"oc_block_final must be >= 1: {oc_block_final}")
    check_cuda_f32("conv2d_chain_ocb", x, *ws, *bs)
    pool, _ = _pool_lrn(pool_kernel, pool_stride, pool_kind, None, 0, 0, 0)
    return _launch_stage_major(conv2d_chain_ocb, "conv_chain_ocb_f32", x, ws,
                               bs, strides, paddings, relus, pool, pool_relu,
                               None, int(oc_block_final))


#: kernel launches since the count was last set to 0
conv2d_pool_fused.launches = 0
conv2d_chain.launches = 0
conv2d_basic_simd.launches = 0
conv2d_basic_parallel.launches = 0
conv2d_pool_lrn_halo.launches = 0
conv2d_pool_carry.launches = 0
conv2d_chain_ocb.launches = 0
