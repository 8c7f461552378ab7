"""Helpers shared by the port's CPU kernel tests (the files split out
of ``tests/test_torch_kernels.py`` by kernel family): tolerances,
input makers, the kernels' cases and geometry restated in Python,
and the plain emulations of their schedules."""
import math
import re
from functools import partial

import jax
import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d import ops as conv_ops

TOL = 1e-4
#: SMs of an H100 SXM: the card the schedule tests plan for
REPORT_SMS = 132


def _close(ours, theirs, tol=TOL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape
    err = np.abs(ours - theirs).max()
    assert err <= tol, err


def _arr(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


def _jit(fn, **static):
    """The JAX reference, jitted with its configuration bound (eager JAX
    compiles every op on its first call, which costs seconds)."""
    return jax.jit(partial(fn, **static))


# -- K1: conv → pool → LRN ------------------------------------------------------

K1_CASES = {
    # name: (x shape, w shape, stride, padding, relu, pool k, pool s, kind,
    #        pool_relu, lrn_n)
    "max": ((2, 3, 12, 12), (8, 3, 3, 3), (1, 1), (0, 0), True, (2, 2),
            (2, 2), "max", False, None),
    "avg": ((2, 3, 12, 12), (8, 3, 3, 3), (1, 1), (1, 1), True, (3, 3),
            (2, 2), "avg", False, None),
    "no_relu_max": ((2, 1, 14, 14), (5, 1, 5, 5), (1, 1), (0, 0), False,
                    (2, 2), (2, 2), "max", False, None),
    "pool_relu_only": ((2, 3, 16, 16), (6, 3, 5, 5), (1, 1), (2, 2), False,
                       (3, 3), (2, 2), "max", True, None),
    "relu_and_pool_relu_avg": ((2, 3, 16, 16), (6, 3, 5, 5), (1, 1), (2, 2),
                               True, (3, 3), (2, 2), "avg", True, None),
    "lrn5": ((2, 6, 13, 13), (16, 6, 5, 5), (1, 1), (2, 2), True, (3, 3),
             (2, 2), "max", False, 5),
    "lrn4_even": ((2, 6, 13, 13), (12, 6, 3, 3), (1, 1), (1, 1), True,
                  (3, 3), (2, 2), "max", False, 4),
    "stride4_11x11": ((2, 3, 51, 51), (8, 3, 11, 11), (4, 4), (0, 0), True,
                      (3, 3), (2, 2), "max", False, 5),
}


# -- K2: conv chain → pool → LRN -----------------------------------------------

K2_CASES = {
    # name: (x shape, per-stage (oc, k, stride, pad, relu), pool, lrn_n)
    "two_stage_no_pool": ((2, 4, 11, 11), ((8, 3, 1, 1, True),
                                           (6, 3, 1, 1, True)), None, None),
    "three_stage_pool": ((2, 4, 13, 13), ((8, 3, 1, 1, True),
                                          (8, 3, 1, 1, True),
                                          (6, 3, 1, 1, True)),
                         ((3, 3), (2, 2), "max"), None),
    "three_stage_pool_lrn": ((2, 4, 13, 13), ((8, 3, 1, 1, True),
                                              (8, 3, 1, 1, False),
                                              (10, 3, 1, 1, True)),
                             ((3, 3), (2, 2), "max"), 5),
    "pad2_avg": ((2, 3, 12, 12), ((6, 5, 1, 2, True), (5, 5, 1, 2, True)),
                 ((2, 2), (2, 2), "avg"), None),
    "pad2_strided_lrn4": ((2, 3, 15, 15), ((6, 5, 2, 2, True),
                                           (8, 3, 1, 1, True)),
                          ((3, 3), (2, 2), "max"), 4),
}


# -- K7, K8, K9: the §4.3 and §4.2 convs and the standalone pool ------------------

LADDER_CONV_CASES = {
    # name: (x shape, w shape, stride, padding)
    "3x3_pad1": ((2, 4, 11, 11), (10, 4, 3, 3), (1, 1), (1, 1)),
    "5x5_pad2_c3": ((2, 3, 14, 13), (7, 3, 5, 5), (1, 1), (2, 2)),
    "11x11_s4": ((1, 3, 43, 43), (8, 3, 11, 11), (4, 4), (0, 0)),
    "strided_2x1": ((2, 6, 12, 15), (5, 6, 3, 3), (2, 1), (1, 0)),
}


# -- K9: the plane-per-block walk of csrc/pool2d.cu ------------------------------


def _pool_constants():
    src = (_build.CSRC / "pool2d.cu").read_text()
    return {name: int(v) for name, v in
            re.findall(r"\b(POOL_[A-Z]+) = (\d+);", src)}


def _net_pool_shapes():
    """(C, H, W, kernel, stride, kind, relu) of every pool of the three
    nets' unfused plans (the pools K9 runs)."""
    from repro_torch.core.methods import Method
    from repro_torch.core.netdefs import NETWORKS
    from repro_torch.core.plan import compile_plan

    out = []
    for name in ("alexnet", "lenet5", "cifar10"):
        for step in compile_plan(NETWORKS[name](),
                                 method=Method("advanced_simd_8"),
                                 fuse=False).steps:
            if step.kind == "pool":
                sp = step.spec
                out.append((*step.in_shape, tuple(sp.kernel),
                            tuple(sp.stride), sp.pool_kind,
                            bool(sp.relu or step.relu)))
    return out


def _emulate_k9(x, kernel, stride, kind, relu):
    """K9's launch in numpy fp32, block by block and thread by thread as
    ``pool2d_kernel`` walks (``pool_plan``'s grid: whole planes a block,
    one output a thread, its window in row-major order) -> (y, how many
    times each output was written)."""
    from repro_torch.kernels.pool2d import ops as pool_ops

    n, c, h, w = x.shape
    kh, kw = kernel
    sy, sx = stride
    oh, ow = pool_ops.pool_out_hw(h, w, kernel, stride)
    planes = x.reshape(n * c, h, w)
    plan = pool_ops.pool_plan(n * c, oh, ow)
    y = np.zeros((n * c, oh, ow), np.float32)
    writes = np.zeros((n * c, oh, ow), int)
    for blk in range(plan.blocks):
        for t in range(plan.ppb * plan.per_plane):
            pl = blk * plan.ppb + t // plan.per_plane
            if pl >= n * c:
                break
            it = t % plan.per_plane
            oy, ox = it // ow, it % ow
            v = np.float32(-np.inf if kind == "max" else 0.0)
            for i in range(kh):
                for j in range(kw):
                    e = planes[pl, oy * sy + i, ox * sx + j]
                    v = max(v, e) if kind == "max" else np.float32(v + e)
            if kind == "avg":
                v = np.float32(v / np.float32(kh * kw))
            y[pl, oy, ox] = max(v, np.float32(0)) if relu else v
            writes[pl, oy, ox] += 1
    return y.reshape(n, c, oh, ow), writes


def _one_thread_an_output(x, kernel, stride, kind, relu):
    """The previous kernel's order: one output a thread, its window in
    row-major order (fp32)."""
    n, c, h, w = x.shape
    (kh, kw), (sy, sx) = kernel, stride
    oh, ow = (h - kh) // sy + 1, (w - kw) // sx + 1
    acc = np.full((n, c, oh, ow), -np.inf if kind == "max" else 0.0,
                  np.float32)
    for i in range(kh):
        for j in range(kw):
            win = x[:, :, i:i + sy * (oh - 1) + 1:sy, j:j + sx * (ow - 1) + 1:sx]
            acc = np.maximum(acc, win) if kind == "max" else (
                acc + win).astype(np.float32)
    if kind == "avg":
        acc = (acc / np.float32(kh * kw)).astype(np.float32)
    return np.maximum(acc, np.float32(0)) if relu else acc


# -- K7 and K8: the register-tiled cores, read from their sources ---------------

#: every per-layer conv of the three nets: (in_chw, OIHW w shape, stride,
#: padding) — K8's shapes on ``basic_parallel``, K7's on unfused
#: ``basic_simd``
NET_CONVS = {
    "alexnet_conv1": ((3, 227, 227), (96, 3, 11, 11), (4, 4), (0, 0)),
    "alexnet_conv2": ((96, 27, 27), (256, 96, 5, 5), (1, 1), (2, 2)),
    "alexnet_conv3": ((256, 13, 13), (384, 256, 3, 3), (1, 1), (1, 1)),
    "alexnet_conv4": ((384, 13, 13), (384, 384, 3, 3), (1, 1), (1, 1)),
    "alexnet_conv5": ((384, 13, 13), (256, 384, 3, 3), (1, 1), (1, 1)),
    "lenet5_conv1": ((1, 28, 28), (20, 1, 5, 5), (1, 1), (0, 0)),
    "lenet5_conv2": ((20, 12, 12), (50, 20, 5, 5), (1, 1), (0, 0)),
    "cifar10_conv1": ((3, 32, 32), (32, 3, 5, 5), (1, 1), (2, 2)),
    "cifar10_conv2": ((32, 15, 15), (32, 32, 5, 5), (1, 1), (2, 2)),
    "cifar10_conv3": ((32, 7, 7), (64, 32, 5, 5), (1, 1), (2, 2)),
}
NET_CONVS.update({f"ladder_{k}": (xs[1:], ws, st, pd)
                  for k, (xs, ws, st, pd) in LADDER_CONV_CASES.items()})


def _simt_constants():
    """The integer constants (``ST_*``, ``K7_*``, ``K8_*``) that K7's and
    K8's sources and their shared core declare."""
    out = {}
    for name in ("conv_simt_tile.cuh", "conv_basic_simd.cu",
                 "conv_basic_parallel.cu"):
        src = (_build.CSRC / name).read_text()
        out.update({k: int(v) for k, v in re.findall(
            r"constexpr (?:int|long long) ((?:ST|K7|K8)_[A-Z_]+) = (\d+);",
            src)})
    return out


def _thread_outputs(c):
    """Each thread's accumulators as tile offsets: pixels [T, 8] (tx + 16 m)
    and channels [T, 8] (``tile_chan``: ty * 4 + u, 32 + ty * 4 + u)."""
    tid = np.arange(c["ST_THREADS"])
    tx, ty = tid % 16, tid // 16
    pix = tx[:, None] + 16 * np.arange(8)[None]
    u = np.arange(8)[None]
    chan = np.where(u < 4, 0, 28) + ty[:, None] * 4 + u
    return pix, chan


def _tile_counts(c, p_all, oc, tiles):
    """How often each (channel, pixel) of one frame is written by the
    threads of the tiles ``(p0, o0)``, masked as the epilogues mask."""
    pix, chan = _thread_outputs(c)
    count = np.zeros((oc, p_all), dtype=np.int64)
    for p0, o0 in tiles:
        p = np.broadcast_to((p0 + pix)[:, :, None], (len(pix), 8, 8))
        o = np.broadcast_to((o0 + chan)[:, None, :], (len(pix), 8, 8))
        keep = (p < p_all) & (o < oc)
        np.add.at(count, (o[keep], p[keep]), 1)
    return count


def _round4(v):
    return -(-v // 4) * 4


def _emulate_k8(x, w, b, stride, padding, relu):
    """K8's tile walk in numpy, fp32: per block (frame, ST_TP pixels, ST_TO
    channels) each stage's halo of ``cc`` channels and its weights as the
    copies stage them (zeros outside the input and past the channels),
    every output's sum over channels ascending, kernel rows, kernel
    columns, then bias and ReLU."""
    c = _simt_constants()
    n, ch, h, wd = x.shape
    oc, _, kh, kw = w.shape
    st, dims, _, grid = conv_ops.k8_launch(n, (ch, h, wd), w.shape, stride,
                                           padding, relu)
    cc, tp, to = int(dims[-1]), c["ST_TP"], c["ST_TO"]
    sy, sx = stride
    py, px = padding
    p_all, khw = st.OH * st.OW, kh * kw
    wp = (st.OW - 1) * sx + kw
    hr = conv_ops.k8_halo_rows(st)
    n_pt = -(-p_all // tp)
    wflat = w.reshape(oc, ch * khw)
    out = np.full((n, oc, p_all), np.nan, dtype=np.float32)
    for bx in range(grid[0]):
        frame, p0 = bx // n_pt, bx % n_pt * tp
        r0 = p0 // st.OW
        p = p0 + np.arange(tp)
        oy = p // st.OW
        poff = np.where(p < p_all,
                        (oy - r0) * sy * wp + (p - oy * st.OW) * sx, 0)
        ci, r, col = np.meshgrid(np.arange(cc), np.arange(hr), np.arange(wp),
                                 indexing="ij")
        iy, ix = r0 * sy - py + r, col - px
        for by in range(grid[1]):
            o0 = by * to
            o = o0 + np.arange(to)
            acc = np.zeros((tp, to), dtype=np.float32)
            for c0 in range(0, ch, cc):
                v = (c0 + ci < ch) & (iy >= 0) & (iy < h) & (ix >= 0) & (
                    ix < wd)
                xs = np.where(v, x[frame, np.minimum(c0 + ci, ch - 1),
                                   iy.clip(0, h - 1), ix.clip(0, wd - 1)],
                              0).astype(np.float32).ravel()
                k = np.arange(_round4(cc * khw))
                kn = min(cc, ch - c0) * khw
                ws = np.where((k[:, None] < kn) & (o[None] < oc),
                              wflat[np.minimum(o, oc - 1)[None],
                                    np.minimum(c0 * khw + k, ch * khw - 1
                                               )[:, None]], 0)
                for cl in range(min(cc, ch - c0)):     # channels outer
                    for i in range(kh):
                        for j in range(kw):
                            a = xs[cl * hr * wp + i * wp + j + poff]
                            brow = ws[cl * khw + i * kw + j]
                            acc = (acc + a[:, None] * brow[None]).astype(
                                np.float32)
            keep_p, keep_o = p < p_all, o < oc
            y = acc + b[np.minimum(o, oc - 1)][None]
            if relu:
                y = np.maximum(y, 0)
            out[frame][np.ix_(o[keep_o], p[keep_p])] = y[keep_p][:, keep_o].T
    assert not np.isnan(out).any()
    return out.reshape(n, oc, st.OH, st.OW)


def _k7_tile(xf, wk, st, row0, npx, p0, o0):
    """One K7 tile in numpy, fp32: the conv before bias at run pixels p0 ..
    p0 + ST_TP of npx row-major outputs from output row row0 of the NHWC
    frame xf, channels o0 .. o0 + ST_TO of the HWIO weights flattened to
    ``wk [KH*KW*C, OC]``; stages of K7_CK rows of k = (i * KW + j) * C + c
    staged as the copies stage them, each sum k ascending."""
    c = _simt_constants()
    tp, to, ck = c["ST_TP"], c["ST_TO"], c["K7_CK"]
    kd, oc = wk.shape
    q = p0 + np.arange(tp)
    iyb = np.where(q < npx, (row0 + q // st.OW) * st.sy - st.py, -(1 << 24))
    ixb = np.where(q < npx, q % st.OW * st.sx - st.px, 0)
    o = o0 + np.arange(to)
    acc = np.zeros((tp, to), dtype=np.float32)
    for k0 in range(0, kd, ck):
        a = np.zeros((tp, ck), dtype=np.float32)
        for q4 in range(ck // 4):
            kg = k0 + 4 * q4
            if kg >= kd:
                continue
            pos, ch = divmod(kg, st.C)
            i, j = divmod(pos, st.KW)
            iy, ix = iyb + i, ixb + j
            v = (iy >= 0) & (iy < st.H) & (ix >= 0) & (ix < st.W)
            a[:, 4 * q4:4 * q4 + 4] = np.where(
                v[:, None], xf[iy.clip(0, st.H - 1), ix.clip(0, st.W - 1),
                               ch:ch + 4], 0)
        k = k0 + np.arange(ck)
        bt = np.where((k < kd)[:, None] & (o < oc)[None],
                      wk[np.minimum(k, kd - 1)[:, None],
                         np.minimum(o, oc - 1)[None]], 0)
        for kk in range(ck):          # positions outer, channels inside
            acc = (acc + a[:, kk:kk + 1] * bt[kk][None]).astype(np.float32)
    return acc


def _k7_operands(x, w):
    """K7's wrapper's dimension swap in numpy: NHWC and HWIO with the
    channels zero-padded to ``K7_ALIGN``; HWIO flattened to [KH*KW*C, OC]."""
    n, ch, h, wd = x.shape
    oc, _, kh, kw = w.shape
    cp = _round4(ch)
    xh = np.zeros((n, h, wd, cp), dtype=np.float32)
    xh[..., :ch] = x.transpose(0, 2, 3, 1)
    wh = np.zeros((kh, kw, cp, oc), dtype=np.float32)
    wh[:, :, :ch] = w.transpose(2, 3, 1, 0)
    return xh, wh.reshape(kh * kw * cp, oc), cp


def _emulate_k7(x, w, b, stride, padding, relu):
    """K7's per-layer kernel in numpy: every block's tile (``_k7_tile``)
    plus bias and ReLU, written NCHW."""
    c = _simt_constants()
    xh, wk, cp = _k7_operands(x, w)
    n, _, h, wd = x.shape
    oc, _, kh, kw = w.shape
    stages = conv_ops.k7_launch(n, (cp, h, wd), (oc, cp, kh, kw), stride,
                                padding, relu, None, False, None)[0]
    st = stages[0]
    p_all, tp, to = st.OH * st.OW, c["ST_TP"], c["ST_TO"]
    out = np.full((n, oc, p_all), np.nan, dtype=np.float32)
    for frame in range(n):
        for p0 in range(0, p_all, tp):
            for o0 in range(0, oc, to):
                acc = _k7_tile(xh[frame], wk, st, 0, p_all, p0, o0)
                p, o = p0 + np.arange(tp), o0 + np.arange(to)
                kp, ko = p < p_all, o < oc
                y = acc[kp][:, ko] + b[o[ko]][None]
                out[frame][np.ix_(o[ko], p[kp])] = (
                    np.maximum(y, 0) if relu else y).T
    assert not np.isnan(out).any()
    return out.reshape(n, oc, st.OH, st.OW)


#: every fused basic-SIMD conv+pool group of the three nets:
#: (net, in_chw, OIHW weight shape, stride, padding, pool k, pool s, lrn)
K7_GROUPS = [
    ("alexnet", (3, 227, 227), (96, 3, 11, 11), (4, 4), (0, 0), (3, 3),
     (2, 2), True),
    ("alexnet", (96, 27, 27), (256, 96, 5, 5), (1, 1), (2, 2), (3, 3),
     (2, 2), True),
    ("lenet5", (1, 28, 28), (20, 1, 5, 5), (1, 1), (0, 0), (2, 2), (2, 2),
     False),
    ("lenet5", (20, 12, 12), (50, 20, 5, 5), (1, 1), (0, 0), (2, 2), (2, 2),
     False),
    ("cifar10", (3, 32, 32), (32, 3, 5, 5), (1, 1), (2, 2), (3, 3), (2, 2),
     False),
    ("cifar10", (32, 15, 15), (32, 32, 5, 5), (1, 1), (2, 2), (3, 3), (2, 2),
     False),
    ("cifar10", (32, 7, 7), (64, 32, 5, 5), (1, 1), (2, 2), (3, 3), (2, 2),
     False),
]


# -- off the CPU: every path reaches its kernel's wrapper ---------------------
#
# A ``meta`` tensor lies on neither the CPU nor a CUDA device: every path
# reaches the wrapper of its kernel (all of K1-K9 are ported), which
# refuses the device with ValueError.  (The names say "unported" for
# history: these cases raised NotImplementedError before their kernels
# were ported.)


def _meta(*shape):
    return torch.empty(shape, device="meta")


# -- K4, K5, K6: the second-generation cells ---------------------------------------
#
# Each knob routes a group to its cell (``methods.fused_cell`` /
# ``chain_cell``), whose wrapper runs K1's or K2's plain version on the
# CPU; the JAX side runs the same knob on its jnp path.  Tolerance: max
# abs <= 1e-4, as above.

CELL_CASES = {
    **K1_CASES,
    # wider than the advanced method's 8-channel tile, so K4 blocks it
    "stride4_11x11_wide": ((2, 3, 51, 51), (20, 3, 11, 11), (4, 4), (0, 0),
                           True, (3, 3), (2, 2), "max", False, 5),
}
K4_CASES = ("lrn5", "lrn4_even", "stride4_11x11_wide")
K5_CASES = ("avg", "pool_relu_only", "relu_and_pool_relu_avg")


# -- the resolvers against the JAX package's, group by group ---------------------


def _group_args(nd_name, unfuse_norms):
    """Every fused single-conv group of a net's default advanced plan:
    ``(name, in_chw, w_shape, stride, padding, pool4, lrn)``."""
    from repro_torch.core.netdefs import NETWORKS
    from repro_torch.core.plan import compile_plan

    net = NETWORKS[nd_name]()
    off = {l.name: False for l in net.layers if l.kind == "lrn"}
    plan = compile_plan(net, per_layer_fuse=off if unfuse_norms else None)
    for st in plan.steps:
        if st.kind != "fused":
            continue
        g, cv = st.group, st.group.conv
        lrn = None if g.lrn is None else (g.lrn.lrn_n, g.lrn.lrn_alpha,
                                          g.lrn.lrn_beta, g.lrn.lrn_k)
        yield (g.name, tuple(st.in_shape),
               (cv.out_channels, st.in_shape[0], *cv.kernel), cv.stride,
               cv.padding, (*g.pool.kernel, *g.pool.stride), lrn)


GROUPS = [(net, unfuse, args) for net in ("lenet5", "cifar10", "alexnet")
          for unfuse in (False, True)
          for args in _group_args(net, unfuse)]


# -- K4, K5, K6 geometry -------------------------------------------------------------

ALEX_GROUPS = {
    # name: (in_chw, w_shape, stride, padding)
    "conv1": ((3, 227, 227), (96, 3, 11, 11), (4, 4), (0, 0)),
    "conv2": ((96, 27, 27), (256, 96, 5, 5), (1, 1), (2, 2)),
}
CIFAR_GROUPS = {
    "conv1": ((3, 32, 32), (32, 3, 5, 5), (1, 1), (2, 2)),
    "conv2": ((32, 15, 15), (32, 32, 5, 5), (1, 1), (2, 2)),
    "conv3": ((32, 7, 7), (64, 32, 5, 5), (1, 1), (2, 2)),
}
POOL32 = conv_ops.Pool(3, 3, 2, 2, "max")
ALEX_CHAIN = conv_ops.make_stages(
    (256, 13, 13), [(384, 256, 3, 3), (384, 384, 3, 3), (256, 384, 3, 3)],
    [(1, 1)] * 3, [(1, 1)] * 3, [True] * 3)


def _stages(in_chw, w_shape, stride, padding):
    return conv_ops.make_stages(in_chw, [w_shape], [stride], [padding],
                                [True])


# -- K1, K2, K5, K6: the stage-major schedule -------------------------------------

#: chains of the schedule tests: AlexNet's conv3-5 + pool5, and a small odd
#: one (channels off the float4, a strided 5 x 5 stage, a 1 x 3 kernel)
CHAINS = {
    "alexnet": (ALEX_CHAIN, POOL32),
    "odd": (conv_ops.make_stages(
        (3, 15, 14), [(6, 3, 5, 5), (9, 6, 3, 3), (5, 9, 1, 3)],
        [(2, 2), (1, 1), (1, 1)], [(2, 2), (1, 1), (0, 1)], [True] * 3),
        conv_ops.Pool(2, 2, 1, 1, "avg")),
}
ALEX_CONVS = {
    # name: (in_chw, w_shape, stride, padding) of AlexNet's per-layer convs
    **ALEX_GROUPS,
    "conv3": ((256, 13, 13), (384, 256, 3, 3), (1, 1), (1, 1)),
    "conv4": ((384, 13, 13), (384, 384, 3, 3), (1, 1), (1, 1)),
    "conv5": ((384, 13, 13), (256, 384, 3, 3), (1, 1), (1, 1)),
}


def _k1_case_stage(case):
    """``(stages, pool)`` of one of ``K1_CASES``."""
    xs, ws, stride, padding, relu, pk, ps, kind = K1_CASES[case][:8]
    return (conv_ops.make_stages(xs[1:], [ws], [stride], [padding], [relu]),
            conv_ops.Pool(*pk, *ps, kind))


#: the one-stage launches of K1 and K5: AlexNet's conv1+pool1(+norm1) and
#: conv2+pool2(+norm2) groups and its per-layer convs 1-5, the CIFAR-10
#: net's three groups (K5's other main-path shapes), and K1_CASES
ONE_STAGE = {
    **{f"alexnet_{g}_group": (_stages(*ALEX_GROUPS[g]), POOL32)
       for g in ALEX_GROUPS},
    **{f"alexnet_{c}": (_stages(*ALEX_CONVS[c]), None) for c in ALEX_CONVS},
    **{f"cifar10_{g}_group": (_stages(*CIFAR_GROUPS[g]), POOL32)
       for g in CIFAR_GROUPS},
    **{f"k1_{c}": _k1_case_stage(c) for c in K1_CASES},
}
#: every schedule the stage-major tests walk
SCHEDULES = {**CHAINS, **ONE_STAGE}


def _chain_constants():
    """The integer constants (``CH_*``) that ``csrc/conv_stage_major.cuh``
    declares."""
    src = (_build.CSRC / "conv_stage_major.cuh").read_text()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (CH_[A-Z_]+) = (\d+);", src)}


def _chain_items(st, sp):
    """The items of one stage as the kernel walks them (item -> pixel
    tile fastest, then channel block, then partial): ``(pixels, channels,
    chunks, q)`` ranges; chunk g is chunk g % split of tap g // split."""
    n_ot = math.ceil(sp.ocp / conv_ops.ST_TO)
    for item in range(sp.items):
        mt, rest = item % sp.tiles_m, item // sp.tiles_m
        ob, q = rest % sp.o_items, rest // sp.o_items
        ot0 = ob * sp.ot_item
        ot1 = min(ot0 + sp.ot_item, n_ot)
        yield (range(mt * conv_ops.ST_TP, min((mt + 1) * conv_ops.ST_TP,
                                              sp.m)),
               range(ot0 * conv_ops.ST_TO, min(ot1 * conv_ops.ST_TO, sp.ocp)),
               range(q * sp.unit, (q + 1) * sp.unit), q)


def _fold(values, add):
    out = values[0]
    for v in values[1:]:
        out = add(out, v)
    return out


def _units(st, split, tpr):
    """The units the kernel takes for a stage: one chunk, a tap, a kernel
    row and, where ``whole_run`` allows it, every chunk."""
    chunks = st.KH * tpr * split
    whole = (chunks,) if conv_ops.whole_run(split, tpr, st.KH) else ()
    return tuple(dict.fromkeys((1, split, tpr * split) + whole))


def _run_tree(st, split, tpr, unit, chunk, add):
    """One output's sum as ``csrc/conv_stage_major.cuh`` adds it with items
    of ``unit`` chunks.  An item folds its chunks into a tap (a fresh tap
    at each tap's first chunk) and writes the tap to partial q when the tap
    or the item ends, adding it to what it wrote there when it is a later
    tap of a row item; the reduce folds the partials left (chunks into
    taps, taps into rows, rows).  A whole item folds runs of ``whole_run``
    chunks and adds each run after the first to its partial.  ``chunk(g)``
    is chunk g's sum."""
    chunks = st.KH * tpr * split
    if unit == chunks:
        run = conv_ops.whole_run(split, tpr, st.KH)
        return _fold([_fold([chunk(g) for g in range(r0, r0 + run)], add)
                      for r0 in range(0, chunks, run)], add)
    part = {}
    for q in range(chunks // unit):
        f = None
        for jj in range(unit):
            g = q * unit + jj
            k = g % split
            f = chunk(g) if k == 0 or jj == 0 else add(f, chunk(g))
            if k == split - 1 or jj == unit - 1:
                later = unit > split and (g // split) % tpr
                part[q] = add(part[q], f) if later else f
    per_tap = split if unit == 1 else 1
    taps = 1 if unit > split else tpr
    return _fold([_fold([_fold([part[(i * taps + j) * per_tap + k]
                                for k in range(per_tap)], add)
                         for j in range(taps)], add)
                  for i in range(st.KH)], add)


def _sum_order(st, split, tpr, unit):
    """The tree of one output's sum with items of ``unit`` chunks."""
    return _run_tree(st, split, tpr, unit, lambda g: g,
                     lambda a, b: ("+", a, b))


def _walk_rows(st, sp):
    """The reduction rows the kernel's loads give each chunk, slot and row
    of a slot (the arithmetic of ``stage_items`` in
    ``csrc/conv_stage_major.cuh``): ``(chunk, kernel row i, kernel column
    j, channel c, HWIO row)`` for each row inside its tap's run."""
    cp = _round4(st.C)
    for g in range(st.KH * sp.tpr * sp.split):
        tap, k = divmod(g, sp.split)
        i, j0 = divmod(tap, sp.tpr)
        for t in range(sp.chunk_slots):
            for kk in range(conv_ops.CH_CK):
                r = (k * sp.chunk_slots + t) * conv_ops.CH_CK + kk
                if r < sp.tw:
                    yield g, i, j0 + r // cp, r % cp, tap * sp.tw + r


#: stages whose Cp is under CH_CK: AlexNet's conv1 and the LeNet-5 and
#: CIFAR-10 conv1 (Cp 4), Cp 8 and 12, and a row of 132 floats (two
#: chunks a row)
NARROW = {
    "alexnet_conv1": ((3, 227, 227), (96, 3, 11, 11), (4, 4), (0, 0)),
    "lenet5_conv1": ((1, 28, 28), (20, 1, 5, 5), (1, 1), (0, 0)),
    "cifar10_conv1": CIFAR_GROUPS["conv1"],
    "cp8_2x3": ((6, 9, 10), (5, 6, 2, 3), (1, 1), (0, 1)),
    "cp12_2x11": ((9, 8, 30), (7, 9, 2, 11), (1, 2), (1, 5)),
}


def _emulate_chain(x, ws, bs, strides, pads, relus, pool, lrn, ocb=None,
                   unit=None, pool_relu=False):
    """The stage-major schedule in plain PyTorch (fp32): the input to
    NHWC with channels zero-padded to a float4, the weights as
    ``chain_weights`` converts them; per stage every item of
    ``chain_plan`` computes each of its chunks as a [pixels, chunk's
    floats] x [chunk's floats, channels] product (a tap's run: one kernel
    position's Cp channels, or a kernel row's KW x Cp floats; zero outside
    the stage's input: padding is read as activation zeros) and the items
    and the reduce add them in the kernel's tree (``_run_tree``), then the
    bias and the ReLU; then the pool / [ReLU] / LRN tail.  ``unit`` (a
    number of chunks) overrides the unit the plan picks at every stage."""
    n = x.shape[0]
    stages = conv_ops.make_stages(tuple(x.shape[1:]), ws, strides, pads,
                                  relus)
    plan = conv_ops.chain_plan(stages, pool, n, REPORT_SMS, ocb)
    act = torch.nn.functional.pad(x.permute(0, 2, 3, 1),
                                  (0, _round4(x.shape[1]) - x.shape[1]))
    for st, sp, w, b in zip(stages, plan.stages, ws, bs):
        chunks = st.KH * sp.tpr * sp.split
        if unit is not None:
            q = chunks // unit
            sp = sp._replace(unit=unit, n_partials=q, whole=unit == chunks,
                             items=sp.tiles_m * sp.o_items * q)
        wt = conv_ops.chain_weights(w)          # [KH, KW, Cp, OCp]
        cp = _round4(st.C)
        assert wt.shape == (st.KH, st.KW, cp, sp.ocp)
        w_rows = wt.reshape(-1, sp.ocp)         # HWIO row tap * tw + r
        m = torch.arange(sp.m)
        fr, pix = m // (st.OH * st.OW), m % (st.OH * st.OW)
        iy0 = pix // st.OW * st.sy - st.py
        ix0 = pix % st.OW * st.sx - st.px
        width = sp.chunk_slots * conv_ops.CH_CK
        span = st.KW if sp.tpr == 1 else 1      # kernel columns of a tap
        sums = torch.full((chunks, sp.m, sp.ocp), float("nan"))
        for px, ch, cr, _ in _chain_items(st, sp):
            sl, cs = slice(px.start, px.stop), slice(ch.start, ch.stop)
            for g in cr:
                tap, k = divmod(g, sp.split)
                i, j0 = divmod(tap, sp.tpr)
                cols = []
                for j in range(j0, j0 + span):
                    iy, ix = iy0[sl] + i, ix0[sl] + j
                    ok = (iy >= 0) & (iy < st.H) & (ix >= 0) & (ix < st.W)
                    a = act[fr[sl], iy.clamp(0, st.H - 1),
                            ix.clamp(0, st.W - 1)]
                    cols.append(torch.where(ok[:, None], a, torch.zeros(())))
                a = torch.cat(cols, dim=1)      # [pixels, tw]
                cc = slice(k * width, (k + 1) * width)
                sums[g, sl, cs] = (a[:, cc]
                                   @ w_rows[tap * sp.tw:(tap + 1) * sp.tw]
                                   [cc, cs])
        tot = _run_tree(st, sp.split, sp.tpr, sp.unit, lambda g: sums[g],
                        torch.add)
        out = tot[:, :st.OC] + b
        out = out.clamp_min(0.0) if st.relu else out
        out = torch.nn.functional.pad(out, (0, sp.ocp - st.OC))
        act = out.reshape(n, st.OH, st.OW, sp.ocp)
    last = stages[-1]
    out = act[..., :last.OC].permute(0, 3, 1, 2)
    kw = {} if lrn is None else dict(lrn_n=lrn[0], lrn_alpha=lrn[1],
                                     lrn_beta=lrn[2], lrn_k=lrn[3])
    if pool is None:
        return out
    from repro_torch.kernels.conv2d.ref import pool_lrn_tail

    return pool_lrn_tail(out, (pool.kh, pool.kw), (pool.sy, pool.sx),
                         pool.kind, pool_relu, **kw)


def _k2_inputs(case, n):
    xs, specs, pool, lrn_n = K2_CASES[case]
    rng = np.random.default_rng(20 + len(case) + n)
    x = _arr(rng, n, *xs[1:])
    c, ws, bs = xs[1], [], []
    for oc, k, _, _, _ in specs:
        ws.append(_arr(rng, oc, c, k, k, scale=(c * k * k) ** -0.5))
        bs.append(_arr(rng, oc, scale=0.1))
        c = oc
    args = ([(s, s) for _, _, s, _, _ in specs],
            [(p, p) for _, _, _, p, _ in specs], [r for *_, r in specs])
    return x, ws, bs, args, pool, lrn_n


def _k1_inputs(case, n):
    """Seeded inputs of a ``K1_CASES`` case at batch ``n``: ``(x, w, b,
    stride, padding, relu, tail, pool, lrn)``, ``tail`` the wrappers'
    keywords, ``pool``/``lrn`` the schedule's."""
    (xs, ws, stride, padding, relu, pk, ps, kind, pool_relu,
     lrn_n) = K1_CASES[case]
    rng = np.random.default_rng(40 + len(case) + n)
    x, w, b = _arr(rng, n, *xs[1:]), _arr(rng, *ws, scale=0.3), _arr(rng,
                                                                    ws[0])
    tail = dict(pool_kernel=pk, pool_stride=ps, pool_kind=kind,
                pool_relu=pool_relu, lrn_n=lrn_n, lrn_alpha=1e-3,
                lrn_beta=0.75, lrn_k=1.0)
    lrn = (lrn_n, 1e-3, 0.75, 1.0) if lrn_n else None
    return (x, w, b, stride, padding, relu, tail,
            conv_ops.Pool(*pk, *ps, kind), lrn)


#: AlexNet's lrn layers (netdefs defaults): n, alpha, beta, k
ALEX_LRN = (5, 1e-4, 0.75, 1.0)


class _OnCard:
    """A CPU tensor that says it lies on the card, so that a wrapper takes
    its CUDA branch, whose launch the test records instead of running."""

    def __init__(self, t):
        self.t, self.shape, self.device = t, t.shape, torch.device("cuda")


#: no-LRN groups K5 takes: AlexNet's conv1+pool1 and conv2+pool2 (frames
#: cut to keep the emulation short) and the CIFAR-10 net's three groups
K5_GROUPS = {
    "alexnet_conv1": ((3, 63, 63), (96, 3, 11, 11), (4, 4), (0, 0)),
    "alexnet_conv2": ((96, 13, 13), (256, 96, 5, 5), (1, 1), (2, 2)),
    **{f"cifar10_{g}": CIFAR_GROUPS[g] for g in CIFAR_GROUPS},
}


def _record_stage_major(monkeypatch):
    """Calls of the stage-major launch, recorded instead of run: (wrapper,
    C entry, the launch's arguments)."""
    calls = []
    monkeypatch.setattr(conv_ops, "check_cuda_f32", lambda *a: None)
    monkeypatch.setattr(conv_ops, "_launch_stage_major",
                        lambda wrapper, entry, *a: calls.append(
                            (wrapper, entry, a)))
    return calls


#: AlexNet's lrn layers in the fused groups' keywords
ALEX_LRN_TAIL = dict(pool_kernel=(3, 3), pool_stride=(2, 2),
                     lrn_n=ALEX_LRN[0], lrn_alpha=ALEX_LRN[1],
                     lrn_beta=ALEX_LRN[2], lrn_k=ALEX_LRN[3])


#: LRN groups K4 takes: AlexNet's conv1+pool1+norm1 and conv2+pool2+norm2,
#: frames cut to keep the emulation short
K4_GROUPS = {
    "alexnet_conv1": ((3, 63, 63), (96, 3, 11, 11), (4, 4), (0, 0)),
    "alexnet_conv2": ((96, 13, 13), (256, 96, 5, 5), (1, 1), (2, 2)),
}


class _Entry:
    """A stand-in of a stage-major C entry that records, when it is called,
    whether each weight pointer it gets is the data of a converted weight
    tensor that is still alive, and each bias pointer a bias's data."""

    def __init__(self, converted, bs):
        self.converted, self.bs, self.seen = converted, bs, None

    def __call__(self, x, w_ptrs, b_ptrs, *rest):
        live = {t.data_ptr() for t in (r() for r in self.converted)
                if t is not None}
        self.seen = ([p in live for p in w_ptrs],
                     list(b_ptrs) == [b.data_ptr() for b in self.bs])
        return 0
