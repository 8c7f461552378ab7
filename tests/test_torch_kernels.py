"""The port's kernel modules on the CPU, against their JAX counterparts.

Each case draws its inputs with numpy from a seed and hands the same
arrays to both packages.  The JAX side takes its jnp paths (the Pallas
path does not run under the installed jax); the port's wrappers take
their plain versions because the tensors lie on the CPU.  Tolerance:
max abs <= 1e-4 (fp32 sums in another order).  The CUDA kernels
themselves are checked against these plain versions on the card by
``chip_smoke.py``.
"""
import math
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import methods as jm
from repro.core.plan import _lrn as jax_lrn
from repro.core.netdefs import LayerSpec as JLayerSpec
from repro.kernels.conv2d.ref import conv2d_ref as jax_conv2d_ref
from repro.kernels.matmul_fused.ref import matmul_fused_ref as jax_mm_ref
from repro.kernels.pool2d.ref import pool2d_ref as jax_pool2d_ref
from repro_torch.core import methods as tm
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.conv2d.ref import (
    conv2d_basic_parallel_ref,
    conv2d_basic_simd_ref,
    conv2d_ref,
    lrn_ref,
)
from repro_torch.kernels.matmul_fused import ops as mm_ops
from repro_torch.kernels.matmul_fused.ops import matmul_fused, split_k
from repro_torch.kernels.pool2d.ops import pool2d
from repro_torch.kernels.pool2d.ref import pool2d_ref

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


# -- K3: fused bias + activation matmul --------------------------------------


@pytest.mark.parametrize("act", ["none", "relu", "silu", "gelu"])
@pytest.mark.parametrize("m,k,n", [(3, 29, 37), (16, 800, 500), (1, 64, 10)])
def test_matmul_fused_matches_jax(act, m, k, n):
    rng = np.random.default_rng(m * 1000 + k + n)
    x, w, b = _arr(rng, m, k), _arr(rng, k, n, scale=k ** -0.5), _arr(rng, n)
    ours = matmul_fused(_t(x), _t(w), _t(b), act)
    _close(ours, jax_mm_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            act))


def test_matmul_fused_no_bias_and_leading_dims():
    rng = np.random.default_rng(1)
    x, w = _arr(rng, 2, 3, 40), _arr(rng, 40, 24, scale=0.2)
    ours = matmul_fused(_t(x), _t(w), None, "relu")
    assert ours.shape == (2, 3, 24)
    _close(ours.reshape(6, 24),
           jax_mm_ref(jnp.asarray(x.reshape(6, 40)), jnp.asarray(w), None,
                      "relu"))


@pytest.mark.parametrize("m,n,k", [(16, 4096, 9216), (1, 4096, 9216),
                                   (16, 1000, 4096), (2, 10, 500),
                                   (40, 7, 3)])
def test_split_k_covers_k(m, n, k):
    """The weight stream's K slices for either type, at every M below 64
    (``m`` is one of them; the slicing does not read it): whole ring
    stages, none empty, one cluster of at most ``STREAM_CLUSTER``."""
    for dtype in (torch.float32, torch.bfloat16):
        splits, kchunk = split_k(dtype, k, n, 132)
        assert kchunk % mm_ops.STREAM_BK[dtype] == 0
        assert 1 <= splits <= mm_ops.STREAM_CLUSTER
        assert (splits - 1) * kchunk < k <= splits * kchunk  # no empty slice
        assert mm_ops.k3_path(dtype, m, k, n) == (
            "stream" if m < mm_ops.TILED_MIN_M else "tiles")


# -- plain building blocks ----------------------------------------------------


@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("relu", [False, True])
def test_pool2d_ref_matches_jax(kind, relu):
    rng = np.random.default_rng(2)
    x = _arr(rng, 2, 5, 13, 11)
    _close(pool2d_ref(_t(x), (3, 3), (2, 2), kind, relu),
           jax_pool2d_ref(jnp.asarray(x), (3, 3), (2, 2), kind, relu))


@pytest.mark.parametrize("stride,padding", [((1, 1), (0, 0)),
                                            ((4, 4), (0, 0)),
                                            ((2, 1), (2, 1))])
def test_conv2d_ref_matches_jax(stride, padding):
    rng = np.random.default_rng(3)
    x, w, b = _arr(rng, 2, 3, 19, 17), _arr(rng, 6, 3, 5, 5), _arr(rng, 6)
    theirs = _jit(jax_conv2d_ref, stride=stride, padding=padding, relu=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(conv2d_ref(_t(x), _t(w), _t(b), stride, padding, True), theirs)


@pytest.mark.parametrize("n", [5, 4, 3])
def test_lrn_ref_matches_jax(n):
    rng = np.random.default_rng(4)
    x = _arr(rng, 2, 12, 5, 5, scale=20.0)  # large enough to normalise
    spec = JLayerSpec("lrn", "norm", lrn_n=n, lrn_alpha=1e-3, lrn_beta=0.75,
                      lrn_k=2.0)
    _close(lrn_ref(_t(x), n, 1e-3, 0.75, 2.0), jax_lrn(jnp.asarray(x), spec))


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


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_conv2d_pool_fused_matches_jax(case):
    (xs, ws, stride, padding, relu, pk, ps, kind, pool_relu,
     lrn_n) = K1_CASES[case]
    rng = np.random.default_rng(len(case))
    x, w, b = _arr(rng, *xs), _arr(rng, *ws, scale=0.3), _arr(rng, ws[0])
    lrn = dict(lrn_n=lrn_n, lrn_alpha=1e-3, lrn_beta=0.75, lrn_k=1.0)
    theirs = _jit(jm.conv2d_pool_fused, method=jm.Method.ADVANCED_SIMD_8,
                  stride=stride, padding=padding, relu=relu, pool_kernel=pk,
                  pool_stride=ps, pool_kind=kind, pool_relu=pool_relu,
                  **lrn)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ours = tm.conv2d_pool_fused(_t(x), _t(w), _t(b),
                                tm.Method.ADVANCED_SIMD_8, stride, padding,
                                relu, pk, ps, kind, pool_relu, **lrn)
    _close(ours, theirs)
    # the kernel module's plain version is the same function
    _close(conv_ops.conv2d_pool_fused_ref(
        _t(x), _t(w), _t(b), stride, padding, relu, pk, ps, kind, pool_relu,
        **lrn), theirs)


def test_conv2d_pool_fused_without_pool_is_the_conv():
    rng = np.random.default_rng(5)
    x, w, b = _arr(rng, 2, 4, 9, 9), _arr(rng, 7, 4, 3, 3), _arr(rng, 7)
    theirs = _jit(jax_conv2d_ref, stride=(2, 2), padding=(1, 1), relu=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(conv_ops.conv2d_pool_fused(_t(x), _t(w), _t(b), (2, 2), (1, 1),
                                      True), theirs)


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


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_conv2d_chain_matches_jax(case):
    xs, stages, pool, lrn_n = K2_CASES[case]
    rng = np.random.default_rng(10 + len(case))
    x = _arr(rng, *xs)
    c = xs[1]
    ws, bs = [], []
    for oc, k, _, _, _ in stages:
        ws.append(_arr(rng, oc, c, k, k, scale=(c * k * k) ** -0.5))
        bs.append(_arr(rng, oc, scale=0.1))
        c = oc
    strides = [(s, s) for _, _, s, _, _ in stages]
    pads = [(p, p) for _, _, _, p, _ in stages]
    relus = [r for *_, r in stages]
    tail = dict(pool_kernel=pool[0] if pool else None,
                pool_stride=pool[1] if pool else None,
                pool_kind=pool[2] if pool else "max", lrn_n=lrn_n,
                lrn_alpha=1e-2, lrn_beta=0.75, lrn_k=1.0)
    theirs = _jit(jm.conv2d_chain_fused, method=jm.Method.ADVANCED_SIMD_8,
                  strides=tuple(strides), paddings=tuple(pads),
                  relus=tuple(relus), **tail)(
        jnp.asarray(x), [jnp.asarray(w) for w in ws],
        [jnp.asarray(b) for b in bs])
    ours = tm.conv2d_chain_fused(_t(x), [_t(w) for w in ws],
                                 [_t(b) for b in bs],
                                 tm.Method.ADVANCED_SIMD_8, strides, pads,
                                 relus, **tail)
    _close(ours, theirs)


# -- K7, K8, K9: the §4.3 and §4.2 convs and the standalone pool ------------------

LADDER_CONV_CASES = {
    # name: (x shape, w shape, stride, padding)
    "3x3_pad1": ((2, 4, 11, 11), (10, 4, 3, 3), (1, 1), (1, 1)),
    "5x5_pad2_c3": ((2, 3, 14, 13), (7, 3, 5, 5), (1, 1), (2, 2)),
    "11x11_s4": ((1, 3, 43, 43), (8, 3, 11, 11), (4, 4), (0, 0)),
    "strided_2x1": ((2, 6, 12, 15), (5, 6, 3, 3), (2, 1), (1, 0)),
}


@pytest.mark.parametrize("case", sorted(LADDER_CONV_CASES))
@pytest.mark.parametrize("relu", [False, True])
def test_basic_simd_ref_matches_jax(case, relu):
    """K7's plain version (NHWC, a channel dot per kernel position) against
    JAX ``methods.conv2d_basic_simd`` without Pallas."""
    xs, ws, stride, padding = LADDER_CONV_CASES[case]
    rng = np.random.default_rng(20 + len(case))
    x, w, b = _arr(rng, *xs), _arr(rng, *ws, scale=0.3), _arr(rng, ws[0])
    theirs = _jit(jm.conv2d_basic_simd, stride=stride, padding=padding,
                  relu=relu)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(conv2d_basic_simd_ref(_t(x), _t(w), _t(b), stride, padding, relu),
           theirs)
    _close(conv_ops.conv2d_basic_simd(_t(x), _t(w), _t(b), stride, padding,
                                      relu), theirs)


@pytest.mark.parametrize("case", sorted(LADDER_CONV_CASES))
@pytest.mark.parametrize("relu", [False, True])
def test_basic_parallel_ref_matches_jax(case, relu):
    """K8's plain version (NCHW patches, channels outer) against JAX
    ``methods.conv2d_basic_parallel`` without Pallas."""
    xs, ws, stride, padding = LADDER_CONV_CASES[case]
    rng = np.random.default_rng(30 + len(case))
    x, w, b = _arr(rng, *xs), _arr(rng, *ws, scale=0.3), _arr(rng, ws[0])
    theirs = _jit(jm.conv2d_basic_parallel, stride=stride, padding=padding,
                  relu=relu)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(conv2d_basic_parallel_ref(_t(x), _t(w), _t(b), stride, padding,
                                     relu), theirs)
    _close(conv_ops.conv2d_basic_parallel(_t(x), _t(w), _t(b), stride,
                                          padding, relu), theirs)


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_basic_simd_fused_matches_jax(case):
    """The fused §4.3 super-layer (K7 with its pool/ReLU/LRN tail) against
    JAX ``methods.conv2d_pool_fused(method=BASIC_SIMD)`` without Pallas."""
    (xs, ws, stride, padding, relu, pk, ps, kind, pool_relu,
     lrn_n) = K1_CASES[case]
    rng = np.random.default_rng(40 + len(case))
    x, w, b = _arr(rng, *xs), _arr(rng, *ws, scale=0.3), _arr(rng, ws[0])
    lrn = dict(lrn_n=lrn_n, lrn_alpha=1e-3, lrn_beta=0.75, lrn_k=1.0)
    theirs = _jit(jm.conv2d_pool_fused, method=jm.Method.BASIC_SIMD,
                  stride=stride, padding=padding, relu=relu, pool_kernel=pk,
                  pool_stride=ps, pool_kind=kind, pool_relu=pool_relu,
                  **lrn)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(tm.conv2d_pool_fused(_t(x), _t(w), _t(b), tm.Method.BASIC_SIMD,
                                stride, padding, relu, pk, ps, kind,
                                pool_relu, **lrn), theirs)
    _close(conv2d_basic_simd_ref(_t(x), _t(w), _t(b), stride, padding, relu,
                                 pool_kernel=pk, pool_stride=ps,
                                 pool_kind=kind, pool_relu=pool_relu, **lrn),
           theirs)


@pytest.mark.parametrize("kernel,stride", [((3, 3), (2, 2)), ((2, 2), (2, 2)),
                                           ((3, 2), (1, 2))])
@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("relu", [False, True])
def test_pool2d_wrapper_matches_jax(kernel, stride, kind, relu):
    """K9's wrapper (its plain version on the CPU) against JAX
    ``pool2d_ref``, at the pool shapes of the three nets and a ragged
    one."""
    rng = np.random.default_rng(sum(kernel) + sum(stride))
    x = _arr(rng, 2, 5, 13, 12)
    _close(pool2d(_t(x), kernel, stride, kind, relu),
           jax_pool2d_ref(jnp.asarray(x), kernel, stride, kind, relu))


def test_pool2d_negative_inputs_stay_negative_under_max():
    """The TPU kernel pads channels with zeros, which must never win a max
    (tests/test_pool2d.py); the port pads no channel, and a max over
    all-negative inputs stays negative."""
    x = -1.0 - np.random.default_rng(9).random((2, 3, 9, 9)).astype(
        np.float32)
    out = pool2d(_t(x), (3, 3), (2, 2), "max")
    assert (out < 0).all()
    _close(out, jax_pool2d_ref(jnp.asarray(x), (3, 3), (2, 2), "max"))


def test_pool2d_rejects_a_window_larger_than_the_input():
    from repro_torch.kernels.pool2d.ops import pool_out_hw

    assert pool_out_hw(27, 27, (3, 3), (2, 2)) == (13, 13)
    with pytest.raises(ValueError, match="larger than input"):
        pool_out_hw(2, 9, (3, 3), (2, 2))


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


def test_pool_constants_match_the_wrapper():
    from repro_torch.kernels.pool2d import ops as pool_ops

    assert _pool_constants() == {"POOL_THREADS": pool_ops.THREADS}


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("shape", _net_pool_shapes()
                         + [(3, 13, 12, (3, 2), (1, 2), "max", False)])
def test_k9_walk_matches_jax(shape, kind, relu):
    """The plane-per-block walk writes every output once and equals JAX's
    ``pool2d_ref`` at every pool shape of the three nets' unfused plans
    (channels cut to 3, batch 2) and a ragged one, max and avg, with and
    without ReLU, with the bits of the previous kernel's order."""
    c, h, w, kernel, stride, _, _ = shape
    rng = np.random.default_rng(h * 100 + w + sum(kernel))
    x = _arr(rng, 2, min(c, 3), h, w)
    y, writes = _emulate_k9(x, kernel, stride, kind, relu)
    assert (writes == 1).all()
    _close(y, jax_pool2d_ref(jnp.asarray(x), kernel, stride, kind, relu))
    assert np.array_equal(y, _one_thread_an_output(x, kernel, stride, kind,
                                                   relu))


@pytest.mark.parametrize("n", [1, 16])
def test_k9_grid_fills_the_card_at_batch_16(n):
    """AlexNet's pools: whole planes a block, 32-bit offsets inside a
    plane, and at batch 16 at least one block an SM."""
    from repro_torch.kernels.pool2d import ops as pool_ops

    for c, h, w, kernel, stride, _, _ in _net_pool_shapes()[:3]:
        oh, ow = pool_ops.pool_out_hw(h, w, kernel, stride)
        plan = pool_ops.pool_plan(n * c, oh, ow)
        assert plan.ppb * plan.per_plane <= max(pool_ops.THREADS,
                                                plan.per_plane)
        assert plan.blocks * plan.ppb >= n * c > (plan.blocks - 1) * plan.ppb
        assert h * w < 2 ** 31
        if n == 16:
            assert plan.blocks >= REPORT_SMS


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("kind", ["max", "avg"])
def test_k9_launch_passes_live_tensors(kind, relu, monkeypatch):
    """``_launch`` hands ``pool2d_f32`` the input and the one tensor it
    allocates (the output it returns), both alive when it is called, the
    geometry, the kind code and the stream handle, and steps the counter
    once."""
    import weakref

    from repro_torch.kernels.pool2d import ops as pool_ops

    x = torch.zeros(2, 5, 13, 12)
    calls, tensors = [], [weakref.ref(x)]
    empty = torch.empty

    def recording(*a, **kw):
        out = empty(*a, **kw)
        tensors.append(weakref.ref(out))
        return out

    def entry(*args):
        live = {t.data_ptr() for t in (r() for r in tensors) if t is not None}
        calls.append((args, [p in live for p in args[:2]]))
        return 0

    fake = type("Lib", (), {"pool2d_f32": staticmethod(entry)})()
    monkeypatch.setattr(pool_ops, "check_cuda_f32", lambda *a: None)
    monkeypatch.setattr(pool_ops, "stream_handle", lambda dev: 55)
    monkeypatch.setattr(pool_ops.torch, "empty", recording)
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(pool2d, "launches", 0)
    y = pool_ops._launch(x, (3, 2), (1, 2), kind, relu)
    (args, live), = calls
    assert live == [True, True] and len(tensors) == 2
    assert args == (x.data_ptr(), y.data_ptr(), 10, 13, 12, 11, 6, 3, 2, 1, 2,
                    pool_ops.KIND_CODES[kind], int(relu), 55)
    assert y.shape == (2, 5, 11, 6) and pool2d.launches == 1


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


def test_simt_constants_match_the_wrappers():
    """The wrappers' copies of the sources' tile constants, and K8's dims
    array, agree with the sources."""
    c = _simt_constants()
    assert (c["ST_TP"], c["ST_TO"], c["ST_BROW"]) == (
        conv_ops.ST_TP, conv_ops.ST_TO, conv_ops.ST_BROW)
    assert (c["K7_CK"], c["K7_AROW"], c["K7_MAX_GROUPS"]) == (
        conv_ops.K7_CK, conv_ops.K7_AROW, conv_ops.K7_MAX_GROUPS)
    assert (c["K7_SMEM_LIMIT"] == c["K8_SMEM_LIMIT"]
            == conv_ops.K7_SMEM_LIMIT == 227 * 1024)
    assert conv_ops.K7_RING == 2 * (c["ST_TP"] * c["K7_AROW"]
                                    + c["K7_CK"] * c["ST_BROW"])
    # 8 x 8 accumulators a thread; K7's stage is whole float4s of channels
    assert c["ST_TP"] * c["ST_TO"] == 64 * c["ST_THREADS"]
    assert c["K7_CK"] % 4 == 0 and c["K7_AROW"] % 4 == 0
    st, dims, _, _ = conv_ops.k8_launch(1, (3, 9, 9), (4, 3, 3, 3), (1, 1),
                                        (1, 1), True)
    assert len(dims) == c["K8_DIMS"]
    geo = conv_ops.k7_launch(1, (4, 9, 9), (4, 4, 3, 3), (1, 1), (1, 1),
                             True, None, False, None)[2]
    assert len(geo) == 14 + 13 + c["K7_GEO_TAIL"]


@pytest.mark.parametrize("conv", sorted(NET_CONVS))
@pytest.mark.parametrize("n", [1, 16])
def test_k8_geometry(conv, n):
    """K8's launch: a block per (frame, pixel tile, channel tile) within
    CUDA's grid limits, every output written by exactly one thread, every
    tap of every pixel inside the stage's halo, ``cc`` the most channels
    whose stage fits ``K8_STAGE_FLOATS``, and two stages within 227 KB."""
    c = _simt_constants()
    in_chw, w_shape, stride, padding = NET_CONVS[conv]
    st, dims, smem, grid = conv_ops.k8_launch(n, in_chw, w_shape, stride,
                                              padding, True)
    p_all, tp, to = st.OH * st.OW, c["ST_TP"], c["ST_TO"]
    n_pt = -(-p_all // tp)
    assert grid == (n_pt * n, -(-st.OC // to))
    assert grid[0] < 2 ** 31 and grid[1] <= 65535
    # blockIdx.x = frame * n_pt + pixel tile: each frame's tiles once
    assert (np.bincount(np.arange(grid[0]) // n_pt) == n_pt).all()
    tiles = [(t * tp, o * to) for t in range(n_pt) for o in range(grid[1])]
    assert (_tile_counts(c, p_all, st.OC, tiles) == 1).all()
    # the halo: rows (oy - r0) * sy + i and columns ox * sx + j of every
    # valid pixel's taps
    wp = (st.OW - 1) * st.sx + st.KW
    hr = 0
    for p0 in range(0, p_all, tp):
        p = np.arange(p0, min(p0 + tp, p_all))
        rows = (p // st.OW - p0 // st.OW) * st.sy + st.KH - 1
        cols = (p % st.OW) * st.sx + st.KW - 1
        assert cols.max() < wp
        hr = max(hr, int(rows.max()) + 1)
    assert hr == conv_ops.k8_halo_rows(st)
    cc = int(dims[-1])

    def stage(k):
        return (_round4(k * hr * wp)
                + _round4(k * st.KH * st.KW) * c["ST_BROW"])

    assert 1 <= cc <= st.C
    assert cc == 1 or stage(cc) <= conv_ops.K8_STAGE_FLOATS
    assert cc == st.C or stage(cc + 1) > conv_ops.K8_STAGE_FLOATS
    assert smem == 2 * 4 * stage(cc) <= c["K8_SMEM_LIMIT"]
    assert list(dims) == [n, *in_chw, w_shape[0], *w_shape[2:], *stride,
                          *padding, st.OH, st.OW, 1, cc]


@pytest.mark.parametrize("conv", sorted(NET_CONVS))
@pytest.mark.parametrize("n", [1, 16])
def test_k7_geometry(conv, n):
    """K7's per-layer launch (the grid its source computes): a block per
    (frame, pixel tile, channel tile) within CUDA's limits, every output
    written by exactly one thread, one ring under the 48 KB a block has
    without opting in, the channels padded to whole float4s."""
    c = _simt_constants()
    (ch, h, w), (oc, _, kh, kw), stride, padding = NET_CONVS[conv]
    cp = _round4(ch)
    stages, smem, geo, _ = conv_ops.k7_launch(
        n, (cp, h, w), (oc, cp, kh, kw), stride, padding, True, None, False,
        None)
    st = stages[0]
    p_all, tp, to = st.OH * st.OW, c["ST_TP"], c["ST_TO"]
    n_pt = -(-p_all // tp)
    assert n_pt * n < 2 ** 31 and -(-oc // to) <= 65535
    tiles = [(t * tp, o * to) for t in range(n_pt)
             for o in range(-(-oc // to))]
    assert (_tile_counts(c, p_all, oc, tiles) == 1).all()
    assert smem == 4 * conv_ops.K7_RING <= 48 * 1024
    assert geo[14] == cp and cp % conv_ops.K7_ALIGN == 0
    assert geo[2] == 0 and list(geo[-2:]) == [1, 0]


def test_simt_stage_loads_cover_each_element_once():
    """The copies a stage's threads issue: K7's A (pixel (gtid >> 2) + 32 r,
    channel quad gtid & 3) and B (row (gtid >> 6) + 2 r, column gtid & 63)
    and K8's weight rows (a warp: 8 channels x 4 consecutive k) write every
    element of their tiles exactly once."""
    c = _simt_constants()
    g = np.arange(c["ST_THREADS"])
    r4, r8 = np.arange(4), np.arange(8)
    a_px = ((g >> 2)[:, None] + 32 * r4[None]).ravel()
    a_q = np.repeat(g & 3, 4)
    count = np.zeros((c["ST_TP"], c["K7_CK"] // 4), dtype=np.int64)
    np.add.at(count, (a_px, a_q), 1)
    assert (count == 1).all()
    b_k = ((g >> 6)[:, None] + 2 * r8[None]).ravel()
    b_o = np.repeat(g & 63, 8)
    count = np.zeros((c["K7_CK"], c["ST_TO"]), dtype=np.int64)
    np.add.at(count, (b_k, b_o), 1)
    assert (count == 1).all()
    for rows in (4, 12, 124):
        e = np.arange(rows * c["ST_TO"])
        o = ((e >> 5) & 7) * 8 + (e & 7)
        k = (e >> 8) * 4 + ((e >> 3) & 3)
        count = np.zeros((rows, c["ST_TO"]), dtype=np.int64)
        np.add.at(count, (k, o), 1)
        assert (count == 1).all()
        # a warp's 32 stores land on 32 distinct banks of rows ST_BROW apart
        for w0 in range(0, len(e), 32):
            banks = (k[w0:w0 + 32] * c["ST_BROW"] + o[w0:w0 + 32]) % 32
            assert len(set(banks)) == 32


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


@pytest.mark.parametrize("case", sorted(LADDER_CONV_CASES))
@pytest.mark.parametrize("relu", [False, True])
def test_k8_tile_walk_matches_jax(case, relu):
    """The numpy emulation of K8's tile walk against JAX
    ``methods.conv2d_basic_parallel`` without Pallas; frame 0 of the batch
    equals, bit for bit, the same walk on frame 0 alone."""
    xs, ws, stride, padding = LADDER_CONV_CASES[case]
    rng = np.random.default_rng(50 + len(case))
    x, w, b = _arr(rng, *xs), _arr(rng, *ws, scale=0.3), _arr(rng, ws[0])
    theirs = _jit(jm.conv2d_basic_parallel, stride=stride, padding=padding,
                  relu=relu)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ours = _emulate_k8(x, w, b, stride, padding, relu)
    _close(ours, theirs)
    assert np.array_equal(ours[:1],
                          _emulate_k8(x[:1], w, b, stride, padding, relu))


@pytest.mark.parametrize("case", sorted(LADDER_CONV_CASES))
@pytest.mark.parametrize("relu", [False, True])
def test_k7_tile_walk_matches_jax(case, relu):
    """The numpy emulation of K7's per-layer tile walk against JAX
    ``methods.conv2d_basic_simd`` without Pallas; frame 0 of the batch
    equals, bit for bit, the same walk on frame 0 alone."""
    xs, ws, stride, padding = LADDER_CONV_CASES[case]
    rng = np.random.default_rng(60 + len(case))
    x, w, b = _arr(rng, *xs), _arr(rng, *ws, scale=0.3), _arr(rng, ws[0])
    theirs = _jit(jm.conv2d_basic_simd, stride=stride, padding=padding,
                  relu=relu)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ours = _emulate_k7(x, w, b, stride, padding, relu)
    _close(ours, theirs)
    assert np.array_equal(ours[:1],
                          _emulate_k7(x[:1], w, b, stride, padding, relu))


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k7_fused_tile_walk_matches_jax(case):
    """The numpy emulation of K7's fused kernel: each block's band (the
    conv rows of its pooled row, ``band_rows``) from its groups' tiles,
    where rows that two blocks share come out bit for bit the same, then
    the pool → [ReLU] → [LRN] tail, against JAX
    ``methods.conv2d_pool_fused(method=BASIC_SIMD)`` without Pallas."""
    (xs, ws, stride, padding, relu, pk, ps, kind, pool_relu,
     lrn_n) = K1_CASES[case]
    rng = np.random.default_rng(70 + len(case))
    x, w, b = _arr(rng, *xs), _arr(rng, *ws, scale=0.3), _arr(rng, ws[0])
    lrn = dict(lrn_n=lrn_n, lrn_alpha=1e-3, lrn_beta=0.75, lrn_k=1.0)
    theirs = _jit(jm.conv2d_pool_fused, method=jm.Method.BASIC_SIMD,
                  stride=stride, padding=padding, relu=relu, pool_kernel=pk,
                  pool_stride=ps, pool_kind=kind, pool_relu=pool_relu,
                  **lrn)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    c = _simt_constants()
    xh, wk, cp = _k7_operands(x, w)
    n, _, h, wd = x.shape
    oc, _, kh, kw = w.shape
    pool = conv_ops.Pool(*pk, *ps, kind)
    lrn_t = (lrn_n, 1e-3, 0.75, 1.0) if lrn_n is not None else None
    stages, _, geo, _ = conv_ops.k7_launch(
        n, (cp, h, wd), (oc, cp, kh, kw), stride, padding, relu, pool,
        pool_relu, lrn_t)
    st, groups = stages[0], int(geo[-2])
    conv = np.full((n, oc, st.OH, st.OW), np.nan, dtype=np.float32)
    for frame in range(n):
        for t in range(int(geo[10])):
            (a, bb), = conv_ops.band_rows(stages, pool, 1, t)
            npx = (bb - a) * st.OW
            n_ot = -(-oc // c["ST_TO"])
            tiles = -(-npx // c["ST_TP"]) * n_ot
            band = np.full((oc, npx), np.nan, dtype=np.float32)
            for gi in range(groups):
                for tile in range(gi, tiles, groups):
                    p0 = tile // n_ot * c["ST_TP"]
                    o0 = tile % n_ot * c["ST_TO"]
                    acc = _k7_tile(xh[frame], wk, st, a, npx, p0, o0)
                    q, o = p0 + np.arange(c["ST_TP"]), o0 + np.arange(
                        c["ST_TO"])
                    kq, ko = q < npx, o < oc
                    y = acc[kq][:, ko] + b[o[ko]][None]
                    band[np.ix_(o[ko], q[kq])] = (
                        np.maximum(y, 0) if relu else y).T
            band = band.reshape(oc, bb - a, st.OW)
            seen = conv[frame, :, a:bb]
            done = ~np.isnan(seen)
            assert np.array_equal(seen[done], band[done])
            conv[frame, :, a:bb] = band
    ours = conv_ops.pool_lrn_tail(
        torch.from_numpy(np.nan_to_num(conv)), pk, ps, kind, pool_relu,
        **lrn)
    _close(ours, theirs)


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


@pytest.mark.parametrize("group", range(len(K7_GROUPS)))
@pytest.mark.parametrize("n", [1, 16])
def test_k7_band_fits_shared_memory(group, n):
    """K7's fused kernel gives a block one pooled row of one frame at full
    channel width: the conv rows that row reads (and, with LRN, the pooled
    row), then one tile ring for each of its groups (one a band tile, at
    most K7_MAX_GROUPS, as many as fit), must fit the 227 KB of shared
    memory a block may have; the groups' tiles cover the band once."""
    c = _simt_constants()
    (_, (ch, h, w), (oc, _, kh, kw), stride, padding, pk, ps,
     lrn) = K7_GROUPS[group]
    cp = _round4(ch)
    pool = conv_ops.Pool(*pk, *ps, "max")
    lrn_t = (5, 1e-4, 0.75, 1.0) if lrn else None
    stages, smem, geo, lrn_f = conv_ops.k7_launch(
        n, (cp, h, w), (oc, cp, kh, kw), stride, padding, True, pool, False,
        lrn_t)
    st = stages[0]
    ph = (st.OH - pk[0]) // ps[0] + 1
    pw = (st.OW - pk[1]) // ps[1] + 1
    # the conv rows of one pooled row, and with LRN that pooled row, then
    # the rings
    groups, ring_off = (int(v) for v in geo[-2:])
    ring = 2 * (c["ST_TP"] * c["K7_AROW"] + c["K7_CK"] * c["ST_BROW"])
    assert ring_off == _round4(oc * (pk[0] * st.OW + (pw if lrn else 0)))
    tiles = -(-pk[0] * st.OW // c["ST_TP"]) * -(-oc // c["ST_TO"])
    fits = (c["K7_SMEM_LIMIT"] // 4 - ring_off) // ring
    assert groups == min(c["K7_MAX_GROUPS"], tiles, fits) >= 1
    assert smem == 4 * (ring_off + groups * ring)
    assert smem <= conv_ops.K7_SMEM_LIMIT == 227 * 1024
    # one pooled row a block, n_tiles = pooled rows, the padded channels;
    # a grid of (pooled rows, frames) and at most 1024 threads
    assert geo[9] == 1 and geo[10] == ph and geo[14] == cp
    assert n <= 65535 and groups * c["ST_THREADS"] <= 1024
    for t in range(ph):
        (a, b), = conv_ops.band_rows(stages, pool, 1, t)
        assert (a, b) == (t * ps[0], t * ps[0] + pk[0]) and b <= st.OH
    n_ot = -(-oc // c["ST_TO"])
    owned = [(tile // n_ot * c["ST_TP"], tile % n_ot * c["ST_TO"])
             for gi in range(groups) for tile in range(gi, tiles, groups)]
    assert (_tile_counts(c, pk[0] * st.OW, oc, owned) == 1).all()


def test_k7_alexnet_conv2_band_is_83_kb():
    stages = conv_ops.make_stages((96, 27, 27), [(256, 96, 5, 5)], [(1, 1)],
                                  [(2, 2)], [True])
    pool = conv_ops.Pool(3, 3, 2, 2, "max")
    ring = 4 * conv_ops.K7_RING
    assert conv_ops.k7_ring_off(stages, pool, False) * 4 == 3 * 27 * 256 * 4
    assert conv_ops.k7_smem(stages, pool, False, 2) == 82944 + 2 * ring
    assert conv_ops.k7_smem(stages, pool, True, 2) == (82944 + 256 * 13 * 4
                                                       + 2 * ring)
    # its band has four 128 x 64 tiles on two groups: 152 KB in all
    assert conv_ops.k7_groups(stages, pool, True) == 2
    assert conv_ops.k7_smem(stages, pool, True, 2) == 155648


# -- the method ladder -----------------------------------------------------------


@pytest.mark.parametrize("method", [m.value for m in jm.LADDER])
def test_conv2d_method_ladder_matches_jax(method):
    rng = np.random.default_rng(6)
    x, w, b = _arr(rng, 2, 3, 11, 11), _arr(rng, 10, 3, 3, 3), _arr(rng, 10)
    theirs = _jit(jm.conv2d, method=jm.Method(method), stride=(2, 2),
                  padding=(1, 1), relu=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ours = tm.conv2d(_t(x), _t(w), _t(b), tm.Method(method), (2, 2), (1, 1),
                     True)
    _close(ours, theirs)


@pytest.mark.parametrize("relu", [False, True])
def test_fc_matches_jax(relu):
    rng = np.random.default_rng(7)
    x, w, b = _arr(rng, 3, 50), _arr(rng, 50, 20, scale=0.2), _arr(rng, 20)
    theirs = jm.fc_seq_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           relu)
    _close(tm.fc_fused(_t(x), _t(w), _t(b), relu), theirs)
    _close(tm.fc_seq_ref(_t(x), _t(w), _t(b), relu), theirs)


# -- off the CPU: every path reaches its kernel's wrapper ---------------------
#
# A ``meta`` tensor lies on neither the CPU nor a CUDA device: every path
# reaches the wrapper of its kernel (all of K1-K9 are ported), which
# refuses the device with ValueError.  (The names say "unported" for
# history: these cases raised NotImplementedError before their kernels
# were ported.)


def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("method,kid", [("basic_parallel", "K8"),
                                        ("basic_simd", "K7")])
def test_unported_conv_methods_raise_off_cpu(method, kid):
    # K8 and K7 are ported: the call reaches conv2d_basic_parallel /
    # conv2d_basic_simd, which take no meta tensor
    wrapper = {"K8": "conv2d_basic_parallel", "K7": "conv2d_basic_simd"}[kid]
    with pytest.raises(ValueError, match=f"{wrapper}: unsupported device"):
        tm.conv2d(_meta(1, 3, 8, 8), _meta(4, 3, 3, 3), _meta(4),
                  tm.Method(method))


@pytest.mark.parametrize("method,knob,kid", [
    ("advanced_simd_8", "pool_carry", "K5"),
    ("advanced_simd_8", "lrn_oc_block", "K4"),
    ("basic_simd", None, "K7")])
def test_unported_fused_cells_raise_off_cpu(method, knob, kid):
    # K5 needs overlapping pool windows (3/2) and K4 an LRN tail: with
    # those the knob routes the group to its cell, whose wrapper refuses
    # the meta tensor
    wrapper = {"K5": "conv2d_pool_carry", "K4": "conv2d_pool_lrn_halo",
               "K7": "conv2d_basic_simd"}[kid]
    tail = dict(pool_kernel=(3, 3), pool_stride=(2, 2))
    if kid == "K4":
        tail["lrn_n"] = 5
    with pytest.raises(ValueError, match=f"{wrapper}: unsupported device"):
        tm.conv2d_pool_fused(_meta(1, 3, 8, 8), _meta(12, 3, 3, 3),
                             _meta(12), tm.Method(method), **tail,
                             **({knob: True} if knob else {}))


def test_unported_chain_cell_raises_off_cpu():
    with pytest.raises(ValueError, match="conv2d_chain_ocb: unsupported"):
        tm.conv2d_chain_fused(_meta(1, 3, 8, 8), [_meta(4, 3, 3, 3)] * 2,
                              [_meta(4)] * 2, tm.Method.ADVANCED_SIMD_8,
                              [(1, 1)] * 2, [(1, 1)] * 2, [True] * 2,
                              oc_block_final=2)


def test_chain_cell_with_an_lrn_tail_raises_on_every_device():
    rng = np.random.default_rng(3)
    x, w, b = _arr(rng, 1, 3, 9, 9), _arr(rng, 8, 3, 3, 3), _arr(rng, 8)
    w2 = _arr(rng, 8, 8, 3, 3)
    for dev_x in (_t(x), _meta(1, 3, 9, 9)):
        with pytest.raises(ValueError, match="no LRN epilogue"):
            tm.conv2d_chain_fused(
                dev_x, [_t(w), _t(w2)], [_t(b), _t(b)],
                tm.Method.ADVANCED_SIMD_8, [(1, 1)] * 2, [(1, 1)] * 2,
                [True] * 2, pool_kernel=(3, 3), pool_stride=(2, 2), lrn_n=5,
                oc_block_final=4)


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="device"):
        matmul_fused(_meta(2, 4), _meta(4, 3))
    with pytest.raises(ValueError, match="device"):
        conv_ops.conv2d_pool_fused(_meta(1, 3, 8, 8), _meta(4, 3, 3, 3),
                                   _meta(4))
    for fn in (conv_ops.conv2d_basic_simd, conv_ops.conv2d_basic_parallel):
        with pytest.raises(ValueError, match="device"):
            fn(_meta(1, 3, 8, 8), _meta(4, 3, 3, 3), _meta(4))
    with pytest.raises(ValueError, match="device"):
        pool2d(_meta(1, 3, 8, 8))
    for fn, lrn in ((conv_ops.conv2d_pool_lrn_halo, dict(lrn_n=5)),
                    (conv_ops.conv2d_pool_carry, {})):
        with pytest.raises(ValueError, match="device"):
            fn(_meta(1, 3, 8, 8), _meta(4, 3, 3, 3), _meta(4),
               pool_kernel=(3, 3), pool_stride=(2, 2), **lrn)
        with pytest.raises(ValueError, match="needs a pool"):
            fn(_t(np.zeros((1, 3, 8, 8), np.float32)),
               _t(np.zeros((4, 3, 3, 3), np.float32)),
               _t(np.zeros(4, np.float32)), **lrn)
    with pytest.raises(ValueError, match="device"):
        conv_ops.conv2d_chain_ocb(_meta(1, 3, 8, 8), [_meta(4, 3, 3, 3)],
                                  [_meta(4)], [(1, 1)], [(1, 1)], [True])


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


@pytest.mark.parametrize("kid,case", [("K4", c) for c in K4_CASES]
                         + [("K5", c) for c in K5_CASES])
def test_fused_cell_knobs_match_jax(kid, case):
    (xs, ws, stride, padding, relu, pk, ps, kind, pool_relu,
     lrn_n) = CELL_CASES[case]
    rng = np.random.default_rng(20 + len(case))
    x, w, b = _arr(rng, *xs), _arr(rng, *ws, scale=0.3), _arr(rng, ws[0])
    tail = dict(pool_kernel=pk, pool_stride=ps, pool_kind=kind,
                pool_relu=pool_relu)
    lrn = dict(lrn_n=lrn_n, lrn_alpha=1e-3, lrn_beta=0.75, lrn_k=1.0)
    knob = {"K4": {"lrn_oc_block": True}, "K5": {"pool_carry": True}}[kid]
    assert tm.fused_cell(tm.Method.ADVANCED_SIMD_8, xs[1:], ws, stride,
                         padding, pk, ps, lrn_n, **knob) == kid
    theirs = _jit(jm.conv2d_pool_fused, method=jm.Method.ADVANCED_SIMD_8,
                  stride=stride, padding=padding, relu=relu, **tail, **lrn,
                  **knob)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ours = tm.conv2d_pool_fused(_t(x), _t(w), _t(b),
                                tm.Method.ADVANCED_SIMD_8, stride, padding,
                                relu, **tail, **lrn, **knob)
    _close(ours, theirs)
    if kid == "K4":
        direct = conv_ops.conv2d_pool_lrn_halo(_t(x), _t(w), _t(b), stride,
                                               padding, relu, **tail, **lrn)
    else:
        direct = conv_ops.conv2d_pool_carry(_t(x), _t(w), _t(b), stride,
                                            padding, relu, **tail)
    _close(direct, theirs)


@pytest.mark.parametrize("case", ["two_stage_no_pool", "three_stage_pool",
                                  "pad2_avg"])
@pytest.mark.parametrize("obf", [1, 4])
def test_chain_cell_knob_matches_jax(case, obf):
    xs, stages, pool, _ = K2_CASES[case]
    rng = np.random.default_rng(30 + len(case) + obf)
    x, c = _arr(rng, *xs), xs[1]
    ws, bs = [], []
    for oc, k, _, _, _ in stages:
        ws.append(_arr(rng, oc, c, k, k, scale=(c * k * k) ** -0.5))
        bs.append(_arr(rng, oc, scale=0.1))
        c = oc
    strides = tuple((s, s) for _, _, s, _, _ in stages)
    pads = tuple((p, p) for _, _, _, p, _ in stages)
    relus = tuple(r for *_, r in stages)
    tail = dict(pool_kernel=pool[0] if pool else None,
                pool_stride=pool[1] if pool else None,
                pool_kind=pool[2] if pool else "max")
    assert tm.chain_cell(ws[-1].shape[0], obf, None) == ("K6", obf)
    theirs = _jit(jm.conv2d_chain_fused, method=jm.Method.ADVANCED_SIMD_8,
                  strides=strides, paddings=pads, relus=relus, **tail,
                  oc_block_final=obf)(
        jnp.asarray(x), [jnp.asarray(w) for w in ws],
        [jnp.asarray(b) for b in bs])
    ours = tm.conv2d_chain_fused(_t(x), [_t(w) for w in ws],
                                 [_t(b) for b in bs],
                                 tm.Method.ADVANCED_SIMD_8, strides, pads,
                                 relus, **tail, oc_block_final=obf)
    _close(ours, theirs)
    _close(conv_ops.conv2d_chain_ocb(_t(x), [_t(w) for w in ws],
                                     [_t(b) for b in bs], strides, pads,
                                     relus, **tail, oc_block_final=obf),
           theirs)


def test_chain_cell_keeps_k2_at_full_width():
    assert tm.chain_cell(256, None, None) == ("K2", None)
    assert tm.chain_cell(256, 256, None) == ("K2", None)
    assert tm.chain_cell(256, 512, None) == ("K2", None)
    assert tm.chain_cell(256, 8, None) == ("K6", 8)


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


@pytest.mark.parametrize("net,unfuse,args", GROUPS,
                         ids=[f"{n}-{'unfused' if u else 'fused'}-{a[0]}"
                              for n, u, a in GROUPS])
@pytest.mark.parametrize("method", ["advanced_simd_4", "advanced_simd_8"])
def test_resolvers_agree_with_jax(net, unfuse, args, method):
    """Halo width: the JAX rule itself (its auto rule keeps full width on
    every group, as the port's None does).  Pool carry: the same rule on
    the same band; the port reads it on its own band (``k5_bands``), and
    where that differs from the TPU's band the JAX package, run on its own
    band, may only say no because the TPU keeps the frame in one band."""
    from repro.core.fusion import group_band_params
    from repro.core.methods import Method as JM
    from repro.core.netdefs import NETWORKS as JN
    from repro.core.plan import compile_plan as jcompile
    from repro.kernels.conv2d import kernels as jk
    from repro.kernels.conv2d.ops import SUBLANES

    name, in_chw, w_shape, stride, padding, pool4, lrn = args
    c, h, w = in_chw
    oc, _, kh, kw = w_shape
    ow = (w + 2 * padding[1] - kw) // stride[1] + 1
    cp = -(-c // SUBLANES) * SUBLANES
    block = conv_ops.ADVANCED_OC_BLOCK[method]
    for knob in (None, True, False):
        theirs = jk.resolve_lrn_ocb(oc, block, lrn, knob, ow,
                                    w + 2 * padding[1], cp, kh, kw,
                                    stride[0], pool4)
        assert conv_ops.resolve_lrn_ocb(oc, block, lrn, knob) == theirs
    halo = conv_ops.resolve_lrn_ocb(oc, block, lrn, True)[1]
    assert halo == (lrn[0] - 1 if lrn is not None and block < oc else 0)
    stages = conv_ops.make_stages(in_chw, [w_shape], [stride], [padding],
                                  [True])
    phb, n_bands = conv_ops.k5_bands(stages, conv_ops.Pool(*pool4, "max"))
    for knob in (True, False):
        assert (conv_ops.resolve_pool_carry(knob, lrn, pool4, phb, n_bands)
                == jk.resolve_pool_carry(knob, True, lrn, pool4, phb,
                                         n_bands))
    assert not conv_ops.resolve_pool_carry(None, lrn, pool4, phb, n_bands)
    # against the JAX package on its own (TPU) band
    jnet = JN[net]()
    off = {l.name: False for l in jnet.layers if l.kind == "lrn"}
    jplan = jcompile(jnet, method=JM(method), verify=False,
                     per_layer_fuse=off if unfuse else None)
    step = next(s for s in jplan.steps if s.kind == "fused"
                and s.group.name == name)
    tpu = group_band_params(step.group, step.method, step.in_shape, None,
                            pool_carry=True)
    ours = conv_ops.resolve_pool_carry(True, lrn, pool4, phb, n_bands)
    if bool(tpu["carry"]) != ours:
        assert ours and tpu["n_tiles"] == 1 and n_bands > 1


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


def test_chain_constants_match_the_wrapper():
    """The wrapper's copies of the stage-major kernels' constants, its plan
    array's layout, its shared memory and the entry points' argument
    lists agree with the sources."""
    c = _chain_constants()
    assert (c["CH_THREADS"], c["CH_MIN_BLOCKS"], c["CH_CK"], c["CH_AROW"],
            c["CH_CHUNK_SLOTS"]) == (
        conv_ops.CH_THREADS, conv_ops.CH_MIN_BLOCKS, conv_ops.CH_CK,
        conv_ops.CH_AROW, conv_ops.CH_CHUNK_SLOTS)
    slot = conv_ops.ST_TP * c["CH_AROW"] + c["CH_CK"] * conv_ops.ST_BROW
    assert conv_ops.CH_RING == 2 * slot
    assert conv_ops.CH_SMEM == 4 * (2 * slot + conv_ops.ST_TP
                                    * conv_ops.ST_TO + 3 * conv_ops.ST_TP)
    plan = conv_ops.chain_plan(ALEX_CHAIN, POOL32, 2, 132)
    arr = conv_ops.pack_chain_plan(plan)
    assert len(arr) == c["CH_PLAN_HEAD"] + 3 * c["CH_PLAN_STAGE"]
    for entry in ("conv_chain_f32", "conv_pool_lrn_f32",
                  "conv_pool_carry_f32", "conv_pool_lrn_halo_f32"):
        assert _build.SIGNATURES[entry] == [_build._P] * 9
    assert _build.SIGNATURES["conv_chain_ocb_f32"] == [_build._P] * 10
    assert _build.SIGNATURES["stage_major_blocks_per_sm"] == []
    # one stage-major __global__, which every stage-major entry launches
    text = (_build.CSRC / "conv_chain.cu").read_text()
    assert '#include "conv_stage_major.cuh"' in text
    assert text.count("__global__ void") == 1
    assert re.search(r"__launch_bounds__\(CH_THREADS, CH_MIN_BLOCKS\)\s*"
                     r"stage_major_kernel\(", text)
    assert text.count("stage_major(g, p, x, out, scratch);") == 1
    for entry in ("conv_chain_f32", "conv_chain_ocb_f32", "conv_pool_lrn_f32",
                  "conv_pool_carry_f32", "conv_pool_lrn_halo_f32"):
        body = text[text.index(f'extern "C" int {entry}('):]
        body = body[:body.index("\n}\n")]
        assert body.count("cnnk::launch_stage_major(") == 1
    others = [p for p in _build.CSRC.glob("*.cu") if p.name != "conv_chain.cu"]
    assert not [p.name for p in others
                if "conv_stage_major.cuh" in p.read_text()]
    # the band body (the old K1's and K4's) and K5's carry loop are gone:
    # K4's entry wraps the stage-major launch once, like K1's and K5's
    assert not (_build.CSRC / "conv_pool_carry.cu").exists()
    assert not (_build.CSRC / "conv_pool_lrn.cu").exists()
    assert not [p.name for p in _build.CSRC.glob("*.cu*")
                if "conv_band(" in p.read_text()]


@pytest.mark.parametrize("chain", sorted(SCHEDULES))
@pytest.mark.parametrize("n", [1, 2, 5, 16])
def test_chain_items_cover_every_output_once(chain, n):
    """Each stage's items write every (partial, pixel tile, channel tile)
    once (a whole item: every output), and through their chunks each
    (chunk, pixel tile, channel tile) of the stage's GEMM once, the chunks
    covering every float of every tap's run; the scratch regions do not
    overlap."""
    stages, pool = SCHEDULES[chain]
    plan = conv_ops.chain_plan(stages, pool, n, REPORT_SMS)
    regions = [(0, n * stages[0].H * stages[0].W * _round4(stages[0].C))]
    tp, to = conv_ops.ST_TP, conv_ops.ST_TO
    for st, sp in zip(stages, plan.stages):
        assert (sp.tw, sp.tpr) == conv_ops.tap_walk(st)
        chunks = st.KH * sp.tpr * sp.split
        assert sp.m == n * st.OH * st.OW and sp.ocp == _round4(st.OC)
        assert sp.unit in _units(st, sp.split, sp.tpr)
        assert sp.whole == (sp.unit == chunks)
        assert sp.n_partials * sp.unit == chunks
        # a tap's chunks: runs of chunk_slots x CH_CK floats over its run
        width = sp.chunk_slots * conv_ops.CH_CK
        assert sp.chunk_slots <= conv_ops.CH_CHUNK_SLOTS
        assert (sp.split - 1) * width < sp.tw <= sp.split * width
        assert (sp.tiles_m - 1) * tp < sp.m <= sp.tiles_m * tp
        n_ot = math.ceil(sp.ocp / to)
        part = np.zeros((sp.n_partials, sp.tiles_m, n_ot), dtype=np.int64)
        cov = np.zeros((chunks, sp.tiles_m, n_ot), dtype=np.int64)
        for px, ch, cr, q in _chain_items(st, sp):
            mt, o0, o1 = px.start // tp, ch.start // to, math.ceil(ch.stop
                                                                  / to)
            assert px == range(mt * tp, min((mt + 1) * tp, sp.m))
            assert len(ch) and ch == range(o0 * to, min(o1 * to, sp.ocp))
            assert list(cr) == list(range(q * sp.unit, (q + 1) * sp.unit))
            part[q, mt, o0:o1] += 1
            cov[cr.start:cr.stop, mt, o0:o1] += 1
        assert (part == 1).all() and (cov == 1).all()
        run = conv_ops.whole_run(sp.split, sp.tpr, st.KH)
        assert sp.part == ((sp.m * sp.ocp if chunks > run else 0) if sp.whole
                           else sp.n_partials * sp.m * sp.ocp)
        if sp.act_off >= 0:
            regions.append((sp.act_off, sp.act_off + sp.m * sp.ocp))
        assert sp.part <= plan.scratch - plan.part_off
    regions.append((plan.part_off, plan.scratch))
    regions.sort()
    assert all(a[1] <= b[0] for a, b in zip(regions, regions[1:]))
    assert all(off % 4 == 0 for off, _ in regions)
    assert (plan.stages[-1].act_off < 0) == (pool is None)
    assert plan.barriers == (sum(1 if sp.whole else 2 for sp in plan.stages)
                             + (pool is not None))


@pytest.mark.parametrize("chain", sorted(SCHEDULES))
def test_chain_sum_order_is_the_same_for_every_batch(chain):
    """The unit follows the batch; each output's sum does not: items of
    one chunk, one tap, a kernel row or the whole reduction add the chunks
    in one tree (chunks into taps, taps into rows, rows, each left to
    right), and the chunks (runs of a tap's floats) are fixed by the
    shape."""
    stages, pool = SCHEDULES[chain]
    plans = {n: conv_ops.chain_plan(stages, pool, n, REPORT_SMS)
             for n in (1, 2, 5, 16)}
    plus = lambda a, b: ("+", a, b)  # noqa: E731
    for s, st in enumerate(stages):
        tw, tpr = conv_ops.tap_walk(st)
        split = plans[1].stages[s].split
        assert split == conv_ops.tap_split(tw)
        assert {(p.stages[s].split, p.stages[s].tpr)
                for p in plans.values()} == {(split, tpr)}
        want = _fold([_fold([_fold([(i * tpr + j) * split + k
                                    for k in range(split)], plus)
                             for j in range(tpr)], plus)
                      for i in range(st.KH)], plus)
        for unit in _units(st, split, tpr):
            assert _sum_order(st, split, tpr, unit) == want
        assert {_sum_order(st, split, tpr, p.stages[s].unit)
                for p in plans.values()} == {want}
    if chain == "alexnet":  # batch 1 takes a chunk an item, 16 a row
        assert [sp.split for sp in plans[1].stages] == [2, 3, 3]
        assert [sp.unit for sp in plans[1].stages] == [1, 1, 1]
        assert plans[16].stages[0].unit == 6
        assert plans[16].stages[1].unit == 9
    if chain in ("alexnet_conv1_group", "alexnet_conv2_group"):
        # batch 16: the pixel x channel tiles fill the grid, so an item
        # takes the whole reduction; batch 1: a chunk an item
        assert plans[16].stages[0].whole and plans[1].stages[0].unit == 1


@pytest.mark.parametrize("chain", sorted(SCHEDULES))
@pytest.mark.parametrize("n", [1, 16])
def test_chain_grid_fits_the_card(chain, n):
    """The cooperative grid fits the blocks an SM holds by the kernel's
    shared memory (228 KB an SM, 1 KB of it reserved a block) and threads
    (2048 an SM) on 132 SMs (its launch bounds promise the registers), 3
    an SM; at batch 16 AlexNet's chain gives every block an item in conv3
    and conv4, its K1 groups give 368 and 758 whole items, and the
    scratch stays in the 50 MB L2."""
    stages, pool = SCHEDULES[chain]
    plan = conv_ops.chain_plan(stages, pool, n, REPORT_SMS)
    per_sm = min(233472 // (conv_ops.CH_SMEM + 1024),
                 2048 // conv_ops.CH_THREADS)
    assert per_sm == conv_ops.CH_MIN_BLOCKS == 3
    assert plan.grid == per_sm * REPORT_SMS == 396
    assert conv_ops.CH_SMEM <= 227 * 1024
    if chain.startswith("alexnet"):
        assert 4 * plan.scratch < 50e6
    if chain == "alexnet" and n == 16:
        assert plan.grid >= 128
        assert [sp.items for sp in plan.stages][:2] == [396, 396]
        assert plan.tail_items == 16 * 6 * 6
    if n == 16 and chain == "alexnet_conv2_group":
        assert plan.stages[0].items == 368 and plan.barriers == 2
        assert plan.tail_items == 16 * 13 * 13
    if n == 16 and chain == "alexnet_conv1_group":
        # one fold holds the whole sum of a row-walked stage: no partials
        assert plan.stages[0].items == 758 and plan.stages[0].part == 0


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


@pytest.mark.parametrize("conv", sorted(NARROW))
def test_kernel_row_walk_covers_each_real_row_once(conv):
    """A stage with Cp < CH_CK walks a kernel row a tap: each real (i, j,
    c) is read once, at its HWIO weight row, the rest of a row's slots are
    padding past the run, and the walk takes fewer reduction rows than a
    tap a slot would."""
    st = _stages(*NARROW[conv])[0]
    sp = conv_ops.chain_plan([st], None, 1, REPORT_SMS).stages[0]
    cp = _round4(st.C)
    assert cp < conv_ops.CH_CK and (sp.tw, sp.tpr) == (st.KW * cp, 1)
    seen = {}
    for g, i, j, c, w_row in _walk_rows(st, sp):
        assert 0 <= i < st.KH and 0 <= j < st.KW and 0 <= c < cp
        assert w_row == (i * st.KW + j) * cp + c
        assert g // sp.split == i
        seen[(i, j, c)] = seen.get((i, j, c), 0) + 1
    assert seen == {(i, j, c): 1 for i in range(st.KH) for j in range(st.KW)
                    for c in range(cp)}
    rows = st.KH * sp.split * sp.chunk_slots * conv_ops.CH_CK
    assert rows < st.KH * st.KW * conv_ops.CH_CK
    if conv == "alexnet_conv1":  # 3 slots a row: 528 rows for 363
        assert (sp.split, sp.chunk_slots, rows) == (1, 3, 528)
    if conv == "cp12_2x11":
        assert sp.split == 2


@pytest.mark.parametrize("conv", sorted(NARROW))
def test_kernel_row_walk_gives_every_unit_the_same_bits(conv):
    """The emulated schedule of a row-walked stage gives the same bits with
    every unit (one chunk, a tap = a kernel row, the whole reduction), and
    its result is the plain conv's within 1e-4."""
    in_chw, w_shape, stride, padding = NARROW[conv]
    rng = np.random.default_rng(len(conv))
    if conv == "alexnet_conv1":  # the full frame is slow to emulate
        in_chw = (3, 51, 51)
    x = _t(_arr(rng, 2, *in_chw))
    w = _t(_arr(rng, *w_shape, scale=(np.prod(w_shape[1:])) ** -0.5))
    b = _t(_arr(rng, w_shape[0], scale=0.1))
    args = ([stride], [padding], [True])
    st = conv_ops.make_stages(in_chw, [w], *args)[0]
    tw, tpr = conv_ops.tap_walk(st)
    units = _units(st, conv_ops.tap_split(tw), tpr)
    assert len(units) >= 2
    outs = [_emulate_chain(x, [w], [b], *args, None, None, unit=u)
            for u in units]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    ref = conv_ops.conv2d_pool_fused_ref(x, w, b, stride, padding, True)
    _close(outs[0], ref.numpy())


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


@pytest.mark.parametrize("case", sorted(K2_CASES))
@pytest.mark.parametrize("n", [1, 3])
def test_chain_schedule_matches_the_plain_chain_and_jax(case, n):
    """The emulated schedule (items, chunks, partials, the fixed folds,
    padding between stages) equals ``conv2d_chain_ref`` and the JAX
    package's jnp chain (``conv2d_chain_fused``, never Pallas) on the
    same numpy inputs within 1e-4, with an LRN tail and without; at
    n = 3 pixel tiles cross frame boundaries."""
    x, ws, bs, (strides, pads, relus), pool, lrn_n = _k2_inputs(case, n)
    tail = dict(pool_kernel=pool[0] if pool else None,
                pool_stride=pool[1] if pool else None,
                pool_kind=pool[2] if pool else "max", lrn_n=lrn_n,
                lrn_alpha=1e-2, lrn_beta=0.75, lrn_k=1.0)
    tpool = (conv_ops.Pool(*pool[0], *pool[1], pool[2]) if pool else None)
    lrn = (lrn_n, 1e-2, 0.75, 1.0) if lrn_n else None
    tw, tb = [_t(w) for w in ws], [_t(b) for b in bs]
    ours = _emulate_chain(_t(x), tw, tb, strides, pads, relus, tpool, lrn)
    ref = conv_ops.conv2d_chain_ref(_t(x), tw, tb, strides, pads, relus,
                                    **tail)
    _close(ours, ref.numpy())
    theirs = _jit(jm.conv2d_chain_fused, method=jm.Method.ADVANCED_SIMD_8,
                  strides=tuple(strides), paddings=tuple(pads),
                  relus=tuple(relus), **tail)(
        jnp.asarray(x), [jnp.asarray(w) for w in ws],
        [jnp.asarray(b) for b in bs])
    _close(ours, theirs)


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


@pytest.mark.parametrize("case", sorted(K1_CASES))
@pytest.mark.parametrize("n", [1, 3])
def test_one_stage_schedule_matches_k1_plain_and_jax(case, n):
    """K1's launch is the one-stage schedule: emulated item by item (the
    kernel-row walk where Cp < 16) with the plan's unit and with the whole
    reduction, it gives the same bits both ways and equals
    ``conv2d_pool_fused_ref`` and the JAX package's jnp
    ``conv2d_pool_fused`` on the same numpy inputs within 1e-4."""
    x, w, b, stride, padding, relu, tail, pool, lrn = _k1_inputs(case, n)
    args = ([stride], [padding], [relu])
    emu = partial(_emulate_chain, _t(x), [_t(w)], [_t(b)], *args, pool, lrn,
                  pool_relu=tail["pool_relu"])
    ours = emu()
    st = conv_ops.make_stages(x.shape[1:], [w.shape], *args)[0]
    tw, tpr = conv_ops.tap_walk(st)
    whole = _units(st, conv_ops.tap_split(tw), tpr)[-1]
    assert whole == st.KH * tpr * conv_ops.tap_split(tw)
    assert torch.equal(ours, emu(unit=whole))
    ref = conv_ops.conv2d_pool_fused_ref(_t(x), _t(w), _t(b), stride,
                                         padding, relu, **tail)
    _close(ours, ref.numpy())
    theirs = _jit(jm.conv2d_pool_fused, method=jm.Method.ADVANCED_SIMD_8,
                  stride=stride, padding=padding, relu=relu, **tail)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(ours, theirs)


#: AlexNet's lrn layers (netdefs defaults): n, alpha, beta, k
ALEX_LRN = (5, 1e-4, 0.75, 1.0)


@pytest.mark.parametrize("conv", ["conv1_group", "conv2_group", "conv1",
                                  "conv2", "conv3", "conv4", "conv5"])
def test_one_stage_schedule_at_alexnet_matches_the_plain_version(conv):
    """K1 at AlexNet's widths, batch 1: the conv1+pool1+norm1 and
    conv2+pool2+norm2 groups and the per-layer convs 1-5, emulated item by
    item with the plan's unit (one chunk) and with the largest unit the
    stage allows (the whole reduction for conv1 and conv2), give the same
    bits both ways and equal ``conv2d_pool_fused_ref`` and the JAX
    package's jnp ``conv2d_pool_fused`` within 1e-4 · max(1, max|plain|)."""
    name = conv.split("_")[0]
    in_chw, w_shape, stride, padding = ALEX_CONVS[name]
    rng = np.random.default_rng(len(conv))
    x = _arr(rng, 1, *in_chw)
    w = _arr(rng, *w_shape, scale=(2.0 / np.prod(w_shape[1:])) ** 0.5)
    b = _arr(rng, w_shape[0], scale=0.05)
    group = conv.endswith("_group")
    pool, lrn = (POOL32, ALEX_LRN) if group else (None, None)
    args = ([stride], [padding], [True])
    emu = partial(_emulate_chain, _t(x), [_t(w)], [_t(b)], *args, pool, lrn)
    ours = emu()
    st = _stages(*ALEX_CONVS[name])[0]
    tw, tpr = conv_ops.tap_walk(st)
    units = _units(st, conv_ops.tap_split(tw), tpr)
    assert torch.equal(ours, emu(unit=units[-1]))
    tail = {} if not group else dict(
        pool_kernel=(3, 3), pool_stride=(2, 2), lrn_n=ALEX_LRN[0],
        lrn_alpha=ALEX_LRN[1], lrn_beta=ALEX_LRN[2], lrn_k=ALEX_LRN[3])
    ref = conv_ops.conv2d_pool_fused_ref(_t(x), _t(w), _t(b), stride,
                                         padding, True, **tail)
    tol = TOL * max(1.0, ref.abs().max().item())
    _close(ours, ref.numpy(), tol)
    if group:
        theirs = _jit(jm.conv2d_pool_fused, method=jm.Method.ADVANCED_SIMD_8,
                      stride=stride, padding=padding, relu=True, **tail)(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    else:
        theirs = _jit(jax_conv2d_ref, stride=stride, padding=padding,
                      relu=True)(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b))
    _close(ours, theirs, tol)


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


@pytest.mark.parametrize("group", sorted(K5_GROUPS))
def test_k5_and_k1_agree_bit_for_bit_in_emulation(group, monkeypatch):
    """On a group without LRN, the K5 wrapper hands the stage-major launch
    what the K1 wrapper hands it (the same tensors, stage, pool and plan;
    only the C entry differs), and the groups resolve to K5 under the
    pool-carry knob: the emulated schedule at batch 2 gives K5 and K1 the
    same bits, frame 0 the bits of frame 0 alone, and equals the plain
    version and the JAX package's jnp path within 1e-4."""
    in_chw, w_shape, stride, padding = K5_GROUPS[group]
    calls = []
    monkeypatch.setattr(conv_ops, "check_cuda_f32", lambda *a: None)
    monkeypatch.setattr(conv_ops, "_launch_stage_major",
                        lambda wrapper, entry, *a: calls.append(
                            (wrapper, entry, a)))
    rng = np.random.default_rng(len(group))
    x = _arr(rng, 2, *in_chw)
    w = _arr(rng, *w_shape, scale=(2.0 / np.prod(w_shape[1:])) ** 0.5)
    b = _arr(rng, w_shape[0], scale=0.05)
    tail = dict(pool_kernel=(3, 3), pool_stride=(2, 2))
    xc, tw_, tb = _OnCard(_t(x)), _t(w), _t(b)
    conv_ops.conv2d_pool_fused(xc, tw_, tb, stride, padding, True, **tail)
    conv_ops.conv2d_pool_carry(xc, tw_, tb, stride, padding, True, **tail)
    (w1, e1, a1), (w5, e5, a5) = calls
    assert (w1, e1) == (conv_ops.conv2d_pool_fused, "conv_pool_lrn_f32")
    assert (w5, e5) == (conv_ops.conv2d_pool_carry, "conv_pool_carry_f32")
    assert a1[0] is a5[0] is xc and a1[1][0] is a5[1][0] is tw_
    assert a1[2][0] is a5[2][0] is tb and a1[3:] == a5[3:]
    _, _, _, strides, pads, relus, pool, pool_relu, lrn = a1
    assert lrn is None and pool == POOL32 and not pool_relu
    assert tm.fused_cell(tm.Method.ADVANCED_SIMD_8, in_chw, w_shape, stride,
                         padding, (3, 3), (2, 2), None, pool_carry=True) == "K5"
    assert tm.fused_cell(tm.Method.ADVANCED_SIMD_8, in_chw, w_shape, stride,
                         padding, (3, 3), (2, 2), None) == "K1"
    emu = partial(_emulate_chain, ws=[tw_], bs=[tb], strides=strides,
                  pads=pads, relus=relus, pool=pool, lrn=lrn)
    k1, k5 = emu(_t(x)), emu(_t(x))
    assert torch.equal(k1, k5)
    assert torch.equal(emu(_t(x[:1]))[0], k1[0])
    ref = conv_ops.conv2d_pool_fused_ref(_t(x), tw_, tb, stride, padding,
                                         True, **tail)
    tol = TOL * max(1.0, ref.abs().max().item())
    _close(k1, ref.numpy(), tol)
    theirs = _jit(jm.conv2d_pool_fused, method=jm.Method.ADVANCED_SIMD_8,
                  stride=stride, padding=padding, relu=True, **tail,
                  pool_carry=True)(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b))
    _close(k1, theirs, tol)


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


@pytest.mark.parametrize("group", sorted(ALEX_GROUPS))
@pytest.mark.parametrize("n", [1, 16])
def test_k4_plan_is_k1s_at_alexnet(group, n, monkeypatch):
    """K4 at AlexNet's two LRN groups, full width, batch 1 and 16: the
    groups resolve to K4 under the LRN-blocking knob (to K1 without it),
    the K4 wrapper hands the stage-major launch what the K1 wrapper hands
    it (the same tensors, stage, pool and LRN; only the C entry differs),
    so ``chain_launch`` gives both one plan: K1's one-stage plan, whose
    tail holds every channel of a pixel (no halo), with the geometry the
    C entry checks (one stage, a pool, an LRN)."""
    in_chw, w_shape, stride, padding = ALEX_GROUPS[group]
    assert tm.fused_cell(tm.Method.ADVANCED_SIMD_8, in_chw, w_shape, stride,
                         padding, (3, 3), (2, 2), ALEX_LRN[0],
                         lrn_oc_block=True) == "K4"
    assert tm.fused_cell(tm.Method.ADVANCED_SIMD_8, in_chw, w_shape, stride,
                         padding, (3, 3), (2, 2), ALEX_LRN[0]) == "K1"
    calls = _record_stage_major(monkeypatch)
    x = _OnCard(torch.zeros(1).expand(n, *in_chw))
    w, b = torch.zeros(w_shape), torch.zeros(w_shape[0])
    conv_ops.conv2d_pool_fused(x, w, b, stride, padding, True,
                               **ALEX_LRN_TAIL)
    conv_ops.conv2d_pool_lrn_halo(x, w, b, stride, padding, True,
                                  **ALEX_LRN_TAIL)
    (w1, e1, a1), (w4, e4, a4) = calls
    assert (w1, e1) == (conv_ops.conv2d_pool_fused, "conv_pool_lrn_f32")
    assert (w4, e4) == (conv_ops.conv2d_pool_lrn_halo,
                        "conv_pool_lrn_halo_f32")
    assert a1[0] is a4[0] is x and a1[1][0] is a4[1][0] is w
    assert a1[2][0] is a4[2][0] is b and a1[3:] == a4[3:]
    _, _, _, strides, pads, relus, pool, pool_relu, lrn = a4
    assert pool == POOL32 and lrn == ALEX_LRN and not pool_relu
    stages, plan, arrays, _ = conv_ops.chain_launch(
        n, in_chw, (w_shape,), tuple(map(tuple, strides)),
        tuple(map(tuple, pads)), tuple(relus), pool, pool_relu, lrn,
        REPORT_SMS)
    assert plan == conv_ops.chain_plan(stages, pool, n, REPORT_SMS)
    assert len(plan.stages) == 1 and plan.stages[0].ot_item == 1
    geo = arrays[0]
    assert (geo[1], geo[2], geo[8]) == (1, 1, ALEX_LRN[0])
    _, out_h, out_w = conv_ops.final_rows(stages, pool)
    assert plan.tail_items == n * out_h * out_w
    assert stages[0].OC <= conv_ops.CH_SMEM // 4


#: LRN groups K4 takes: AlexNet's conv1+pool1+norm1 and conv2+pool2+norm2,
#: frames cut to keep the emulation short
K4_GROUPS = {
    "alexnet_conv1": ((3, 63, 63), (96, 3, 11, 11), (4, 4), (0, 0)),
    "alexnet_conv2": ((96, 13, 13), (256, 96, 5, 5), (1, 1), (2, 2)),
}


@pytest.mark.parametrize("group", sorted(K4_GROUPS))
def test_k4_and_k1_agree_bit_for_bit_in_emulation(group, monkeypatch):
    """On an LRN group, K4 hands the stage-major launch K1's arguments
    (so the two give the same bits), and the emulated schedule of those
    arguments at batch 2 gives frame 0 the bits of frame 0 alone and
    equals the plain version and the JAX package's jnp path under the
    LRN-blocking knob within 1e-4 · max(1, max|plain|)."""
    in_chw, w_shape, stride, padding = K4_GROUPS[group]
    calls = _record_stage_major(monkeypatch)
    rng = np.random.default_rng(len(group) + 4)
    x = _arr(rng, 2, *in_chw)
    w = _arr(rng, *w_shape, scale=(2.0 / np.prod(w_shape[1:])) ** 0.5)
    b = _arr(rng, w_shape[0], scale=0.05)
    xc, tw_, tb = _OnCard(_t(x)), _t(w), _t(b)
    conv_ops.conv2d_pool_fused(xc, tw_, tb, stride, padding, True,
                               **ALEX_LRN_TAIL)
    conv_ops.conv2d_pool_lrn_halo(xc, tw_, tb, stride, padding, True,
                                  **ALEX_LRN_TAIL)
    (_, _, a1), (_, _, a4) = calls
    assert a1[3:] == a4[3:]
    _, _, _, strides, pads, relus, pool, pool_relu, lrn = a4
    emu = partial(_emulate_chain, ws=[tw_], bs=[tb], strides=strides,
                  pads=pads, relus=relus, pool=pool, lrn=lrn,
                  pool_relu=pool_relu)
    k4 = emu(_t(x))
    assert torch.equal(emu(_t(x[:1]))[0], k4[0])
    ref = conv_ops.conv2d_pool_fused_ref(_t(x), tw_, tb, stride, padding,
                                         True, **ALEX_LRN_TAIL)
    tol = TOL * max(1.0, ref.abs().max().item())
    _close(k4, ref.numpy(), tol)
    theirs = _jit(jm.conv2d_pool_fused, method=jm.Method.ADVANCED_SIMD_8,
                  stride=stride, padding=padding, relu=True, **ALEX_LRN_TAIL,
                  lrn_oc_block=True)(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b))
    _close(k4, theirs, tol)


@pytest.mark.parametrize("case", K4_CASES)
def test_k4_equals_k1_on_the_cpu(case):
    """On the CPU the K4 wrapper and the K1 wrapper run one plain version:
    the same bits on every LRN case."""
    (xs, ws, stride, padding, relu, pk, ps, kind, pool_relu,
     lrn_n) = CELL_CASES[case]
    rng = np.random.default_rng(60 + len(case))
    x, w, b = _arr(rng, *xs), _arr(rng, *ws, scale=0.3), _arr(rng, ws[0])
    tail = dict(pool_kernel=pk, pool_stride=ps, pool_kind=kind,
                pool_relu=pool_relu, lrn_n=lrn_n, lrn_alpha=1e-3,
                lrn_beta=0.75, lrn_k=1.0)
    assert torch.equal(
        conv_ops.conv2d_pool_lrn_halo(_t(x), _t(w), _t(b), stride, padding,
                                      relu, **tail),
        conv_ops.conv2d_pool_fused(_t(x), _t(w), _t(b), stride, padding,
                                   relu, **tail))


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


@pytest.mark.parametrize("inference", [False, True])
@pytest.mark.parametrize("entry", ["conv_pool_lrn_f32", "conv_chain_f32"])
def test_stage_major_launch_keeps_converted_weights_alive(entry, inference,
                                                          monkeypatch):
    """Every weight pointer the stage-major launch hands its C entry (one
    stage for K1, three for K2) points into a converted weight tensor that
    is still alive when the entry is called, also for inference tensors,
    whose converted copies are not cached: a copy freed before the launch
    could be overwritten by the next stage's conversion before the kernel
    reads it."""
    import weakref

    one = entry == "conv_pool_lrn_f32"
    rng = np.random.default_rng(7)
    shapes = [(8, 3, 3, 3)] if one else [(8, 4, 3, 3), (8, 8, 3, 3),
                                         (4, 8, 3, 3)]
    with torch.inference_mode(inference):
        x = _t(_arr(rng, 2, shapes[0][1], 9, 9))
        ws = [_t(_arr(rng, *s)) for s in shapes]
        bs = [_t(_arr(rng, s[0])) for s in shapes]
    converted = []
    convert = conv_ops.chain_weights

    def recording(w):
        out = convert(w)
        converted.append(weakref.ref(out))
        return out

    fake = type("Lib", (), {})()
    setattr(fake, entry, _Entry(converted, bs))
    wrapper = (conv_ops.conv2d_pool_fused if one else conv_ops.conv2d_chain)
    monkeypatch.setattr(conv_ops, "chain_weights", recording)
    monkeypatch.setattr(conv_ops, "_sms", lambda dev: REPORT_SMS)
    monkeypatch.setattr(conv_ops, "_stream", lambda dev: 0)
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(wrapper, "launches", 0)
    k = len(shapes)
    pool, lrn = conv_ops._pool_lrn((2, 2), None, "max", None, 0, 0, 0)
    with torch.inference_mode(inference):
        conv_ops._launch_stage_major(wrapper, entry, x, ws, bs,
                                     [(1, 1)] * k, [(1, 1)] * k, [True] * k,
                                     pool, False, lrn)
    assert all(w.is_inference() == inference for w in ws)
    assert getattr(fake, entry).seen == ([True] * k, True)
    assert wrapper.launches == 1


@pytest.mark.parametrize("n", [1, 2])
def test_chain_schedule_at_alexnet_matches_the_plain_chain(n):
    """The emulated schedule at AlexNet's chain (one chunk an item at
    these batches: taps cut in two or three), and K6's at
    ``oc_block_final`` 100 (128-wide final items), equal
    ``conv2d_chain_ref``."""
    rng = np.random.default_rng(n)
    x = _t(_arr(rng, n, 256, 13, 13))
    ws, bs, c = [], [], 256
    for oc in (384, 384, 256):
        ws.append(_t(_arr(rng, oc, c, 3, 3, scale=(9 * c) ** -0.5)))
        bs.append(_t(_arr(rng, oc, scale=0.05)))
        c = oc
    args = ([(1, 1)] * 3, [(1, 1)] * 3, [True] * 3)
    ref = conv_ops.conv2d_chain_ref(x, ws, bs, *args, pool_kernel=(3, 3),
                                    pool_stride=(2, 2))
    for ocb in (None, conv_ops.k6_ocb(100)):
        ours = _emulate_chain(x, ws, bs, *args, POOL32, None, ocb)
        _close(ours, ref.numpy(), TOL * max(1.0, ref.abs().max().item()))


def test_chain_schedule_gives_the_same_bits_with_every_unit():
    """Items of one chunk, one tap or a kernel row (the units the host
    picks by the batch) add each output in the same tree: the emulated
    schedule gives the same bits with each, within 1e-4 of the plain
    chain, on a chain whose taps are cut in chunks (136 and 140 channels:
    two chunks a tap) and a 1 x 3 kernel."""
    rng = np.random.default_rng(7)
    x = _t(_arr(rng, 2, 136, 6, 7))
    ws = [_t(_arr(rng, 140, 136, 3, 3, scale=(9 * 136) ** -0.5)),
          _t(_arr(rng, 12, 140, 1, 3, scale=(3 * 140) ** -0.5))]
    bs = [_t(_arr(rng, 140, scale=0.1)), _t(_arr(rng, 12, scale=0.1))]
    args = ([(1, 1)] * 2, [(1, 1), (0, 1)], [True, False])
    pool = conv_ops.Pool(2, 2, 2, 2, "max")
    stages = conv_ops.make_stages((136, 6, 7), ws, *args)
    assert [conv_ops.tap_split(_round4(st.C)) for st in stages] == [2, 2]
    # a chunk, a tap and a kernel row at every stage (the 1 x 3 stage's
    # row is its whole reduction)
    outs = [_emulate_chain(x, ws, bs, *args, pool, None, unit=u)
            for u in (1, 2, 6)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])
    ref = conv_ops.conv2d_chain_ref(x, ws, bs, *args, pool_kernel=(2, 2),
                                    pool_stride=(2, 2))
    _close(outs[0], ref.numpy())


def test_chain_weights_are_converted_once():
    """``chain_weights`` converts a tensor once and reuses the copy until
    the tensor is written in place or dropped."""
    w = _t(_arr(np.random.default_rng(0), 5, 3, 3, 2))
    a = conv_ops.chain_weights(w)
    assert a.shape == (3, 2, 4, 8) and a.is_contiguous()
    assert torch.equal(a[:, :, :3, :5], w.permute(2, 3, 1, 0))
    assert not a[:, :, 3:].any() and not a[..., 5:].any()
    assert conv_ops.chain_weights(w) is a
    w.mul_(2.0)
    b = conv_ops.chain_weights(w)
    assert b is not a and torch.equal(b[:, :, :3, :5], w.permute(2, 3, 1, 0))
    key = id(w)
    del w
    assert key not in conv_ops._CHAIN_WEIGHTS


@pytest.mark.parametrize("requested", [1, 8, 64, 100])
@pytest.mark.parametrize("n", [1, 16])
def test_k6_tiles_cover_the_final_stage_once(requested, n):
    """K6 runs K2's schedule with final-stage items of ``k6_ocb`` channels
    (the request rounded up to 64-wide core tiles): they cover every
    final channel once, and the earlier stages are K2's (no stage is
    recomputed per channel tile)."""
    ocb = conv_ops.k6_ocb(requested)
    assert ocb >= requested and ocb % conv_ops.ST_TO == 0
    k6 = conv_ops.chain_plan(ALEX_CHAIN, POOL32, n, REPORT_SMS, ocb)
    k2 = conv_ops.chain_plan(ALEX_CHAIN, POOL32, n, REPORT_SMS)
    assert k6.stages[:-1] == k2.stages[:-1]
    last = k6.stages[-1]
    assert last.ot_item * conv_ops.ST_TO == ocb
    owned = np.zeros((last.n_partials, 256), dtype=np.int64)
    for _, ch, _, q in _chain_items(ALEX_CHAIN[-1], last):
        assert len(ch) <= ocb
        owned[q, ch.start:ch.stop] += 1
    assert (owned == last.tiles_m).all()
    tile = conv_ops._tile(ocb, 256)
    assert tile[1] * ocb >= 256 > (tile[1] - 1) * ocb


def test_k6_emulated_by_tiles_equals_the_chain():
    rng = np.random.default_rng(2)
    x = _t(_arr(rng, 2, 4, 11, 11))
    ws = [_t(_arr(rng, 6, 4, 3, 3, scale=0.3)),
          _t(_arr(rng, 10, 6, 3, 3, scale=0.3))]
    bs = [_t(_arr(rng, 6)), _t(_arr(rng, 10))]
    args = ([(1, 1)] * 2, [(1, 1)] * 2, [True] * 2)
    ref = conv_ops.conv2d_chain_ref(x, ws, bs, *args, pool_kernel=(3, 3),
                                    pool_stride=(2, 2))
    ocb = 4
    parts = [conv_ops.conv2d_chain_ref(
        x, [ws[0], ws[1][u:u + ocb]], [bs[0], bs[1][u:u + ocb]], *args,
        pool_kernel=(3, 3), pool_stride=(2, 2)) for u in range(0, 10, ocb)]
    assert torch.equal(torch.cat(parts, dim=1), ref)
