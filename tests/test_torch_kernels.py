"""The port's kernel modules on the CPU, against their JAX counterparts.

Each case draws its inputs with numpy from a seed and hands the same
arrays to both packages.  The JAX side takes its jnp paths (the Pallas
path does not run under the installed jax); the port's wrappers take
their plain versions because the tensors lie on the CPU.  Tolerance:
max abs <= 1e-4 (fp32 sums in another order).  The CUDA kernels
themselves are checked against these plain versions on the card by
``chip_smoke.py``.
"""
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
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.conv2d.ref import (
    conv2d_basic_parallel_ref,
    conv2d_basic_simd_ref,
    conv2d_ref,
    lrn_ref,
)
from repro_torch.kernels.matmul_fused.ops import matmul_fused, split_k
from repro_torch.kernels.pool2d.ops import pool2d
from repro_torch.kernels.pool2d.ref import pool2d_ref

TOL = 1e-4


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
    splits, kchunk = split_k(m, n, k, 132)
    assert 1 <= kchunk <= 512
    assert (splits - 1) * kchunk < k <= splits * kchunk  # no empty slice


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


# -- K7's band geometry --------------------------------------------------------------

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
    row) must fit the 227 KB of shared memory a block may have."""
    (_, (c, h, w), (oc, _, kh, kw), stride, padding, pk, ps,
     lrn) = K7_GROUPS[group]
    cp = -(-c // conv_ops.K7_ALIGN) * conv_ops.K7_ALIGN
    pool = conv_ops.Pool(*pk, *ps, "max")
    lrn_t = (5, 1e-4, 0.75, 1.0) if lrn else None
    stages, smem, geo, lrn_f = conv_ops.k7_launch(
        n, (cp, h, w), (oc, cp, kh, kw), stride, padding, True, pool, False,
        lrn_t)
    st = stages[0]
    ph = (st.OH - pk[0]) // ps[0] + 1
    pw = (st.OW - pk[1]) // ps[1] + 1
    # the conv rows of one pooled row, and with LRN that pooled row
    assert smem == 4 * oc * (pk[0] * st.OW + (pw if lrn else 0))
    assert smem <= conv_ops.K7_SMEM_LIMIT == 227 * 1024
    # one pooled row a block, n_tiles = pooled rows, the padded channels
    assert geo[9] == 1 and geo[10] == ph and geo[14] == cp
    for t in range(ph):
        (a, b), = conv_ops.band_rows(stages, pool, 1, t)
        assert (a, b) == (t * ps[0], t * ps[0] + pk[0]) and b <= st.OH


def test_k7_alexnet_conv2_band_is_83_kb():
    stages = conv_ops.make_stages((96, 27, 27), [(256, 96, 5, 5)], [(1, 1)],
                                  [(2, 2)], [True])
    pool = conv_ops.Pool(3, 3, 2, 2, "max")
    assert conv_ops.k7_smem(stages, pool, False) == 3 * 27 * 256 * 4 == 82944
    assert conv_ops.k7_smem(stages, pool, True) == 82944 + 256 * 13 * 4


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


# -- off the CPU: the ported rungs reach their wrappers, the rest raise -----
#
# A ``meta`` tensor lies on neither the CPU nor a CUDA device: a path whose
# kernel is ported reaches its wrapper, which refuses the device with
# ValueError; a path that needs an unported kernel (K4, K5, K6) raises
# NotImplementedError naming it first.


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
    call = partial(tm.conv2d_pool_fused, _meta(1, 3, 8, 8),
                   _meta(4, 3, 3, 3), _meta(4), tm.Method(method),
                   **({knob: True} if knob else {}))
    if kid == "K7":  # ported: the fused K7 wrapper refuses the device
        with pytest.raises(ValueError,
                           match="conv2d_basic_simd: unsupported device"):
            call()
    else:
        with pytest.raises(NotImplementedError, match=kid):
            call()


def test_unported_chain_cell_raises_off_cpu():
    with pytest.raises(NotImplementedError, match="K6"):
        tm.conv2d_chain_fused(_meta(1, 3, 8, 8), [_meta(4, 3, 3, 3)] * 2,
                              [_meta(4)] * 2, tm.Method.ADVANCED_SIMD_8,
                              [(1, 1)] * 2, [(1, 1)] * 2, [True] * 2,
                              oc_block_final=8)


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
