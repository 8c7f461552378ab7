"""The port's kernel modules on the CPU, against their JAX counterparts.

K3 (the fused bias + activation matmul), the plain building blocks
(pool, conv, LRN), K1's and K2's plain versions, the method ladder and
the wrappers off the CPU.

Each case draws its inputs with numpy from a seed and hands the same
arrays to both packages.  The JAX side takes its jnp paths (the Pallas
path does not run under the installed jax); the port's wrappers take
their plain versions because the tensors lie on the CPU.  Tolerance:
max abs <= 1e-4 (fp32 sums in another order).  The CUDA kernels
themselves are checked against these plain versions on the card by
``chip_smoke.py``.
"""
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
from repro_torch.kernels.conv2d.ref import conv2d_ref, lrn_ref
from repro_torch.kernels.matmul_fused import ops as mm_ops
from repro_torch.kernels.matmul_fused.ops import matmul_fused, split_k
from repro_torch.kernels.pool2d.ops import pool2d
from repro_torch.kernels.pool2d.ref import pool2d_ref
from torch_kernels_common import (
    K1_CASES,
    K2_CASES,
    _arr,
    _close,
    _jit,
    _meta,
    _t,
)


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
