"""The port's kernel modules on the CPU, against their JAX counterparts.

The stage-major schedule's emulation at AlexNet's one-stage groups
and per-layer convs.

Each case draws its inputs with numpy from a seed and hands the same
arrays to both packages.  The JAX side takes its jnp paths (the Pallas
path does not run under the installed jax); the port's wrappers take
their plain versions because the tensors lie on the CPU.  Tolerance:
max abs <= 1e-4 (fp32 sums in another order).  The CUDA kernels
themselves are checked against these plain versions on the card by
``chip_smoke.py``.
"""
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import methods as jm
from repro.kernels.conv2d.ref import conv2d_ref as jax_conv2d_ref
from repro_torch.kernels.conv2d import ops as conv_ops
from torch_kernels_common import (
    ALEX_CONVS,
    ALEX_LRN,
    POOL32,
    TOL,
    _arr,
    _close,
    _emulate_chain,
    _jit,
    _stages,
    _t,
    _units,
)


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
