"""The CNNdroid execution-method ladder (§4 of the paper), in PyTorch: the
port of ``repro.core.methods``.

Every method computes the same convolution (or FC).  On the CPU each runs
as its plain PyTorch version, in the arithmetic of the JAX package's jnp
form of that method.  On CUDA each goes to a hand-written kernel:

* ``BASIC_PARALLEL`` (§4.2): the per-layer conv on K8;
* ``BASIC_SIMD`` (§4.3): the per-layer conv and the fused conv+pool
  super-layer on K7; a ``BASIC_SIMD`` conv chain runs on K2, which is the
  JAX package's chain kernel for every SIMD method too
  (``_chain_simd_kernel`` with ``im2col=False``), so its launch counts
  under K2;
* ``ADVANCED_SIMD_4``/``_8`` (§4.4): the per-layer conv (K1 without its
  pool) and the fused super-layer on K1, chains on K2;
* every method but ``SEQ_REF``: the fc layers on K3 (``fc_fused``).

``SEQ_REF`` is the paper's sequential reference and runs as plain PyTorch
on any device, as it runs without Pallas in the JAX package.  The JAX
package's second-generation cells (K4–K6: ``pool_carry``,
``lrn_oc_block``, ``oc_block_final``) raise ``NotImplementedError`` on
CUDA until they are ported.

The method names keep the JAX package's enum.  ``ADVANCED_SIMD_4``/``_8``
name the paper's 4/8-outputs-per-thread blocking; the CUDA kernels pick
their own tiles, so on CUDA both map to the same kernels.
"""
from __future__ import annotations

import enum

import torch

from repro_torch.kernels.common import ACC_DTYPE, not_ported
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.conv2d.ref import conv2d_ref
from repro_torch.kernels.matmul_fused import ops as mm_ops


class Method(enum.Enum):
    SEQ_REF = "seq_ref"
    BASIC_PARALLEL = "basic_parallel"
    BASIC_SIMD = "basic_simd"
    ADVANCED_SIMD_4 = "advanced_simd_4"
    ADVANCED_SIMD_8 = "advanced_simd_8"


LADDER = (
    Method.SEQ_REF,
    Method.BASIC_PARALLEL,
    Method.BASIC_SIMD,
    Method.ADVANCED_SIMD_4,
    Method.ADVANCED_SIMD_8,
)

_SIMD = (Method.BASIC_SIMD, Method.ADVANCED_SIMD_4, Method.ADVANCED_SIMD_8)


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def conv2d_seq_ref(x, w, b, stride=(1, 1), padding=(0, 0), relu=False):
    """§4.1 sequential reference: direct NCHW convolution accumulated over
    kernel positions.  x: [N, C, H, W]; w: [OC, C, KH, KW]; b: [OC]."""
    return conv2d_ref(x, w, b, stride, padding, relu)


def conv2d_advanced_simd(x, w, b, stride=(1, 1), padding=(0, 0), relu=False,
                         block: int = 4):
    """§4.4 advanced SIMD: im2col patches × the kernel matrix, bias and
    ReLU in the epilogue — K1 without a pool stage (its plain version on
    the CPU).  ``block`` is the paper's 4/8 output channels per thread; the
    result does not depend on it, and the CUDA kernel picks its own
    tiles."""
    return conv_ops.conv2d_pool_fused(x, w, b, stride, padding, relu)


def conv2d_pool_fused(x, w, b, method: Method, stride=(1, 1),
                      padding=(0, 0), relu=False, pool_kernel=(2, 2),
                      pool_stride=(2, 2), pool_kind: str = "max",
                      pool_relu: bool = False, lrn_n=None,
                      lrn_alpha: float = 1e-4, lrn_beta: float = 0.75,
                      lrn_k: float = 1.0, pool_carry: bool = None,
                      lrn_oc_block: bool = None):
    """One-launch conv→[ReLU]→pool→[ReLU]→[LRN] (a ``FusedLayerSpec``).
    SIMD methods only.  On CUDA: K7 for ``BASIC_SIMD``, K1 for the
    advanced methods.  ``pool_carry``/``lrn_oc_block`` select the JAX
    package's second-generation cells of the advanced methods (K5/K4; the
    JAX package ignores them for ``BASIC_SIMD``); they do not change the
    result, and on CUDA a True raises until they are ported."""
    if method not in _SIMD:
        raise ValueError(f"fused super-layer requires a SIMD method: {method}")
    tail = dict(pool_kernel=pool_kernel, pool_stride=pool_stride,
                pool_kind=pool_kind, pool_relu=pool_relu, lrn_n=lrn_n,
                lrn_alpha=lrn_alpha, lrn_beta=lrn_beta, lrn_k=lrn_k)
    if method == Method.BASIC_SIMD:
        return conv_ops.conv2d_basic_simd(x, w, b, stride, padding, relu,
                                          **tail)
    if not _on_cpu(x):
        if pool_carry:
            raise not_ported("K5", "the sliding-window pool carry")
        if lrn_oc_block:
            raise not_ported("K4", "the oc-blocked LRN cell")
    return conv_ops.conv2d_pool_fused(x, w, b, stride, padding, relu,
                                      **tail)


def conv2d_chain_fused(x, ws, bs, method: Method, strides, paddings, relus,
                       pool_kernel=None, pool_stride=None,
                       pool_kind: str = "max", pool_relu: bool = False,
                       lrn_n=None, lrn_alpha: float = 1e-4,
                       lrn_beta: float = 0.75, lrn_k: float = 1.0,
                       oc_block_final: int = None):
    """One-launch conv→[ReLU]→conv→…→[pool]→[ReLU]→[LRN] (a chain
    ``FusedLayerSpec``).  SIMD methods only.  On CUDA: K2 for every SIMD
    method (the §4.3 and §4.4 stage arithmetic compute the same chain);
    ``oc_block_final`` (the JAX package's K6 cell) raises there."""
    if method not in _SIMD:
        raise ValueError(f"fused conv chain requires a SIMD method: {method}")
    if oc_block_final is not None and not _on_cpu(x):
        raise not_ported("K6", "the oc-blocked chain final stage")
    return conv_ops.conv2d_chain(
        x, tuple(ws), tuple(bs), tuple(strides), tuple(paddings),
        tuple(relus), pool_kernel=pool_kernel, pool_stride=pool_stride,
        pool_kind=pool_kind, pool_relu=pool_relu, lrn_n=lrn_n,
        lrn_alpha=lrn_alpha, lrn_beta=lrn_beta, lrn_k=lrn_k)


def fc_seq_ref(x, w, b, relu=False):
    """x: [N, D]; w: [D, F].  A plain fp32 product."""
    out = x.to(ACC_DTYPE) @ w.to(ACC_DTYPE) + b.to(ACC_DTYPE)
    if relu:
        out = out.clamp_min(0.0)
    return out.to(x.dtype)


def fc_fused(x, w, b, relu=False):
    """Fused bias+activation matmul — the paper's FC acceleration; on
    CUDA the K3 kernel."""
    return mm_ops.matmul_fused(x, w, b, act="relu" if relu else "none")


def conv2d(x, w, b, method: Method, stride=(1, 1), padding=(0, 0),
           relu=False):
    """The per-layer conv of ``method``."""
    if method == Method.SEQ_REF:
        return conv2d_seq_ref(x, w, b, stride, padding, relu)
    if method == Method.BASIC_PARALLEL:   # §4.2: K8
        return conv_ops.conv2d_basic_parallel(x, w, b, stride, padding, relu)
    if method == Method.BASIC_SIMD:       # §4.3: K7 without its pool
        return conv_ops.conv2d_basic_simd(x, w, b, stride, padding, relu)
    if method == Method.ADVANCED_SIMD_4:
        return conv2d_advanced_simd(x, w, b, stride, padding, relu, 4)
    if method == Method.ADVANCED_SIMD_8:
        return conv2d_advanced_simd(x, w, b, stride, padding, relu, 8)
    raise ValueError(method)
