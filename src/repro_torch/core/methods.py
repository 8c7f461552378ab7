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
* the second-generation cells of the fused super-layer, chosen by the
  knobs through the resolvers of ``kernels.conv2d.ops`` (``fused_cell``,
  ``chain_cell``): ``lrn_oc_block`` → K4 (advanced methods, LRN groups),
  ``pool_carry`` → K5 (advanced methods, overlapping pools, no LRN),
  ``oc_block_final`` → K6 (every SIMD chain without an LRN tail);
* every method but ``SEQ_REF``: the fc layers on K3 (``fc_fused``).

``SEQ_REF`` is the paper's sequential reference and runs as plain PyTorch
on any device, as it runs without Pallas in the JAX package.

``conv_geometry``, ``fused_geometry`` and ``chain_geometry`` give, from shapes
alone, the kernel a conv, a fused group or a chain runs on and the launch
geometry its wrapper computes (a ``kernels.common.Launch``), through the
same cell choice and the same geometry functions as the dispatch: the
plan verifier reads them.

The method names keep the JAX package's enum.  ``ADVANCED_SIMD_4``/``_8``
name the paper's 4/8-outputs-per-thread blocking; the CUDA kernels pick
their own tiles, so on CUDA both map to the same kernels.
"""
from __future__ import annotations

import enum
from typing import Optional, Tuple

from repro_torch.kernels.common import ACC_DTYPE, Launch
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


def fused_cell(method: Method, in_chw, w_shape, stride, padding,
               pool_kernel, pool_stride, lrn_n, pool_carry=None,
               lrn_oc_block=None) -> str:
    """The kernel a fused conv + pool[+LRN] group runs on: ``"K7"`` for
    ``BASIC_SIMD``; for the advanced methods ``"K4"`` where
    ``resolve_lrn_ocb`` blocks the LRN group, ``"K5"`` where
    ``resolve_pool_carry`` takes the carry on the port's band, else
    ``"K1"``.  Shapes only, so the plan's ``fusion_report`` reads it on
    any device."""
    if method not in _SIMD:
        raise ValueError(f"fused super-layer requires a SIMD method: {method}")
    if method == Method.BASIC_SIMD:
        return "K7"
    oc = w_shape[0]
    lrn = (lrn_n,) if lrn_n is not None else None
    if conv_ops.resolve_lrn_ocb(oc, conv_ops.ADVANCED_OC_BLOCK[method.value],
                                lrn, lrn_oc_block)[1]:
        return "K4"
    if pool_carry is True and lrn is None:
        pool = conv_ops.Pool(*pool_kernel, *(pool_stride or pool_kernel),
                             "max")
        if pool.kh > pool.sy:
            stages = conv_ops.make_stages(in_chw, [w_shape], [stride],
                                          [padding], [False])
            phb, n_bands = conv_ops.k5_bands(stages, pool)
            if conv_ops.resolve_pool_carry(True, None, tuple(pool[:4]), phb,
                                           n_bands):
                return "K5"
    return "K1"


def chain_cell(oc_f: int, oc_block_final, lrn_n) -> Tuple[str,
                                                          Optional[int]]:
    """``("K6", block)`` when a chain's final stage is oc-blocked
    (``resolve_oc_block_final``), else ``("K2", None)``."""
    obf = conv_ops.resolve_oc_block_final(
        oc_f, oc_block_final, (lrn_n,) if lrn_n is not None else None)
    return ("K2", None) if obf is None else ("K6", obf)


def _fused_tail(cell: str, pool_kernel, pool_stride, pool_kind, pool_relu,
                lrn_n, lrn_alpha, lrn_beta, lrn_k) -> dict:
    """The tail keywords the wrapper of ``cell`` takes: K5's has no LRN."""
    tail = dict(pool_kernel=pool_kernel, pool_stride=pool_stride,
                pool_kind=pool_kind, pool_relu=pool_relu)
    if cell != "K5":
        tail.update(lrn_n=lrn_n, lrn_alpha=lrn_alpha, lrn_beta=lrn_beta,
                    lrn_k=lrn_k)
    return tail


#: the wrapper of each cell of a fused conv + pool[+LRN] group
_FUSED_WRAPPERS = {"K7": conv_ops.conv2d_basic_simd,
                   "K4": conv_ops.conv2d_pool_lrn_halo,
                   "K5": conv_ops.conv2d_pool_carry,
                   "K1": conv_ops.conv2d_pool_fused}


def conv2d_pool_fused(x, w, b, method: Method, stride=(1, 1),
                      padding=(0, 0), relu=False, pool_kernel=(2, 2),
                      pool_stride=(2, 2), pool_kind: str = "max",
                      pool_relu: bool = False, lrn_n=None,
                      lrn_alpha: float = 1e-4, lrn_beta: float = 0.75,
                      lrn_k: float = 1.0, pool_carry: bool = None,
                      lrn_oc_block: bool = None):
    """One-launch conv→[ReLU]→pool→[ReLU]→[LRN] (a ``FusedLayerSpec``).
    SIMD methods only.  The kernel is ``fused_cell``'s: K7 for
    ``BASIC_SIMD`` (which ignores ``pool_carry``/``lrn_oc_block``, as the
    JAX package does), and K1, K4 or K5 for the advanced methods.  Every
    cell computes the same result; on the CPU each wrapper runs K1's plain
    version."""
    cell = fused_cell(method, tuple(x.shape[1:]), tuple(w.shape), stride,
                      padding, pool_kernel, pool_stride, lrn_n, pool_carry,
                      lrn_oc_block)
    tail = _fused_tail(cell, pool_kernel, pool_stride, pool_kind, pool_relu,
                       lrn_n, lrn_alpha, lrn_beta, lrn_k)
    return _FUSED_WRAPPERS[cell](x, w, b, stride, padding, relu, **tail)


def fused_geometry(method: Method, n: int, in_chw, w_shape, sms: int,
                   stride=(1, 1), padding=(0, 0), relu=False,
                   pool_kernel=(2, 2), pool_stride=(2, 2),
                   pool_kind: str = "max", pool_relu: bool = False,
                   lrn_n=None, lrn_alpha: float = 1e-4,
                   lrn_beta: float = 0.75, lrn_k: float = 1.0,
                   pool_carry: bool = None,
                   lrn_oc_block: bool = None) -> Tuple[str, Launch]:
    """``(cell, launch)`` of ``conv2d_pool_fused`` on ``n`` frames of
    ``in_chw`` on ``sms`` SMs: the cell ``fused_cell`` picks and the
    launch geometry its wrapper computes."""
    cell = fused_cell(method, tuple(in_chw), tuple(w_shape), stride, padding,
                      pool_kernel, pool_stride, lrn_n, pool_carry,
                      lrn_oc_block)
    tail = _fused_tail(cell, pool_kernel, pool_stride, pool_kind, pool_relu,
                       lrn_n, lrn_alpha, lrn_beta, lrn_k)
    pool, lrn = conv_ops._pool_lrn(pool_kernel, pool_stride, pool_kind,
                                   tail.get("lrn_n"), lrn_alpha, lrn_beta,
                                   lrn_k)
    if cell == "K7":
        return cell, conv_ops.k7_geometry(n, in_chw, w_shape, stride,
                                          padding, relu, pool, pool_relu, lrn)
    return cell, conv_ops.stage_major_geometry(
        n, in_chw, [w_shape], [stride], [padding], [relu], pool, pool_relu,
        lrn, sms)


def conv2d_chain_fused(x, ws, bs, method: Method, strides, paddings, relus,
                       pool_kernel=None, pool_stride=None,
                       pool_kind: str = "max", pool_relu: bool = False,
                       lrn_n=None, lrn_alpha: float = 1e-4,
                       lrn_beta: float = 0.75, lrn_k: float = 1.0,
                       oc_block_final: int = None):
    """One-launch conv→[ReLU]→conv→…→[pool]→[ReLU]→[LRN] (a chain
    ``FusedLayerSpec``).  SIMD methods only.  K2 for every SIMD method
    (the §4.3 and §4.4 stage arithmetic compute the same chain), or K6
    where ``chain_cell`` blocks the final stage (``oc_block_final`` below
    its width; with an LRN tail it raises on every device)."""
    if method not in _SIMD:
        raise ValueError(f"fused conv chain requires a SIMD method: {method}")
    cell, obf = chain_cell(ws[-1].shape[0], oc_block_final, lrn_n)
    if cell == "K6":
        return conv_ops.conv2d_chain_ocb(
            x, tuple(ws), tuple(bs), tuple(strides), tuple(paddings),
            tuple(relus), pool_kernel=pool_kernel, pool_stride=pool_stride,
            pool_kind=pool_kind, pool_relu=pool_relu, oc_block_final=obf)
    return conv_ops.conv2d_chain(
        x, tuple(ws), tuple(bs), tuple(strides), tuple(paddings),
        tuple(relus), pool_kernel=pool_kernel, pool_stride=pool_stride,
        pool_kind=pool_kind, pool_relu=pool_relu, lrn_n=lrn_n,
        lrn_alpha=lrn_alpha, lrn_beta=lrn_beta, lrn_k=lrn_k)


def chain_geometry(method: Method, n: int, in_chw, w_shapes, sms: int,
                   strides, paddings, relus, pool_kernel=None,
                   pool_stride=None, pool_kind: str = "max",
                   pool_relu: bool = False, lrn_n=None,
                   lrn_alpha: float = 1e-4, lrn_beta: float = 0.75,
                   lrn_k: float = 1.0,
                   oc_block_final: int = None) -> Tuple[str, Launch]:
    """``(cell, launch)`` of ``conv2d_chain_fused`` on ``n`` frames of
    ``in_chw`` on ``sms`` SMs: K2 or K6 (``chain_cell``, which raises for
    K6 with an LRN tail, as the dispatch does) and its wrapper's launch
    geometry."""
    if method not in _SIMD:
        raise ValueError(f"fused conv chain requires a SIMD method: {method}")
    cell, obf = chain_cell(w_shapes[-1][0], oc_block_final, lrn_n)
    if cell == "K6":
        lrn_n = None
    pool, lrn = conv_ops._pool_lrn(pool_kernel, pool_stride, pool_kind,
                                   lrn_n, lrn_alpha, lrn_beta, lrn_k)
    return cell, conv_ops.stage_major_geometry(
        n, in_chw, w_shapes, strides, paddings, relus, pool, pool_relu, lrn,
        sms, obf)


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


#: the kernel of the per-layer conv of each method (``SEQ_REF``: none)
CONV_KERNELS = {Method.BASIC_PARALLEL: "K8", Method.BASIC_SIMD: "K7",
                Method.ADVANCED_SIMD_4: "K1", Method.ADVANCED_SIMD_8: "K1"}


def conv_geometry(method: Method, n: int, in_chw, w_shape, sms: int,
                  stride=(1, 1), padding=(0, 0), relu=False
                  ) -> Optional[Tuple[str, Launch]]:
    """``(kernel, launch)`` of ``conv2d`` on ``n`` frames of ``in_chw`` on
    ``sms`` SMs, or None for ``SEQ_REF`` (no kernel)."""
    kid = CONV_KERNELS.get(method)
    if kid == "K8":
        return kid, conv_ops.k8_geometry(n, in_chw, w_shape, stride, padding,
                                         relu)
    if kid == "K7":
        return kid, conv_ops.k7_geometry(n, in_chw, w_shape, stride, padding,
                                         relu, None, False, None)
    if kid == "K1":
        return kid, conv_ops.stage_major_geometry(
            n, in_chw, [w_shape], [stride], [padding], [relu], None, False,
            None, sms)
    return None


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
