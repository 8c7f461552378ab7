"""Engine-level fusion planner: conv-chain[+pool][+lrn] → super-layers.
The port of ``repro.core.fusion``.

``plan_fusion`` scans a ``NetworkDef`` and greedily groups a run of
consecutive conv layers (standalone ReLUs absorbed), an optional pool
right after it and an optional trailing LRN into one ``FusedLayerSpec``,
which the engine runs as one launch: a single conv with its tail on K1,
a chain of convs on K2.  AlexNet becomes conv1+pool1+norm1,
conv2+pool2+norm2 and conv3+conv4+conv5+pool5.

Layers stay on the per-layer ladder when a conv's method is not a SIMD
method, when two consecutive convs resolve to different methods, when the
pool kind is not max/avg or its window exceeds the conv output, when a
layer is named in ``no_fuse``, or when a standalone ReLU follows a conv
and ``fuse_relu`` is off.  A lone conv with no pool is not a group.

With no ``cost_gate`` the planner admits every group it forms (the port's
kernels take them all) and forms the groups the JAX planner forms on its
jnp path.  Given a ``cost_gate`` (``repro_torch.core.cost.
fusion_cost_gate``), a group is admitted only when the cost model scores
its one launch no slower than its per-layer ladder; a declined group
walks JAX's admission ladder: drop the LRN tail, then block the final
stage of a chain (``oc_block_final``, K6), then shorten the chain (the
detached layers re-enter the scan), and decline only at a single
conv+pool.  JAX's other admission check, the VMEM budget of the TPU
cell, is TPU geometry and has no counterpart here.

``group_geometry`` reports what a group executes: the kernel it resolves
to (K1, K4, K5 or K7 for a single conv with its tail, K2 or K6 for a
chain) and that kernel's band, the port's own tiling.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Tuple, Union

from repro_torch.core.methods import Method, chain_cell, fused_cell
from repro_torch.core.netdefs import LayerSpec, NetworkDef
from repro_torch.kernels.conv2d import ops as conv_ops

#: methods whose kernels take the fused pooling epilogue
FUSABLE_METHODS = frozenset({
    Method.BASIC_SIMD, Method.ADVANCED_SIMD_4, Method.ADVANCED_SIMD_8,
})

SUPPORTED_POOL_KINDS = frozenset({"max", "avg"})

#: the final-stage oc block the admission ladder's chain rung asks for,
#: by method (JAX's ``_ADVANCED_OC_BLOCK``; 8 for any other method)
_ADVANCED_OC_BLOCK = {Method.ADVANCED_SIMD_4: 4, Method.ADVANCED_SIMD_8: 8}


@dataclass(frozen=True)
class FusedLayerSpec:
    """A conv→[ReLU]→…→conv→[ReLU]→[pool]→[ReLU]→[LRN] super-layer (one
    launch).  ``convs`` is the chain of consecutive conv stages;
    ``relus[i]`` is the ReLU after stage i (the conv's own or an absorbed
    standalone one).  ``pool`` is None for a chain fused without a pool
    tail."""
    convs: Tuple[LayerSpec, ...]
    relus: Tuple[bool, ...]
    pool: Optional[LayerSpec]
    pool_relu: bool   # ReLU after the pool (pool's own or absorbed)
    names: Tuple[str, ...]  # original layer names this group covers
    lrn: Optional[LayerSpec] = None  # trailing LRN absorbed into the cell
    #: chain-only: the oc block of the final stage asked for (None = full
    #: width, K2; below the stage's width the chain runs on K6)
    oc_block_final: Optional[int] = None

    kind = "fused"  # sentinel so plan items can be dispatched on .kind

    @property
    def conv(self) -> LayerSpec:
        """The first conv of the chain (single-conv groups: THE conv)."""
        return self.convs[0]

    @property
    def relu(self) -> bool:
        """ReLU between the last conv stage and the pool."""
        return self.relus[-1]

    @property
    def name(self) -> str:
        return "+".join(self.names)


PlanItem = Union[LayerSpec, FusedLayerSpec]


def _conv_out_hw(h: int, w: int, spec: LayerSpec) -> Tuple[int, int]:
    kh, kw = spec.kernel
    return ((h + 2 * spec.padding[0] - kh) // spec.stride[0] + 1,
            (w + 2 * spec.padding[1] - kw) // spec.stride[1] + 1)


def _pool_out_hw(h: int, w: int, spec: LayerSpec) -> Tuple[int, int]:
    kh, kw = spec.kernel
    return ((h - kh) // spec.stride[0] + 1,
            (w - kw) // spec.stride[1] + 1)


#: a fusion cost gate: ``gate(candidate_group, method, in_shape) -> bool``
#: — True admits the group, False sends the planner down its admission
#: ladder.  Built by ``repro_torch.core.cost.fusion_cost_gate``.
CostGate = Callable[["FusedLayerSpec", Optional[Method],
                     Tuple[int, int, int]], bool]


def plan_fusion(net: NetworkDef, *,
                method_for: Optional[Callable[[str], Method]] = None,
                no_fuse: Iterable[str] = (),
                fuse_relu: bool = True,
                cost_gate: Optional[CostGate] = None) -> List[PlanItem]:
    """Greedy left-to-right grouping of conv-chain[+relu][+pool][+lrn]
    runs.  ``method_for`` maps a conv layer name to its ``Method`` (None:
    every conv is fusable).  ``cost_gate`` (None: every group formed is
    admitted) decides each candidate group on its modelled cost; a
    declined candidate drops its LRN tail, then (a chain) blocks its
    final stage's oc grid, then loses trailing convs, and is declined
    only as a single conv+pool.  Returns the layer sequence with each
    fused run replaced by one ``FusedLayerSpec``; other layers pass
    through."""
    no_fuse = frozenset(no_fuse)
    layers = list(net.layers)
    plan: List[PlanItem] = []
    c, h, w = net.input_shape
    i = 0
    while i < len(layers):
        spec = layers[i]
        if spec.kind == "conv":
            group = _try_group(layers, i, method_for, no_fuse, fuse_relu,
                               c, h, w, cost_gate)
            if group is not None:
                plan.append(group)
                for cv in group.convs:
                    h, w = _conv_out_hw(h, w, cv)
                c = group.convs[-1].out_channels
                if group.pool is not None:
                    h, w = _pool_out_hw(h, w, group.pool)
                i += len(group.names)
                continue
            h, w = _conv_out_hw(h, w, spec)
            c = spec.out_channels
        elif spec.kind == "pool":
            h, w = _pool_out_hw(h, w, spec)
        plan.append(spec)
        i += 1
    return plan


def _try_group(layers, i, method_for, no_fuse, fuse_relu, cin, h_in, w_in,
               cost_gate: Optional[CostGate] = None,
               ) -> Optional[FusedLayerSpec]:
    """A FusedLayerSpec for the run starting at conv ``layers[i]``, or
    None when any eligibility check fails (the per-layer fallback)."""
    first = layers[i]
    if first.name in no_fuse:
        return None
    method = method_for(first.name) if method_for is not None else None
    if method is not None and method not in FUSABLE_METHODS:
        return None
    # -- collect the maximal conv chain (absorbing standalone ReLUs) -------
    convs = [first]
    relus = [first.relu]
    conv_names = [[first.name]]  # per-stage names incl. absorbed ReLUs
    h, w = _conv_out_hw(h_in, w_in, first)
    j = i + 1
    blocked_by_relu = False  # an un-foldable standalone ReLU ends the run
    while True:
        if j < len(layers) and layers[j].kind == "relu":
            if not fuse_relu:
                blocked_by_relu = True
                break
            relus[-1] = True
            conv_names[-1].append(layers[j].name)
            j += 1
        nxt = layers[j] if j < len(layers) else None
        if (nxt is None or nxt.kind != "conv" or nxt.name in no_fuse
                or (method_for is not None
                    and method_for(nxt.name) != method)):
            break
        oh2, ow2 = _conv_out_hw(h, w, nxt)
        if oh2 < 1 or ow2 < 1:
            break
        convs.append(nxt)
        relus.append(nxt.relu)
        conv_names.append([nxt.name])
        h, w = oh2, ow2
        j += 1
    # -- optional pool (+ReLU) and LRN tail on the last conv ---------------
    pool = None
    pool_relu = False
    pool_names: List[str] = []
    lrn = None
    if not blocked_by_relu and j < len(layers) and layers[j].kind == "pool":
        p = layers[j]
        pkh, pkw = p.kernel
        if (p.name not in no_fuse and p.pool_kind in SUPPORTED_POOL_KINDS
                and pkh >= 1 and pkw >= 1
                and p.stride[0] >= 1 and p.stride[1] >= 1
                and pkh <= h and pkw <= w):
            pool = p
            pool_relu = p.relu
            pool_names = [p.name]
            k = j + 1
            if fuse_relu and k < len(layers) and layers[k].kind == "relu":
                pool_relu = True
                pool_names.append(layers[k].name)
                k += 1
            if (k < len(layers) and layers[k].kind == "lrn"
                    and layers[k].name not in no_fuse):
                lrn = layers[k]
    # -- admission (with a cost gate): JAX's ladder ------------------------
    # a declined group first drops its LRN tail, then (a chain) blocks its
    # final stage's oc grid — whose channels feed no further stage — then
    # loses its last conv (the detached pool/convs re-enter the greedy
    # scan), and is declined only as a single conv+pool
    oc_block_final = None
    if cost_gate is not None:
        while True:
            if len(convs) == 1 and pool is None:
                return None
            cand = _group(convs, relus, conv_names, pool, pool_relu,
                          pool_names, lrn, oc_block_final)
            if cost_gate(cand, method, (cin, h_in, w_in)):
                return cand
            if lrn is not None:
                lrn = None
                continue
            if len(convs) > 1 and oc_block_final is None:
                oc_block_final = _ADVANCED_OC_BLOCK.get(method, 8)
                continue
            if len(convs) == 1:
                return None
            convs.pop()
            relus.pop()
            conv_names.pop()
            pool, pool_relu, pool_names = None, False, []
            oc_block_final = None
    if len(convs) == 1 and pool is None:
        return None  # a lone conv is not a super-layer
    return _group(convs, relus, conv_names, pool, pool_relu, pool_names,
                  lrn, oc_block_final)


def _group(convs, relus, conv_names, pool, pool_relu, pool_names, lrn,
           oc_block_final) -> FusedLayerSpec:
    names = (tuple(n for stage in conv_names for n in stage)
             + tuple(pool_names) + ((lrn.name,) if lrn is not None else ()))
    return FusedLayerSpec(convs=tuple(convs), relus=tuple(relus), pool=pool,
                          pool_relu=pool_relu, names=names, lrn=lrn,
                          oc_block_final=oc_block_final)


def fusion_summary(plan: Iterable[PlanItem]) -> List[Tuple[str, ...]]:
    """The fused groups in a plan, as tuples of original layer names."""
    return [it.names for it in plan if isinstance(it, FusedLayerSpec)]


def group_geometry(group: FusedLayerSpec, method: Method,
                   in_shape: Tuple[int, int, int], *,
                   pool_carry: Optional[bool] = None,
                   lrn_oc_block: Optional[bool] = None) -> dict:
    """The executed geometry of one fused group, resolved by the same
    rules as the dispatch (``methods.fused_cell`` / ``chain_cell``): the
    JAX report's keys — ``group``, ``convs``, ``rows_per_cell`` (final
    rows a block owns; a chain's whole frame, since each of its stages
    covers every row), ``n_tiles`` (bands a frame) and ``out_hw`` — from
    the port's tiling, plus ``cell`` (the kernel) and ``oc_block``
    (output channels of the last stage an item computes).  ``in_shape``
    is the ``(C, H, W)`` entering the group."""
    convs = group.convs
    ins = (in_shape[0],) + tuple(cv.out_channels for cv in convs[:-1])
    stages = conv_ops.make_stages(
        tuple(in_shape),
        [(cv.out_channels, c, *cv.kernel) for cv, c in zip(convs, ins)],
        [cv.stride for cv in convs], [cv.padding for cv in convs],
        group.relus)
    p = group.pool
    pool = None if p is None else conv_ops.Pool(*p.kernel, *p.stride,
                                                p.pool_kind)
    lrn_n = group.lrn.lrn_n if group.lrn is not None else None
    total, out_h, out_w = conv_ops.final_rows(stages, pool)
    oc = stages[-1].OC
    if len(convs) == 1:
        cell = fused_cell(method, tuple(in_shape),
                          (oc, stages[0].C, *convs[0].kernel),
                          convs[0].stride, convs[0].padding, p.kernel,
                          p.stride, lrn_n, pool_carry, lrn_oc_block)
        if cell == "K7":
            blk, ocb = 1, oc
        else:
            # stage-major (K1, K4, K5): one band of all the final rows,
            # items ST_TO channels wide
            blk, ocb = total, min(oc, conv_ops.ST_TO)
    else:
        # stage-major (K2, K6): every stage covers the whole frame, so one
        # band of all the final rows; oc_block is the final stage's item
        cell, obf = chain_cell(oc, group.oc_block_final, lrn_n)
        blk = total
        ocb = min(oc, conv_ops.k6_ocb(obf) if cell == "K6"
                  else conv_ops.ST_TO)
    return {"group": group.name, "convs": len(convs), "rows_per_cell": blk,
            "n_tiles": math.ceil(total / blk), "out_hw": [out_h, out_w],
            "cell": cell, "oc_block": ocb}
