"""Compile-once ExecutionPlan IR — the engine's executor spine.  The port
of ``repro.core.plan``.

``compile_plan(net, ...)`` lowers a ``NetworkDef`` into resolved
``PlanStep``s: each step carries its input and output activation shape,
standalone ReLUs are folded into the preceding conv/fc/pool step (with
``fuse_relu``), ``fusion.plan_fusion`` runs once and each
``FusedLayerSpec`` becomes one ``fused`` (single conv + pool: K1, or K7
for basic SIMD) or ``chain`` (several convs, K2) step, and per-layer
methods are resolved.  ``ExecutionPlan.execute`` is a thin loop over step
executors; an unfused plan's standalone pools run on K9.

``compile_plan(cost_gate=...)`` admits each fused group through the cost
model (``repro_torch.core.cost.fusion_cost_gate``; see
``fusion.plan_fusion``), and ``ExecutionPlan.cost`` prices a plan with
it.  ``knob_space`` is the per-layer grid the autotuner
(``repro_torch.tools.autotune``) searches.  ``compile_plan(verify=True)``
runs the shape-flow rules of ``repro_torch.analysis.verifier`` and
raises ``PlanVerificationError`` on an error finding; the default stays
False (the engine verifies in ``CNNEngine.verify``) until the port's
static analysis decides it (``ROADMAP.md`` queue 1).
``ExecutionPlan.fusion_report`` reads each fused group's kernel and band
off the steps (``fusion.group_geometry``).  Not ported: the TPU band
overrides (``oh_block``), which ``knob_space`` still lists so that knob
sets round-trip, and the band and VMEM verifier rules — TPU geometry.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.core.fusion import (
    FUSABLE_METHODS,
    CostGate,
    FusedLayerSpec,
    PlanItem,
    _conv_out_hw,
    _pool_out_hw,
    group_geometry,
    plan_fusion,
)
from repro_torch.core.methods import (
    Method,
    conv2d,
    conv2d_chain_fused,
    conv2d_pool_fused,
    fc_fused,
    fc_seq_ref,
)
from repro_torch.core.netdefs import LayerSpec, NetworkDef
from repro_torch.kernels.common import ACC_DTYPE
from repro_torch.kernels.conv2d.ref import lrn_ref
from repro_torch.kernels.pool2d.ops import pool2d

Shape = Tuple[int, ...]


def infer_param_shapes(net: NetworkDef) -> Dict[str, Tuple]:
    """Propagate shapes through the net to size conv/fc parameters
    (conv: OIHW weight shape; fc: ``(d_in, d_out)``).  An fc straight
    after a conv/pool (no flatten layer) consumes the whole ``c*h*w``
    activation."""
    c, h, w = net.input_shape
    shapes: Dict[str, Tuple] = {}
    flat: Optional[int] = None
    for spec in net.layers:
        if spec.kind == "conv":
            kh, kw = spec.kernel
            shapes[spec.name] = (spec.out_channels, c, kh, kw)
            h, w = _conv_out_hw(h, w, spec)
            c = spec.out_channels
        elif spec.kind == "pool":
            h, w = _pool_out_hw(h, w, spec)
        elif spec.kind == "flatten":
            flat = c * h * w
        elif spec.kind == "fc":
            d_in = flat if flat is not None else c * h * w
            shapes[spec.name] = (d_in, spec.out_channels)
            flat = spec.out_channels
    return shapes


#: the conv methods worth sweeping per layer: the three fusable SIMD
#: rungs (seq_ref / basic_parallel are reference semantics, never faster)
SIMD_METHODS: Tuple[Method, ...] = tuple(
    m for m in Method if m in FUSABLE_METHODS)

#: JAX's per-layer band candidates; the port has no row bands, so these
#: are listed (the knob sets round-trip) and never applied
OH_BLOCK_CANDIDATES: Tuple[int, ...] = (4, 8, 16, 32, 64)


def knob_space(net: NetworkDef) -> Dict[str, Dict[str, list]]:
    """The per-layer candidate knob grid an offline autotuner sweeps, the
    dict JAX's ``knob_space`` returns: ``{layer_name: {"methods": [...],
    "oh_blocks": [None, ...], "fuse": [True, False], ...}}``.

    Each conv's ``oh_blocks`` list is clipped to bands strictly smaller
    than its output height (``None`` leads).  Conv layers also expose the
    second-generation cell axes: ``pool_carry`` and ``lrn_oc_block`` bind
    when the conv leads a fused conv+pool group (K5, K4),
    ``oc_block_final`` when it ends a fused chain (K6).  Pool and LRN
    layers expose only ``fuse``; fc and the pointwise layers expose no
    axis."""
    space: Dict[str, Dict[str, list]] = {}
    c, h, w = net.input_shape
    for spec in net.layers:
        if spec.kind == "conv":
            oh, ow = _conv_out_hw(h, w, spec)
            space[spec.name] = {
                "methods": list(SIMD_METHODS),
                "oh_blocks": [None] + [b for b in OH_BLOCK_CANDIDATES
                                       if b < oh],
                "fuse": [True, False],
                "pool_carry": [None, False],
                "lrn_oc_block": [None, True, False],
                "oc_block_final": [None, 4, 8],
            }
            c, h, w = spec.out_channels, oh, ow
        elif spec.kind == "pool":
            space[spec.name] = {"fuse": [True, False]}
            h, w = _pool_out_hw(h, w, spec)
        elif spec.kind == "lrn":
            space[spec.name] = {"fuse": [True, False]}
    return space


@dataclass(frozen=True)
class PlanStep:
    """One resolved executor step.  ``kind`` selects the executor:
    conv | fused (single conv + pool epilogue) | chain (multi-conv) |
    pool | lrn | flatten | fc | relu | softmax.  ``names`` are the
    original layer names the step covers (folded standalone ReLUs
    included)."""
    kind: str
    names: Tuple[str, ...]
    in_shape: Shape
    out_shape: Shape
    spec: Optional[LayerSpec] = None          # per-layer steps
    group: Optional[FusedLayerSpec] = None    # fused / chain steps
    method: Optional[Method] = None           # conv / fc / fused / chain
    relu: bool = False                        # folded epilogue ReLU
    pre_flatten: bool = False                 # fc fed a spatial activation
    d_in: Optional[int] = None                # fc input features
    kwargs: Optional[Mapping] = None          # fused/chain tail constants


def _lrn_kwargs(lrn: Optional[LayerSpec]) -> Dict:
    return dict(
        lrn_n=lrn.lrn_n if lrn is not None else None,
        lrn_alpha=lrn.lrn_alpha if lrn is not None else 1e-4,
        lrn_beta=lrn.lrn_beta if lrn is not None else 0.75,
        lrn_k=lrn.lrn_k if lrn is not None else 1.0)


# -- step executors (every decision is already resolved in the step) --------


def _pool(x, spec: LayerSpec, relu: bool = False):
    """Standalone VALID pooling on K9 (its plain version on the CPU);
    ``relu`` is the folded standalone activation (applied on top of the
    spec's own)."""
    return pool2d(x, spec.kernel, spec.stride, spec.pool_kind,
                  relu=spec.relu or relu)


def _lrn(x, spec: LayerSpec):
    """Local response normalization across channels (AlexNet-style), fp32;
    ``lrn_ref`` has the window and the formula."""
    return lrn_ref(x, spec.lrn_n, spec.lrn_alpha, spec.lrn_beta, spec.lrn_k)


def _exec_conv(step: PlanStep, params, x):
    p = params[step.spec.name]
    return conv2d(x, p["w"], p["b"], step.method, step.spec.stride,
                  step.spec.padding, step.relu)


def _exec_fused(step: PlanStep, params, x):
    # single conv + pool[+LRN]: K1 (advanced SIMD) or K7 (basic SIMD)
    g = step.group
    p = params[g.conv.name]
    return conv2d_pool_fused(
        x, p["w"], p["b"], step.method, g.conv.stride, g.conv.padding,
        g.relu, g.pool.kernel, g.pool.stride, g.pool.pool_kind, g.pool_relu,
        **step.kwargs)


def _exec_chain(step: PlanStep, params, x):
    # conv chain (optional pool/LRN tail): K2
    g = step.group
    pool = g.pool
    return conv2d_chain_fused(
        x, tuple(params[cv.name]["w"] for cv in g.convs),
        tuple(params[cv.name]["b"] for cv in g.convs),
        step.method, tuple(cv.stride for cv in g.convs),
        tuple(cv.padding for cv in g.convs), g.relus,
        pool_kernel=pool.kernel if pool is not None else None,
        pool_stride=pool.stride if pool is not None else None,
        pool_kind=pool.pool_kind if pool is not None else "max",
        pool_relu=g.pool_relu, **step.kwargs)


def _exec_pool(step, params, x):
    return _pool(x, step.spec, relu=step.relu)


def _exec_lrn(step, params, x):
    return _lrn(x, step.spec)


def _exec_flatten(step, params, x):
    # NCHW flatten, as the JAX engine: the kernels store NCHW, so fc6's
    # rows keep the JAX package's order
    return x.reshape(x.shape[0], -1)


def _exec_fc(step, params, x):
    if step.pre_flatten:  # fc fed a spatial activation (no flatten layer)
        x = x.reshape(x.shape[0], -1)
    p = params[step.spec.name]
    if step.method == Method.SEQ_REF:
        return fc_seq_ref(x, p["w"], p["b"], step.relu)
    return fc_fused(x, p["w"], p["b"], step.relu)


def _exec_relu(step, params, x):
    return x.clamp_min(0.0)


def _exec_softmax(step, params, x):
    return torch.softmax(x.to(ACC_DTYPE), dim=-1)


_EXECUTORS: Dict[str, Callable] = {
    "conv": _exec_conv,
    "fused": _exec_fused,
    "chain": _exec_chain,
    "pool": _exec_pool,
    "lrn": _exec_lrn,
    "flatten": _exec_flatten,
    "fc": _exec_fc,
    "relu": _exec_relu,
    "softmax": _exec_softmax,
}


@dataclass(frozen=True)
class ExecutionPlan:
    """The compiled forward path: a tuple of resolved ``PlanStep``s plus
    the pre-IR ``PlanItem`` sequence (iterating the plan yields the items,
    so ``fusion_summary`` works on an ``ExecutionPlan``)."""
    net: NetworkDef
    fuse: bool
    steps: Tuple[PlanStep, ...]
    items: Tuple[PlanItem, ...]

    def __iter__(self):
        return iter(self.items)

    def __len__(self) -> int:
        return len(self.items)

    def execute(self, params, x, collect: Optional[dict] = None):
        """x: [N, C, H, W].  A thin loop over the step executors."""
        for step in self.steps:
            x = _EXECUTORS[step.kind](step, params, x)
            if collect is not None:
                for n in step.names:
                    collect[n] = x
        return x

    def fusion_report(self) -> List[dict]:
        """The executed geometry of every fused group, read off the plan
        steps (each carries its resolved input shape, method and cell
        knobs): the JAX report's keys plus the kernel (``cell``) and its
        channel block — see ``fusion.group_geometry``."""
        return [group_geometry(
                    s.group, s.method, s.in_shape,
                    pool_carry=s.kwargs.get("pool_carry"),
                    lrn_oc_block=s.kwargs.get("lrn_oc_block"))
                for s in self.steps if s.kind in ("fused", "chain")]

    def cost(self, model=None, batch: int = 1):
        """Modelled cost of this plan: a ``repro_torch.core.cost.PlanCost``
        with per-step FLOPs, bytes and launches and, under ``model`` (a
        fitted ``CostModel``; None = unit coefficients), predicted
        microseconds.  Deferred import: the cost model sits above the
        plan IR."""
        from repro_torch.core.cost import plan_cost

        return plan_cost(self, model=model, batch=batch)


def compile_plan(net: NetworkDef, *,
                 method: Method = Method.ADVANCED_SIMD_8,
                 per_layer_methods: Optional[Mapping[str, Method]] = None,
                 fuse: bool = True,
                 fuse_relu: bool = True,
                 per_layer_fuse: Optional[Mapping[str, bool]] = None,
                 per_layer_pool_carry: Optional[Mapping[str, bool]] = None,
                 per_layer_lrn_oc_block: Optional[Mapping[str, bool]] = None,
                 per_layer_oc_block_final: Optional[Mapping[str, int]] = None,
                 cost_gate: Optional[CostGate] = None,
                 verify: bool = False) -> ExecutionPlan:
    """Lower ``net`` into an ``ExecutionPlan``: run the fusion planner
    (``fuse=True``), fold standalone ReLUs (``fuse_relu``), resolve each
    layer's method and propagate activation shapes.

    ``cost_gate`` (see ``fusion.plan_fusion``; built by
    ``repro_torch.core.cost.fusion_cost_gate``) admits a fused group only
    when the cost model scores its one launch no slower than its
    per-layer ladder; None admits every group formed.

    ``per_layer_pool_carry`` / ``per_layer_lrn_oc_block`` (keyed by the
    conv leading a fused conv+pool group) and ``per_layer_oc_block_final``
    (keyed by the conv ending a chain) select the second-generation cells
    (K5, K4, K6), which compute the same result; the resolvers of
    ``kernels.conv2d.ops`` decide where each takes effect.

    ``verify=True`` runs the shape-flow verifier
    (``repro_torch.analysis.verifier.verify_plan``) over the compiled
    plan and raises ``PlanVerificationError`` on any error finding, as
    JAX's ``compile_plan`` does.  The default is False: the port's engine
    verifies in ``CNNEngine.verify``, and whether compiling should
    verify too waits for the port's static analysis.
    """
    per_layer_methods = per_layer_methods or {}
    per_layer_pool_carry = per_layer_pool_carry or {}
    per_layer_lrn_oc_block = per_layer_lrn_oc_block or {}
    per_layer_oc_block_final = per_layer_oc_block_final or {}

    def method_for(name: str) -> Method:
        return per_layer_methods.get(name, method)

    if fuse:
        no = frozenset(n for n, v in (per_layer_fuse or {}).items() if not v)
        items: List[PlanItem] = plan_fusion(
            net, method_for=method_for, no_fuse=no, fuse_relu=fuse_relu,
            cost_gate=cost_gate)
    else:
        items = list(net.layers)

    steps: List[PlanStep] = []
    final_items: List[PlanItem] = []
    c, h, w = net.input_shape
    cur: Shape = (c, h, w)
    flat: Optional[int] = None
    for it in items:
        if isinstance(it, FusedLayerSpec):
            in_shape = cur
            c, h, w = cur
            for cv in it.convs:
                h, w = _conv_out_hw(h, w, cv)
            c = it.convs[-1].out_channels
            if it.pool is not None:
                h, w = _pool_out_hw(h, w, it.pool)
            cur = (c, h, w)
            kw = _lrn_kwargs(it.lrn)
            if len(it.convs) > 1:
                # an LRN tail keeps full width (the JAX kernel rejects
                # the combination)
                obf = per_layer_oc_block_final.get(it.convs[-1].name)
                if obf is not None and it.lrn is None:
                    it = replace(it, oc_block_final=obf)
                kw["oc_block_final"] = it.oc_block_final
            else:
                kw["pool_carry"] = per_layer_pool_carry.get(it.conv.name)
                kw["lrn_oc_block"] = per_layer_lrn_oc_block.get(it.conv.name)
            steps.append(PlanStep(
                kind="chain" if len(it.convs) > 1 else "fused",
                names=it.names, in_shape=in_shape, out_shape=cur, group=it,
                method=method_for(it.conv.name), kwargs=kw))
            final_items.append(it)
            continue
        spec = it
        final_items.append(spec)
        in_shape = cur
        if spec.kind == "conv":
            c, h, w = cur
            h, w = _conv_out_hw(h, w, spec)
            c = spec.out_channels
            cur = (c, h, w)
            steps.append(PlanStep(
                "conv", (spec.name,), in_shape, cur, spec=spec,
                method=method_for(spec.name), relu=spec.relu))
        elif spec.kind == "pool":
            c, h, w = cur
            h, w = _pool_out_hw(h, w, spec)
            cur = (c, h, w)
            steps.append(PlanStep("pool", (spec.name,), in_shape, cur,
                                  spec=spec, relu=spec.relu))
        elif spec.kind == "lrn":
            steps.append(PlanStep("lrn", (spec.name,), in_shape, cur,
                                  spec=spec))
        elif spec.kind == "flatten":
            flat = int(cur[0] * cur[1] * cur[2]) if len(cur) == 3 else cur[0]
            cur = (flat,)
            steps.append(PlanStep("flatten", (spec.name,), in_shape, cur,
                                  spec=spec))
        elif spec.kind == "fc":
            d_in = flat if flat is not None else int(cur[0] * cur[1] * cur[2])
            flat = spec.out_channels
            pre_flatten = len(cur) == 3
            cur = (spec.out_channels,)
            steps.append(PlanStep(
                "fc", (spec.name,), in_shape, cur, spec=spec,
                method=method_for(spec.name), relu=spec.relu,
                pre_flatten=pre_flatten, d_in=d_in))
        elif spec.kind == "relu":
            # a relu following a conv/fc/pool step joins that step's
            # epilogue (its name joins the step so collect still sees it)
            if (fuse_relu and steps
                    and steps[-1].kind in ("conv", "fc", "pool")):
                steps[-1] = replace(steps[-1], relu=True,
                                    names=steps[-1].names + (spec.name,))
            else:
                steps.append(PlanStep("relu", (spec.name,), in_shape, cur,
                                      spec=spec))
        elif spec.kind == "softmax":
            steps.append(PlanStep("softmax", (spec.name,), in_shape, cur,
                                  spec=spec))
        else:
            raise ValueError(spec.kind)
    plan = ExecutionPlan(net=net, fuse=fuse, steps=tuple(steps),
                         items=tuple(final_items))
    if verify:
        # deferred import: the verifier imports this module
        from repro_torch.analysis.verifier import (PlanVerificationError,
                                                   verify_plan)

        errors = [f for f in verify_plan(plan) if f.severity == "error"]
        if errors:
            raise PlanVerificationError(errors)
    return plan
