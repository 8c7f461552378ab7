"""Static plan verifier, shape flow only: the port of
``repro.analysis.verifier``'s V1xx rules.

``verify_plan(plan)`` walks the compiled ``PlanStep``s and checks, with
no kernel execution, that every step's output shape re-derives from its
input shape and layer spec (V101), that consecutive steps chain (V102)
and that conv/fc parameter geometry matches ``infer_param_shapes``
(V103).

Not ported: the JAX verifier's band-coverage rules (V2xx) and its VMEM
budget audit (V3xx).  Both prove the TPU kernels' row-band tiling and
their fit in VMEM; the CUDA kernels tile differently (a block per pooled
row band, shared memory under 227 KB, checked by the CPU geometry tests)
and their own rules wait for ROADMAP item 8.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.core.fusion import _conv_out_hw, _pool_out_hw
from repro_torch.core.plan import ExecutionPlan, PlanStep, infer_param_shapes


def _derived_out_shape(step: PlanStep) -> Optional[Tuple[int, ...]]:
    cur = tuple(step.in_shape)
    if step.kind == "conv":
        _, h, w = cur
        h, w = _conv_out_hw(h, w, step.spec)
        return (step.spec.out_channels, h, w)
    if step.kind in ("fused", "chain"):
        _, h, w = cur
        for cv in step.group.convs:
            h, w = _conv_out_hw(h, w, cv)
        if step.group.pool is not None:
            h, w = _pool_out_hw(h, w, step.group.pool)
        return (step.group.convs[-1].out_channels, h, w)
    if step.kind == "pool":
        c, h, w = cur
        h, w = _pool_out_hw(h, w, step.spec)
        return (c, h, w)
    if step.kind == "flatten":
        return ((int(cur[0] * cur[1] * cur[2]),) if len(cur) == 3 else cur)
    if step.kind == "fc":
        return (step.spec.out_channels,)
    if step.kind in ("lrn", "relu", "softmax"):
        return cur
    return None


def _shape_findings(step: PlanStep, label: str, cur: Tuple[int, ...],
                    shapes: dict) -> List[Finding]:
    findings: List[Finding] = []
    if tuple(step.in_shape) != tuple(cur):
        findings.append(Finding(
            "error", label, "V102",
            f"step input shape {tuple(step.in_shape)} != upstream "
            f"activation {tuple(cur)}"))
    want = _derived_out_shape(step)
    if want is not None:
        if any(d < 1 for d in want):
            findings.append(Finding(
                "error", label, "V101",
                f"derived output shape {want} has a non-positive dim "
                f"(kernel/pool larger than its input)"))
        elif tuple(step.out_shape) != want:
            findings.append(Finding(
                "error", label, "V101",
                f"step output shape {tuple(step.out_shape)} != derived "
                f"{want}"))
    # parameter geometry vs infer_param_shapes
    if step.kind == "conv":
        kh, kw = step.spec.kernel
        want_w = (step.spec.out_channels, step.in_shape[0], kh, kw)
        if shapes.get(step.spec.name) != want_w:
            findings.append(Finding(
                "error", label, "V103",
                f"conv {step.spec.name} weight {shapes.get(step.spec.name)} "
                f"!= step-derived {want_w}"))
    elif step.kind in ("fused", "chain"):
        c = step.in_shape[0]
        for cv in step.group.convs:
            kh, kw = cv.kernel
            want_w = (cv.out_channels, c, kh, kw)
            if shapes.get(cv.name) != want_w:
                findings.append(Finding(
                    "error", label, "V103",
                    f"conv {cv.name} weight {shapes.get(cv.name)} != "
                    f"step-derived {want_w}"))
            c = cv.out_channels
    elif step.kind == "fc":
        d_in = (int(step.in_shape[0] * step.in_shape[1] * step.in_shape[2])
                if len(step.in_shape) == 3 else int(step.in_shape[0]))
        want_w = (d_in, step.spec.out_channels)
        if step.d_in != d_in or shapes.get(step.spec.name) != want_w:
            findings.append(Finding(
                "error", label, "V103",
                f"fc {step.spec.name}: weight {shapes.get(step.spec.name)} "
                f"/ step d_in {step.d_in} != step-derived {want_w}"))
    return findings


def verify_plan(plan: ExecutionPlan) -> List[Finding]:
    """All findings for ``plan``, most severe first."""
    net = plan.net
    cur: Tuple[int, ...] = tuple(net.input_shape)
    shapes = infer_param_shapes(net)
    findings: List[Finding] = []
    for idx, step in enumerate(plan.steps):
        label = f"step{idx}:{'+'.join(step.names)}"
        findings += _shape_findings(step, label, cur, shapes)
        cur = tuple(step.out_shape)
    # headless nets end wherever they end; a classifier tail must land
    # exactly on the class distribution
    if (plan.steps and plan.steps[-1].kind in ("fc", "softmax")
            and tuple(cur) != (net.num_classes,)):
        findings.append(Finding(
            "warning", "plan", "V102",
            f"final activation {tuple(cur)} != (num_classes="
            f"{net.num_classes},)"))
    order = {"error": 0, "warning": 1, "info": 2}
    findings.sort(key=lambda f: order[f.severity])
    return findings
