"""Per-``PlanStep`` analytic cost model for compiled ExecutionPlans: the
port of ``repro.core.cost``.

The model of "Modeling the Resource Requirements of CNNs on Mobile
Devices" (arxiv 1709.09503), adapted to the plan IR.  Every step is
reduced to three measurable resources:

* **FLOPs** — the arithmetic the step must do (2 × MACs for conv/fc;
  window/pointwise op counts for the tail kinds), attributed to a
  coefficient bucket: one per conv ladder method, one per fusable
  method's fused launch (K1/K2/K7 run a different kernel from the
  per-layer ladder, with a different achieved throughput), one shared
  ``fc`` bucket (K3 for every method) and ``other`` for the cheap
  pool/lrn/softmax tail,
* **bytes streamed** from device memory — input activation + weights +
  output: a fused/chain step streams no intermediate activation (the
  fusion win, visible to the model),
* **launches** (``dispatches``) — one per step that runs a kernel.

Predicted microseconds come from fitted per-backend coefficients
(``us_per_gflop[bucket]``, ``us_per_gb``, ``dispatch_us``) loaded from
the port's committed ``COST_MODEL.json`` (beside this module, backend
``cuda``), fitted on the card by ``repro_torch.tools.cost_fit`` and
checked by ``repro_torch.tools.cost_validate`` (Spearman rank
correlation between predicted and measured ``us_per_call``).

The resources are priced as the JAX package prices its plans without
Pallas (``use_pallas=False``): the port's kernels have no row bands to
re-fetch, so the input charge is never multiplied by an overfetch
factor, and with the same coefficients ``plan_cost`` of a port plan
equals JAX's of the same knobs on its jnp path.  JAX's VMEM column
(``StepCost.vmem_bytes``, the TPU cell's working set) is dropped: the
port's planner admits groups without a budget check, and the shared-
memory budget rules of the CUDA kernels are still to be written (the
port's static analysis, ``ROADMAP.md`` queue 1).  So the fusion gate
here is the model's decision alone.

Deliberate simplifications (the fit absorbs them): weights are charged
once per launch; im2col staging is not charged as memory traffic (the
per-method FLOP coefficients absorb the restaging cost).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.fusion import (
    FUSABLE_METHODS,
    FusedLayerSpec,
    _conv_out_hw,
    _pool_out_hw,
)
from repro_torch.core.methods import Method
from repro_torch.core.netdefs import LayerSpec
from repro_torch.core.plan import ExecutionPlan, PlanStep

ITEMSIZE = 4  # fp32 end to end


def fused_flop_key(method: Method) -> str:
    """The coefficient bucket of a fused/chain launch running ``method``:
    a different kernel from the per-layer ladder's, so its own
    coefficient."""
    return f"{method.value}:fused"


#: coefficient buckets FLOPs are attributed to: one per ladder method,
#: one per fusable method's fused launch, one for the (method-invariant)
#: fc matmul, one for the cheap pool/lrn/softmax/relu tail
FLOP_KEYS: Tuple[str, ...] = (
    tuple(m.value for m in Method)
    + tuple(fused_flop_key(m) for m in Method if m in FUSABLE_METHODS)
    + ("fc", "other"))

#: the port's committed model, beside this module (the repo root's
#: COST_MODEL.json is the JAX package's)
DEFAULT_MODEL_PATH = Path(__file__).resolve().parent / "COST_MODEL.json"
#: the backend the port's model is fitted for
DEFAULT_BACKEND = "cuda"


# -- resources of one step ---------------------------------------------------


@dataclass(frozen=True)
class StepCost:
    """One step's modelled resources (whole-batch numbers) plus, once a
    ``CostModel`` has priced them, predicted microseconds."""
    label: str
    kind: str
    key: str            # FLOP coefficient bucket (method value/"fc"/"other")
    flops: float
    hbm_bytes: float
    dispatches: int
    us: float = 0.0


@dataclass(frozen=True)
class PlanCost:
    """A whole plan's modelled cost: per-step ``StepCost`` rows plus
    aggregate views.  ``us`` is a latency only under a fitted
    ``CostModel``.  ``model_backend``/``model_fallback_from`` echo the
    pricing model's provenance, so a table priced with another backend's
    coefficients says so."""
    steps: Tuple[StepCost, ...]
    batch: int
    model_backend: str = ""
    model_fallback_from: Optional[str] = None

    @property
    def flops(self) -> float:
        return sum(s.flops for s in self.steps)

    @property
    def hbm_bytes(self) -> float:
        return sum(s.hbm_bytes for s in self.steps)

    @property
    def dispatches(self) -> int:
        return sum(s.dispatches for s in self.steps)

    @property
    def us(self) -> float:
        return sum(s.us for s in self.steps)

    @property
    def flops_by_key(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in self.steps:
            if s.flops:
                out[s.key] = out.get(s.key, 0.0) + s.flops
        return out

    def table_markdown(self, title: str = "Plan cost") -> str:
        lines = [f"### {title} (batch {self.batch})", "",
                 "| step | kind | bucket | GFLOP | MB streamed | pred us |",
                 "|---|---|---|---:|---:|---:|"]
        for s in self.steps:
            lines.append(
                f"| {s.label} | {s.kind} | {s.key} | {s.flops / 1e9:.4f} "
                f"| {s.hbm_bytes / 1e6:.2f} | {s.us:.1f} |")
        lines.append(f"| **total** |  |  | {self.flops / 1e9:.4f} "
                     f"| {self.hbm_bytes / 1e6:.2f} | {self.us:.1f} |")
        if self.model_fallback_from:
            lines += ["", f"> **Note**: no fitted coefficients for "
                          f"backend `{self.model_fallback_from}` — priced "
                          f"with the `{self.model_backend}` model "
                          f"(cross-backend fallback; ranks usually "
                          f"transfer, magnitudes do not)."]
        return "\n".join(lines)


# -- fitted coefficients -----------------------------------------------------


@dataclass(frozen=True)
class CostModel:
    """Fitted per-backend coefficients pricing the three resources.

    ``fallback_from`` records a cross-backend substitution made by
    ``load``: the backend that was requested when the file had no entry
    for it and another backend's coefficients were returned instead
    (``None`` for an exact match)."""
    backend: str
    us_per_gflop: Mapping[str, float]
    us_per_gb: float
    dispatch_us: float
    fallback_from: Optional[str] = None

    def predict(self, flops_by_key: Mapping[str, float], hbm_bytes: float,
                dispatches: int) -> float:
        """Price aggregate features (a whole plan's, or one step's)."""
        us = (dispatches * self.dispatch_us
              + hbm_bytes * 1e-9 * self.us_per_gb)
        for k, f in flops_by_key.items():
            a = self.us_per_gflop.get(k)
            if a is None:
                a = self.us_per_gflop.get("other", 0.0)
            us += f * 1e-9 * a
        return us

    def step_us(self, key: str, flops: float, hbm_bytes: float,
                dispatches: int) -> float:
        return self.predict({key: flops}, hbm_bytes, dispatches)

    @staticmethod
    def unit(backend: str = "unit") -> "CostModel":
        """Unit coefficients (1 us per GFLOP / per GB / per launch):
        resource accounting without calibration."""
        return CostModel(backend=backend,
                         us_per_gflop={k: 1.0 for k in FLOP_KEYS},
                         us_per_gb=1.0, dispatch_us=1.0)

    def to_dict(self) -> dict:
        return {"us_per_gflop": dict(self.us_per_gflop),
                "us_per_gb": self.us_per_gb,
                "dispatch_us": self.dispatch_us}

    @classmethod
    def from_dict(cls, d: Mapping, backend: str) -> "CostModel":
        return cls(backend=backend,
                   us_per_gflop=dict(d["us_per_gflop"]),
                   us_per_gb=float(d["us_per_gb"]),
                   dispatch_us=float(d["dispatch_us"]))

    @classmethod
    def load(cls, path: Optional[str] = None,
             backend: str = DEFAULT_BACKEND) -> "CostModel":
        """Load a ``COST_MODEL.json`` (schema: ``{"format_version": 1,
        "backends": {name: coefficients}}``; default: the port's
        ``DEFAULT_MODEL_PATH``).  An unreadable file raises.  When
        ``backend`` has no entry it falls back to the first fitted
        backend (sorted order), as the JAX package does, and records the
        requested backend in ``fallback_from``."""
        p = Path(path) if path is not None else DEFAULT_MODEL_PATH
        with open(p) as f:
            data = json.load(f)
        backends = data["backends"]
        if backend in backends:
            return cls.from_dict(backends[backend], backend)
        name = sorted(backends)[0]
        return replace(cls.from_dict(backends[name], name),
                       fallback_from=backend)


# -- per-kind resource accounting --------------------------------------------


def _elems(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _act_bytes(shape: Sequence[int]) -> int:
    return _elems(shape) * ITEMSIZE


def _conv_flops(spec: LayerSpec, in_shape: Tuple[int, int, int]) -> float:
    c, h, w = in_shape
    oh, ow = _conv_out_hw(h, w, spec)
    kh, kw = spec.kernel
    return 2.0 * (oh * ow * spec.out_channels * c * kh * kw)


def _conv_weight_bytes(spec: LayerSpec, cin: int) -> int:
    kh, kw = spec.kernel
    return (spec.out_channels * cin * kh * kw + spec.out_channels) * ITEMSIZE


def _group_resources(group: FusedLayerSpec, method: Optional[Method],
                     in_shape: Tuple[int, int, int],
                     batch: int) -> StepCost:
    """Resources of one fused/chain launch: all conv stages' FLOPs plus
    the pool/LRN tail, and no intermediate activation traffic — that is
    what fusion buys."""
    c, h, w = in_shape
    flops = 0.0
    weight_bytes = 0
    cc, hh, ww = c, h, w
    for cv in group.convs:
        flops += _conv_flops(cv, (cc, hh, ww))
        weight_bytes += _conv_weight_bytes(cv, cc)
        hh, ww = _conv_out_hw(hh, ww, cv)
        cc = cv.out_channels
    if group.pool is not None:
        ph, pw = _pool_out_hw(hh, ww, group.pool)
        flops += cc * ph * pw * group.pool.kernel[0] * group.pool.kernel[1]
        hh, ww = ph, pw
    if group.lrn is not None:
        flops += cc * hh * ww * (group.lrn.lrn_n + 4)
    flops *= batch
    hbm = (batch * _act_bytes(in_shape) + weight_bytes
           + batch * _act_bytes((cc, hh, ww)))
    key = fused_flop_key(method if method is not None
                         else Method.ADVANCED_SIMD_8)
    kind = "chain" if len(group.convs) > 1 else "fused"
    return StepCost(label=group.name, kind=kind, key=key, flops=flops,
                    hbm_bytes=hbm, dispatches=1)


def _unfused_group_resources(group: FusedLayerSpec,
                             method: Optional[Method],
                             in_shape: Tuple[int, int, int],
                             batch: int) -> List[StepCost]:
    """The per-layer-ladder alternative of a candidate group: one launch
    per conv / pool / lrn, every intermediate activation written and
    re-read."""
    key = (method.value if method is not None
           else Method.ADVANCED_SIMD_8.value)
    out: List[StepCost] = []
    c, h, w = in_shape
    for cv in group.convs:
        oh, ow = _conv_out_hw(h, w, cv)
        out.append(StepCost(
            label=cv.name, kind="conv", key=key,
            flops=batch * _conv_flops(cv, (c, h, w)),
            hbm_bytes=(batch * _act_bytes((c, h, w))
                       + _conv_weight_bytes(cv, c)
                       + batch * _act_bytes((cv.out_channels, oh, ow))),
            dispatches=1))
        c, h, w = cv.out_channels, oh, ow
    if group.pool is not None:
        ph, pw = _pool_out_hw(h, w, group.pool)
        out.append(StepCost(
            label=group.pool.name, kind="pool", key="other",
            flops=batch * c * ph * pw
            * group.pool.kernel[0] * group.pool.kernel[1],
            hbm_bytes=batch * (_act_bytes((c, h, w))
                               + _act_bytes((c, ph, pw))),
            dispatches=1))
        h, w = ph, pw
    if group.lrn is not None:
        out.append(StepCost(
            label=group.lrn.name, kind="lrn", key="other",
            flops=batch * c * h * w * (group.lrn.lrn_n + 4),
            hbm_bytes=batch * 2 * _act_bytes((c, h, w)),
            dispatches=1))
    return out


def step_resources(plan: ExecutionPlan, step: PlanStep,
                   batch: int = 1) -> StepCost:
    """The modelled resources of one compiled step (``us`` left 0 — a
    ``CostModel`` prices it)."""
    label = "+".join(step.names)
    if step.kind in ("fused", "chain"):
        return replace(_group_resources(step.group, step.method,
                                        step.in_shape, batch), label=label)
    if step.kind == "conv":
        spec = step.spec
        c = step.in_shape[0]
        return StepCost(
            label=label, kind="conv", key=step.method.value,
            flops=batch * _conv_flops(spec, step.in_shape),
            hbm_bytes=(batch * _act_bytes(step.in_shape)
                       + _conv_weight_bytes(spec, c)
                       + batch * _act_bytes(step.out_shape)),
            dispatches=1)
    if step.kind == "fc":
        d_in = step.d_in
        d_out = step.spec.out_channels
        return StepCost(
            label=label, kind="fc", key="fc",
            flops=batch * 2.0 * d_in * d_out,
            hbm_bytes=(batch * d_in * ITEMSIZE
                       + (d_in * d_out + d_out) * ITEMSIZE
                       + batch * d_out * ITEMSIZE),
            dispatches=1)
    if step.kind == "pool":
        c = step.in_shape[0]
        oh, ow = step.out_shape[1], step.out_shape[2]
        return StepCost(
            label=label, kind="pool", key="other",
            flops=batch * c * oh * ow
            * step.spec.kernel[0] * step.spec.kernel[1],
            hbm_bytes=batch * (_act_bytes(step.in_shape)
                               + _act_bytes(step.out_shape)),
            dispatches=1)
    if step.kind == "lrn":
        return StepCost(
            label=label, kind="lrn", key="other",
            flops=batch * _elems(step.in_shape) * (step.spec.lrn_n + 4),
            hbm_bytes=batch * 2 * _act_bytes(step.in_shape),
            dispatches=1)
    if step.kind in ("relu", "softmax"):
        per_elem = 1 if step.kind == "relu" else 5
        return StepCost(
            label=label, kind=step.kind, key="other",
            flops=batch * _elems(step.in_shape) * per_elem,
            hbm_bytes=batch * 2 * _act_bytes(step.in_shape),
            dispatches=1)
    # flatten: a view — free
    return StepCost(label=label, kind=step.kind, key="other",
                    flops=0.0, hbm_bytes=0.0, dispatches=0)


def plan_cost(plan: ExecutionPlan, model: Optional[CostModel] = None,
              batch: int = 1) -> PlanCost:
    """Price a whole compiled plan: per-step resources via
    ``step_resources``, microseconds via ``model`` (unit coefficients
    when None)."""
    m = model if model is not None else CostModel.unit()
    steps = []
    for step in plan.steps:
        sc = step_resources(plan, step, batch)
        steps.append(replace(
            sc, us=m.step_us(sc.key, sc.flops, sc.hbm_bytes, sc.dispatches)))
    return PlanCost(steps=tuple(steps), batch=batch,
                    model_backend=m.backend,
                    model_fallback_from=m.fallback_from)


# -- cost-model fusion gate --------------------------------------------------


def fusion_cost_gate(model: Optional[CostModel] = None, *, batch: int = 1):
    """The ``cost_gate`` callable ``plan_fusion`` takes: a candidate group
    is admitted only when the model scores its one fused launch no slower
    than its per-layer ladder.  A declined group walks the planner's
    admission ladder (drop the LRN tail, block the final stage of a
    chain, shorten the chain)."""
    m = model if model is not None else CostModel.unit()

    def gate(group: FusedLayerSpec, method: Optional[Method],
             in_shape: Tuple[int, int, int]) -> bool:
        fused = _group_resources(group, method, in_shape, batch)
        fused_us = m.step_us(fused.key, fused.flops, fused.hbm_bytes,
                             fused.dispatches)
        unfused_us = sum(
            m.step_us(s.key, s.flops, s.hbm_bytes, s.dispatches)
            for s in _unfused_group_resources(group, method, in_shape, batch))
        return fused_us <= unfused_us

    return gate


# -- fitting + rank validation (numpy only) ----------------------------------


def _ranks(v) -> "object":
    import numpy as np

    v = np.asarray(v, dtype=float)
    order = np.argsort(v, kind="mergesort")
    ranks = np.empty(v.size, dtype=float)
    ranks[order] = np.arange(1, v.size + 1, dtype=float)
    for val in np.unique(v):  # average ties
        mask = v == val
        if mask.sum() > 1:
            ranks[mask] = ranks[mask].mean()
    return ranks


def spearman(xs: Sequence[float], ys: Sequence[float]) -> float:
    """Spearman rank correlation (average-tie ranks, Pearson of ranks).
    Returns 0.0 for degenerate inputs (n < 2 or a constant series)."""
    import numpy as np

    x = np.asarray(xs, dtype=float)
    y = np.asarray(ys, dtype=float)
    if x.size != y.size:
        raise ValueError(f"length mismatch: {x.size} vs {y.size}")
    if x.size < 2:
        return 0.0
    rx, ry = _ranks(x), _ranks(y)
    sx, sy = rx.std(), ry.std()
    if sx == 0.0 or sy == 0.0:
        return 0.0
    return float(((rx - rx.mean()) * (ry - ry.mean())).mean() / (sx * sy))


def fit_coefficients(rows: Sequence[Mapping], backend: str) -> CostModel:
    """Fit the coefficient vector from measured rows — each row
    ``{"flops_by_key": {bucket: flops}, "hbm_bytes": b, "dispatches": d,
    "us": measured}`` — by relative least squares (each row scaled by
    1/measured-us, so a small net's row pulls as hard as a big one's)
    with iterative negative-column pruning (the most negative
    coefficient is dropped and the system re-solved until all are >= 0),
    so the model stays monotone for the autotuner.  FLOP buckets never
    observed in the rows (or pruned away) get the largest fitted bucket
    coefficient — unmeasured methods look expensive, never fast."""
    import numpy as np

    keys = sorted({k for r in rows
                   for k, v in r["flops_by_key"].items() if v > 0})
    cols = list(keys) + ["__gb__", "__dispatch__"]
    A = np.zeros((len(rows), len(cols)))
    y = np.ones(len(rows))  # each row normalized by its measured us
    for i, r in enumerate(rows):
        us = float(r["us"])
        for j, k in enumerate(keys):
            A[i, j] = r["flops_by_key"].get(k, 0.0) * 1e-9 / us
        A[i, len(keys)] = float(r["hbm_bytes"]) * 1e-9 / us
        A[i, len(keys) + 1] = float(r["dispatches"]) / us
    coef = np.zeros(len(cols))
    active = list(range(len(cols)))
    while active:
        sol, _, _, _ = np.linalg.lstsq(A[:, active], y, rcond=None)
        if (sol >= 0).all():
            for j, cj in enumerate(active):
                coef[cj] = float(sol[j])
            break
        drop = int(np.argmin(sol))
        active.pop(drop)
    fitted = {k: coef[j] for j, k in enumerate(keys)}
    positive = [v for v in fitted.values() if v > 0]
    fallback = max(positive) if positive else 1.0
    us_per_gflop = {k: float(fitted[k] if fitted.get(k, 0.0) > 0 else fallback)
                    for k in FLOP_KEYS}
    return CostModel(backend=backend, us_per_gflop=us_per_gflop,
                     us_per_gb=float(coef[len(keys)]),
                     dispatch_us=float(coef[len(keys) + 1]))
