"""Offline autotuner: search the compiled-plan knob space with the cost
model and write the winner into a deploy manifest — the port of
``tools/autotune.py``.

Coordinate descent over ``plan.knob_space`` (per-conv method, per-layer
fusion opt-outs and the second-generation cell knobs), starting from the
default configuration.  Every candidate is compiled through
``compile_plan(verify=True)`` — a knob set whose plan has an error
finding is rejected, whatever the model says — and priced by
``repro_torch.core.cost`` under the port's committed model (backend
``cuda``).  Only strict predicted improvements are accepted, so the tuned
plan's modelled cost is <= the default's by construction.  The knobs the
port does not apply (``oh_block``, ``per_layer_oh_blocks``,
``use_pallas``) keep their defaults and round-trip through the manifest.

The winner is written with ``deploy.save_model(tuned=...)`` and the tool
reloads its own artifact: the knobs must come back byte-exact, the plan
must verify clean, and its modelled cost must not exceed the default
plan's:

    python -m repro_torch.tools.autotune --net alexnet --batch 16 \\
        --out tuned-alexnet

Exit codes: 0 = tuned artifact written and self-checked (or no --out);
1 = a tuned-plan check failed; 2 = usage/input error.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple


from repro_torch.analysis.verifier import PlanVerificationError, verify_plan
from repro_torch.core import deploy
from repro_torch.core.cost import DEFAULT_BACKEND, CostModel, PlanCost, plan_cost
from repro_torch.core.engine import CNNEngine
from repro_torch.core.methods import Method
from repro_torch.core.netdefs import NETWORKS
from repro_torch.core.plan import ExecutionPlan, compile_plan, knob_space

#: accept a move only when it improves the prediction by this relative
#: margin — float noise must not churn the tuned configuration
EPSILON = 1e-6

#: the per-layer map knobs a move may write
_MAPS = ("per_layer_methods", "per_layer_oh_blocks", "per_layer_fuse",
         "per_layer_pool_carry", "per_layer_lrn_oc_block",
         "per_layer_oc_block_final")


def default_knobs() -> Dict:
    """The configuration every engine starts from — the baseline the
    tuned plan must beat (or match).  The JAX package's knob set, TPU
    knobs included, so that manifests match byte for byte."""
    return {
        "method": Method.ADVANCED_SIMD_8,
        "per_layer_methods": {},
        "oh_block": None,
        "per_layer_oh_blocks": {},
        "fuse": True,
        "fuse_relu": True,
        "per_layer_fuse": {},
        "per_layer_pool_carry": {},
        "per_layer_lrn_oc_block": {},
        "per_layer_oc_block_final": {},
        "use_pallas": False,
    }


def score(net, knobs: Dict, model: CostModel,
          batch: int) -> Tuple[Optional[ExecutionPlan], Optional[PlanCost]]:
    """Compile + verify + price one candidate; ``(None, None)`` for a
    candidate the verifier rejects with error findings."""
    try:
        plan = compile_plan(net, verify=True, **deploy.plan_knobs(knobs))
    except PlanVerificationError:
        return None, None
    return plan, plan_cost(plan, model, batch)


def tune(net, model: CostModel, batch: int = 8, passes: int = 2) -> Dict:
    """Greedy coordinate descent from the default configuration.  Each
    pass walks every layer's candidate axes (method, fuse, the cell
    knobs; not JAX's row bands, which the port does not apply) and keeps
    a move only when the verified candidate strictly improves the
    predicted cost.  Returns the tune record: knobs, plans, costs,
    decisions."""
    space = knob_space(net)
    knobs = default_knobs()
    base_plan, base_cost = score(net, knobs, model, batch)
    if base_plan is None:
        raise RuntimeError(
            f"default plan for {net.name} fails static verification")
    best = base_cost.us
    decisions: List[Dict] = []

    def try_move(layer: str, axis: str, knob: str, value) -> bool:
        nonlocal best, knobs
        cand = {**knobs, **{k: dict(knobs[k]) for k in _MAPS}}
        cand[knob][layer] = value
        _, cost = score(net, cand, model, batch)
        if cost is None or cost.us >= best * (1.0 - EPSILON):
            return False
        decisions.append({"layer": layer, "axis": axis,
                          "value": value if not isinstance(value, Method)
                          else value.value,
                          "us_before": round(best, 1),
                          "us_after": round(cost.us, 1)})
        knobs, best = cand, cost.us
        return True

    for _ in range(max(1, passes)):
        improved = False
        for name, axes in space.items():
            for m in axes.get("methods", ()):
                improved |= try_move(name, "method", "per_layer_methods", m)
            if False in axes.get("fuse", ()):
                improved |= try_move(name, "fuse", "per_layer_fuse", False)
            # the cell knobs: None (the resolvers' rule) is the start
            # point, so only explicit pins move
            for axis in ("pool_carry", "lrn_oc_block", "oc_block_final"):
                for v in axes.get(axis, ()):
                    if v is not None:
                        improved |= try_move(name, axis,
                                             f"per_layer_{axis}", v)
        if not improved:
            break

    plan, cost = score(net, knobs, model, batch)
    return {
        "net": net.name, "batch": batch, "knobs": knobs, "plan": plan,
        "cost": cost, "default_plan": base_plan, "default_cost": base_cost,
        "decisions": decisions,
    }


def decision_table(result: Dict, model: CostModel) -> str:
    """The per-layer decision table (markdown): what each step of the
    tuned plan runs, and the search moves that got there."""
    lines = [f"### Autotune — {result['net']} "
             f"(batch {result['batch']}, model backend `{model.backend}`)",
             "", "| step | kind | method | fused into | pred us |",
             "|---|---|---|---|---:|"]
    for step, sc in zip(result["plan"].steps, result["cost"].steps):
        meth = step.method.value if step.method is not None else ""
        grp = "+".join(step.names) if step.kind in ("fused", "chain") else ""
        lines.append(f"| {'+'.join(step.names)} | {step.kind} | {meth} "
                     f"| {grp} | {sc.us:.1f} |")
    d, t = result["default_cost"].us, result["cost"].us
    lines += ["",
              f"- default plan: **{d:.1f} us** (modelled)",
              f"- tuned plan: **{t:.1f} us** (modelled, "
              f"{d / t if t else 1.0:.2f}x)",
              f"- accepted moves: {len(result['decisions'])}"]
    for mv in result["decisions"]:
        lines.append(f"  - `{mv['layer']}` {mv['axis']} → `{mv['value']}` "
                     f"({mv['us_before']} → {mv['us_after']} us)")
    return "\n".join(lines)


def write_and_check(result: Dict, model: CostModel, out: str,
                    params: Optional[dict] = None) -> int:
    """Write the tuned artifact (``params``, or weights drawn from seed 0)
    and prove on the reloaded copy: byte-exact knob round-trip, no error
    finding, modelled cost <= the default plan's.  Returns the exit
    code."""
    net = result["plan"].net
    if params is None:
        params = CNNEngine(net, device="cpu").init()
    deploy.save_model(out, net, params, tuned=result["knobs"],
                      extra={"autotune": {
                          "modelled_us": round(result["cost"].us, 1),
                          "default_modelled_us":
                              round(result["default_cost"].us, 1),
                          "batch": result["batch"],
                          "model_backend": model.backend}})

    saved = json.dumps(deploy.knobs_to_manifest(result["knobs"]),
                       sort_keys=True)
    loaded_knobs = deploy.load_tuned_knobs(out)
    loaded = json.dumps(deploy.knobs_to_manifest(loaded_knobs),
                        sort_keys=True)
    if saved != loaded:
        print(f"FAIL: tuned knobs did not round-trip byte-exactly:\n"
              f"  saved:  {saved}\n  loaded: {loaded}", file=sys.stderr)
        return 1
    plan = compile_plan(net, **deploy.plan_knobs(loaded_knobs))
    errors = [f for f in verify_plan(plan) if f.severity == "error"]
    if errors:
        print(f"FAIL: reloaded tuned plan has {len(errors)} error "
              f"finding(s): {errors}", file=sys.stderr)
        return 1
    reloaded_us = plan_cost(plan, model, result["batch"]).us
    default_us = result["default_cost"].us
    if reloaded_us > default_us * (1.0 + EPSILON):
        print(f"FAIL: tuned plan modelled cost {reloaded_us:.1f} us exceeds "
              f"default {default_us:.1f} us", file=sys.stderr)
        return 1
    print(f"tuned artifact written to {out} "
          f"(modelled {reloaded_us:.1f} us vs default {default_us:.1f} us)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--net", default="lenet5",
                    help=f"network to tune ({', '.join(sorted(NETWORKS))})")
    ap.add_argument("--batch", type=int, default=8,
                    help="batch size the cost is modelled at")
    ap.add_argument("--model", default=None,
                    help="COST_MODEL.json path (default: the port's)")
    ap.add_argument("--backend", default=DEFAULT_BACKEND,
                    help="coefficient backend to price with")
    ap.add_argument("--passes", type=int, default=2,
                    help="coordinate-descent passes over the knob space")
    ap.add_argument("--smoke", action="store_true",
                    help="single-pass quick search")
    ap.add_argument("--out", default=None,
                    help="write the tuned deploy artifact to this directory "
                         "and self-check the round-trip")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="dump the tune record as JSON to this path")
    args = ap.parse_args(argv)

    if args.net not in NETWORKS:
        print(f"error: unknown network {args.net!r} "
              f"(have: {', '.join(sorted(NETWORKS))})", file=sys.stderr)
        return 2
    try:
        model = CostModel.load(args.model, backend=args.backend)
    except (OSError, json.JSONDecodeError, KeyError) as e:
        print(f"error: cannot load cost model: {e}", file=sys.stderr)
        return 2
    if model.fallback_from:
        print(f"warning: no fitted cost model for backend "
              f"{model.fallback_from!r} — pricing with {model.backend!r}")

    net = NETWORKS[args.net]()
    result = tune(net, model, batch=args.batch,
                  passes=1 if args.smoke else args.passes)
    print(decision_table(result, model))

    if args.json_out:
        record = {
            "net": result["net"], "batch": result["batch"],
            "tuned_plan": deploy.knobs_to_manifest(result["knobs"]),
            "modelled_us": round(result["cost"].us, 1),
            "default_modelled_us": round(result["default_cost"].us, 1),
            "decisions": result["decisions"],
        }
        with open(args.json_out, "w") as f:
            json.dump(record, f, indent=2, sort_keys=True)

    if args.out:
        return write_and_check(result, model, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
