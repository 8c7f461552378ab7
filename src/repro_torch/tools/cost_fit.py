"""Fit the port's cost model on measured network-ladder rows: the port of
``benchmarks/cost_fit.py``.

Every ladder row (network × method × fused/unfused) becomes one
calibration point: its plan is compiled as the row ran it,
``repro_torch.core.cost`` extracts the aggregate features (per-bucket
FLOPs, bytes streamed, launches), and the measured ``us_per_call`` is
the target.  A deterministic fit/holdout split (points sorted by id,
every ``--holdout-every``-th held out) keeps the reported rank
correlation honest: ``spearman_holdout`` is computed on points the
solver never saw.

The rows are in the schema of the JAX package's ``BENCH_network.json``
(``backend``, ``batch``, ``networks.<net>.rows[{method, fused|unfused:
{us_per_call}}]``), so a JAX bench file fits here too.  On the card they
come from ``measure_ladder``, which times every net × method × fused and
unfused (where the method fuses) with ``CNNEngine.time_forward``,
round-robin over the rows:

    python -m repro_torch.tools.cost_fit --measure --batch 16 --iters 40 \\
        --holdout-every 0 --out src/repro_torch/core/COST_MODEL.json

(the committed model's command.  On the card's steady-state rows a fit
on two thirds of the 24 points leaves each method's bucket two rows or
fewer; the solver then charges AlexNet's time to the bytes column and
prunes an advanced method's column to the largest coefficient.  The
smoke's fresh rows are the held-out check instead.)

The fitted coefficients land under their backend key (other backends'
entries are kept), with ``fitted_from`` recording the card, its power
limit, the torch and CUDA versions and the measured rows themselves, so
the fit can be redone offline (``fit_model(fitted_from["ladder"],
validation["holdout_every"])``).
"""
from __future__ import annotations

import argparse
import gc
from dataclasses import replace
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.cost import (DEFAULT_MODEL_PATH, CostModel,
                                   fit_coefficients, fused_flop_key,
                                   plan_cost, spearman)
from repro_torch.core.engine import CNNEngine
from repro_torch.core.fusion import fusion_summary
from repro_torch.core.methods import LADDER, Method
from repro_torch.core.netdefs import NETWORKS
from repro_torch.core.plan import compile_plan
from repro_torch.kernels.common import resolve_device

COST_MODEL_FORMAT_VERSION = 1


def bench_backend(bench: Mapping) -> str:
    """The backend the rows were measured on (``cpu`` when unnamed, as in
    the JAX package).  The port's plans have no Pallas switch, so unlike
    JAX's this returns the name alone."""
    return bench.get("backend", "cpu")


def ladder_points(bench: Mapping) -> List[Dict]:
    """One calibration point per measured ladder row-variant, its features
    extracted from the plan the row ran.  Rows measured on a card also
    carry the plan's host operations (``PlanCost.host_ops``): there the
    host only enqueues the work, and a small net's rows follow it.  On
    the CPU every wrapper runs its plain version in the host's own
    thread, so the count does not describe the work, and the points are
    the JAX package's."""
    batch = int(bench["batch"])
    host = bench_backend(bench) != "cpu"
    pts: List[Dict] = []
    for net_name in sorted(bench["networks"]):
        net = NETWORKS[net_name]()
        for row in bench["networks"][net_name]["rows"]:
            method = Method(row["method"])
            for variant, fuse in (("unfused", False), ("fused", True)):
                r = row.get(variant)
                if not r:
                    continue
                pc = plan_cost(compile_plan(net, method=method, fuse=fuse),
                               batch=batch)
                pts.append({
                    "id": f"{net_name}/{method.value}/{variant}",
                    # the per-step buckets plan_cost prices (what the
                    # validator and the model's rho see)
                    "flops_by_key": pc.flops_by_key,
                    # the solver's view: the row's total flops under the
                    # row's method(:fused) bucket.  A whole-ladder row
                    # runs every layer under one method, so an fc column
                    # of its own is collinear with the method columns;
                    # the fc coefficient is pinned after the fit instead
                    "fit_flops_by_key": {
                        fused_flop_key(method) if fuse else method.value:
                        pc.flops},
                    "hbm_bytes": pc.hbm_bytes,
                    "dispatches": pc.dispatches,
                    **({"host_ops": pc.host_ops} if host else {}),
                    "us": float(r["us_per_call"]),
                })
    return pts


def split_points(pts: List[Dict],
                 holdout_every: int = 3) -> Tuple[List[Dict], List[Dict]]:
    """Deterministic fit/holdout split: sorted by id, every
    ``holdout_every``-th point held out (0 disables the holdout)."""
    pts = sorted(pts, key=lambda p: p["id"])
    if holdout_every <= 0:
        return pts, []
    fit, hold = [], []
    for i, p in enumerate(pts):
        (hold if i % holdout_every == holdout_every - 1 else fit).append(p)
    return fit, hold


def _rho(model: CostModel, pts: List[Dict]) -> float:
    pred = [model.predict(p["flops_by_key"], p["hbm_bytes"],
                          p["dispatches"], p.get("host_ops", 0))
            for p in pts]
    return spearman(pred, [p["us"] for p in pts])


def fit_model(bench: Mapping, holdout_every: int = 3) -> Tuple[CostModel,
                                                               Dict]:
    """Fit on the split's fit points; validate rank fidelity on the fit
    set, the holdout set and all points.  Returns the model and the
    validation record that ships inside COST_MODEL.json."""
    backend = bench_backend(bench)
    pts = ladder_points(bench)
    fit_pts, hold_pts = split_points(pts, holdout_every)
    model = fit_coefficients(
        [{**p, "flops_by_key": p["fit_flops_by_key"]} for p in fit_pts],
        backend=backend)
    # pin the buckets the collapsed fit cannot see: fc and the
    # pool/lrn/softmax tail are priced as the advanced per-layer path (both
    # small slices of any row; the max-fitted fallback would let them
    # dominate)
    coeffs = dict(model.us_per_gflop)
    coeffs["fc"] = coeffs["other"] = coeffs[Method.ADVANCED_SIMD_8.value]
    model = replace(model, us_per_gflop=coeffs)
    validation = {
        "points": len(pts),
        "fit_points": len(fit_pts),
        "holdout_points": len(hold_pts),
        "holdout_every": holdout_every,
        "spearman_fit": round(_rho(model, fit_pts), 4),
        "spearman_holdout": (round(_rho(model, hold_pts), 4)
                             if len(hold_pts) >= 2 else None),
        "spearman_all": round(_rho(model, pts), 4),
    }
    return model, validation


def measure_ladder(nets: Sequence[str], batch: int, iters: int,
                   device=None, params: Optional[Mapping] = None,
                   seed: int = 0) -> Dict:
    """The ladder rows ``fit_model`` reads, measured on ``device`` (cuda
    unless given): for every net × ``Method``, the unfused forward and,
    where the method forms a fused group, the fused one.  Every row first
    runs once untimed (its kernels built, its weights converted); then
    each row is the mean of ``iters`` readings of ``CNNEngine.
    time_forward(iters=1)`` (one warm-up call, then one timed call, the
    card synchronized after each), taken round-robin over all the rows
    with Python's garbage collector paused, so that a drift of the host's
    speed falls on every row alike rather than on the rows measured
    while it lasts.  ``params`` maps a net's name to its parameters on
    ``device`` (default: ``CNNEngine.init`` from ``seed``); the frames
    are drawn from ``seed`` + 1."""
    dev = resolve_device(device)
    out = {"bench": "network_ladder", "batch": batch, "iters": iters,
           "backend": dev.type, "networks": {}}
    cases = []  # (net name, row, variant, engine, params, frames, fuse)
    for name in nets:
        net = NETWORKS[name]()
        if params is not None and name in params:
            p = params[name]
        else:
            p = CNNEngine(net, device=dev).init(
                torch.Generator().manual_seed(seed))
        x = torch.randn((batch, *net.input_shape),
                        generator=torch.Generator().manual_seed(seed + 1)
                        ).to(dev)
        rows = []
        for method in LADDER:
            eng = CNNEngine(net, method=method, device=dev)
            row = {"method": method.value}
            rows.append(row)
            cases.append((row, "unfused", eng, p, x, False))
            if fusion_summary(eng.plan(True)):
                cases.append((row, "fused", eng, p, x, True))
        out["networks"][name] = {"rows": rows,
                                 "input_shape": list(net.input_shape)}
    for _, _, eng, p, x, fuse in cases:
        eng.forward(p, x, fuse=fuse)
    sums = [0.0] * len(cases)
    gc.collect()
    gc.disable()
    try:
        for _ in range(iters):
            for i, (_, _, eng, p, x, fuse) in enumerate(cases):
                sums[i] += eng.time_forward(p, x, 1, fuse=fuse)
    finally:
        gc.enable()
    for (row, variant, *_), total in zip(cases, sums):
        row[variant] = {"us_per_call": 1e6 * total / iters}
    return out


def card() -> str:
    """``name, power limit`` of the card, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("bench", nargs="?", default=None,
                    help="ladder rows to fit (BENCH_network.json schema); "
                         "or --measure")
    ap.add_argument("--measure", action="store_true",
                    help="measure the ladder on the device first")
    ap.add_argument("--device", default=None,
                    help="device --measure runs on (default cuda)")
    ap.add_argument("--nets", default=",".join(sorted(NETWORKS)),
                    help="comma-separated nets --measure times")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=40,
                    help="readings a row is the mean of (round-robin)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(DEFAULT_MODEL_PATH),
                    help="cost-model file to write (entries for other "
                         "backends are kept)")
    ap.add_argument("--holdout-every", type=int, default=3,
                    help="hold out every N-th point for validation "
                         "(0 = fit on everything)")
    args = ap.parse_args(argv)

    if args.measure:
        nets = [n for n in args.nets.split(",") if n]
        unknown = [n for n in nets if n not in NETWORKS]
        if unknown:
            print(f"error: unknown network(s) {unknown}", file=sys.stderr)
            return 2
        bench = measure_ladder(nets, args.batch, args.iters, args.device,
                               seed=args.seed)
        source = {"measured": "repro_torch.tools.cost_fit --measure",
                  "torch": torch.__version__, "cuda": torch.version.cuda,
                  "seed": args.seed}
        if bench["backend"] == "cuda":
            source["card"] = card()
            source["device"] = torch.cuda.get_device_name(0)
    elif args.bench is not None:
        try:
            with open(args.bench) as f:
                bench = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"error: cannot read bench file {args.bench}: {e}",
                  file=sys.stderr)
            return 2
        source = {"bench": args.bench}
    else:
        print("error: give a bench file or --measure", file=sys.stderr)
        return 2

    model, validation = fit_model(bench, args.holdout_every)
    entry = model.to_dict()
    entry["fitted_from"] = {
        **source,
        "nets": sorted(bench["networks"]),
        "batch": bench.get("batch"),
        "iters": bench.get("iters"),
        "ladder": bench,
    }
    entry["validation"] = validation

    out_path = Path(args.out)
    data = {"format_version": COST_MODEL_FORMAT_VERSION, "backends": {}}
    if out_path.exists():
        try:
            data = json.loads(out_path.read_text())
        except json.JSONDecodeError:
            print(f"warning: overwriting unreadable {args.out}",
                  file=sys.stderr)
    data.setdefault("backends", {})[model.backend] = entry
    out_path.write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")

    for net, rec in bench["networks"].items():
        for row in rec["rows"]:
            for variant in ("unfused", "fused"):
                if variant in row:
                    print(f"row {net}/{row['method']}/{variant} "
                          f"{row[variant]['us_per_call']:.1f} us")
    print(f"fitted backend={model.backend} from {validation['fit_points']} "
          f"points (holdout {validation['holdout_points']})")
    print(f"  spearman fit={validation['spearman_fit']} "
          f"holdout={validation['spearman_holdout']} "
          f"all={validation['spearman_all']}")
    print(f"  us_per_gflop={ {k: round(v, 3) for k, v in model.us_per_gflop.items()} }")
    print(f"  us_per_gb={model.us_per_gb:.4f} "
          f"dispatch_us={model.dispatch_us:.4f} "
          f"host_op_us={model.host_op_us:.4f}")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
