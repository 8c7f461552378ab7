"""Cost-model accuracy gate, predicted against measured rank correlation:
the port of ``tools/cost_validate.py``.

For every ladder row of a measured bench (``BENCH_network.json``
schema; net × method × fused/unfused), compile the plan the row ran,
price it with the port's committed model (``repro_torch/core/
COST_MODEL.json``, the bench's backend) and compute the Spearman rank
correlation between predicted and measured ``us_per_call`` over all
rows.  The model's job is to order candidate plans for the autotuner:
rank fidelity is the contract, not absolute microseconds.

    python -m repro_torch.tools.cost_validate ROWS.json --threshold 0.8 --md

Exit codes: 0 = rank correlation meets the threshold (or --warn-only);
1 = below threshold; 2 = unreadable inputs.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from repro_torch.core.cost import CostModel, spearman
from repro_torch.tools.cost_fit import bench_backend, ladder_points


def validate(bench: dict, model: CostModel) -> dict:
    """Predicted-against-measured record for every ladder row, plus the
    overall and per-network Spearman rank correlations."""
    rows = []
    for p in ladder_points(bench):
        pred = model.predict(p["flops_by_key"], p["hbm_bytes"],
                             p["dispatches"])
        rows.append({"id": p["id"], "predicted_us": pred,
                     "measured_us": p["us"]})
    rho = spearman([r["predicted_us"] for r in rows],
                   [r["measured_us"] for r in rows])
    per_net = {}
    for net in sorted({r["id"].split("/")[0] for r in rows}):
        sub = [r for r in rows if r["id"].split("/")[0] == net]
        per_net[net] = spearman([r["predicted_us"] for r in sub],
                                [r["measured_us"] for r in sub])
    return {"rows": rows, "spearman": rho, "per_network": per_net}


def markdown(report: dict, threshold: float, backend: str,
             fallback_from: Optional[str] = None) -> str:
    ok = report["spearman"] >= threshold
    lines = [f"### Cost-model accuracy gate (backend `{backend}`)", ""]
    if fallback_from:
        lines += [f"> **Note**: bench measured backend `{fallback_from}` "
                  f"has no fitted coefficients — validated against the "
                  f"`{backend}` model (cross-backend fallback).", ""]
    lines += [f"Spearman rank correlation over {len(report['rows'])} bench "
              f"rows: **{report['spearman']:.4f}** "
              f"(threshold {threshold}) — "
              f"{'PASS' if ok else '**FAIL**'}", ""]
    for net, rho in report["per_network"].items():
        lines.append(f"- `{net}`: {rho:.4f}")
    lines += ["", "| row | predicted us | measured us | ratio |",
              "|---|---:|---:|---:|"]
    for r in sorted(report["rows"], key=lambda r: r["measured_us"]):
        ratio = (r["predicted_us"] / r["measured_us"]
                 if r["measured_us"] else float("inf"))
        lines.append(f"| {r['id']} | {r['predicted_us']:.1f} "
                     f"| {r['measured_us']:.1f} | {ratio:.2f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("bench", help="measured ladder rows to validate against")
    ap.add_argument("--model", default=None,
                    help="COST_MODEL.json path (default: the port's)")
    ap.add_argument("--threshold", type=float, default=0.8,
                    help="minimum acceptable Spearman rank correlation")
    ap.add_argument("--warn-only", action="store_true",
                    help="report a failure but exit 0")
    ap.add_argument("--md", action="store_true",
                    help="print the full markdown table (else a summary "
                         "line)")
    args = ap.parse_args(argv)

    try:
        with open(args.bench) as f:
            bench = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"error: cannot read bench file {args.bench}: {e}",
              file=sys.stderr)
        return 2
    try:
        model = CostModel.load(args.model, backend=bench_backend(bench))
    except (OSError, json.JSONDecodeError, KeyError) as e:
        print(f"error: cannot load cost model: {e}", file=sys.stderr)
        return 2
    if model.fallback_from:
        print(f"warning: no fitted cost model for backend "
              f"{model.fallback_from!r} — validating the {model.backend!r} "
              f"coefficients (ranks usually transfer; magnitudes do not)")

    report = validate(bench, model)
    if args.md:
        print(markdown(report, args.threshold, model.backend,
                       model.fallback_from))
    else:
        fb = (f" [fallback from {model.fallback_from}]"
              if model.fallback_from else "")
        print(f"cost-model spearman={report['spearman']:.4f} over "
              f"{len(report['rows'])} rows (threshold {args.threshold}) "
              f"backend={model.backend}{fb}")
    if report["spearman"] >= args.threshold:
        return 0
    msg = (f"cost model rank correlation {report['spearman']:.4f} below "
           f"threshold {args.threshold} — refit with "
           f"repro_torch.tools.cost_fit")
    if args.warn_only:
        print(f"warning: {msg}")
        return 0
    print(f"error: {msg}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
