"""Verify every bundled netdef across the knob grid: the tier-1 gate.

    PYTHONPATH=src python -m repro_torch.tools.verify_sweep [--json | --md]

Compiles each network in ``repro_torch.core.netdefs.NETWORKS`` under
every method that reaches a conv kernel (``basic_parallel``,
``basic_simd``, ``advanced_simd_4``, ``advanced_simd_8``) × fuse on and
off, plus the forced second-generation knob sets of ``EXTRA_CONFIGS``
(the pool carry, the oc-blocked LRN cell, the oc-blocked chain, and the
tuned AlexNet deployment ``chip_smoke.py`` runs) — plans only, nothing
launches — and runs ``repro_torch.analysis.verifier.verify_plan`` over
each at every batch from 1 to 16 on 132 SMs.  Exits 1 on any finding of
any severity: the bundled networks are the reference configurations and
must verify spotless.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.findings import (Finding, findings_json,
                                           findings_markdown)
from repro_torch.analysis.verifier import DEFAULT_SMS, verify_plan
from repro_torch.core.methods import Method
from repro_torch.core.netdefs import NETWORKS
from repro_torch.core.plan import compile_plan

METHODS = (Method.BASIC_PARALLEL, Method.BASIC_SIMD, Method.ADVANCED_SIMD_4,
           Method.ADVANCED_SIMD_8)
BATCHES = tuple(range(1, 17))

#: the tuned AlexNet deployment of ``chip_smoke.py`` (its ``TUNED``):
#: conv1+pool1 on the pool carry (K5), conv2+pool2+norm2 on the
#: oc-blocked LRN cell (K4), conv3-5+pool5 on the oc-blocked chain (K6)
TUNED = {"per_layer_fuse": {"norm1": False},
         "per_layer_pool_carry": {"conv1": True},
         "per_layer_lrn_oc_block": {"conv2": True},
         "per_layer_oc_block_final": {"conv5": 8}}

#: forced second-generation configurations appended to the grid: the
#: JAX tool's (pool carry with the LRNs unfused, the oc-blocked LRN cell,
#: the oc-blocked chain final stage) and the tuned deployment.  Each
#: entry is (network, method, compile_plan knobs, tag suffix).
EXTRA_CONFIGS = (
    ("alexnet", Method.ADVANCED_SIMD_8,
     dict(per_layer_fuse={"norm1": False, "norm2": False},
          per_layer_pool_carry={"conv1": True, "conv2": True}), "carry"),
    ("alexnet", Method.ADVANCED_SIMD_4,
     dict(per_layer_fuse={"norm1": False, "norm2": False},
          per_layer_pool_carry={"conv1": True, "conv2": True}), "carry"),
    ("alexnet", Method.ADVANCED_SIMD_8,
     dict(per_layer_lrn_oc_block={"conv1": True, "conv2": True}),
     "lrn-oc-block"),
    ("alexnet", Method.ADVANCED_SIMD_4,
     dict(per_layer_lrn_oc_block={"conv1": True, "conv2": True}),
     "lrn-oc-block"),
    ("alexnet", Method.ADVANCED_SIMD_8,
     dict(per_layer_oc_block_final={"conv5": 8}), "oc-block-final"),
    ("alexnet", Method.ADVANCED_SIMD_4,
     dict(per_layer_oc_block_final={"conv5": 4}), "oc-block-final"),
    ("alexnet", Method.ADVANCED_SIMD_8, TUNED, "tuned"),
)


def sweep(networks=None, batches=BATCHES, sms: int = DEFAULT_SMS):
    """``(findings, configurations)`` over every (network × method ×
    fuse) and ``EXTRA_CONFIGS``.  ``networks`` maps name -> NetworkDef
    factory (default ``NETWORKS``; tests inject seeded defects)."""
    if networks is None:
        networks = NETWORKS
    configs = [(name, method, dict(fuse=fuse), f"fuse={fuse}")
               for name in sorted(networks) for method in METHODS
               for fuse in (False, True)]
    configs += [(name, method, dict(fuse=True, **knobs), f"fuse=True/{tag}")
                for name, method, knobs, tag in EXTRA_CONFIGS
                if name in networks]
    findings = []
    for name, method, knobs, tag in configs:
        plan = compile_plan(networks[name](), method=method, verify=False,
                            **knobs)
        for f in verify_plan(plan, batches=batches, sms=sms):
            findings.append(Finding(f.severity,
                                    f"{name}/{method.value}/{tag}::{f.step}",
                                    f.rule, f.detail))
    return findings, len(configs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--md", action="store_true")
    args = ap.parse_args(argv)

    findings, combos = sweep()
    title = (f"Plan verifier sweep — {combos} configurations at batches "
             f"{BATCHES[0]}-{BATCHES[-1]} on {DEFAULT_SMS} SMs, "
             f"{len(findings)} finding(s)")
    if args.json:
        print(findings_json(findings))
    elif args.md:
        print(findings_markdown(findings, title=title), end="")
    else:
        for f in findings:
            print(f)
        print(title)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
