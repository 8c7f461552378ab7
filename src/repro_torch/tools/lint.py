"""Run the port's lint pass (R-rules): the tier-1 gate and a local check.

    PYTHONPATH=src python -m repro_torch.tools.lint [--json | --md] \
        [--fail-on-findings] [paths ...]

Lints the ``repro_torch`` package (wherever it is imported from) unless
``paths`` name other files or directories.  ``--fail-on-findings`` exits
1 when anything at all is reported.  Rule taxonomy:
``src/repro_torch/analysis/README.md``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.findings import findings_json, findings_markdown
from repro_torch.analysis.lint import lint_file, lint_tree

#: the package itself
DEFAULT_PATH = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="*",
                    help=f"files or directories to lint (default "
                         f"{DEFAULT_PATH})")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON")
    ap.add_argument("--md", action="store_true",
                    help="emit findings as a markdown table")
    ap.add_argument("--fail-on-findings", action="store_true",
                    help="exit 1 if any finding is reported")
    args = ap.parse_args(argv)

    findings = []
    for p in (args.paths or [DEFAULT_PATH]):
        path = Path(p)
        if path.is_dir():
            findings += lint_tree(path)
        else:
            findings += lint_file(path)

    if args.json:
        print(findings_json(findings))
    elif args.md:
        print(findings_markdown(findings, title="Port lint"), end="")
    else:
        for f in findings:
            print(f)
        print(f"{len(findings)} finding(s)")
    return 1 if (args.fail_on_findings and findings) else 0


if __name__ == "__main__":
    sys.exit(main())
