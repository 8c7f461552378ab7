"""Structured findings of the plan verifier: the port's copy of
``repro.analysis.findings`` (its V1xx rules; the band, VMEM, lint and
sanitizer rules check TPU geometry and Pallas source).

A ``Finding`` is one rule violation: ``severity`` (``error`` — the
configuration is wrong and must not run; ``warning`` — suspect;
``info`` — advisory), the ``step`` it anchors to (a plan step label), the
``rule`` ID, and a human-readable ``detail``.  ``RULES`` is the taxonomy:
every finding's ``rule`` must be a key of it.
"""
from __future__ import annotations

from dataclasses import dataclass

SEVERITIES = ("error", "warning", "info")

#: rule ID -> (pass, one-line summary).  V1xx: shape flow.
RULES = {
    "V101": ("verifier",
             "step output shape disagrees with its re-derivation from the "
             "step's input shape and layer spec"),
    "V102": ("verifier",
             "activation shapes do not chain: a step's input shape is not "
             "the previous step's output shape (or the plan input)"),
    "V103": ("verifier",
             "conv/fc parameter geometry disagrees with infer_param_shapes "
             "(wrong in-channels, kernel, or fc fan-in)"),
}


@dataclass(frozen=True)
class Finding:
    severity: str
    step: str
    rule: str
    detail: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")
        if self.rule not in RULES:
            raise ValueError(f"unknown rule {self.rule!r}")

    def __str__(self) -> str:
        return f"[{self.rule}:{self.severity}] {self.step}: {self.detail}"
