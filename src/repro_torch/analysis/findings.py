"""Structured findings of the port's static analysis: the port's copy of
``repro.analysis.findings``.

A ``Finding`` is one rule violation: ``severity`` (``error`` — the
configuration is wrong and must not run; ``warning`` — explicitly
requested but suspect, or not analysed; ``info`` — advisory), the
``step`` it anchors to (a plan step label for V-rules, ``path:line`` for
R-rules, a case and kernel for K-rules), the ``rule`` ID, and a
human-readable ``detail``.  ``RULES`` is the taxonomy: every finding's
``rule`` must be a key of it.  ``analysis/README.md`` gives, for each
rule, the JAX rule it answers, and the JAX rules with no counterpart.
``PlanVerificationError`` carries a plan's error findings out of
``compile_plan(verify=True)``.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Iterable, List, Sequence

SEVERITIES = ("error", "warning", "info")

#: rule ID -> (pass, one-line summary).  V1xx: shape flow.  V2xx: the
#: CUDA kernels' launch geometry.  V3xx: shared memory, scratch and the
#: cooperative grid.  R0xx: lint of the port's source (AST).  K1xx:
#: launches on the card, checked by NVIDIA compute-sanitizer (K100,
#: K107, K108), by the guard pass (``analysis/guard.py``: K109-K111) or
#: by either (K101, K102).
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
    "V201": ("verifier",
             "the launch's work does not cover every output exactly once: "
             "a stage-major stage's items over (partial, pixel tile, "
             "channel tile) and its chunks, K7's blocks over the pooled "
             "rows of every frame or its tiles over the pixels, K8's tiles "
             "over the pixels and channel tiles, K9's blocks over the "
             "planes (gap or overlap), or scratch regions that overlap"),
    "V203": ("verifier",
             "a band misses rows its windows read: a stage's band_rows "
             "(clipped to the stage's output) do not hold every row the "
             "next stage or the pool reads, or K8's k8_halo_rows are fewer "
             "than its tallest tile reads (under-fetch / off-by-one halo)"),
    "V205": ("verifier",
             "a packed array the kernel reads (pack_geo's geo, "
             "pack_chain_plan's plan, K7's tail of groups and ring offset, "
             "K8's dims, K6's tile) disagrees field by field with the "
             "geometry it was packed from"),
    "V301": ("verifier",
             "a block's dynamic shared memory exceeds the card's 227-KB "
             "opt-in limit (the stage-major CH_SMEM, K7's k7_smem, K8's "
             "two stages), or the LRN tail holds more channels than the "
             "stage-major shared memory"),
    "V302": ("verifier",
             "the stage-major scratch is past the kernel's 32-bit float "
             "offsets (CH_SCRATCH_LIMIT), or a tap or chunk unit's "
             "partials exceed CH_PARTIAL_BYTES"),
    "V303": ("verifier",
             "the launch has no geometry for the step: even its smallest "
             "(K7 at one tile group, K8 at one channel) does not fit, or "
             "its cell cannot take the step (K6 with an LRN tail) — the "
             "planner should not have admitted it"),
    "V304": ("verifier",
             "the stage-major cooperative grid (CH_MIN_BLOCKS x the SMs) "
             "needs more resident blocks an SM than the kernel's shared "
             "memory and threads allow"),
    "R001": ("lint",
             "a call into _build.library() must pass its return code to "
             "_build.check (a refused launch never runs, and a later "
             "synchronize would not say so)"),
    "R002": ("lint",
             "engine knob mutation paths must invalidate the plan/jit/"
             "bucket caches (knob name mismatch, _KnobDict mutator not "
             "calling _on_change, or clear_caches missing a cache)"),
    "R004": ("lint",
             "silent exception handler: bare/broad except whose body is "
             "only pass"),
    "R005": ("lint",
             "magic-number byte budget in a comparison — use the named "
             "kernel budget constants"),
    "R006": ("lint",
             "serving/ except handler swallows a supervisor error: it "
             "must re-raise, reference its bound exception, or record a "
             "typed failure result (FailedResult/ShedResult/...)"),
    "R007": ("lint",
             "a plain version under kernels/ converts with .to(...) to an "
             "inline float dtype: accumulation must target the named "
             "ACC_DTYPE constant or a tensor's .dtype"),
    "R008": ("lint",
             "a wrapper under kernels/*/ops.py that calls _build.library() "
             "allocates a tensor with torch.empty, zeros, empty_like or "
             "zeros_like instead of common.alloc (the guard pass's hook)"),
    "K100": ("sanitizer",
             "compute-sanitizer could not analyse a launch (the tool "
             "failed, or cannot see the kernel's accesses: TMA and wgmma "
             "traffic through the async proxy under racecheck) — "
             "unanalysed, not clean"),
    "K101": ("sanitizer",
             "a kernel accessed memory outside its operand: memcheck (out "
             "of bounds or misaligned, global or shared) or the guard pass "
             "(a guard band written, or read: the result changes with the "
             "bands' contents)"),
    "K102": ("sanitizer",
             "an output not covered: initcheck (global memory read that "
             "nothing wrote) or the guard pass (an output element never "
             "written, or an output or its scratch read before it was "
             "written)"),
    "K107": ("sanitizer",
             "racecheck: a shared-memory hazard between threads of a "
             "block (read/write ordering without a barrier)"),
    "K108": ("sanitizer",
             "synccheck: a barrier misused (a block, grid or cluster "
             "barrier in divergent code, or an invalid barrier)"),
    "K109": ("guard",
             "a kernel wrote to an input: a byte of an operand it only "
             "reads changed"),
    "K110": ("guard",
             "a launch is not bit for bit repeatable: a repeat under the "
             "same conditions differs (the determinism contract; a race), "
             "or the result depends on where the buffers sit"),
    "K111": ("guard",
             "a pointer a wrapper hands its C entry (or an element of a "
             "pointer array) lies in no buffer the guard pass staged: the "
             "pass is incomplete"),
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


class PlanVerificationError(ValueError):
    """Raised by ``compile_plan(verify=True)`` on error-severity findings.
    A ``ValueError``, so call sites that guard deployment artifacts with
    ``except ValueError`` treat it as they treat a checksum fault; the
    findings stay on ``.findings``."""

    def __init__(self, findings: Sequence[Finding]):
        self.findings = list(findings)
        detail = "; ".join(str(f) for f in self.findings)
        super().__init__(
            f"plan verification failed with {len(self.findings)} "
            f"error finding(s): {detail}")


def findings_json(findings: Iterable[Finding]) -> str:
    return json.dumps([asdict(f) for f in findings], indent=2)


def findings_markdown(findings: Iterable[Finding],
                      title: str = "Findings") -> str:
    """A GitHub-flavored markdown table (piped into CI step summaries)."""
    rows: List[Finding] = list(findings)
    out = [f"### {title}", ""]
    if not rows:
        out.append("No findings.")
        return "\n".join(out) + "\n"
    out += ["| severity | rule | where | detail |",
            "| --- | --- | --- | --- |"]
    for f in rows:
        detail = f.detail.replace("|", "\\|")
        out.append(f"| {f.severity} | {f.rule} | `{f.step}` | {detail} |")
    return "\n".join(out) + "\n"
