"""Run every kernel of the port under NVIDIA compute-sanitizer on the card.

    PYTHONPATH=src python -m repro_torch.tools.sanitize [--tools LIST] \
        [--json PATH] [--md] [--timeout SECONDS]

The JAX package proves its Pallas kernels by abstract interpretation of
their source (``repro.analysis.sanitizer``); CUDA C++ cannot be proved
that way, so this tool asks the card's own checker.  It runs a case
runner (``--run-cases``, below) once under each of compute-sanitizer's tools and
reads their reports into the port's findings:

* ``memcheck`` — an access outside its allocation: **K101**;
* ``initcheck`` — a read of global memory nothing wrote (an output or a
  scratch element never written): **K102**, with
  ``PYTORCH_NO_CUDA_MEMORY_CACHING=1`` so that each tensor is an
  allocation of its own;
* ``racecheck`` — a shared-memory hazard: **K107**;
* ``synccheck`` — a misused barrier: **K108**;
* **K100** — not analysed: the tool failed, or (racecheck) the kernel
  moves shared memory through the async proxy (TMA loads and ``wgmma``
  reads: ``mm_wgmma``, ``flash_wgmma``), which racecheck does not see.

The case runner launches every kernel once at small shapes: LeNet-5 and
CIFAR-10 forwards at batch 2 under every rung that reaches a kernel (K1,
K7, K8, K9 and K3 in fp32), AlexNet at batch 1 fused (K1, K2) and with
the tuned knobs (K4, K5, K6), K3 in bf16 at M = 4 and 64 (the weight
stream, the wgmma path), K10 in bf16 and fp32 at 256 tokens, and K11 at
256 tokens.  It prints a marker before each case and the kernels the
case launched (the wrappers' counters) after it, so each report is tied
to its case and, through the function it names, to its kernel.

The tool looks for ``compute-sanitizer`` beside ``nvcc`` and on ``PATH``;
without it, it says so and exits 2, as it does when no tool could
analyse the run (a machine whose card the sanitizer does not support).
It exits 1 on an error finding and 0 otherwise (K100 is a warning: not
analysed is not clean).  It is slow
(every access is instrumented), so no smoke phase depends on it.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import (Finding, findings_json,
                                           findings_markdown)

TOOLS = ("memcheck", "initcheck", "racecheck", "synccheck")
#: the rule of a report of each tool
TOOL_RULES = {"memcheck": "K101", "initcheck": "K102", "racecheck": "K107",
              "synccheck": "K108"}
#: each tool's extra arguments
TOOL_ARGS = {"memcheck": ["--leak-check", "no"],
             "initcheck": [],
             "racecheck": ["--racecheck-report", "hazard"],
             "synccheck": []}
#: the port's __global__ functions by kernel (and, for K3 and K10, path)
GLOBALS = {
    "K1": ("stage_major_kernel",), "K2": ("stage_major_kernel",),
    "K4": ("stage_major_kernel",), "K5": ("stage_major_kernel",),
    "K6": ("stage_major_kernel",),
    "K7": ("conv_basic_simd_kernel", "conv_basic_simd_pool_kernel"),
    "K8": ("conv_basic_parallel_kernel",), "K9": ("pool2d_kernel",),
    "K3/stream": ("mm_stream16", "mm_stream32"), "K3/tiles": ("mm_tiled",),
    "K3/wgmma": ("mm_wgmma",), "K10/simt": ("flash_fwd",),
    "K10/wgmma": ("flash_wgmma",),
    "K11": ("wkv6_chunk_state", "wkv6_walk", "wkv6_chunk_out"),
}
#: the units the runner's cases launch (K3's CUDA-core tile path takes
#: fp32 products from 64 rows, which no case has)
COVERED = tuple(u for u in GLOBALS if u != "K3/tiles")
#: kernels whose shared memory is written by TMA and read by wgmma
#: through the async proxy, which racecheck does not track
ASYNC_PROXY = ("mm_wgmma", "flash_wgmma")
CASE_MARK = "SANITIZE-CASE "
RAN_MARK = "SANITIZE-RAN "
PREFIX = "========= "


# -- finding the tool ------------------------------------------------------------


def find_sanitizer() -> Optional[str]:
    """``compute-sanitizer`` beside ``nvcc`` (``_build._nvcc``), else on
    ``PATH``; None when neither has it."""
    from repro_torch.kernels import _build

    try:
        beside = Path(_build._nvcc()).resolve().parent / "compute-sanitizer"
    except RuntimeError:
        beside = None
    if beside is not None and beside.exists():
        return str(beside)
    return shutil.which("compute-sanitizer")


# -- reading a report -------------------------------------------------------------


def _records(text: str):
    """``(case, lines)`` of every report record in the sanitizer's output:
    a ``========= `` line with text at its start opens a record, indented
    ones continue it; the runner's markers set the case."""
    case, rec = None, None
    for line in text.splitlines():
        if line.startswith(CASE_MARK):
            if rec:
                yield rec
            case, rec = line[len(CASE_MARK):].strip(), None
            continue
        if not line.startswith(PREFIX.rstrip()):
            continue
        body = line[len(PREFIX):] if line.startswith(PREFIX) else ""
        if body and not body.startswith(" "):
            if rec:
                yield rec
            rec = (case, [body.strip()])
        elif body.strip() and rec:
            rec[1].append(body.strip())
    if rec:
        yield rec


def _kernel_of(lines: Sequence[str]) -> Optional[str]:
    """The port's __global__ a record names, if any."""
    known = {g for names in GLOBALS.values() for g in names}
    for line in lines:
        for name in re.findall(r"([A-Za-z_]\w*)(?:<[^>]*>)?\(", line):
            if name in known:
                return name
    return None


def parse_report(tool: str, text: str) -> Tuple[List[Finding], bool, list]:
    """``(findings, analysed, ran)``: the report's findings, whether the
    tool analysed the run (it printed its summary and reported no failure
    of its own), and the runner's ``(case, units)`` records.  A hazard or
    error record naming one of the port's kernels is a finding of the
    tool's rule; one naming another kernel, or a CUDA API error, is an
    ``info`` K100 (not the port's launch); a failure of the tool or of
    the runner is a ``warning`` K100."""
    findings: List[Finding] = []
    summary, failed = False, False
    ran = []
    for line in text.splitlines():
        if line.startswith(RAN_MARK):
            case, units = line[len(RAN_MARK):].split(" ", 1)
            ran.append((case, json.loads(units)))
    for case, lines in _records(text):
        head = lines[0]
        where = f"{tool}:{case or '-'}"
        if head.startswith(("ERROR SUMMARY", "RACECHECK SUMMARY",
                            "LEAK SUMMARY")):
            summary = True
            continue
        if head.startswith("COMPUTE-SANITIZER") or head.startswith(
                "Saved host backtrace"):
            continue
        detail = " / ".join(lines[:3])
        if head.startswith("Program hit"):
            findings.append(Finding("info", where, "K100",
                                    f"CUDA API error: {detail}"))
            continue
        kernel = _kernel_of(lines)
        hazard = ("Race reported" in head or head.startswith(
            ("Invalid ", "Uninitialized ", "Barrier error", "Misaligned",
             "Out-of-range", "Address ", "Malloc/Free")))
        if hazard and kernel is not None:
            sev = "warning" if head.startswith("Warning") else "error"
            findings.append(Finding(sev, f"{where}:{kernel}",
                                    TOOL_RULES[tool], detail))
        elif hazard:
            findings.append(Finding("info", where, "K100",
                                    f"a kernel outside the port: {detail}"))
        elif head.startswith(("Error", "Target application")):
            failed = True
            findings.append(Finding("warning", where, "K100",
                                    f"the tool did not analyse: {detail}"))
    if not summary:
        failed = True
        findings.append(Finding("warning", f"{tool}:-", "K100",
                                "the tool printed no summary: the run was "
                                "not analysed"))
    return findings, not failed, ran


def status_table(results: Dict[str, Tuple[List[Finding], bool, list]]):
    """``{unit: {tool: status}}`` for every unit the runner covers:
    ``unanalysed`` where the tool did not analyse the run or cannot see
    the kernel (racecheck and the async proxy), ``finding`` where a report
    names the unit's kernel, ``clean`` where the unit ran with no report,
    ``not run`` where its case did not run."""
    table: Dict[str, Dict[str, str]] = {u: {} for u in COVERED}
    for tool, (findings, analysed, ran) in results.items():
        hit = {f.step.rsplit(":", 1)[-1] for f in findings
               if f.rule == TOOL_RULES[tool]}
        launched = {u for _, units in ran for u in units}
        for unit in table:
            names = set(GLOBALS[unit])
            if not analysed:
                st = "unanalysed"
            elif names & hit:
                st = "finding"
            elif unit not in launched:
                st = "not run"
            elif tool == "racecheck" and names & set(ASYNC_PROXY):
                st = "unanalysed"
            else:
                st = "clean"
            table[unit][tool] = st
    return table


# -- the case runner ------------------------------------------------------------

#: rungs of the CNN cases that reach a kernel: (method, fuse)
RUNGS = (("advanced_simd_8", True), ("advanced_simd_8", False),
         ("basic_simd", True), ("basic_simd", False),
         ("basic_parallel", True))


def _units(counters) -> List[str]:
    """The units launched since the counters were set to 0."""
    conv, pool, mm, attn, wkv = counters
    out = [k for k, fn in conv.items() if fn.launches]
    if pool.launches:
        out.append("K9")
    out += [f"K3/{p}" for p, c in mm.path_launches.items() if c]
    out += [f"K10/{p}" for p, c in attn.path_launches.items() if c]
    if wkv.launches:
        out.append("K11")
    return out


def run_cases(names: Optional[Sequence[str]] = None) -> int:
    """Launch every case once on the card, each between markers."""
    import torch

    from repro_torch.core.engine import CNNEngine
    from repro_torch.core.methods import Method
    from repro_torch.core.netdefs import NETWORKS
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.conv2d import ops as conv_ops
    from repro_torch.kernels.matmul_fused import ops as mm_ops
    from repro_torch.kernels.pool2d import ops as pool_ops
    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    from repro_torch.tools.verify_sweep import TUNED

    dev = torch.device("cuda")
    conv = {"K1": conv_ops.conv2d_pool_fused, "K2": conv_ops.conv2d_chain,
            "K4": conv_ops.conv2d_pool_lrn_halo,
            "K5": conv_ops.conv2d_pool_carry,
            "K6": conv_ops.conv2d_chain_ocb,
            "K7": conv_ops.conv2d_basic_simd,
            "K8": conv_ops.conv2d_basic_parallel}
    counters = (conv, pool_ops.pool2d, mm_ops.matmul_fused,
                attn_ops.flash_attention, wkv6_ops.wkv6)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def cnn(name, batch, method, fuse, knobs=None):
        net = NETWORKS[name]()
        eng = CNNEngine(net, method=Method(method), fuse_pool=fuse,
                        device=dev, **(knobs or {}))
        params = eng.init(torch.Generator().manual_seed(0))
        x = randn(batch, *net.input_shape)
        return lambda: eng.forward(params, x)

    def k3(m):
        x = randn(m, 2304, dtype=torch.bfloat16)
        w = randn(2304, 2048, dtype=torch.bfloat16) * 0.02
        return lambda: mm_ops.matmul_fused(x, w, act="gelu")

    def k10(dt):
        q = randn(1, 256, 8, 256, dtype=dt)
        k, v = (randn(1, 256, 4, 256, dtype=dt) for _ in range(2))
        return lambda: attn_ops.flash_attention(q, k, v, causal=True,
                                                attn_softcap=50.0)

    def k11():
        r, k, v = (randn(1, 256, 8, 64, dtype=torch.bfloat16)
                   for _ in range(3))
        logw = -torch.exp(randn(1, 256, 8, 64) - 1.0)
        u = 0.5 * randn(8, 64)
        return lambda: wkv6_ops.wkv6(r, k, v, logw, u, chunk=64)

    cases = {}
    for name in ("lenet5", "cifar10"):
        for method, fuse in RUNGS:
            tag = f"{name}/{method}/{'fused' if fuse else 'unfused'}"
            cases[tag] = (cnn, (name, 2, method, fuse))
    cases["alexnet/advanced_simd_8/fused/b1"] = (
        cnn, ("alexnet", 1, "advanced_simd_8", True))
    cases["alexnet/tuned/b1"] = (
        cnn, ("alexnet", 1, "advanced_simd_8", True, TUNED))
    cases["k3/bf16/m4"] = (k3, (4,))
    cases["k3/bf16/m64"] = (k3, (64,))
    cases["k10/bfloat16/256"] = (k10, (torch.bfloat16,))
    cases["k10/float32/256"] = (k10, (torch.float32,))
    cases["k11/bfloat16/256"] = (k11, ())
    rc = 0
    with torch.no_grad():
        for name, (make, args) in cases.items():
            if names and name not in names:
                continue
            fn = make(*args)
            for c in conv.values():
                c.launches = 0
            counters[1].launches = counters[4].launches = 0
            for fnc in (counters[2], counters[3]):
                fnc.path_launches = dict.fromkeys(fnc.path_launches, 0)
            print(CASE_MARK + name, flush=True)
            try:
                out = fn()
                torch.cuda.synchronize()
            except RuntimeError as e:  # a refused launch fails the case
                print(f"case {name} failed: {e}", flush=True)
                rc = 1
                continue
            outs = out if isinstance(out, tuple) else (out,)
            if not all(bool(torch.isfinite(o.float()).all()) for o in outs):
                print(f"case {name}: non-finite output", flush=True)
                rc = 1
            print(RAN_MARK + name + " " + json.dumps(_units(counters)),
                  flush=True)
    return rc


# -- the tool ----------------------------------------------------------------------


def run_tool(sanitizer: str, tool: str, timeout: float) -> str:
    """The sanitizer's and the case runner's output for one tool."""
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sanitizer, "--tool", tool, "--print-limit", "100",
           *TOOL_ARGS[tool], sys.executable, "-m",
           "repro_torch.tools.sanitize", "--run-cases"]
    try:
        p = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True, env=env,
                           timeout=timeout)
        return p.stdout + f"\n[exit {p.returncode}]\n"
    except subprocess.TimeoutExpired as e:
        out = e.stdout or ""
        out = out.decode() if isinstance(out, bytes) else out
        return out + f"\n[timed out after {timeout} s]\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tools", default=",".join(TOOLS))
    ap.add_argument("--json", help="write the table, findings and each "
                                   "tool's output here")
    ap.add_argument("--md", action="store_true",
                    help="print the findings as a markdown table")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a tool's run may take")
    ap.add_argument("--run-cases", nargs="*", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.run_cases is not None:
        return run_cases(args.run_cases)
    sanitizer = find_sanitizer()
    if sanitizer is None:
        print("compute-sanitizer not found beside nvcc or on PATH: nothing "
              "was analysed", flush=True)
        return 2
    from repro_torch.kernels import _build

    _build.build()  # once, outside the sanitizer
    version = subprocess.run([sanitizer, "--version"], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True).stdout
    print(version.strip(), flush=True)
    results, outputs = {}, {}
    for tool in args.tools.split(","):
        outputs[tool] = run_tool(sanitizer, tool, args.timeout)
        results[tool] = parse_report(tool, outputs[tool])
        print(f"{tool}: {'analysed' if results[tool][1] else 'NOT analysed'}"
              f", {len(results[tool][2])} cases ran", flush=True)
    findings = [f for r in results.values() for f in r[0]]
    table = status_table(results)
    print("| kernel | " + " | ".join(results) + " |")
    print("| --- |" + " --- |" * len(results))
    for unit in table:
        print(f"| {unit} | " + " | ".join(table[unit][t] for t in results)
              + " |")
    if args.md:
        print(findings_markdown(findings, title="compute-sanitizer"), end="")
    else:
        for f in findings:
            print(f)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"sanitizer": version.strip(), "table": table,
             "findings": json.loads(findings_json(findings)),
             "outputs": outputs}, indent=1))
    if any(f.severity == "error" for f in findings):
        return 1
    return 0 if any(r[1] for r in results.values()) else 2


if __name__ == "__main__":
    sys.exit(main())
