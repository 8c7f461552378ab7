"""Check every kernel of the port on the card: the guard pass, then NVIDIA
compute-sanitizer.

    PYTHONPATH=src python -m repro_torch.tools.sanitize [--tools LIST] \
        [--json PATH] [--md] [--timeout SECONDS]

The JAX package proves its Pallas kernels by abstract interpretation of
their source (``repro.analysis.sanitizer``); CUDA C++ cannot be proved
that way, so this tool checks launches on the card.  ``--tools`` (default
``guard`` and compute-sanitizer's four) names the checks:

* ``guard`` — the guard pass (``repro_torch.analysis.guard``) over every
  case (``cases``, below), in this process: each case run four times in
  guard mode and once unguarded, its launches' guard bands, inputs and
  outputs compared — K101 (a band written or read), K102 (an output
  element never written, or read before it was written), K109 (an input
  written), K110 (a launch not bit for bit repeatable) and K111 (a
  pointer the pass did not stage).  It needs only the card.

Then it runs the case runner (``--run-cases``, below) once under each of
compute-sanitizer's tools and reads their reports into the port's
findings:

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

The cases (``cases``) launch every unit of ``GLOBALS`` at the main
path's shapes and ragged ones: the CNN forwards on six rungs at batch 1
and 3, AlexNet at 16 and the tuned deployment (K1, K2, K4-K9, K3 in
fp32), K3 in bf16 at every row count from the weight stream's 1 to the
wgmma tiles' 1500 (N = 8384 among them), with a bias, its backward, fp32
on the CUDA-core tiles (``mm_tiled``), K10 from 16 to 4096 tokens at
head_dim 64, 128 and 256, windowed, soft-capped, grouped and not, causal
and not, with m and l and in fp32, and K11 at 16 to 1500 tokens in bf16
and fp32.  The runner prints a marker before each case and the kernels
the case launched (the wrappers' counters) after it, so each report is
tied to its case and, through the function it names, to its kernel.

The tool looks for ``compute-sanitizer`` beside ``nvcc`` and on
``PATH``; without it (or on a card it does not support) its tools
analyse nothing.  The tool exits 1 on an error finding, 0 when a check
analysed the run (the guard pass or a compute-sanitizer tool) and 2 when
none did (K100 is a warning: not analysed is not clean).
compute-sanitizer is slow (every access is instrumented), so no smoke
phase depends on it; the guard pass is the smoke's phase 5d.
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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import (Finding, findings_json,
                                           findings_markdown)

TOOLS = ("memcheck", "initcheck", "racecheck", "synccheck")
#: the guard pass's entry in the tool list
GUARD = "guard"
#: the checks the tool runs by default, the guard pass first
DEFAULT_TOOLS = (GUARD,) + TOOLS
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
#: the units the cases launch: every one
COVERED = tuple(GLOBALS)
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
    names the unit's kernel (the guard pass: where an error finding names
    the unit), ``clean`` where the unit ran with no report, ``not run``
    where its case did not run."""
    table: Dict[str, Dict[str, str]] = {u: {} for u in COVERED}
    for tool, (findings, analysed, ran) in results.items():
        if tool == GUARD:
            hit = {f.step.rsplit(":", 1)[-1] for f in findings
                   if f.severity == "error"}
        else:
            hit = {f.step.rsplit(":", 1)[-1] for f in findings
                   if f.rule == TOOL_RULES[tool]}
        launched = {u for _, units in ran for u in units}
        for unit in table:
            names = {unit} if tool == GUARD else set(GLOBALS[unit])
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


# -- the cases ------------------------------------------------------------------

#: rungs of the CNN cases: (method, fuse), the smoke's six
RUNGS = (("advanced_simd_8", True), ("advanced_simd_8", False),
         ("basic_simd", True), ("basic_simd", False),
         ("basic_parallel", True), ("seq_ref", True))
CNN_BATCHES = (1, 3)
#: K3 bf16 products: (name, K, N, activation, bias) and their rows
K3_SHAPES = (("gate", 2304, 9216, "gelu", False),
             ("in_proj", 2048, 8384, "none", False))
K3_ROWS = (1, 4, 16, 17, 48, 63, 64, 65, 300, 1500)
#: K3 bf16 products where the weight stream takes one K slice on 132 SMs
#: (no cluster reduction) and wgmma's widest N: (name, K, N, activation,
#: bias, rows) — starcoder2-15b's up, qwen1.5-32b's gate
K3_ONE_SLICE = (("starcoder2_up+bias", 6144, 24576, "gelu", True, (4,)),
                ("qwen1.5_gate", 5120, 27392, "silu", False, (4, 300)))
#: K10 cases: (sq, skv, heads, kv heads, head_dim, causal, window, cap,
#: dtype); skv None: sq
K10_CASES = (
    [(s, None, 8, 4, 256, True, 4096, 50.0, "bfloat16")
     for s in (16, 37, 300, 1500)]                         # gemma2
    + [(s, None, 8, 4, 256, True, 0, 0.0, "bfloat16") for s in (300, 1500)]
    + [(s, None, 32, 4, 128, True, 0, 0.0, "bfloat16")
       for s in (37, 300, 1500)]                           # qwen3-moe
    + [(s, None, 16, 16, 64, True, 0, 0.0, "bfloat16") for s in (37, 300)]
    + [(300, None, 48, 4, 128, True, 4096, 0.0, "bfloat16")]  # starcoder2
    + [(1500, None, 32, 32, 128, True, 0, 0.0, "bfloat16")]  # zamba2
    + [(300, 6400, 32, 8, 128, False, 0, 0.0, "bfloat16"),   # llama cross
       (4096, None, 16, 16, 64, False, 0, 0.0, "bfloat16")]  # seamless
    + [(s, None, 8, 4, 256, True, 4096, 50.0, "float32") for s in (37, 256)])
K11_ROWS = (16, 37, 300, 1500)
K11_HEADS = 32


def cases(dev) -> Dict[str, Callable]:
    """The runner's cases by name: each a function that builds its inputs
    (seeded, on ``dev``) and returns a function that launches the case and
    returns its outputs.  Together they launch every unit of ``GLOBALS``
    at the main path's shapes and ragged ones: the CNN forwards on every
    rung at batch 1 and 3, AlexNet at 16, the tuned deployment (K4, K5,
    K6 at ``oc_block_final`` 8 and 64); K3 in bf16 at gemma2's gate and
    zamba2's in_proj (N = 8384: a half-empty last wgmma tile) for every
    row count of ``K3_ROWS``, ``K3_ONE_SLICE`` (the stream's one K slice,
    N = 27392 on wgmma), seamless's ``w_up`` with a bias, relu and
    silu, ``MatmulFusedFn``'s dx and dw at M = 4096, K3 in fp32 on the
    CUDA-core tiles at M = 64 and 65 and AlexNet's fc6-fc8 on the stream;
    K10 (``K10_CASES``, and its launch with m and l at 2 x 2048); K11 at
    ``K11_ROWS`` tokens in bf16 and fp32 with an input state."""
    import torch

    from repro_torch.core.engine import CNNEngine
    from repro_torch.core.methods import Method
    from repro_torch.core.netdefs import NETWORKS
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.matmul_fused import ops as mm_ops
    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    from repro_torch.tools.verify_sweep import TUNED

    params = {}

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    def randn(g, *shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(dtype)

    def cnn(name, batch, method, fuse, knobs=None):
        def make():
            net = NETWORKS[name]()
            eng = CNNEngine(net, method=Method(method), fuse_pool=fuse,
                            device=dev, **(knobs or {}))
            if name not in params:
                p = eng.init(torch.Generator().manual_seed(0))
                g = gen()
                for layer in p.values():  # nonzero biases
                    layer["b"].copy_(randn(g, *layer["b"].shape, scale=0.1))
                params[name] = p
            x = randn(gen(), batch, *net.input_shape)
            return lambda: eng.forward(params[name], x)
        return make

    def k3(m, kk, n, act, bias, dtype=torch.bfloat16):
        def make():
            g = gen()
            x = randn(g, m, kk, dtype=dtype)
            w = randn(g, kk, n, dtype=dtype, scale=kk ** -0.5)
            b = randn(g, n, scale=0.1) if bias else None
            return lambda: mm_ops.matmul_fused(x, w, b, act=act)
        return make

    def k3_grad(m, kk, n):
        def make():
            g = gen()
            x = randn(g, m, kk, dtype=torch.bfloat16).requires_grad_(True)
            w = randn(g, kk, n, dtype=torch.bfloat16,
                      scale=kk ** -0.5).requires_grad_(True)
            dy = randn(g, m, n, dtype=torch.bfloat16)

            def run():
                x.grad = w.grad = None
                with torch.enable_grad():
                    y = mm_ops.matmul_fused(x, w)
                    y.backward(dy)
                return y.detach(), x.grad, w.grad
            return run
        return make

    def k10(sq, skv, h, kvh, hd, causal, window, cap, dname, b=1, ml=False):
        def make():
            g, dt = gen(), getattr(torch, dname)
            q = randn(g, b, sq, h, hd, dtype=dt)
            k, v = (randn(g, b, skv or sq, kvh, hd, dtype=dt)
                    for _ in range(2))
            if ml:
                return lambda: attn_ops._launch(q, k, v, causal, window, cap,
                                                hd ** -0.5, ml=True)
            return lambda: attn_ops.flash_attention(
                q, k, v, causal=causal, window=window, attn_softcap=cap)
        return make

    def k11(s, dtype):
        def make():
            g = gen()
            r, k, v = (randn(g, 1, s, K11_HEADS, 64, dtype=dtype)
                       for _ in range(3))
            logw = -torch.exp(randn(g, 1, s, K11_HEADS, 64) - 1.0)
            u = randn(g, K11_HEADS, 64, scale=0.5)
            state = randn(g, 1, K11_HEADS, 64, 64, scale=0.1)
            return lambda: wkv6_ops.wkv6(r, k, v, logw, u, chunk=64,
                                         state=state)
        return make

    out = {}
    for name in ("lenet5", "cifar10", "alexnet"):
        for method, fuse in RUNGS:
            for batch in CNN_BATCHES:
                out[f"{name}/{method}/{'fused' if fuse else 'unfused'}"
                    f"/b{batch}"] = cnn(name, batch, method, fuse)
    out["alexnet/advanced_simd_8/fused/b16"] = cnn(
        "alexnet", 16, "advanced_simd_8", True)
    for ocb in (8, 64):
        knobs = dict(TUNED, per_layer_oc_block_final={"conv5": ocb})
        for batch in CNN_BATCHES:
            out[f"alexnet/tuned/ocb{ocb}/b{batch}"] = cnn(
                "alexnet", batch, "advanced_simd_8", True, knobs)
    for shape, kk, n, act, bias in K3_SHAPES:
        for m in K3_ROWS:
            out[f"k3/bf16/{shape}/m{m}"] = k3(m, kk, n, act, bias)
    for shape, kk, n, act, bias, rows in K3_ONE_SLICE:
        for m in rows:
            out[f"k3/bf16/{shape}/m{m}"] = k3(m, kk, n, act, bias)
    for m in (4, 300):
        out[f"k3/bf16/w_up+bias/m{m}"] = k3(m, 1024, 8192, "gelu", True)
    out["k3/bf16/relu/m300"] = k3(300, 2048, 7168, "relu", False)
    out["k3/bf16/silu+bias/m16"] = k3(16, 2048, 2048, "silu", True)
    out["k3/bf16/grad/m4096"] = k3_grad(4096, 2304, 2048)
    for m in (64, 65):
        out[f"k3/f32/tiles/m{m}"] = k3(m, 9216, 4096, "relu", True,
                                       torch.float32)
    for fc, kk, n, act in (("fc6", 9216, 4096, "relu"),
                           ("fc7", 4096, 4096, "relu"),
                           ("fc8", 4096, 1000, "none")):
        out[f"k3/f32/{fc}/m3"] = k3(3, kk, n, act, True, torch.float32)
    for c in K10_CASES:
        sq, skv, h, kvh, hd, causal, window, cap, dname = c
        out[f"k10/{dname}/{sq}x{skv or sq}/h{h}-{kvh}/hd{hd}/"
            f"{'causal' if causal else 'full'}/w{window}/cap{cap:g}"] = \
            k10(*c)
    out["k10/bfloat16/ml/2x2048"] = k10(2048, None, 8, 4, 256, True, 4096,
                                        50.0, "bfloat16", b=2, ml=True)
    for dname in ("bfloat16", "float32"):
        for s in K11_ROWS:
            out[f"k11/{dname}/{s}"] = k11(s, getattr(torch, dname))
    return out


# -- the case runner under compute-sanitizer --------------------------------------


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


def _outputs(out) -> list:
    """The tensors a case returned."""
    import torch

    outs = out if isinstance(out, tuple) else (out,)
    return [o for o in outs if isinstance(o, torch.Tensor)]


def run_cases(names: Optional[Sequence[str]] = None) -> int:
    """Launch every case once on the card, each between markers."""
    import torch

    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.conv2d import ops as conv_ops
    from repro_torch.kernels.matmul_fused import ops as mm_ops
    from repro_torch.kernels.pool2d import ops as pool_ops
    from repro_torch.kernels.wkv6 import ops as wkv6_ops

    conv = {"K1": conv_ops.conv2d_pool_fused, "K2": conv_ops.conv2d_chain,
            "K4": conv_ops.conv2d_pool_lrn_halo,
            "K5": conv_ops.conv2d_pool_carry,
            "K6": conv_ops.conv2d_chain_ocb,
            "K7": conv_ops.conv2d_basic_simd,
            "K8": conv_ops.conv2d_basic_parallel}
    counters = (conv, pool_ops.pool2d, mm_ops.matmul_fused,
                attn_ops.flash_attention, wkv6_ops.wkv6)
    rc = 0
    with torch.no_grad():
        for name, make in cases(torch.device("cuda")).items():
            if names and name not in names:
                continue
            fn = make()
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
            if not all(bool(torch.isfinite(o.float()).all())
                       for o in _outputs(out)):
                print(f"case {name}: non-finite output", flush=True)
                rc = 1
            print(RAN_MARK + name + " " + json.dumps(_units(counters)),
                  flush=True)
    return rc


# -- the guard pass ----------------------------------------------------------------


def guard_pass(log: Optional[Callable[[str], None]] = None):
    """The guard pass (``analysis/guard.py``) over every case on the card,
    in this process: ``(findings, ran)``, ``ran`` the ``(case, units)``
    records.  The wrappers' launch counters are left as they were."""
    import torch

    from repro_torch.analysis import guard
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.conv2d import ops as conv_ops
    from repro_torch.kernels.matmul_fused import ops as mm_ops
    from repro_torch.kernels.pool2d import ops as pool_ops
    from repro_torch.kernels.wkv6 import ops as wkv6_ops

    wrappers = (conv_ops.conv2d_pool_fused, conv_ops.conv2d_chain,
                conv_ops.conv2d_pool_lrn_halo, conv_ops.conv2d_pool_carry,
                conv_ops.conv2d_chain_ocb, conv_ops.conv2d_basic_simd,
                conv_ops.conv2d_basic_parallel, pool_ops.pool2d,
                mm_ops.matmul_fused, attn_ops.flash_attention,
                wkv6_ops.wkv6)
    counts = [{k: (dict(v) if isinstance(v, dict) else v)
               for k, v in vars(w).items()} for w in wrappers]
    findings, ran = [], []
    try:
        with torch.no_grad():
            for name, make in cases(torch.device("cuda")).items():
                got, units = guard.check_case(name, make())
                findings += got
                ran.append((name, sorted(set(units))))
                if log is not None:
                    log(f"guard {name}: {len(units)} launches "
                        f"{sorted(set(units))}, {len(got)} finding(s)")
    finally:
        for w, c in zip(wrappers, counts):
            for k, v in c.items():
                setattr(w, k, v)
    return findings, ran


def run_guard():
    """``(findings, analysed, ran)`` of the guard pass, as ``parse_report``
    gives a compute-sanitizer tool's; without a CUDA device nothing runs
    (not analysed)."""
    import torch

    if not torch.cuda.is_available():
        print("guard: no CUDA device: the guard pass did not run",
              flush=True)
        return [], False, []
    findings, ran = guard_pass(log=lambda s: print(s, flush=True))
    return findings, True, ran


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
    ap.add_argument("--tools", default=",".join(DEFAULT_TOOLS))
    ap.add_argument("--json", help="write the table, findings and each "
                                   "tool's output here")
    ap.add_argument("--md", action="store_true",
                    help="print the findings as a markdown table")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a compute-sanitizer tool's run may take")
    ap.add_argument("--run-cases", nargs="*", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.run_cases is not None:
        return run_cases(args.run_cases)
    tools = args.tools.split(",")
    results, outputs, version = {}, {}, None
    if GUARD in tools:
        results[GUARD] = run_guard()
    sanitize_tools = [t for t in tools if t != GUARD]
    sanitizer = find_sanitizer() if sanitize_tools else None
    if sanitize_tools and sanitizer is None:
        print("compute-sanitizer not found beside nvcc or on PATH: nothing "
              "was analysed", flush=True)
        sanitize_tools = []
    if sanitize_tools:
        from repro_torch.kernels import _build

        _build.build()  # once, outside the sanitizer
        version = subprocess.run(
            [sanitizer, "--version"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True).stdout.strip()
        print(version, flush=True)
    for tool in sanitize_tools:
        outputs[tool] = run_tool(sanitizer, tool, args.timeout)
        results[tool] = parse_report(tool, outputs[tool])
    for tool, (_, analysed, ran) in results.items():
        print(f"{tool}: {'analysed' if analysed else 'NOT analysed'}, "
              f"{len(ran)} cases ran", flush=True)
    findings = [f for r in results.values() for f in r[0]]
    table = status_table(results)
    print("| kernel | " + " | ".join(results) + " |")
    print("| --- |" + " --- |" * len(results))
    for unit in table:
        print(f"| {unit} | " + " | ".join(table[unit][t] for t in results)
              + " |")
    if GUARD in results and results[GUARD][1]:
        from repro_torch.analysis import guard

        print(guard.table_markdown(guard.guard_table(
            results[GUARD][0], (u for _, us in results[GUARD][2] for u in us),
            COVERED)))
    if args.md:
        print(findings_markdown(findings, title="sanitizer"), end="")
    else:
        for f in findings:
            print(f)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"sanitizer": version, "table": table,
             "findings": json.loads(findings_json(findings)),
             "guard_ran": results.get(GUARD, ([], False, []))[2],
             "outputs": outputs}, indent=1))
    if any(f.severity == "error" for f in findings):
        return 1
    return 0 if any(r[1] for r in results.values()) else 2


if __name__ == "__main__":
    sys.exit(main())
