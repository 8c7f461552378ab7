"""Seeded faults through the port's own kernels on the card, under the
guard pass: each must be flagged by its rule.

    PYTHONPATH=src python3 tools/guard_fault_probe.py

Each fault calls a C entry through ``_build.library()`` on tensors the
wrappers' hooks made (``common.alloc``, ``common.operand``) with one
argument wrong against them, and ``repro_torch.analysis.guard.check_case``
runs it four times guarded and once unguarded (where a fault that
reaches past a tensor is left out: past a tensor there lies another
allocation's memory, not a band):

* K3 (``mm_stream32``, AlexNet's fc6 at M = 3): the kernel told M + 1
  rows, so it writes a row past y (K101);
* K3 (``mm_wgmma``, gemma2's q at M = 300): y one row taller than the
  M it is told, so its last row is never written (K102);
* K9 (max pool 3 x 3 / 2): told one plane more than x holds, into a y
  that holds it, so it reads a plane of x's guard band — ``fmaxf`` drops
  the quiet-NaN band but not the large finite one (K101);
* K9: x's staged copy handed as y, so the kernel writes an input (K109);
* K9: x handed past the operand hook, so a pointer lies in no staged
  buffer (K111).

Prints the card, then one line a fault with the rules found; exits 1
unless every fault gives exactly its rule.  Needs one CUDA device and
nvcc.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.analysis import guard
    from repro_torch.kernels import _build, common
    from repro_torch.kernels.common import alloc, operand, stream_handle
    from repro_torch.kernels.matmul_fused import ops as mm
    from repro_torch.kernels.pool2d import ops as pool

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = stream_handle(dev)

    def guarded():
        return common._guard is not None and common._guard.stage

    def k3(m, kk, n, dtype, rows_told, rows_alloc):
        x = torch.randn((m, kk), generator=gen, device=dev).to(dtype)
        w = (torch.randn((kk, n), generator=gen, device=dev)
             / kk ** 0.5).to(dtype)
        path = mm.k3_path(dtype, rows_told, kk, n)
        splits, kchunk = (mm.split_k(dtype, kk, n, mm.sm_count(dev))
                          if path == "stream" else (0, 0))
        entry = ("matmul_fused_bf16" if dtype == torch.bfloat16
                 else "matmul_fused_f32")

        def run():
            y = alloc((rows_alloc, n), dtype, dev)
            told = rows_told if guarded() else min(rows_told, rows_alloc)
            rc = getattr(_build.library(), entry)(
                operand(x).data_ptr(), operand(w).data_ptr(), None,
                y.data_ptr(), told, n, kk, mm.PATH_CODES[path], splits,
                kchunk, 0, stream)
            _build.check(rc, entry)
            return y
        return run

    def k9(planes_told, y_is_x=False, unstaged=False):
        x = torch.randn((1, 8, 13, 13), generator=gen, device=dev)
        oh = ow = (13 - 3) // 2 + 1

        def run():
            xs = x if unstaged else operand(x)
            y = xs if y_is_x else alloc((1, planes_told, oh, ow),
                                        torch.float32, dev)
            told = planes_told if guarded() else min(planes_told, 8)
            rc = _build.library().pool2d_f32(
                xs.data_ptr(), y.data_ptr(), told, 13, 13, oh, ow, 3,
                3, 2, 2, pool.KIND_CODES["max"], 0, stream)
            _build.check(rc, "pool2d_f32")
            return y
        return run

    faults = {
        "k3 stream: M + 1 rows told": (
            k3(3, 9216, 4096, torch.float32, 4, 3), "K101"),
        "k3 wgmma: y a row taller": (
            k3(300, 2304, 2048, torch.bfloat16, 300, 301), "K102"),
        "k9: a plane past x": (k9(9), "K101"),
        "k9: x handed as y": (k9(8, y_is_x=True), "K109"),
        "k9: x past the hook": (k9(8, unstaged=True), "K111"),
    }
    ok = True
    with torch.no_grad():
        for name, (fn, rule) in faults.items():
            findings, units = guard.check_case(name, fn)
            rules = sorted({f.rule for f in findings})
            ok &= rules == [rule]
            print(json.dumps({"fault": name, "expected": rule,
                              "rules": rules, "units": units,
                              "findings": [str(f) for f in findings]}),
                  flush=True)
    print("every fault flagged by its rule" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
