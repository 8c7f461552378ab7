"""K3's wgmma path on the card, for one source tree: how far its sums
drift from exact ones as K grows, and its time.

    python3 tools/k3_accuracy_probe.py [--src PATH] [--label NAME]

Imports ``repro_torch`` from ``--src`` (default: this checkout's
``src``), so a parent tree unpacked beside the checkout runs the same
code; builds its kernels, then for each of ``CASES`` (bf16 operands drawn
from a seed: a backward's dw over many rows with N(0, 1) operands, and
forward projections with w at std 1/sqrt(K)):

- the error of three bf16 products against the exact one (float64 sums
  of the same bf16 operands): K3 (``_launch``, the wgmma path), the plain
  version (``matmul_fused_ref``: fp32 sums, TF32 off) and the library's
  bf16 product (``torch.matmul``), each as its largest absolute error and
  its largest error past its output's own bf16 rounding (``|err| -
  2^-8 |exact|``, half a bf16 step at most: what the sums add), and
  whether each element is within
  ``chip_smoke.LM_KERNEL_TOL``'s bf16 limit of the exact product;
- K3's event time (``chip_smoke.time_ms``) beside its bound.

Prints the card (``nvidia-smi --query-gpu=name,power.limit``), then one
JSON line a case.  Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (name, M, K, N, w's std: None for N(0, 1))
CASES = (("dw llama k/v over 2 x 6400 media rows", 4096, 12800, 1024, None),
         ("dw gemma2 gate over 4096 rows", 2304, 4096, 9216, None),
         ("dw starcoder2 up over 4096 rows", 6144, 4096, 24576, None),
         ("gemma2 gate at 4500 tokens", 4500, 2304, 9216, "fan_in"),
         ("starcoder2 down at 4096 tokens", 4096, 24576, 6144, "fan_in"),
         ("zamba2 in_proj at 4096 tokens", 4096, 2048, 8384, "fan_in"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.matmul_fused import ops as mm_ops
    from repro_torch.kernels.matmul_fused.ref import matmul_fused_ref

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.library()
    _, bw_peak, bf16_peak = smoke.card_peaks(torch.cuda.get_device_name(0))
    rtol, atol = smoke.LM_KERNEL_TOL["bfloat16"]
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, m, k, n, std in CASES:
        x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        w = torch.randn((k, n), generator=gen, device=dev)
        w = (w / k ** 0.5 if std == "fan_in" else w).bfloat16()
        exact = x.double() @ w.double()
        rec = {"label": args.label, "case": name, "m": m, "k": k, "n": n}
        for who, fn in (("k3", lambda: mm_ops._launch(x, w, None, "none")),
                        ("plain", lambda: matmul_fused_ref(x, w)),
                        ("library", lambda: torch.matmul(x, w))):
            y = fn().double()
            err = (y - exact).abs()
            rec[who] = {
                "max_abs_err": err.max().item(),
                "past_rounding": (err - 2.0 ** -8 * exact.abs()).max().item(),
                "within_tol": bool((err <= atol + rtol * exact.abs()).all())}
            del y, err
        flops = 2.0 * m * k * n
        rec["ms"] = smoke.time_ms(torch, lambda: mm_ops._launch(
            x, w, None, "none"))
        rec["bound_ms"] = 1e3 * max(flops / bf16_peak,
                                    2.0 * (m * k + k * n + m * n) / bw_peak)
        print(json.dumps(rec), flush=True)
        del x, w, exact
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
