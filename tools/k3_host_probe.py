"""Where K3's host time a call goes on the weight stream.

Times, on the host clock, ``CALLS`` calls enqueued back to back (the card's
queue absorbs them, so each number is host time) of each piece of the
wrapper's path at gemma2-2b's q projection for a decode step (bf16,
M = 4, 2304 -> 2048): the whole ``matmul_fused`` call, ``_launch``, the
output's ``torch.empty``, the current stream's handle (the public call and
``stream_handle``, which the wrappers use), the C entry called
directly through ctypes with the same arguments, and ``torch.matmul`` on
the same operands beside them.  Prints the card, then one JSON line of
microseconds a call.

    PYTHONPATH=src python3 tools/k3_host_probe.py

Needs one CUDA device and nvcc (``/usr/local/cuda/bin`` or PATH).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS = 2000
M, K, N = 4, 2304, 2048


def per_call_us(torch, fn) -> float:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / CALLS
    torch.cuda.synchronize()
    return us


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import stream_handle
    from repro_torch.kernels.matmul_fused import ops as mm

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((M, K), generator=gen, device=dev).bfloat16()
    w = (torch.randn((K, N), generator=gen, device=dev) / K ** 0.5).bfloat16()
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    splits, kchunk = mm.split_k(x.dtype, K, N, mm.sm_count(dev))
    entry = _build.library().matmul_fused_bf16
    stream = torch.cuda.current_stream(dev).cuda_stream
    direct = (x.data_ptr(), w.data_ptr(), None, y.data_ptr(), M, N, K,
              mm.PATH_CODES["stream"], splits, kchunk, 0, stream)
    rec = {"shape": [M, K, N], "calls": CALLS, "us_per_call": {
        "matmul_fused": per_call_us(torch, lambda: mm.matmul_fused(x, w)),
        "_launch": per_call_us(torch, lambda: mm._launch(x, w, None, "none")),
        "torch.empty": per_call_us(torch, lambda: torch.empty(
            (M, N), dtype=x.dtype, device=dev)),
        "current_stream": per_call_us(
            torch, lambda: torch.cuda.current_stream(dev).cuda_stream),
        "stream_handle": per_call_us(torch, lambda: stream_handle(dev)),
        "c_entry": per_call_us(torch, lambda: entry(*direct)),
        "torch.matmul": per_call_us(torch, lambda: torch.matmul(x, w)),
    }}
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
