"""Device time of K3's weight stream under other ring depths and slicings.

Builds ``src/repro_torch/csrc/matmul_fused.cu`` into
``build/k3_stream_probe/`` once per ring depth in ``STAGES``
(``SW_STAGES`` replaced, 4 being the source as it is; the kernel keeps
no switch for it),
and calls each build's C entry directly at the main path's stream shapes
(gemma2-2b's and rwkv6-1.6b's projections in bf16 at M = 4, gemma2's gate
at M = 48, AlexNet's fc layers in fp32 at M = 1 and 16) with the K
slicing of ``ops.split_k_aimed`` for each aim in ``BLOCKS_PER_SM`` blocks an
SM (``ops.split_k`` aims at ``ops.STREAM_BLOCKS_PER_SM``).
Each device time is ``LAUNCHES`` calls captured into a CUDA graph, its
replay timed with CUDA events (the median of 5, over the launches): no
host gap.  Every output is held against the plain version with the
smoke's limits.  Prints the card, then one JSON line a shape, the
variants in the order built, then again in reverse (the same card, in
turns).

    PYTHONPATH=src python3 tools/k3_stream_probe.py

Needs one CUDA device and nvcc (``/usr/local/cuda/bin`` or PATH).
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k3_stream_probe"
STAGES = (4, 6, 8)
BLOCKS_PER_SM = (2, 3, 4)
LAUNCHES = 20
STAGES_LINE = "constexpr int SW_STAGES = 4;"
#: (dtype, M, K, N)
SHAPES = (("bfloat16", 4, 2304, 2048), ("bfloat16", 4, 2304, 1024),
          ("bfloat16", 4, 2048, 2304), ("bfloat16", 4, 2304, 9216),
          ("bfloat16", 4, 9216, 2304), ("bfloat16", 4, 2048, 7168),
          ("bfloat16", 4, 7168, 2048), ("bfloat16", 48, 2304, 9216),
          ("float32", 1, 9216, 4096), ("float32", 16, 9216, 4096),
          ("float32", 16, 4096, 4096), ("float32", 16, 4096, 1000))


def build(_build, name: str, source: str) -> ctypes.CDLL:
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "matmul_fused.cu").write_text(source)
    (d / "hopper_common.cuh").write_text(
        (_build.CSRC / "hopper_common.cuh").read_text())
    lib = d / "lib.so"
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
                    "-shared", "-o", str(lib), str(d / "matmul_fused.cu")],
                   check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    for entry in ("matmul_fused_f32", "matmul_fused_bf16"):
        fn = getattr(dll, entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return dll


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.matmul_fused import ops as mm
    from repro_torch.kernels.matmul_fused.ref import matmul_fused_ref

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    source = (_build.CSRC / "matmul_fused.cu").read_text()
    if source.count(STAGES_LINE) != 1:
        print("SW_STAGES = 4 was not found once", file=sys.stderr)
        return 1
    libs = {s: build(_build, f"stages{s}", source.replace(
        STAGES_LINE, f"constexpr int SW_STAGES = {s};")) for s in STAGES}
    sms = mm.sm_count(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    variants = [(s, a) for s in STAGES for a in BLOCKS_PER_SM]
    bad = 0
    for dname, m, k, n in SHAPES:
        dt = getattr(torch, dname)
        x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
        w = (torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
             ).to(dt)
        y = torch.empty((m, n), dtype=dt, device="cuda")
        ref = matmul_fused_ref(x, w, None, "none").float()
        entry = "matmul_fused_bf16" if dt == torch.bfloat16 else \
            "matmul_fused_f32"
        rtol, atol = (2.0 ** -7, 2.0 ** -10) if dt == torch.bfloat16 else \
            (1e-4, 1e-5)
        times = {f"stages{s}_bps{a}": [] for s, a in variants}
        for s, a in variants + variants[::-1]:
            fn = getattr(libs[s], entry)
            splits, kchunk = mm.split_k_aimed(dt, k, n, sms, a)
            args = (x.data_ptr(), w.data_ptr(), None, y.data_ptr(), m, n, k,
                    mm.PATH_CODES["stream"], splits, kchunk, 0, stream)
            _build.check(fn(*args), entry)
            torch.cuda.synchronize()
            if not bool(((y.float() - ref).abs()
                         <= rtol * ref.abs() + atol).all()):
                bad += 1
                print(f"{dname} {m}x{k}x{n} stages {s} aim {a}: off the "
                      f"plain version", file=sys.stderr)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                cap = args[:-1] + (torch.cuda.current_stream().cuda_stream,)
                for _ in range(LAUNCHES):
                    fn(*cap)
            runs = []
            for _ in range(8):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                graph.replay()
                e1.record()
                e1.synchronize()
                runs.append(e0.elapsed_time(e1) / LAUNCHES)
            times[f"stages{s}_bps{a}"].append(statistics.median(runs[3:]))
            del graph
        print(json.dumps({"dtype": dname, "m": m, "k": k, "n": n,
                          "bytes": (m * k + k * n + m * n) * x.element_size(),
                          "device_ms": times}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
