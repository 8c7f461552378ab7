"""What K10's hi/lo split of p costs on the card.

Builds ``src/repro_torch/csrc/flash_attention.cu`` twice into
``build/k10_split_probe/``: as it is, and with the ``P_lo`` product
removed (p rounded once to bf16 before p.v, as SDPA does; the kernel
keeps no switch for it).  Times the wgmma path of both at gemma2-2b's
shapes (1 x tokens x 8 heads over 4, head_dim 256) in the order split,
single, single, split, each time with CUDA events around 20 launches
back to back (device time, no host gap), and holds each output against
the plain version with the smoke's element-wise limit (bf16: 2^-7 of
|plain| + 2^-10).  Prints the card, then one JSON line a shape.

    PYTHONPATH=src python3 tools/k10_split_probe.py

Needs one CUDA device and nvcc (``/usr/local/cuda/bin`` or PATH).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k10_split_probe"
#: (tokens, window, cap)
SHAPES = ((4500, 4096, 50.0), (4500, 0, 0.0), (1500, 4096, 50.0))
LO_PRODUCT = "        wgmma_rs(o, a_lo, dv, 1);\n"
RTOL, ATOL = 2.0 ** -7, 2.0 ** -10


def build(_build, name: str, source: str) -> ctypes.CDLL:
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "flash_attention.cu").write_text(source)
    (d / "hopper_common.cuh").write_text(
        (_build.CSRC / "hopper_common.cuh").read_text())
    lib = d / "lib.so"
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
                    "-shared", "-o", str(lib), str(d / "flash_attention.cu")],
                   check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.flash_attention_fwd.argtypes = _build.SIGNATURES["flash_attention_fwd"]
    dll.flash_attention_fwd.restype = ctypes.c_int
    return dll


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention.ops import PATH_CODES
    from repro_torch.kernels.attention.ref import flash_attention_ref

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    source = (_build.CSRC / "flash_attention.cu").read_text()
    if source.count(LO_PRODUCT) != 1:
        print("the P_lo product was not found once", file=sys.stderr)
        return 1
    libs = {"split": build(_build, "split", source),
            "single": build(_build, "single", source.replace(LO_PRODUCT, ""))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for sq, window, cap in SHAPES:
        q = torch.randn((1, sq, 8, 256), generator=gen, device="cuda").bfloat16()
        k = torch.randn((1, sq, 4, 256), generator=gen, device="cuda").bfloat16()
        v = torch.randn((1, sq, 4, 256), generator=gen, device="cuda").bfloat16()
        ref = flash_attention_ref(q, k, v, causal=True, window=window,
                                  attn_softcap=cap).float()
        out = torch.empty_like(q)

        def launch(lib):
            rc = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1,
                sq, sq, 8, 4, 256, 1, window, 256 ** -0.5, cap, 1,
                PATH_CODES["wgmma"], stream)
            if rc:
                raise RuntimeError(f"flash_attention_fwd: CUDA error {rc}")

        def device_ms(lib, reps=20):
            launch(lib)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(reps):
                launch(lib)
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / reps

        row = {"tokens": sq, "window": window, "cap": cap}
        for name, lib in libs.items():
            launch(lib)
            torch.cuda.synchronize()
            d = (out.float() - ref).abs()
            row[f"{name}_max_abs_err"] = d.max().item()
            row[f"{name}_within_limit"] = bool(
                (d <= ATOL + RTOL * ref.abs()).all())
        runs = [device_ms(libs[n]) for n in ("split", "single", "single",
                                             "split")]
        row.update(runs_split_single_single_split_ms=runs,
                   split_ms=(runs[0] + runs[3]) / 2,
                   single_ms=(runs[1] + runs[2]) / 2)
        row["split_cost"] = row["split_ms"] / row["single_ms"] - 1.0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
