"""Build the CUDA kernels of ``src/repro_torch/csrc`` and bind them.

The sources are compiled with ``nvcc`` for ``sm_90a`` (Hopper) the first
time a kernel is launched, one ``nvcc`` process per source, all started
together, then linked into one shared library with a plain C interface
that ``ctypes`` loads.  The library lives in ``build/`` at the repository
root under a name derived from the sources' hash, so an edited source is
never served by a stale build.  Nothing here runs at import time: the
package imports on machines without a GPU or a CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

from repro_torch.kernels import common

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: C entry points and their argument types (every pointer and the stream
#: as c_void_p, so none is cut to 32 bits)
SIGNATURES = {
    "matmul_fused_f32": [_P, _P, _P, _P] + [_I] * 7 + [_P],
    "matmul_fused_bf16": [_P, _P, _P, _P] + [_I] * 7 + [_P],
    "matmul_fused_bf16_f32": [_P, _P, _P, _P] + [_I] * 7 + [_P],
    "flash_attention_fwd": [_P, _P, _P, _P] + [_I] * 8
    + [ctypes.c_float, ctypes.c_float, _I, _I, _P],
    "flash_attention_fwd_ml": [_P] * 6 + [_I] * 8
    + [ctypes.c_float, ctypes.c_float, _I, _I, _P],
    "conv_pool_lrn_f32": [_P] * 9,
    "conv_chain_f32": [_P] * 9,
    "pool2d_f32": [_P, _P, _L] + [_I] * 10 + [_P],
    "conv_basic_parallel_f32": [_P, _P, _P, _P, _P, _P],
    "conv_basic_simd_f32": [_P, _P, _P, _P, _P, _P, _L, _P],
    "conv_pool_lrn_halo_f32": [_P] * 9,
    "conv_pool_carry_f32": [_P] * 9,
    "conv_chain_ocb_f32": [_P] * 10,
    "stage_major_blocks_per_sm": [],
    "wkv6_f32": [_P] * 9 + [_I] * 4 + [_P],
    "wkv6_bf16": [_P] * 9 + [_I] * 4 + [_P],
}

_lib: Optional[ctypes.CDLL] = None
#: what the last build printed (ptxas register and shared-memory use) and
#: how long it took, for the smoke script's report
build_log: str = ""
build_seconds: float = 0.0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    cus, cuhs = _sources()
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every ``csrc/*.cu`` in parallel and link them into
    ``build/libcnnk-<hash>.so``; returns the library's path (reused when
    it already exists)."""
    global build_log, build_seconds
    lib = BUILD_DIR / f"libcnnk-{source_hash()}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    cus, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in cus:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o",
                 str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = [], []
        for src, p in zip(cus, procs):
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        # atomic: a concurrent build never loads a half-written library
        os.replace(tmp_lib, lib)
    build_log = "\n".join(logs)
    build_seconds = time.perf_counter() - t0
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use); under guard mode
    (``repro_torch.analysis.guard``) a proxy that checks every launch."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    g = common._guard
    return _lib if g is None else g.proxy(_lib)


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error (a launch that was
    refused never runs, and a later synchronize would not say so)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
