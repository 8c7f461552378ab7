"""Where K11's output pass (``wkv6_chunk_out``) spends its time, on the card.

    python3 tools/wkv6_sections_probe.py

Copies ``src/repro_torch/csrc/wkv6.cu`` into ``build/probe/`` with one
section of ``wkv6_chunk_out`` compiled out at a time (the cumulative sums,
the diagonal blocks' pairwise exps, the decays of r and k, the off-diagonal
blocks' products, the final products), builds each copy with nvcc beside a
small driver that launches the pass alone on bf16 operands of rwkv6-1.6b's
4500-token prefill (b 1, 32 heads of 64, chunks of 64),
and prints the time a launch (CUDA events over 20 launches) of the whole
pass, of each copy, and of the copy with every section out (its loads,
stores and barriers).  A section's cost is the whole pass's time less its
copy's; the copies compute wrong values and are timed only.  Exits 1 if a
section's anchor is not found in the source.  Needs one CUDA device and
nvcc.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "probe"
TOKENS = 4500  # rwkv6-1.6b's longest served prompt in chip_smoke.py

#: section -> (first line of it, the text that follows it)
SECTIONS = {
    "scan": ("#pragma unroll 16\n    for (int t = 0; t < WK_LMAX; ++t) {\n"
             "      const float w = Cp",
             "  } else if (tid >= WK_THREADS - 2 * WK_LMAX) {"),
    "diag": ("  if (tid < 2 * PAIRS) {",
             "  __syncthreads();\n  {  // r ⊙ exp(cw_prev - C_q)"),
    "convert": ("  {  // r ⊙ exp(cw_prev - C_q) and k ⊙ exp(C_{q+1} - cw)",
                "  __syncthreads();\n  // the six off-diagonal blocks"),
    "offdiag": ("#pragma unroll 2\n    for (int cc = 0; cc < WK_E; cc += 4) {\n"
                "      float4 kj[2];",
                "#pragma unroll\n    for (int r4 = 0; r4 < 4; ++r4)\n"),
    "product": ("#pragma unroll\n      for (int jb = 0; jb < NSUB; ++jb) {",
                "      keys(0, SPLIT_E);"),
    "product_keys": ("      keys(0, SPLIT_E);", "    } else {"),
    "product_keys2": ("      keys(SPLIT_E, WK_E);", "#pragma unroll\n"),
}

DRIVER = r'''
#include "wkv6_sections.cu"
#include <cstdio>
#include <vector>
int main(int argc, char** argv) {
  const int b = 1, s = atoi(argv[1]), H = 32, L = 64, nc = (s + L - 1) / L;
  const long items = (long)b * H * nc;
  const size_t elems = (size_t)b * s * H * 64;
  std::vector<__nv_bfloat16> hr(elems);
  std::vector<float> hw(elems), hs(items * 4096), hu(H * 64, 0.3f);
  for (size_t i = 0; i < elems; ++i) {
    hr[i] = __float2bfloat16((float)((i * 2654435761u) % 2000) / 1000.f - 1.f);
    hw[i] = -0.2f - (float)((i * 40503u) % 1000) / 500.f;
  }
  for (size_t i = 0; i < hs.size(); ++i)
    hs[i] = (float)((i * 2654435761u) % 1000) / 1000.f - 0.5f;
  __nv_bfloat16 *r, *o;
  float *w, *sp, *u;
  cudaMalloc(&r, elems * 2); cudaMalloc(&o, elems * 2);
  cudaMalloc(&w, elems * 4); cudaMalloc(&sp, hs.size() * 4);
  cudaMalloc(&u, hu.size() * 4);
  cudaMemcpy(r, hr.data(), elems * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(w, hw.data(), elems * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(sp, hs.data(), hs.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(u, hu.data(), hu.size() * 4, cudaMemcpyHostToDevice);
  cudaFuncSetAttribute(wkv6_chunk_out<__nv_bfloat16>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, OUT_SMEM);
  auto go = [&] {
    wkv6_chunk_out<__nv_bfloat16><<<items, WK_THREADS, OUT_SMEM>>>(
        r, r, r, w, u, sp, o, s, H, L, nc);
  };
  for (int i = 0; i < 3; ++i) go();
  cudaEvent_t a, e;
  cudaEventCreate(&a); cudaEventCreate(&e);
  cudaEventRecord(a);
  for (int i = 0; i < 20; ++i) go();
  cudaEventRecord(e); cudaEventSynchronize(e);
  float ms; cudaEventElapsedTime(&ms, a, e);
  printf("%.4f %s\n", ms / 20, cudaGetErrorString(cudaGetLastError()));
  return 0;
}
'''


def source_without(names):
    """wkv6.cu with ``names``' sections inside ``#if 0`` in the output
    pass."""
    src = (SRC / "wkv6.cu").read_text()
    at = src.index("wkv6_chunk_out(const T*")
    head, body = src[:at], src[at:]
    for name in names:
        start, end = SECTIONS[name]
        i = body.find(start)
        j = body.find(end, i + len(start))
        if i < 0 or j < 0:
            raise SystemExit(f"section {name}: anchor not found")
        body = body[:i] + "#if 0\n" + body[i:j] + "#endif\n" + body[j:]
    return head + body


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "wkv6_sections_driver.cu").write_text(DRIVER)
    nvcc = "/usr/local/cuda/bin/nvcc"
    product = ["product", "product_keys", "product_keys2"]
    variants = [("whole pass", [])] + [
        (f"without {n}", [n]) for n in ("scan", "diag", "convert",
                                        "offdiag")] + [
        ("without product", product),
        ("loads, stores, barriers", ["scan", "diag", "convert", "offdiag",
                                     *product])]
    whole = None
    for label, names in variants:
        (OUT / "wkv6_sections.cu").write_text(source_without(names))
        exe = OUT / "wkv6_sections"
        b = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
             "-std=c++17", f"-I{SRC}", "-o", str(exe),
             str(OUT / "wkv6_sections_driver.cu")],
            capture_output=True, text=True)
        if b.returncode != 0:
            print(f"{label}: nvcc failed\n{b.stdout}{b.stderr}")
            return 1
        run = subprocess.run([str(exe), str(TOKENS)],
                             capture_output=True, text=True)
        ms = float(run.stdout.split()[0])
        whole = ms if whole is None else whole
        print(f"{label:26s} {ms:.4f} ms a launch"
              + ("" if not names else f"  (section: {whole - ms:+.4f} ms)")
              + f"  {run.stdout.split(maxsplit=1)[1].strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
