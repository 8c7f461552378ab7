// Variants of K9 (csrc/pool2d.cu) on the card, at AlexNet's 3x3 stride-2
// max pools (pool1, pool2, pool5; batch 16 and 1): the previous kernel
// (one thread an output over a flat 64-bit index, the window read at run
// time: "old"), strips of 1, 2 or 4 adjacent outputs a thread that read
// each input column once (256 or 128 threads a block, whole planes a
// block), and one output a thread with a compile-time 3x3 window, whole
// planes a block (256 or 128 threads: "fixed3", the kernel's choice).  The
// time a launch is the mean of 200 launched back to back; every variant's
// output must equal the old kernel's bit for bit.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o build/pool tools/pool2d_variants_probe.cu && build/pool
#include <cstdio>
#include <cmath>
#include <cuda_runtime.h>
#include <vector>
#include <cstring>
__global__ void __launch_bounds__(256)
pool_old(const float* __restrict__ x, float* __restrict__ y, long long nc, int H, int W, int OH, int OW, int kh, int kw, int sy, int sx, int kind, int relu) {
  const long long total = nc * OH * OW;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int ox = (int)(idx % OW); const long long r = idx / OW; const int oy = (int)(r % OH); const long long plane = r / OH;
    const float* src = x + plane * H * W + (long long)oy * sy * W + ox * sx;
    float v;
    if (kind == 1) { v = -INFINITY; for (int i = 0; i < kh; ++i) for (int j = 0; j < kw; ++j) v = fmaxf(v, src[i * W + j]); }
    else { v = 0.f; for (int i = 0; i < kh; ++i) for (int j = 0; j < kw; ++j) v += src[i * W + j]; v = v / (float)(kh * kw); }
    if (relu) v = fmaxf(v, 0.f);
    y[idx] = v;
  }
}
template <int STRIP, int THREADS>
__global__ void __launch_bounds__(THREADS)
pool_strip(const float* __restrict__ x, float* __restrict__ y, int planes, int H, int W, int OH, int OW, int kh, int kw, int sy, int sx, int kind, int relu, int strips, int ppb) {
  const int per_plane = OH * strips; const int plane0 = blockIdx.x * ppb; const int span = ppb * per_plane;
  for (int t = threadIdx.x; t < span; t += THREADS) {
    const int pl = plane0 + t / per_plane; if (pl >= planes) return;
    const int it = t % per_plane; const int oy = it / strips, ox0 = (it % strips) * STRIP;
    const int n = min(STRIP, OW - ox0); const int width = (n - 1) * sx + kw;
    const float* src = x + (size_t)pl * H * W + oy * sy * W + ox0 * sx;
    float acc[STRIP];
#pragma unroll
    for (int o = 0; o < STRIP; ++o) acc[o] = kind == 1 ? -INFINITY : 0.f;
    for (int i = 0; i < kh; ++i) { const float* row = src + i * W;
      for (int jc = 0; jc < width; ++jc) { const float v = row[jc];
#pragma unroll
        for (int o = 0; o < STRIP; ++o) { const int j = jc - o * sx; if (j >= 0 && j < kw) acc[o] = kind == 1 ? fmaxf(acc[o], v) : acc[o] + v; } } }
    float* dst = y + (size_t)pl * OH * OW + oy * OW + ox0; const float area = (float)(kh * kw);
#pragma unroll
    for (int o = 0; o < STRIP; ++o) if (o < n) { float v = kind == 1 ? acc[o] : acc[o] / area; if (relu) v = fmaxf(v, 0.f); dst[o] = v; }
  }
}
// fixed 3x3 window (kh, kw compile-time), one output a thread
template <int K, int THREADS>
__global__ void __launch_bounds__(THREADS)
pool_fixed(const float* __restrict__ x, float* __restrict__ y, int planes, int H, int W, int OH, int OW, int sy, int sx, int kind, int relu, int ppb) {
  const int per_plane = OH * OW; const int plane0 = blockIdx.x * ppb; const int span = ppb * per_plane;
  for (int t = threadIdx.x; t < span; t += THREADS) {
    const int pl = plane0 + t / per_plane; if (pl >= planes) return;
    const int it = t % per_plane; const int oy = it / OW, ox = it % OW;
    const float* src = x + (size_t)pl * H * W + oy * sy * W + ox * sx;
    float v = kind == 1 ? -INFINITY : 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j) { const float e = __ldg(src + i * W + j); v = kind == 1 ? fmaxf(v, e) : v + e; }
    if (kind != 1) v = v / (float)(K * K);
    if (relu) v = fmaxf(v, 0.f);
    y[(size_t)pl * per_plane + it] = v;
  }
}
int main() {
  struct S { const char* name; int n, c, h, w; } shapes[] = {{"pool1 b16", 16, 96, 55, 55}, {"pool2 b16", 16, 256, 27, 27}, {"pool5 b16", 16, 256, 13, 13}, {"pool1 b1", 1, 96, 55, 55}, {"pool2 b1", 1, 256, 27, 27}, {"pool5 b1", 1, 256, 13, 13}};
  for (auto& sh : shapes) {
    const int k = 3, st = 2; const int OH = (sh.h - k) / st + 1, OW = (sh.w - k) / st + 1; const long long nc = (long long)sh.n * sh.c;
    size_t nin = nc * sh.h * sh.w, nout = nc * OH * OW;
    std::vector<float> hx(nin); for (size_t i = 0; i < nin; ++i) hx[i] = (float)((i * 2654435761u) % 2000) / 1000.f - 1.f;
    float *x, *y; cudaMalloc(&x, nin * 4); cudaMalloc(&y, nout * 4); cudaMemcpy(x, hx.data(), nin * 4, cudaMemcpyHostToDevice);
    std::vector<float> ref(nout), out(nout);
    auto run = [&](const char* name, auto launch) {
      cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
      for (int r = 0; r < 5; ++r) launch();
      cudaEventRecord(a); for (int r = 0; r < 200; ++r) launch(); cudaEventRecord(b); cudaEventSynchronize(b);
      float ms; cudaEventElapsedTime(&ms, a, b);
      cudaMemcpy(out.data(), y, nout * 4, cudaMemcpyDeviceToHost);
      bool same = true; if (!strcmp(name, "old")) ref = out; else same = !memcmp(ref.data(), out.data(), nout * 4);
      printf("%s %-12s %.2f us a launch (200 back to back) same %d %s\n", sh.name, name, ms * 1000 / 200, (int)same, cudaGetErrorString(cudaGetLastError()));
    };
    const long long tot = nc * OH * OW; long long blocks = (tot + 255) / 256; if (blocks > 65535) blocks = 65535;
    run("old", [&] { pool_old<<<(unsigned)blocks, 256>>>(x, y, nc, sh.h, sh.w, OH, OW, k, k, st, st, 1, 0); });
    auto strip = [&](auto kern, int STRIP, int THREADS) { const int strips = (OW + STRIP - 1) / STRIP; const int pp = OH * strips; const int ppb = pp >= THREADS ? 1 : THREADS / pp; const int nb = (int)((nc + ppb - 1) / ppb);
      kern<<<nb, THREADS>>>(x, y, (int)nc, sh.h, sh.w, OH, OW, k, k, st, st, 1, 0, strips, ppb); };
    run("strip1x256", [&] { strip(pool_strip<1, 256>, 1, 256); });
    run("strip2x256", [&] { strip(pool_strip<2, 256>, 2, 256); });
    run("strip4x256", [&] { strip(pool_strip<4, 256>, 4, 256); });
    run("strip1x128", [&] { strip(pool_strip<1, 128>, 1, 128); });
    run("strip2x128", [&] { strip(pool_strip<2, 128>, 2, 128); });
    auto fixed = [&](auto kern, int THREADS) { const int pp = OH * OW; const int ppb = pp >= THREADS ? 1 : THREADS / pp; const int nb = (int)((nc + ppb - 1) / ppb);
      kern<<<nb, THREADS>>>(x, y, (int)nc, sh.h, sh.w, OH, OW, st, st, 1, 0, ppb); };
    run("fixed3x256", [&] { fixed(pool_fixed<3, 256>, 256); });
    run("fixed3x128", [&] { fixed(pool_fixed<3, 128>, 128); });
    run("old2", [&] { pool_old<<<(unsigned)blocks, 256>>>(x, y, nc, sh.h, sh.w, OH, OW, k, k, st, st, 1, 0); });
    cudaFree(x); cudaFree(y);
  }
  return 0;
}
