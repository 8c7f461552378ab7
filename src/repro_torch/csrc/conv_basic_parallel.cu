// K8: the paper's §4.2 basic parallel convolution: NCHW, channels the outer
// loop of every output's reduction, then kernel rows, then kernel columns,
// one scalar weight times a spatial plane at a time, fp32; then bias and
// the optional ReLU.  No pool.
//
// Replaces the TPU kernel src/repro/kernels/conv2d/kernels.py
// conv2d_basic_parallel -> _basic_parallel_kernel, which keeps the
// un-swapped NCHW layout and loops channels outermost, kernel rows, kernel
// columns inside.
//
// Bound on the H100: fp32 operations (AlexNet's five convs do 34.6 GFLOP at
// batch 16 on about 41 MB of inputs and weights; 66.9 TFLOP/s on the CUDA
// cores).  To approach it the kernel must reuse every loaded value from
// registers: a block of ST_THREADS threads owns ST_TO output channels x
// ST_TP consecutive output pixels (row-major) of one frame, each thread an
// 8 x 8 micro-tile (conv_simt_tile.cuh).  The channels are walked in
// chunks of cc (the host picks cc so that a stage fits its budget), in
// order.  A stage holds, in shared memory, the input rectangle that the
// tile's pixels read from each channel of the chunk (hr rows x the padded
// width; rows and columns outside the input are zeros, so padding is never
// materialised in device memory) and the weights w[o0:o0+64, c, :, :]
// k-major.  Two stages form a ring: cp.async brings chunk s + 1 while chunk
// s computes.  Each (c, i, j) step is an outer product of 8 scalar weights
// and the 8 pixels' shifted inputs: 10 shared loads per 64 FMAs, against
// about one global load per FMA for one thread per output.  NCHW rows of
// 227, 55, 27 or 13 floats are not 16-byte aligned, so TMA cannot describe
// them and the copies are 4-byte cp.async.
//
// Each output's sum runs channels ascending, kernel rows, kernel columns,
// padding zeros included as fma(0, w, acc); no split of the reduction, no
// atomics.  A tile lies in one frame and its sums do not depend on the tile
// (a pixel's order is the same wherever it sits), so repeated runs give the
// same bits and a frame's output depends on that frame alone.
#include <string.h>

#include "conv_simt_tile.cuh"

namespace cnnk {

// dims[] from the host: N, C, H, W, OC, KH, KW, sy, sx, py, px, OH, OW,
// relu, cc (input channels a stage holds)
struct Dims {
  int N, C, H, W, OC, KH, KW, sy, sx, py, px, OH, OW, relu, cc;
};

constexpr int K8_DIMS = 15;
constexpr long long K8_SMEM_LIMIT = 232448;  // 227 KB a block may opt in to

// Input rows the tile starting at pixel p0 reads: its output rows' span
// times the stride plus the kernel's height.
inline int k8_rows(const Dims& d, int p0) {
  const int P = d.OH * d.OW;
  const int last = (p0 + ST_TP < P ? p0 + ST_TP : P) - 1;
  return (last / d.OW - p0 / d.OW) * d.sy + d.KH;
}

// hr: the most input rows any tile reads (the halo's height in a stage).
inline int k8_halo_rows(const Dims& d) {
  int hr = 0;
  for (int p0 = 0; p0 < d.OH * d.OW; p0 += ST_TP) {
    const int r = k8_rows(d, p0);
    hr = r > hr ? r : hr;
  }
  return hr;
}

// Floats of one stage: the halo (16-byte aligned), then the weight rows.
__host__ __device__ inline int k8_stage(const Dims& d, int hr) {
  const int wp = (d.OW - 1) * d.sx + d.KW;
  return ((d.cc * hr * wp + 3) & ~3) +
         ((d.cc * d.KH * d.KW + 3) & ~3) * ST_BROW;
}

__global__ void __launch_bounds__(ST_THREADS)
conv_basic_parallel_kernel(Dims d, int hr, int n_pt,
                           const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ b,
                           float* __restrict__ out) {
  extern __shared__ float4 dyn4[];
  float* sm = reinterpret_cast<float*>(dyn4);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n = blockIdx.x / n_pt;
  const int p0 = (blockIdx.x - n * n_pt) * ST_TP;
  const int o0 = blockIdx.y * ST_TO;
  const int P = d.OH * d.OW;
  const int KHW = d.KH * d.KW;
  const int wp = (d.OW - 1) * d.sx + d.KW;  // padded width of a halo row
  const int plane = hr * wp;
  const int xs_n = d.cc * plane;
  const int ws_off = (xs_n + 3) & ~3;
  const int ws_rows = (d.cc * KHW + 3) & ~3;
  const int stage = k8_stage(d, hr);
  const int r0 = p0 / d.OW;
  const int iy0 = r0 * d.sy - d.py;
  const float* xf = x + (long long)n * d.C * d.H * d.W;

  int poff[8];  // each pixel's (0, 0) tap in a halo plane
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int p = p0 + tx + 16 * m;
    poff[m] = 0;
    if (p < P) {
      const int oy = p / d.OW;
      poff[m] = (oy - r0) * d.sy * wp + (p - oy * d.OW) * d.sx;
    }
  }

  auto load = [&](int s, float* dst) {
    const int c0 = s * d.cc;
    for (int e = tid; e < xs_n; e += ST_THREADS) {
      const int ci = e / plane;
      const int rem = e - ci * plane;
      const int r = rem / wp;
      const int iy = iy0 + r;
      const int ix = rem - r * wp - d.px;
      const int c = c0 + ci;
      const bool v = c < d.C && (unsigned)iy < (unsigned)d.H &&
                     (unsigned)ix < (unsigned)d.W;
      cp_async4(dst + e, v ? xf + ((long long)c * d.H + iy) * d.W + ix : xf,
                v);
    }
    // weights: a warp takes 8 channels x 4 consecutive k (16 contiguous
    // bytes of a channel's row), which also keeps the k-major stores of
    // rows ST_BROW apart on distinct banks
    const int kn = (d.C - c0 < d.cc ? d.C - c0 : d.cc) * KHW;
    float* ws = dst + ws_off;
    for (int e = tid; e < ws_rows * ST_TO; e += ST_THREADS) {
      const int o = ((e >> 5) & 7) * 8 + (e & 7);
      const int k = (e >> 8) * 4 + ((e >> 3) & 3);
      const bool v = k < kn && o0 + o < d.OC;
      cp_async4(ws + k * ST_BROW + o,
                v ? w + ((long long)(o0 + o) * d.C + c0) * KHW + k : w, v);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[m][u] = 0.f;

  const int nst = (d.C + d.cc - 1) / d.cc;
  load(0, sm);
  cp_async_commit();
  for (int s = 0; s < nst; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s landed; stage s - 1's buffer is free
    if (s + 1 < nst) load(s + 1, sm + ((s + 1) & 1) * stage);
    cp_async_commit();
    const float* xs = sm + (s & 1) * stage;
    const float* ws = xs + ws_off;
    const int ccn = d.C - s * d.cc < d.cc ? d.C - s * d.cc : d.cc;
    for (int ci = 0; ci < ccn; ++ci) {          // channels OUTER (§4.2)
      for (int i = 0; i < d.KH; ++i) {
        const float* xrow = xs + ci * plane + i * wp;
        const float* wrow = ws + (ci * KHW + i * d.KW) * ST_BROW;
        for (int j = 0; j < d.KW; ++j) {
          float a[8];
#pragma unroll
          for (int m = 0; m < 8; ++m) a[m] = xrow[poff[m] + j];
          outer8x8(acc, a, wrow + j * ST_BROW, ty);
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int o = o0 + tile_chan(ty, u);
    if (o >= d.OC) continue;
    const float bias = b[o];
    float* orow = out + ((long long)n * d.OC + o) * P;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int p = p0 + tx + 16 * m;
      if (p >= P) continue;
      float v = acc[m][u] + bias;
      if (d.relu) v = fmaxf(v, 0.f);
      orow[p] = v;
    }
  }
}

}  // namespace cnnk

// x [N, C, H, W], w [OC, C, KH, KW], b [OC], out [N, OC, OH, OW]; dims a host
// array of K8_DIMS ints (the Dims order).  The grid is (pixel tiles x N,
// channel tiles); the dynamic shared memory is two stages (k8_stage), opted
// in above 48 KB.  Returns cudaGetLastError() after the launch.
extern "C" int conv_basic_parallel_f32(const void* x, const void* w,
                                       const void* b, void* out,
                                       const int* dims, void* stream) {
  static_assert(sizeof(cnnk::Dims) == cnnk::K8_DIMS * sizeof(int),
                "Dims is K8_DIMS ints");
  cnnk::Dims d;
  memcpy(&d, dims, sizeof(cnnk::Dims));
  if (d.N < 1 || d.C < 1 || d.OC < 1 || d.OH < 1 || d.OW < 1 || d.cc < 1 ||
      d.cc > d.C)
    return (int)cudaErrorInvalidValue;
  const int hr = cnnk::k8_halo_rows(d);
  const long long smem = 2LL * 4 * cnnk::k8_stage(d, hr);
  const long long n_pt = (d.OH * d.OW + cnnk::ST_TP - 1) / cnnk::ST_TP;
  const long long n_ot = (d.OC + cnnk::ST_TO - 1) / cnnk::ST_TO;
  if (smem > cnnk::K8_SMEM_LIMIT || n_pt * d.N > 0x7fffffff || n_ot > 65535)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cnnk::conv_basic_parallel_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)(n_pt * d.N), (unsigned)n_ot);
  cnnk::conv_basic_parallel_kernel<<<grid, cnnk::ST_THREADS, (size_t)smem,
                                     (cudaStream_t)stream>>>(
      d, hr, (int)n_pt, static_cast<const float*>(x),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
