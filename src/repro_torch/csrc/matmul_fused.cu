// K3: y = act(x @ w + b) in fp32, act one of none, relu, silu, gelu (tanh
// form).  x [M, K], w [K, N], b [N] or null, y [M, N], all contiguous.
//
// Replaces the TPU kernel src/repro/kernels/matmul_fused/kernel.py
// matmul_fused_pallas -> _kernel.
//
// Bound on the H100: bytes.  On the main path M is the batch (1 to 16) and
// the weights dominate: AlexNet's fc6 streams 151 MB for 2 * M * 37.7 M
// operations, about 45 us at 3.35 TB/s against 1 to 18 us of fp32 FMAs.  So
// the design is a weight stream that fills every SM, not a square tile:
//   pass 1: a block owns 512 output columns (4 a thread, 128 apart so each
//           warp reads 128 contiguous bytes of a weight row) and a K slice,
//           keeps its x slice [BM, <= 512] in shared memory, and writes its
//           partial sums to a scratch [splits, M, N];
//   pass 2: sums the partials in split order, adds the bias and applies the
//           activation.
// The split count is chosen by the host so that about four blocks per SM are
// in flight while the partials stay small next to the weights.  The order of
// every sum is fixed, so repeated runs give the same bits (no atomics).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MM_THREADS = 128;
constexpr int COLS = 4;                       // columns per thread
constexpr int BN = MM_THREADS * COLS;         // columns per block
constexpr int KMAX = 512;                     // largest K slice a block takes

template <int BM>
__global__ void __launch_bounds__(MM_THREADS)
mm_partial(const float* __restrict__ x, const float* __restrict__ w,
           float* __restrict__ part, int M, int N, int K, int kchunk) {
  __shared__ float xs[BM][KMAX];
  const int n0 = blockIdx.x * BN + threadIdx.x;
  const int s = blockIdx.y;
  const int m0 = blockIdx.z * BM;
  const int kb = s * kchunk;
  const int ke = min(K, kb + kchunk);
  const int kl = ke - kb;
  for (int e = threadIdx.x; e < BM * kl; e += MM_THREADS) {
    int m = e / kl;
    int k = e - m * kl;
    xs[m][k] = (m0 + m < M) ? x[(long)(m0 + m) * K + kb + k] : 0.f;
  }
  __syncthreads();
  float acc[BM][COLS];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[m][j] = 0.f;
  bool ok[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) ok[j] = n0 + j * MM_THREADS < N;
  int k = 0;
  // four weight rows in flight per thread
  for (; k + 4 <= kl; k += 4) {
    float wv[4][COLS];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* row = w + (long)(kb + k + u) * N + n0;
#pragma unroll
      for (int j = 0; j < COLS; ++j) wv[u][j] = ok[j] ? row[j * MM_THREADS] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        float xv = xs[m][k + u];
#pragma unroll
        for (int j = 0; j < COLS; ++j) acc[m][j] = fmaf(xv, wv[u][j], acc[m][j]);
      }
  }
  for (; k < kl; ++k) {
    const float* row = w + (long)(kb + k) * N + n0;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      float wv = ok[j] ? row[j * MM_THREADS] : 0.f;
#pragma unroll
      for (int m = 0; m < BM; ++m) acc[m][j] = fmaf(xs[m][k], wv, acc[m][j]);
    }
  }
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    if (m0 + m >= M) break;
    float* dst = part + ((long)s * M + m0 + m) * N + n0;
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      if (ok[j]) dst[j * MM_THREADS] = acc[m][j];
  }
}

__device__ inline float activate(float y, int act) {
  if (act == 1) return fmaxf(y, 0.f);
  if (act == 2) return y * (1.f / (1.f + expf(-y)));
  if (act == 3)
    return 0.5f * y * (1.f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
  return y;
}

__global__ void mm_reduce(const float* __restrict__ part,
                          const float* __restrict__ b, float* __restrict__ y,
                          int M, int N, int splits, int act) {
  long mn = (long)M * N;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < mn;
       i += (long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += part[s * mn + i];
    if (b) v += b[i % N];
    y[i] = activate(v, act);
  }
}

template <int BM>
void launch_partial(const float* x, const float* w, float* part, int M, int N,
                    int K, int splits, int kchunk, cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, splits, (M + BM - 1) / BM);
  mm_partial<BM><<<grid, MM_THREADS, 0, st>>>(x, w, part, M, N, K, kchunk);
}

}  // namespace

// part holds splits * M * N floats; kchunk * splits >= K, kchunk <= 512;
// act: 0 none, 1 relu, 2 silu, 3 gelu.  Returns cudaGetLastError().
extern "C" int matmul_fused_f32(const void* x, const void* w, const void* b,
                                void* part, void* y, int M, int N, int K,
                                int splits, int kchunk, int act, void* stream) {
  if (kchunk > KMAX || kchunk < 1 || (long)kchunk * splits < K || M < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(part);
  if (M <= 1) launch_partial<1>(xf, wf, pf, M, N, K, splits, kchunk, st);
  else if (M <= 2) launch_partial<2>(xf, wf, pf, M, N, K, splits, kchunk, st);
  else if (M <= 4) launch_partial<4>(xf, wf, pf, M, N, K, splits, kchunk, st);
  else if (M <= 8) launch_partial<8>(xf, wf, pf, M, N, K, splits, kchunk, st);
  else launch_partial<16>(xf, wf, pf, M, N, K, splits, kchunk, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  long mn = (long)M * N;
  int blocks = (int)((mn + 255) / 256);
  if (blocks > 4096) blocks = 4096;
  mm_reduce<<<blocks, 256, 0, st>>>(pf, static_cast<const float*>(b),
                                    static_cast<float*>(y), M, N, splits, act);
  return (int)cudaGetLastError();
}
