// K3: y = act(x @ w + b), act one of none, relu, silu, gelu (tanh form).
// x [M, K], w [K, N] and y [M, N] all fp32 or all bf16, b [N] fp32 or
// null, all contiguous.  Operands are converted to fp32 on load, every sum
// is fp32, the bias and the activation are applied in fp32, and y is
// stored once in the operands' type.
//
// Replaces the TPU kernel src/repro/kernels/matmul_fused/kernel.py
// matmul_fused_pallas -> _kernel.
//
// Two paths, chosen by the host from M and passed as ``tiled``; each sums
// in a fixed order, so repeated runs give the same bits (no atomics):
//
// * Weight stream (M below 64: AlexNet's fc layers at batch 1 to 16, an
//   LM decode step, a short prompt).  Bound on the H100: bytes.  AlexNet's
//   fc6 streams 151 MB for 2 * M * 37.7 M operations, about 45 us at 3.35
//   TB/s against 1 to 18 us of fp32 FMAs; a decode step of gemma2-2b
//   streams 156 MB of bf16 weights a layer for M = 4.  So the design fills
//   every SM with weight rows, not with square tiles:
//     pass 1: a block owns 512 output columns (4 a thread, 128 apart so
//             each warp reads contiguous bytes of a weight row) and a K
//             slice, keeps its x slice [BM, <= 512] in shared memory, and
//             writes its partial sums to a scratch [splits, M, N];
//     pass 2: sums the partials in split order, adds the bias and applies
//             the activation.
//   The split count is chosen by the host so that about four blocks per SM
//   are in flight while the partials stay small next to the weights.
// * Tiles (M of 64 and more: an LM prefill, M the prompt length).  Bound:
//   operations (2 * 4500 * 2304 * 9216 for gemma2-2b's gate projection of
//   a 4500-token prompt).  A classic fp32 CUDA-core tile: a block of 256
//   threads owns a 128 x 128 output tile, each thread 8 x 8 of it, and
//   walks K in steps of 8 through double-buffered shared memory (the next
//   step's loads in registers while this step computes); no split of K,
//   the epilogue adds the bias and applies the activation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MM_THREADS = 128;
constexpr int COLS = 4;                       // columns per thread
constexpr int BN = MM_THREADS * COLS;         // columns per block
constexpr int KMAX = 512;                     // largest K slice a block takes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int BM, typename T>
__global__ void __launch_bounds__(MM_THREADS)
mm_partial(const T* __restrict__ x, const T* __restrict__ w,
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
    xs[m][k] = (m0 + m < M) ? to_f(x[(long)(m0 + m) * K + kb + k]) : 0.f;
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
      const T* row = w + (long)(kb + k + u) * N + n0;
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        wv[u][j] = ok[j] ? to_f(row[j * MM_THREADS]) : 0.f;
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
    const T* row = w + (long)(kb + k) * N + n0;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      float wv = ok[j] ? to_f(row[j * MM_THREADS]) : 0.f;
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

template <typename T>
__global__ void mm_reduce(const float* __restrict__ part,
                          const float* __restrict__ b, T* __restrict__ y,
                          int M, int N, int splits, int act) {
  long mn = (long)M * N;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < mn;
       i += (long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += part[s * mn + i];
    if (b) v += b[i % N];
    y[i] = from_f<T>(activate(v, act));
  }
}

template <int BM, typename T>
void launch_partial(const T* x, const T* w, float* part, int M, int N, int K,
                    int splits, int kchunk, cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, splits, (M + BM - 1) / BM);
  mm_partial<BM, T><<<grid, MM_THREADS, 0, st>>>(x, w, part, M, N, K, kchunk);
}

constexpr int TM = 128, TN = 128, TK = 8, TT = 256;

template <typename T>
__global__ void __launch_bounds__(TT)
mm_tiled(const T* __restrict__ x, const T* __restrict__ w,
         const float* __restrict__ b, T* __restrict__ y, int M, int N, int K,
         int act) {
  __shared__ __align__(16) float As[2][TK][TM];  // x tile, k-major
  __shared__ __align__(16) float Bs[2][TK][TN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int a_r = tid >> 1, a_c = (tid & 1) * 4;    // x: row, 4 k's
  const int b_r = tid >> 5, b_c = (tid & 31) * 4;   // w: k, 4 columns
  const int ty = tid / 16, tx = tid % 16;
  float ra[4], rb[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = k0 + a_c + u;
      ra[u] = (m0 + a_r < M && kk < K) ? to_f(x[(long)(m0 + a_r) * K + kk]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = k0 + b_r, nn = n0 + b_c + u;
      rb[u] = (kk < K && nn < N) ? to_f(w[(long)kk * N + nn]) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int u = 0; u < 4; ++u) As[buf][a_c + u][a_r] = ra[u];
    *reinterpret_cast<float4*>(&Bs[buf][b_r][b_c]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int nk = (K + TK - 1) / TK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) load((t + 1) * TK);
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (t + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n >= N) continue;
      float v = acc[i][j];
      if (b) v += b[n];
      y[(long)m * N + n] = from_f<T>(activate(v, act));
    }
  }
}

template <typename T>
int run(const void* x, const void* w, const void* b, void* part, void* y,
        int M, int N, int K, int tiled, int splits, int kchunk, int act,
        void* stream) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const T* xf = static_cast<const T*>(x);
  const T* wf = static_cast<const T*>(w);
  const float* bf = static_cast<const float*>(b);
  T* yf = static_cast<T*>(y);
  if (tiled) {
    dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
    mm_tiled<T><<<grid, TT, 0, st>>>(xf, wf, bf, yf, M, N, K, act);
    return (int)cudaGetLastError();
  }
  if (splits < 1 || kchunk > KMAX || kchunk < 1 || (long)kchunk * splits < K)
    return (int)cudaErrorInvalidValue;
  float* pf = static_cast<float*>(part);
  if (M <= 1) launch_partial<1, T>(xf, wf, pf, M, N, K, splits, kchunk, st);
  else if (M <= 2) launch_partial<2, T>(xf, wf, pf, M, N, K, splits, kchunk, st);
  else if (M <= 4) launch_partial<4, T>(xf, wf, pf, M, N, K, splits, kchunk, st);
  else if (M <= 8) launch_partial<8, T>(xf, wf, pf, M, N, K, splits, kchunk, st);
  else launch_partial<16, T>(xf, wf, pf, M, N, K, splits, kchunk, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  long mn = (long)M * N;
  int blocks = (int)((mn + 255) / 256);
  if (blocks > 4096) blocks = 4096;
  mm_reduce<T><<<blocks, 256, 0, st>>>(pf, bf, yf, M, N, splits, act);
  return (int)cudaGetLastError();
}

}  // namespace

// tiled = 1 takes the tiled path (part, splits and kchunk unused); tiled = 0
// the weight stream, with part holding splits * M * N floats, splits >= 1,
// kchunk * splits >= K and kchunk <= 512.  act: 0 none, 1 relu, 2 silu,
// 3 gelu.  Return cudaGetLastError().
extern "C" int matmul_fused_f32(const void* x, const void* w, const void* b,
                                void* part, void* y, int M, int N, int K,
                                int tiled, int splits, int kchunk, int act,
                                void* stream) {
  return run<float>(x, w, b, part, y, M, N, K, tiled, splits, kchunk, act,
                    stream);
}

extern "C" int matmul_fused_bf16(const void* x, const void* w, const void* b,
                                 void* part, void* y, int M, int N, int K,
                                 int tiled, int splits, int kchunk, int act,
                                 void* stream) {
  return run<__nv_bfloat16>(x, w, b, part, y, M, N, K, tiled, splits, kchunk,
                            act, stream);
}
