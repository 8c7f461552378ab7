// K3: y = act(x @ w + b), act one of none, relu, silu, gelu (tanh form).
// x [M, K], w [K, N] and y [M, N] all fp32 or all bf16, b [N] fp32 or
// null, all contiguous.  Every sum is fp32, the bias and the activation
// are applied in fp32, and y is stored once in the operands' type.
//
// Replaces the TPU kernel src/repro/kernels/matmul_fused/kernel.py
// matmul_fused_pallas -> _kernel.
//
// Three paths, chosen by the host from the type, the shape and the
// pointers and passed as ``path``; each sums in a fixed order, so repeated
// runs give the same bits (no atomics), and a row's result does not depend
// on how many rows share the call:
//
// * Weight stream (path 0; M below 64 in either type: AlexNet's fc layers
//   at batch 1 to 16, an LM decode step, a short prompt).  Bound on the
//   H100: bytes.  AlexNet's fc6 streams 151 MB for 2 * M * 37.7 M
//   operations, about 45 us at 3.35 TB/s against 1 to 18 us of fp32 FMAs;
//   a decode step of gemma2-2b streams 156 MB of bf16 weights a layer for
//   M = 4.  So the design fills every SM with weight rows, not with square
//   tiles:
//     pass 1: a block owns 512 output columns (4 a thread, 128 apart so
//             each warp reads contiguous bytes of a weight row) and a K
//             slice, keeps its x slice [BM, <= 512] in shared memory, and
//             writes its partial sums to a scratch [splits, M, N];
//     pass 2: sums the partials in split order, adds the bias and applies
//             the activation.
//   The split count is chosen by the host so that about four blocks per SM
//   are in flight while the partials stay small next to the weights.
// * Tensor-core tiles (path 2; bf16 with M of 64 and more: an LM prefill,
//   M the prompt length; K and N multiples of 8 and x, w 16-byte aligned,
//   as TMA needs).  Bound: operations (2 * 4500 * 2304 * 9216 for
//   gemma2-2b's gate projection of a 4500-token prompt, 0.19 ms at 989
//   TFLOP/s).  Products of bf16 operands are exact in fp32, so Hopper's
//   tensor cores compute the contract's function: ``mm_wgmma`` gives a
//   block of 384 threads a 128 x 128 output tile, whatever M (blocks walk
//   M first when x is the smaller operand, else N, so that neighbours share
//   its tiles in L2).  Warpgroup 0 is the producer: one thread walks K in
//   steps of 64 and has TMA copy x's [128, 64] box (K-major, 128-byte
//   swizzle) and two boxes of w's [64, 64] (read in its [K, N] layout,
//   N-major, no transposed copy) into a ring of four shared-memory stages,
//   one pair of mbarriers (full, empty) per stage.  Warpgroups 1 and 2
//   each own 64 rows of the tile and run wgmma m64n128k16 (B transposed)
//   four times a stage into fp32 registers, releasing a stage once the
//   next one's products are issued.  No split of K: each block sums K from
//   0 to K in order.  The epilogue adds the bias and applies the activation in fp32
//   on the registers, stages the bf16 tile in shared memory and stores it
//   in coalesced 16-byte chunks, rows at and past M masked (TMA fills the
//   missing rows and the K tail with zeros on load).
// * CUDA-core tiles (path 1; fp32 with M of 64 and more, and bf16 shapes
//   TMA cannot describe).  Bound: operations, at the fp32 rate.  A classic
//   fp32 tile: a block of 256 threads owns a 128 x 128 output tile, each
//   thread 8 x 8 of it, and walks K in steps of 8 through double-buffered
//   shared memory (the next step's loads in registers while this step
//   computes); operands are converted to fp32 on load; no split of K, the
//   epilogue adds the bias and applies the activation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

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

// -- path 2: TMA + wgmma ---------------------------------------------------

// a block's tile is WG_BM x WG_BN; it walks K in steps of WG_BK through a
// ring of WG_STAGES stages, each an x box and WG_BN / 64 w boxes
constexpr int WG_BM = 128, WG_BN = 128, WG_BK = 64, WG_STAGES = 4;
constexpr int WG_THREADS = 384;
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;  // x box [128 rows, 64 K]
constexpr int WG_BOX_BYTES = WG_BK * 64 * 2;   // w box [64 K rows, 64 N]
constexpr int WG_STAGE_BYTES = WG_A_BYTES + WG_BN / 64 * WG_BOX_BYTES;
// the ring, 1 KB to align it to the 128-byte swizzle's 1 KB pattern, and
// a full and an empty barrier per stage
constexpr int WG_SMEM = WG_STAGES * WG_STAGE_BYTES + 1024 + 2 * WG_STAGES * 8;

#define D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d = a (64 x 16, K-major) * b (16 x 128, N-major) + (acc ? d : 0), fp32
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24),
        D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(acc));
}

#undef D8

__global__ void __launch_bounds__(WG_THREADS, 1)
mm_wgmma(const __grid_constant__ CUtensorMap xmap,
         const __grid_constant__ CUtensorMap wmap,
         const float* __restrict__ b, __nv_bfloat16* __restrict__ y, int M,
         int N, int K, int act, int m_fast) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t bars = ring + WG_STAGES * WG_STAGE_BYTES;
  auto a_at = [&](int s) { return ring + s * WG_STAGE_BYTES; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (WG_STAGES + s); };
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m0 = (m_fast ? blockIdx.x : blockIdx.y) * WG_BM;
  const int n0 = (m_fast ? blockIdx.y : blockIdx.x) * WG_BN;
  const int nk = (K + WG_BK - 1) / WG_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % WG_STAGES;
        if (kb >= WG_STAGES) mbar_wait(empty(s), (kb / WG_STAGES - 1) & 1);
        mbar_expect_tx(full(s), WG_STAGE_BYTES);
        tma_load(a_at(s), &xmap, full(s), kb * WG_BK, m0);
#pragma unroll
        for (int j = 0; j < WG_BN / 64; ++j)
          tma_load(a_at(s) + WG_A_BYTES + j * WG_BOX_BYTES, &wmap, full(s),
                   n0 + 64 * j, kb * WG_BK);
      }
    }
  } else {
    // consumers: warpgroup c owns rows 64 c .. 64 c + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    // the first product writes d without reading it: no instruction but
    // a wgmma defines the accumulators, so the products of a stage issue
    // back to back
    float d[WG_BN / 2];
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % WG_STAGES;
      mbar_wait(full(s), (kb / WG_STAGES) & 1);
      const uint32_t a = a_at(s) + c * 64 * 128;
      const uint32_t bt = a_at(s) + WG_A_BYTES;
      fence_acc(d);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        wgmma_n128(d, wg_desc(a + 32 * kk, 16, 1024),
                   wg_desc(bt + 16 * 128 * kk, WG_BOX_BYTES, 1024),
                   kb > 0 || kk > 0);
      wg_commit();
      // the previous stage's products are done: release its buffers
      wg_wait<1>();
      fence_acc(d);
      if (kb > 0 && (tid & 31) == 0)
        mbar_arrive(empty((kb - 1) % WG_STAGES));
    }
    wg_wait<0>();
    fence_acc(d);
    // Epilogue: the bias and the activation in fp32 on the registers, then
    // bf16 pairs into this warpgroup's halves of the x boxes, which nobody
    // reads any more (16-byte chunks swizzled by row, so the pairs of one
    // store hit 32 banks), then coalesced 16-byte stores of whole rows.
    // d[4 j + 2 h + e] holds row 16 warp + lane / 4 + 8 h and column
    // 8 j + 2 (lane % 4) + e of the warpgroup's 64 x 128 slice; a box half
    // holds 32 of its rows.
    constexpr int ROW_BYTES = WG_BN * 2, ROWS_PER_BOX = 8192 / ROW_BYTES;
    static_assert(64 / ROWS_PER_BOX <= WG_STAGES, "the epilogue's rows");
    auto out_row = [&](int r) {
      return a_at(r / ROWS_PER_BOX) + c * 8192 +
             (r % ROWS_PER_BOX) * ROW_BYTES;
    };
    const int lane = tid % 32, r0 = 16 * (tid / 32) + lane / 4;
#pragma unroll
    for (int j = 0; j < WG_BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      const bool bias = b && n < N;  // N is a multiple of 8: n + 1 < N too
      const float b0 = bias ? b[n] : 0.f, b1 = bias ? b[n + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
        if (b) {
          v0 += b0;
          v1 += b1;
        }
        __nv_bfloat162 v =
            __floats2bfloat162_rn(activate(v0, act), activate(v1, act));
        asm volatile("st.shared.b32 [%0], %1;\n"
                     :: "r"(out_row(r) + 16 * (j ^ (r % 8)) + 4 * (lane % 4)),
                        "r"(*reinterpret_cast<uint32_t*>(&v))
                     : "memory");
      }
    }
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + c) : "memory");
    constexpr int CHUNKS = WG_BN / 8;  // 16-byte chunks of a row
    for (int e = tid; e < 64 * CHUNKS; e += 128) {
      const int r = e / CHUNKS, ch = e % CHUNKS;
      const int m = m0 + 64 * c + r, n = n0 + 8 * ch;
      if (m >= M || n >= N) continue;
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(out_row(r) + 16 * (ch ^ (r % 8))));
      *reinterpret_cast<uint4*>(y + (long)m * N + n) = v;
    }
  }
}

int launch_wgmma(const void* x, const void* w, const float* b, void* y,
                 int M, int N, int K, int act, cudaStream_t st) {
  CUtensorMap xmap, wmap;
  if (!tensor_map(&xmap, x, M, K, WG_BM, WG_BK) ||
      !tensor_map(&wmap, w, K, N, WG_BK, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      mm_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (e != cudaSuccess) return (int)e;
  // consecutive blocks share the smaller operand's tiles in L2: they walk
  // M first when x is the smaller one (M < N), else N
  const int mt = (M + WG_BM - 1) / WG_BM, nt = (N + WG_BN - 1) / WG_BN;
  const int m_fast = M < N;
  dim3 grid(m_fast ? mt : nt, m_fast ? nt : mt);
  mm_wgmma<<<grid, WG_THREADS, WG_SMEM, st>>>(
      xmap, wmap, b, static_cast<__nv_bfloat16*>(y), M, N, K, act, m_fast);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* x, const void* w, const void* b, void* part, void* y,
        int M, int N, int K, int path, int splits, int kchunk, int act,
        void* stream) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const T* xf = static_cast<const T*>(x);
  const T* wf = static_cast<const T*>(w);
  const float* bf = static_cast<const float*>(b);
  T* yf = static_cast<T*>(y);
  if (path == 2) {  // bf16 only
    if (sizeof(T) != 2) return (int)cudaErrorInvalidValue;
    return launch_wgmma(x, w, bf, y, M, N, K, act, st);
  }
  if (path == 1) {
    dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
    mm_tiled<T><<<grid, TT, 0, st>>>(xf, wf, bf, yf, M, N, K, act);
    return (int)cudaGetLastError();
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
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

// path 0: the weight stream, with part holding splits * M * N floats,
// splits >= 1, kchunk * splits >= K and kchunk <= 512; path 1: CUDA-core
// tiles; path 2 (bf16 only): TMA + wgmma tiles of 128 x 128, K and N
// multiples of 8, x and w 16-byte aligned.  part, splits and kchunk are
// read by path 0 only.  act: 0 none, 1 relu, 2 silu, 3 gelu.  Return a CUDA error code, 0 when the launch was taken.
extern "C" int matmul_fused_f32(const void* x, const void* w, const void* b,
                                void* part, void* y, int M, int N, int K,
                                int path, int splits, int kchunk, int act,
                                void* stream) {
  return run<float>(x, w, b, part, y, M, N, K, path, splits, kchunk, act,
                    stream);
}

extern "C" int matmul_fused_bf16(const void* x, const void* w, const void* b,
                                 void* part, void* y, int M, int N, int K,
                                 int path, int splits, int kchunk, int act,
                                 void* stream) {
  return run<__nv_bfloat16>(x, w, b, part, y, M, N, K, path, splits, kchunk,
                            act, stream);
}
