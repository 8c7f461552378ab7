// K3: y = act(x @ w + b), act one of none, relu, silu, gelu (tanh form).
// x [M, K], w [K, N] and y [M, N] all fp32 or all bf16, b [N] fp32 or
// null, all contiguous.  Every sum is fp32, the bias and the activation
// are applied in fp32, and y is stored once in the operands' type.
//
// Replaces the TPU kernel src/repro/kernels/matmul_fused/kernel.py
// matmul_fused_pallas -> _kernel.
//
// Three paths, chosen by the host from the type, the shape and the
// pointers and passed as ``path``.  Each sums in a fixed order, so repeated
// runs give the same bits (no atomics in any sum), and on each path a
// row's result does not depend on how many rows share the call: the order
// of every sum is fixed by K, N and the card's SM count, never by M.  The
// path itself changes at 64 rows, and with it the order.
//
// * Weight stream (path 0; M below 64 in either type: AlexNet's fc layers
//   at batch 1 to 16, an LM decode step, a short prompt).  Bound on the
//   H100: bytes.  AlexNet's fc6 streams 151 MB for 2 * M * 37.7 M
//   operations, 45 us at 3.35 TB/s against 1 to 18 us of fp32 FMAs; a
//   decode step of gemma2-2b streams 156 MB of bf16 weights a layer, and
//   its gate projection alone 42.5 MB, 12.7 us.  One launch a call, which
//   reads every weight byte from HBM once whatever M, and no partial sums
//   in global memory:
//     - A block owns SW_BN output columns and one K slice of whole ring
//       stages, and keeps the partial sums of every row of the call (M
//       padded to the row tile) for its columns.  The K slices of a column
//       block are one thread-block cluster (SW_CLUSTER blocks at most).
//       The slicing (ops.split_k) is a function of K, N and the SM count
//       only: about SW_BLOCKS_PER_SM blocks an SM.
//     - w's [stage rows, SW_BN] tile and x's [rows, stage rows] tile come
//       through a ring of SW_STAGES shared-memory stages by 16-byte
//       cp.async (zero-filled past K, N and M), three stages in flight
//       while one computes: 24 KB of weights a block, about 48 KB an SM.
//       x comes through the ring beside w rather than once a slice: at 63
//       rows a slice of x would not fit beside the ring.  Shapes whose rows
//       are not whole 16-byte chunks (LeNet-5's fc3, N = 10) take 4-byte
//       copies (fp32) or plain loads (bf16) into the same layout.
//     - After the ring, the block adds its warps' sums in a fixed tree,
//       leaves its fp32 partial tile in its own shared memory and waits at
//       the cluster barrier; then block r of the cluster sums its share of
//       the tile's outputs over the slices in rank order (0, 1, ...,
//       through distributed shared memory), adds the bias, applies the
//       activation and stores y once; a second cluster barrier keeps every
//       partial alive until it has been read.
//   fp32: CUDA-core FMAs (a tensor core would round the operands to
//   TF32).  Warp j of 8 takes the stage rows 4 j to 4 j + 3 in order; a
//   lane owns two columns for every row of the tile, and reads a row's
//   four x values as one float4 (a broadcast).  At fc6's M = 16, 16 *
//   37.7 M FMAs are 18 us on 132 SMs, under its 45 us of bytes.
//   bf16: tensor cores, mma.sync m16n8k16 (products of bf16 operands are
//   exact in fp32; the sums stay in one fixed order).  By arithmetic:
//   gemma2's gate at M = 16 needs 16 * 21.2 M = 340 M FMAs, 10.2 us at the
//   card's 33.4 T FMA/s, 80 % of the 12.7 us the bytes take, before the
//   conversion of each weight to fp32 and the shared-memory reads of both
//   operands that every FMA needs: CUDA-core FMAs would exceed the byte
//   bound there.  A row's bits must not depend on M, so the form taken at
//   M = 16 is taken at every M: a 16-row tile of the tensor cores, whose
//   padding rows cost 0.7 us of their rate at M = 1.  Warps 0-3 own 16
//   columns each over the even k16 steps of a stage, warps 4-7 the same
//   columns over the odd ones (ldmatrix of both operands from rows padded
//   to distinct banks); the two halves are added in that order.
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
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper_common.cuh"

namespace {

using namespace hopper;
namespace coop = cooperative_groups;

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

__device__ inline float activate(float y, int act) {
  if (act == 1) return fmaxf(y, 0.f);
  if (act == 2) return y * (1.f / (1.f + expf(-y)));
  if (act == 3)
    return 0.5f * y * (1.f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
  return y;
}

// -- path 0: the weight stream ----------------------------------------------

constexpr int SW_THREADS = 256;   // 8 warps
constexpr int SW_BN = 64;         // output columns of a block
constexpr int SW_STAGES = 4;      // the shared-memory ring
constexpr int SW_BK16 = 64;       // K rows of a stage, bf16
constexpr int SW_BK32 = 32;       // K rows of a stage, fp32
constexpr int SW_PAD16 = 8;       // bf16 row padding: ldmatrix rows on distinct banks
constexpr int SW_CLUSTER = 8;     // most K slices: the blocks of one cluster
constexpr int SW_BLOCKS_PER_SM = 2;  // the slicing's aim (ops.split_k)
constexpr int SW_MT = 4;          // most 16-row m tiles, bf16
constexpr int SW_BM32 = 64;       // most rows of the fp32 tile
constexpr int SW_LD16 = SW_BN + SW_PAD16;  // a bf16 tile row, w's and x's
static_assert(SW_BN == SW_BK16, "w's and x's bf16 tile rows share SW_LD16");
static_assert(16 * SW_MT == 64 && SW_BM32 == 64,
              "the row tiles reach the 63 rows below the tiled paths");

// dynamic shared memory of the ring: bf16 with MT m tiles, fp32 with BM rows
constexpr int sw_smem16(int mt) {
  return SW_STAGES * (SW_BK16 + 16 * mt) * SW_LD16 * 2;
}
constexpr int sw_smem32(int bm) {
  return SW_STAGES * SW_BK32 * (SW_BN + bm) * 4;
}

// Block r of the cluster sums its share of the [rows, SW_BN] partial tiles
// over the cluster's blocks in rank order, adds the bias, applies the
// activation and stores y's rows below M and columns below N.
template <typename T>
__device__ __forceinline__ void sw_cluster_sum(const float* part, int rows,
                                               const float* __restrict__ b,
                                               T* __restrict__ y, int M,
                                               int N, int n0, int act) {
  coop::cluster_group cluster = coop::this_cluster();
  cluster.sync();  // every slice's partial tile is written
  const int S = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int total = min(M, rows) * SW_BN;
  const int share = (total + S - 1) / S;
  const int e1 = min(total, (r + 1) * share);
  for (int e = r * share + (int)threadIdx.x; e < e1; e += SW_THREADS) {
    const int m = e / SW_BN, n = n0 + e % SW_BN;
    if (n >= N) continue;
    float* p = const_cast<float*>(part + e);
    float v = *cluster.map_shared_rank(p, 0);
    for (int q = 1; q < S; ++q) v += *cluster.map_shared_rank(p, q);
    if (b) v += b[n];
    y[(long)m * N + n] = from_f<T>(activate(v, act));
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// One bf16 stage: w rows [k0, k0 + SW_BK16) x columns [n0, n0 + SW_BN) and
// x rows [0, 16 MT) x the same K rows, zeros past K, N and M.
template <int MT, bool VEC>
__device__ __forceinline__ void sw_load16(const __nv_bfloat16* x,
                                          const __nv_bfloat16* w,
                                          __nv_bfloat16* ws,
                                          __nv_bfloat16* xs, int M, int N,
                                          int K, int k0, int n0) {
  constexpr int WQ = SW_BN / 8, XQ = SW_BK16 / 8;  // 16-byte chunks a row
  if (VEC) {
    for (int c = threadIdx.x; c < SW_BK16 * WQ; c += SW_THREADS) {
      const int r = c / WQ, q = c % WQ, k = k0 + r, n = n0 + 8 * q;
      const bool ok = k < K && n < N;
      cp_async16(ws + r * SW_LD16 + 8 * q, ok ? w + (long)k * N + n : w, ok);
    }
    for (int c = threadIdx.x; c < 16 * MT * XQ; c += SW_THREADS) {
      const int r = c / XQ, q = c % XQ, k = k0 + 8 * q;
      const bool ok = r < M && k < K;
      cp_async16(xs + r * SW_LD16 + 8 * q, ok ? x + (long)r * K + k : x, ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int e = threadIdx.x; e < SW_BK16 * SW_BN; e += SW_THREADS) {
      const int r = e / SW_BN, c = e % SW_BN, k = k0 + r, n = n0 + c;
      ws[r * SW_LD16 + c] = k < K && n < N ? w[(long)k * N + n] : zero;
    }
    for (int e = threadIdx.x; e < 16 * MT * SW_BK16; e += SW_THREADS) {
      const int r = e / SW_BK16, c = e % SW_BK16, k = k0 + c;
      xs[r * SW_LD16 + c] = r < M && k < K ? x[(long)r * K + k] : zero;
    }
  }
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(SW_THREADS)
mm_stream16(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ w, const float* __restrict__ b,
            __nv_bfloat16* __restrict__ y, int M, int N, int K, int kslice,
            int act) {
  extern __shared__ __align__(16) unsigned char sw_raw[];
  constexpr int W_ELEMS = SW_BK16 * SW_LD16, STAGE = W_ELEMS + 16 * MT * SW_LD16;
  static_assert(2 * 16 * MT * SW_BN * 4 <= SW_STAGES * STAGE * 2,
                "the partial tiles fit in the ring");
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(sw_raw);
  const int kb = (int)coop::this_cluster().block_rank() * kslice;
  const int n0 = blockIdx.y * SW_BN;
  const int nst = (min(K, kb + kslice) - kb + SW_BK16 - 1) / SW_BK16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cw = warp % 4, kw = warp / 4;  // 16 columns; even or odd k16 steps
  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[mt][i / 4][i % 4] = 0.f;
  for (int s = 0; s < SW_STAGES - 1; ++s) {
    if (s < nst)
      sw_load16<MT, VEC>(x, w, ring + s * STAGE, ring + s * STAGE + W_ELEMS,
                         M, N, K, kb + s * SW_BK16, n0);
    cp_async_commit();
  }
  for (int t = 0; t < nst; ++t) {
    cp_async_wait<SW_STAGES - 2>();  // stage t has landed
    __syncthreads();                 // for every thread; stage t - 1 is free
    const int nt = t + SW_STAGES - 1;
    if (nt < nst) {
      __nv_bfloat16* st = ring + (nt % SW_STAGES) * STAGE;
      sw_load16<MT, VEC>(x, w, st, st + W_ELEMS, M, N, K, kb + nt * SW_BK16,
                         n0);
    }
    cp_async_commit();
    const __nv_bfloat16* ws = ring + (t % SW_STAGES) * STAGE;
    const __nv_bfloat16* xs = ws + W_ELEMS;
#pragma unroll
    for (int i = 0; i < SW_BK16 / 32; ++i) {
      const int kk = 16 * (2 * i + kw);
      uint32_t bq[4];
      ldsm_x4_trans(bq, ws + (kk + (lane & 15)) * SW_LD16 + 16 * cw +
                            8 * (lane >> 4));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, xs + (16 * mt + (lane & 15)) * SW_LD16 + kk + 8 * (lane >> 4));
        mma_bf16(acc[mt][0], a, bq[0], bq[1]);
        mma_bf16(acc[mt][1], a, bq[2], bq[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the partial tiles now
  float* red = reinterpret_cast<float*>(sw_raw);  // the odd steps' sums
  float* part = red + 16 * MT * SW_BN;            // the block's partial tile
  // acc[mt][j][2 h + e]: row 16 mt + lane / 4 + 8 h, column 16 cw + 8 j +
  // 2 (lane % 4) + e
  const int r0 = lane / 4, c0 = 16 * cw + 2 * (lane % 4);
  if (kw == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        red[(16 * mt + r0 + 8 * (i % 4 / 2)) * SW_BN + c0 + 8 * (i / 4) +
            i % 2] = acc[mt][i / 4][i % 4];
  }
  __syncthreads();
  if (kw == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = (16 * mt + r0 + 8 * (i % 4 / 2)) * SW_BN + c0 +
                      8 * (i / 4) + i % 2;
        part[e] = acc[mt][i / 4][i % 4] + red[e];
      }
  }
  sw_cluster_sum(part, 16 * MT, b, y, M, N, n0, act);
}

// One fp32 stage: w rows [k0, k0 + SW_BK32) x columns [n0, n0 + SW_BN),
// and x's rows [0, BM) x the same K rows (xs[m * SW_BK32 + k]), zeros past
// K, N and M.
template <int BM, bool VEC>
__device__ __forceinline__ void sw_load32(const float* x, const float* w,
                                          float* ws, float* xs, int M, int N,
                                          int K, int k0, int n0) {
  if (VEC) {
    constexpr int WQ = SW_BN / 4, XQ = SW_BK32 / 4;  // 16-byte chunks a row
    for (int c = threadIdx.x; c < SW_BK32 * WQ; c += SW_THREADS) {
      const int r = c / WQ, q = c % WQ, k = k0 + r, n = n0 + 4 * q;
      const bool ok = k < K && n < N;
      cp_async16(ws + r * SW_BN + 4 * q, ok ? w + (long)k * N + n : w, ok);
    }
    for (int c = threadIdx.x; c < BM * XQ; c += SW_THREADS) {
      const int m = c / XQ, q = c % XQ, k = k0 + 4 * q;
      const bool ok = m < M && k < K;
      cp_async16(xs + m * SW_BK32 + 4 * q, ok ? x + (long)m * K + k : x, ok);
    }
  } else {
    for (int e = threadIdx.x; e < SW_BK32 * SW_BN; e += SW_THREADS) {
      const int r = e / SW_BN, c = e % SW_BN, k = k0 + r, n = n0 + c;
      const bool ok = k < K && n < N;
      cp_async4(ws + e, ok ? w + (long)k * N + n : w, ok);
    }
    for (int e = threadIdx.x; e < BM * SW_BK32; e += SW_THREADS) {
      const int m = e / SW_BK32, kk = e % SW_BK32, k = k0 + kk;
      const bool ok = m < M && k < K;
      cp_async4(xs + e, ok ? x + (long)m * K + k : x, ok);
    }
  }
}

template <int BM, bool VEC>
__global__ void __launch_bounds__(SW_THREADS)
mm_stream32(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ b, float* __restrict__ y, int M, int N,
            int K, int kslice, int act) {
  extern __shared__ __align__(16) unsigned char sw_raw[];
  constexpr int W_ELEMS = SW_BK32 * SW_BN, STAGE = W_ELEMS + SW_BK32 * BM;
  static_assert(4 * BM * SW_BN <= SW_STAGES * STAGE,
                "the k-way tree's tiles fit in the ring");
  float* ring = reinterpret_cast<float*>(sw_raw);
  const int kb = (int)coop::this_cluster().block_rank() * kslice;
  const int n0 = blockIdx.y * SW_BN;
  const int nst = (min(K, kb + kslice) - kb + SW_BK32 - 1) / SW_BK32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[BM][2];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m][0] = acc[m][1] = 0.f;
  for (int s = 0; s < SW_STAGES - 1; ++s) {
    if (s < nst)
      sw_load32<BM, VEC>(x, w, ring + s * STAGE, ring + s * STAGE + W_ELEMS,
                         M, N, K, kb + s * SW_BK32, n0);
    cp_async_commit();
  }
  for (int t = 0; t < nst; ++t) {
    cp_async_wait<SW_STAGES - 2>();
    __syncthreads();
    const int nt = t + SW_STAGES - 1;
    if (nt < nst) {
      float* st = ring + (nt % SW_STAGES) * STAGE;
      sw_load32<BM, VEC>(x, w, st, st + W_ELEMS, M, N, K, kb + nt * SW_BK32,
                         n0);
    }
    cp_async_commit();
    const float* ws = ring + (t % SW_STAGES) * STAGE;
    const float* xs = ws + W_ELEMS;
    // warp j takes the stage rows 4 j .. 4 j + 3 in order; lane l the
    // columns 2 l and 2 l + 1
    static_assert(SW_BK32 == 4 * SW_THREADS / 32, "four stage rows a warp");
    float2 wv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      wv[u] = *reinterpret_cast<const float2*>(ws + (4 * warp + u) * SW_BN +
                                               2 * lane);
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      const float4 xv =
          *reinterpret_cast<const float4*>(xs + m * SW_BK32 + 4 * warp);
      const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[m][0] = fmaf(xq[u], wv[u].x, acc[m][0]);
        acc[m][1] = fmaf(xq[u], wv[u].y, acc[m][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // the 8 warps' sums in a fixed tree, ((w0 + w4) + (w2 + w6)) + ((w1 + w5)
  // + (w3 + w7)), through tiles slot(0..3) of the ring; warp 0's result,
  // the block's partial tile, ends in slot(0)
  auto slot = [&](int j) { return ring + j * BM * SW_BN; };
#pragma unroll
  for (int half = 4; half >= 1; half /= 2) {
    if (warp >= half && warp < 2 * half) {
      float* t = slot(warp - half);
#pragma unroll
      for (int m = 0; m < BM; ++m)
        *reinterpret_cast<float2*>(t + m * SW_BN + 2 * lane) =
            make_float2(acc[m][0], acc[m][1]);
    }
    __syncthreads();
    if (warp < half) {
      const float* t = slot(warp);
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float2 v = *reinterpret_cast<const float2*>(t + m * SW_BN +
                                                          2 * lane);
        acc[m][0] += v.x;
        acc[m][1] += v.y;
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
#pragma unroll
    for (int m = 0; m < BM; ++m)
      *reinterpret_cast<float2*>(slot(0) + m * SW_BN + 2 * lane) =
          make_float2(acc[m][0], acc[m][1]);
  }
  sw_cluster_sum(slot(0), BM, b, y, M, N, n0, act);
}

// One launch of stream kernel Kern: a grid of (splits, column blocks), each
// column block's splits one cluster.
template <auto Kern, typename T>
int sw_launch(int smem, const T* x, const T* w, const float* b, T* y, int M,
              int N, int K, int splits, int kslice, int act,
              cudaStream_t st) {
  static std::atomic<unsigned long long> opted{0};
  cudaError_t e = opt_in_smem(Kern, smem, opted);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + SW_BN - 1) / SW_BN);
  cfg.blockDim = dim3(SW_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, Kern, x, w, b, y, M, N, K, kslice, act);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int MT>
int stream16(bool vec, const __nv_bfloat16* x, const __nv_bfloat16* w,
             const float* b, __nv_bfloat16* y, int M, int N, int K,
             int splits, int kslice, int act, cudaStream_t st) {
  return vec ? sw_launch<mm_stream16<MT, true>>(sw_smem16(MT), x, w, b, y, M,
                                                N, K, splits, kslice, act, st)
             : sw_launch<mm_stream16<MT, false>>(sw_smem16(MT), x, w, b, y, M,
                                                 N, K, splits, kslice, act, st);
}

template <int BM>
int stream32(bool vec, const float* x, const float* w, const float* b,
             float* y, int M, int N, int K, int splits, int kslice, int act,
             cudaStream_t st) {
  return vec ? sw_launch<mm_stream32<BM, true>>(sw_smem32(BM), x, w, b, y, M,
                                                N, K, splits, kslice, act, st)
             : sw_launch<mm_stream32<BM, false>>(sw_smem32(BM), x, w, b, y, M,
                                                 N, K, splits, kslice, act, st);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The weight stream: its row tile from M (16-row m tiles for bf16, 4 to
// 64 rows for fp32), whole 16-byte chunks where the rows and bases allow.
int launch_stream(const __nv_bfloat16* x, const __nv_bfloat16* w,
                  const float* b, __nv_bfloat16* y, int M, int N, int K,
                  int splits, int kslice, int act, cudaStream_t st) {
  const bool vec = aligned16(x) && aligned16(w) && K % 8 == 0 && N % 8 == 0;
  switch ((M + 15) / 16) {
    case 1: return stream16<1>(vec, x, w, b, y, M, N, K, splits, kslice, act, st);
    case 2: return stream16<2>(vec, x, w, b, y, M, N, K, splits, kslice, act, st);
    case 3: return stream16<3>(vec, x, w, b, y, M, N, K, splits, kslice, act, st);
    case SW_MT: return stream16<SW_MT>(vec, x, w, b, y, M, N, K, splits, kslice, act, st);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_stream(const float* x, const float* w, const float* b, float* y,
                  int M, int N, int K, int splits, int kslice, int act,
                  cudaStream_t st) {
  const bool vec = aligned16(x) && aligned16(w) && K % 4 == 0 && N % 4 == 0;
  if (M <= 4) return stream32<4>(vec, x, w, b, y, M, N, K, splits, kslice, act, st);
  if (M <= 8) return stream32<8>(vec, x, w, b, y, M, N, K, splits, kslice, act, st);
  if (M <= 16) return stream32<16>(vec, x, w, b, y, M, N, K, splits, kslice, act, st);
  if (M <= 32) return stream32<32>(vec, x, w, b, y, M, N, K, splits, kslice, act, st);
  return stream32<SW_BM32>(vec, x, w, b, y, M, N, K, splits, kslice, act, st);
}

// -- path 1: CUDA-core tiles -------------------------------------------------

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
  static std::atomic<unsigned long long> opted{0};
  cudaError_t e = opt_in_smem(mm_wgmma, WG_SMEM, opted);
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
int run(const void* x, const void* w, const void* b, void* y, int M, int N,
        int K, int path, int splits, int kchunk, int act, void* stream) {
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
  // K slices of whole stages, none empty, one cluster of them
  const int bk = sizeof(T) == 2 ? SW_BK16 : SW_BK32;
  if (M >= 64 || splits < 1 || splits > SW_CLUSTER || kchunk < 1 ||
      kchunk % bk || (long)(splits - 1) * kchunk >= K ||
      (long)splits * kchunk < K || (N + SW_BN - 1) / SW_BN > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_stream(xf, wf, bf, yf, M, N, K, splits, kchunk, act, st);
}

}  // namespace

// path 0: the weight stream (M below 64), in ``splits`` K slices of
// ``kchunk`` rows (ops.split_k: 1 to SW_CLUSTER slices, kchunk a multiple
// of the type's stage rows, every slice holding rows); path 1: CUDA-core
// tiles; path 2 (bf16 only): TMA + wgmma tiles of 128 x 128, K and N
// multiples of 8, x and w 16-byte aligned.  splits and kchunk are read by
// path 0 only.  act: 0 none, 1 relu, 2 silu, 3 gelu.  Return a CUDA error
// code, 0 when the launch was taken.  No call allocates or synchronises.
extern "C" int matmul_fused_f32(const void* x, const void* w, const void* b,
                                void* y, int M, int N, int K, int path,
                                int splits, int kchunk, int act,
                                void* stream) {
  return run<float>(x, w, b, y, M, N, K, path, splits, kchunk, act, stream);
}

extern "C" int matmul_fused_bf16(const void* x, const void* w, const void* b,
                                 void* y, int M, int N, int K, int path,
                                 int splits, int kchunk, int act,
                                 void* stream) {
  return run<__nv_bfloat16>(x, w, b, y, M, N, K, path, splits, kchunk, act,
                            stream);
}
