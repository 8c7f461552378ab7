// K11: RWKV6 chunked WKV (linear attention with a data-dependent decay),
// per head of width E = 64:
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T ;  o_t = r_t (S_{t-1} + u ⊙ k_t v_t^T)
//
// r, k, v and o [b, s, h, E] in one type (fp32 or bf16); logw [b, s, h, E]
// (log w_t < 0), u [h, E], the state [b, h, E, E] (layout [key, value]), all
// fp32 and contiguous.  The state in may be null (zero).  Operands are
// converted to fp32 on load, every sum is fp32, o is stored once in its
// type and the final state in fp32.
//
// Replaces the TPU kernel src/repro/kernels/wkv6/kernel.py wkv6_pallas ->
// _kernel, with the contract of src/repro/nn/rwkv.py _wkv6_chunked, the
// function the model calls: an initial state in, the final state out.
// Chunks of L steps (1 <= L <= 64, the last one padded with r = k = v = 0
// and logw = 0, which leave the state as it was); per chunk, with cw the
// inclusive cumulative sum of logw per channel and cw_prev = cw - logw:
//
//   A[i, j] = sum_c r_i k_j exp(cw_prev_i - cw_j)   (j < i)
//   o       = A v + (r ⊙ u ⊙ k) v + (r ⊙ exp(cw_prev)) S
//   S      <- S exp(cw_L) + U,  U = sum_j (k_j ⊙ exp(cw_L - cw_j)) v_j^T
//
// Bound on the H100: operations.  A 4500-token prefill of rwkv6-1.6b (b 1,
// 32 heads) needs about 4.5 G fp32 operations for 111 MB of bytes moved
// (chip_smoke.wkv6_cost), 0.068 ms at the CUDA cores' peak.  A walk over
// the chunks in order is one block a (batch, head): 32 of the 132 SMs.
// This design trades bytes for parallelism: its scratch (37 MB at that
// prefill) is written, read, rewritten and read again, 335 MB in all
// (0.100 ms at 3.35 TB/s, wkv6_plan counts them), and it cuts the exps,
// the largest share of the operations, about 4x.
//
// Design: three launches a call, on 2272 blocks at that prefill.
//
// 1. wkv6_chunk_state, one block a (batch, head, chunk): a chunk's own
//    contribution U_c to the next state and its total decay exp(cw_L)
//    depend on nothing before the chunk, so every chunk computes them at
//    once, into scratch.
// 2. wkv6_walk, one thread a state element: S_c = exp(cw_L,c) ⊙ S_{c-1} +
//    U_c.  An element of the state depends on itself alone, so the only
//    sequential part of the algorithm is b h E^2 independent scans over
//    the chunks (131072 at b 1, 32 heads), each keeping the loads of the
//    next eight chunks in flight while it consumes eight.  Each walker overwrites U_c with S_{c-1}, the state entering
//    chunk c, and writes the final state.
// 3. wkv6_chunk_out, one block a (batch, head, chunk): the intra-chunk
//    terms and the inter-chunk term (r ⊙ exp(cw_prev)) S_{c-1}, o stored
//    once.
//
// Why three launches and not one cooperative launch with grid barriers:
// the items are 8.6 waves of the card, so a persistent kernel would keep
// nothing in shared memory across its barriers, and it would run every
// pass at the occupancy of the largest (2 blocks an SM, where pass 1
// holds 4).  Measured on an H100 at that prefill, the three kernels'
// device times (59 + 21 + 174 us, torch.profiler) add up to the call's
// device time from a replayed CUDA graph (254 us): the two extra
// launches cost nothing on the device.
//
// Sub-chunk factoring.  A chunk's 64 rows are four sub-chunks of 16.  The
// cumulative decays are formed exactly as the plain version forms them
// (cw by one sequential fp32 sum a channel, cw_prev = cw - logw), so the
// kernel and the plain version share the rounding of cw, which is the
// largest error either makes; every exponent below is a difference of
// those values.  With anchors C_q = cw_prev at the first row of sub-chunk
// q (C_4 = cw_L), for i in sub-chunk q and j in an earlier sub-chunk p:
//
//   cw_prev_i - cw_j = (cw_prev_i - C_q) + (C_q - C_{p+1}) + (C_{p+1} - cw_j)
//
// three terms each <= 0.  So the off-diagonal blocks of A are plain
// products of r_i ⊙ exp(cw_prev_i - C_q) with k_j ⊙ exp(C_{p+1} - cw_j) ⊙
// exp(C_q - C_{p+1}) (a pair factor, 1 where q = p + 1): 64 x 64 exps for
// each side and 3 x 64 for the pair factors.  Only the strictly lower
// halves of the four diagonal 16 x 16 blocks keep one exp per pair and
// channel, exp(cw_prev_i - cw_j): about 39 k exps for A where the previous
// kernel took 164 k.  r ⊙ exp(cw_prev) is (r ⊙ exp(cw_prev_i - C_q))
// exp(C_q); pass 1's k_j ⊙ exp(cw_L - cw_j) and exp(cw_L) are the plain
// version's own exponents.  No product exp(cw_prev_i) exp(-cw_j) is ever
// formed: it overflows fp32 once a chunk's decays sum below about -88.
// cw is monotone, but cw_prev = cw - logw may sit an ulp of cw above the
// anchor or row it is taken from, as in the plain version: an exponent is
// then a rounding error above 0 and its factor 1 + O(2^-23 |cw|).  It is
// kept, not clamped, so that the diagonal blocks' exponents are the plain
// version's bit for bit; under strong decays (|cw| ~ 10^3) clamping them
// moved o by 4e-4 against it.
//
// Precision.  Every exp is ex2.approx.ftz.f32 of the exponent times
// log2 e: at most 2 ulp (2^-22 relative) per factor, plus the rounding of
// the product (2^-24 of the exponent), a flushed result only where the
// factor is below 2^-126; the factored exponents add two roundings of
// differences no larger than the exponent.  Against LM_KERNEL_TOL (fp32:
// 1e-4 |plain| + 1e-5) that is below 1e-6 relative per term.  All
// arithmetic is fp32 FMAs on the CUDA cores; no decay and no r ⊙ decay is
// rounded to bf16.
//
// Determinism: every sum runs in a fixed order (channels, then rows, in
// ascending order; the bonus sum of each row a fixed shuffle tree), there
// are no atomics, a repeated launch gives the same bits, and a (batch,
// head) reads and writes only its own rows and scratch.  Scratch (U and
// then S_prev [b, h, n_chunks, E, E] and the decays [b, h, n_chunks, E],
// fp32) comes from the caller; nothing is allocated here, and the launch
// makes no runtime call but the launches once each kernel has opted in to
// its shared memory, so it can be captured in a CUDA graph.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

#include "hopper_common.cuh"

namespace {

constexpr int WK_E = 64;              // head width
constexpr int WK_LMAX = 64;           // longest chunk
constexpr int WK_SUB = 16;            // rows of a sub-chunk
constexpr int WK_P = 68;              // row stride in floats (16-byte rows)
constexpr int WK_THREADS = 256;       // chunk blocks: 16 x 16
constexpr int WK_WALK_THREADS = 256;  // walk blocks
constexpr int WK_WALK_AHEAD = 8;      // chunks a walker loads ahead
constexpr int WK_STATE_BLOCKS = 4;    // chunk-state blocks an SM
constexpr int WK_OUT_BLOCKS = 2;      // chunk-output blocks an SM
constexpr int NSUB = WK_LMAX / WK_SUB;
constexpr int SPLIT_E = 12;  // keys of o's first partial sum (A v and these)
constexpr float LOG2E = 1.4426950408889634f;
constexpr int TILE = WK_LMAX * WK_P;  // one [LMAX][P] array, in floats

// shared memory of a chunk-state block: k, v and the decays
constexpr int STATE_SMEM = (int)sizeof(float) * 3 * TILE;
// of a chunk-output block: r, k, v, cw_prev (then A), cw and S_prev, then
// exp(C_q), the three pair factors, u, the bonus of each row and the
// diagonal blocks' entries
constexpr int OUT_SMEM =
    (int)sizeof(float) * (6 * TILE + NSUB * WK_E + 3 * WK_E + WK_E + WK_LMAX +
                          NSUB * WK_SUB * WK_SUB);
// the strictly lower pairs of a diagonal block, 15 x 8 of them
constexpr int PAIRS = WK_SUB * (WK_SUB - 1) / 2;
static_assert(PAIRS == (WK_SUB - 1) * (WK_SUB / 2), "a 15 x 8 rectangle");
static_assert(2 * PAIRS <= WK_THREADS, "two diagonal blocks a round");

// exp(x) of a log decay x <= 0 (but for rounding noise): 2^(x log2 e)
__device__ __forceinline__ float decay(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * LOG2E));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// four consecutive elements of a row, as fp32
__device__ __forceinline__ float4 load4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) { st4(p, x); }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
// acc += a * b for the four columns of b
__device__ __forceinline__ void axpy4(float a, float4 b, float* acc) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// A thread's share of one [LMAX][E] array of a chunk: four 4-wide pieces.
constexpr int SLOTS = WK_LMAX * WK_E / 4 / WK_THREADS;
static_assert(SLOTS * 4 * WK_THREADS == WK_LMAX * WK_E, "whole pieces");

// The thread's pieces of the chunk's rows of x (rows at and past n zero),
// as fp32.  A pass fetches every array it needs before it puts any into
// shared memory, so all of a thread's global loads are in flight at once.
template <typename T>
__device__ __forceinline__ void fetch(float4 (&buf)[SLOTS],
                                      const T* __restrict__ x, long base,
                                      long step, int n) {
#pragma unroll
  for (int it = 0; it < SLOTS; ++it) {
    const int idx = threadIdx.x + it * WK_THREADS;
    const int row = idx / (WK_E / 4), c = 4 * (idx % (WK_E / 4));
    buf[it] = row < n ? load4(x + base + row * step + c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// the pieces into dst [LMAX][P]
__device__ __forceinline__ void put(float* dst, const float4 (&buf)[SLOTS]) {
#pragma unroll
  for (int it = 0; it < SLOTS; ++it) {
    const int idx = threadIdx.x + it * WK_THREADS;
    st4(dst + (idx / (WK_E / 4)) * WK_P + 4 * (idx % (WK_E / 4)), buf[it]);
  }
}

static_assert(WK_THREADS == NSUB * WK_E, "one thread a (channel, sub-chunk)");
static_assert(WK_THREADS == 16 * 16, "16 x 16 thread tiles");
static_assert(SPLIT_E % 4 == 0, "whole 4-key steps");

// Pass 1: U_c = sum_j (k_j ⊙ exp(cw_L - cw_j)) v_j^T and exp(cw_L) of one
// (batch, head, chunk), into U [items][E][E] and D [items][E].
template <typename T>
__global__ void __launch_bounds__(WK_THREADS, WK_STATE_BLOCKS)
wkv6_chunk_state(const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ logw, float* __restrict__ U,
                 float* __restrict__ D, int S_len, int H, int L, int nc) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;       // k; then k ⊙ exp(cw_L - cw)
  float* Vs = Ks + TILE;  // v
  float* Cw = Vs + TILE;  // logw; then cw

  const long item = blockIdx.x;
  const int bh = (int)(item / nc), ch = (int)(item % nc);
  const int bb = bh / H, hh = bh % H;
  const int t0 = ch * L, n = min(L, S_len - t0);
  const long step = (long)H * WK_E;
  const long base = ((long)bb * S_len + t0) * step + (long)hh * WK_E;
  const int tid = threadIdx.x;

  {
    float4 bk[SLOTS], bv[SLOTS], bw[SLOTS];
    fetch(bk, k, base, step, n);
    fetch(bv, v, base, step, n);
    fetch(bw, logw, base, step, n);
    put(Ks, bk);
    put(Vs, bv);
    put(Cw, bw);
  }
  __syncthreads();
  if (tid < WK_E) {  // cw, one thread a channel, rows in order
    float acc = 0.f;
#pragma unroll 16
    for (int t = 0; t < WK_LMAX; ++t) {
      acc += Cw[t * WK_P + tid];
      Cw[t * WK_P + tid] = acc;
    }
    D[item * WK_E + tid] = decay(acc);  // padded rows add 0: acc is cw_L
  }
  __syncthreads();
  {  // k_j ⊙ exp(cw_L - cw_j), one thread a (c, q)
    const int c = tid % WK_E, q = tid / WK_E;
    const float total = Cw[(WK_LMAX - 1) * WK_P + c];
#pragma unroll 4
    for (int t = 0; t < WK_SUB; ++t) {
      const int j = q * WK_SUB + t;
      Ks[j * WK_P + c] *= decay(total - Cw[j * WK_P + c]);
    }
  }
  __syncthreads();
  // U[e, f] over the chunk's rows in order; thread rows 4 ty + a, columns
  // 4 tx + b
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int j = 0; j < n; ++j) {
    const float4 kv = ld4(Ks + j * WK_P + 4 * ty);
    const float4 vv = ld4(Vs + j * WK_P + 4 * tx);
    axpy4(kv.x, vv, acc[0]);
    axpy4(kv.y, vv, acc[1]);
    axpy4(kv.z, vv, acc[2]);
    axpy4(kv.w, vv, acc[3]);
  }
  float* u_out = U + item * WK_E * WK_E;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    st4(u_out + (4 * ty + a) * WK_E + 4 * tx,
        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
}

// Pass 2: one thread a state element of one (batch, head) walks the chunks:
// writes S_{c-1} over U_c, then S_c = D_c S_{c-1} + U_c; the final state to
// s_out.
__global__ void __launch_bounds__(WK_WALK_THREADS)
wkv6_walk(float* __restrict__ U, const float* __restrict__ D,
          const float* __restrict__ s_in, float* __restrict__ s_out,
          int nc) {
  const long g = (long)blockIdx.x * WK_WALK_THREADS + threadIdx.x;
  const long bh = g / (WK_E * WK_E);
  const int x = (int)(g % (WK_E * WK_E)), e = x / WK_E;
  float s = s_in ? s_in[g] : 0.f;
  float* u = U + bh * nc * WK_E * WK_E + x;
  const float* d = D + bh * nc * WK_E + e;
  // loads of the next WALK_AHEAD chunks in flight while this window's are
  // consumed
  float uc[WK_WALK_AHEAD], dc[WK_WALK_AHEAD];
#pragma unroll
  for (int i = 0; i < WK_WALK_AHEAD; ++i) {
    if (i < nc) {
      uc[i] = u[(long)i * WK_E * WK_E];
      dc[i] = d[(long)i * WK_E];
    }
  }
  for (int c0 = 0; c0 < nc; c0 += WK_WALK_AHEAD) {
    float un[WK_WALK_AHEAD] = {}, dn[WK_WALK_AHEAD] = {};
#pragma unroll
    for (int i = 0; i < WK_WALK_AHEAD; ++i) {
      if (c0 + WK_WALK_AHEAD + i < nc) {
        un[i] = u[(long)(c0 + WK_WALK_AHEAD + i) * WK_E * WK_E];
        dn[i] = d[(long)(c0 + WK_WALK_AHEAD + i) * WK_E];
      }
    }
#pragma unroll
    for (int i = 0; i < WK_WALK_AHEAD; ++i) {
      if (c0 + i < nc) {
        u[(long)(c0 + i) * WK_E * WK_E] = s;
        s = fmaf(dc[i], s, uc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < WK_WALK_AHEAD; ++i) {
      uc[i] = un[i];
      dc[i] = dn[i];
    }
  }
  s_out[g] = s;
}

// Pass 3: o of one (batch, head, chunk), from S_prev (the state entering
// the chunk, in U's slot).
template <typename T>
__global__ void __launch_bounds__(WK_THREADS, WK_OUT_BLOCKS)
wkv6_chunk_out(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ logw,
               const float* __restrict__ u, const float* __restrict__ Sp,
               T* __restrict__ o, int S_len, int H, int L, int nc) {
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem;             // r; r ⊙ exp(cw_prev - C_q); r ⊙ exp(cw_prev)
  float* Ks = Rs + TILE;        // k; then k ⊙ exp(C_{p+1} - cw)
  float* Vs = Ks + TILE;        // v
  float* Cp = Vs + TILE;        // logw; cw_prev; then A, bonus on its diagonal
  float* Cw = Cp + TILE;        // cw
  float* Ss = Cw + TILE;        // S_prev [key][value]
  float* Gs = Ss + TILE;        // [NSUB][E] exp(C_q)
  float* Fs = Gs + NSUB * WK_E; // [3][E] pair factors (2,0) (3,1) (3,0)
  float* us = Fs + 3 * WK_E;    // [E] u
  float* dg = us + WK_E;        // [LMAX] sum_c r u k of each row
  float* Dd = dg + WK_LMAX;     // [NSUB][SUB][SUB] diagonal blocks' pairs
  float* As = Cp;

  const long item = blockIdx.x;
  const int bh = (int)(item / nc), ch = (int)(item % nc);
  const int bb = bh / H, hh = bh % H;
  const int t0 = ch * L, n = min(L, S_len - t0);
  const long step = (long)H * WK_E;
  const long base = ((long)bb * S_len + t0) * step + (long)hh * WK_E;
  const int tid = threadIdx.x;

  {
    float4 br[SLOTS], bk[SLOTS], bv[SLOTS], bw[SLOTS], bs[SLOTS];
    fetch(br, r, base, step, n);
    fetch(bk, k, base, step, n);
    fetch(bv, v, base, step, n);
    fetch(bw, logw, base, step, n);
    fetch(bs, Sp + item * WK_E * WK_E, 0, WK_E, WK_E);
    if (tid < WK_E) us[tid] = u[hh * WK_E + tid];
    put(Rs, br);
    put(Ks, bk);
    put(Vs, bv);
    put(Cp, bw);
    put(Ss, bs);
  }
  __syncthreads();
  if (tid < WK_E) {  // cw and cw_prev = cw - logw, rows in order
    float acc = 0.f;
#pragma unroll 16
    for (int t = 0; t < WK_LMAX; ++t) {
      const float w = Cp[t * WK_P + tid];
      acc += w;
      Cw[t * WK_P + tid] = acc;
      Cp[t * WK_P + tid] = acc - w;
    }
  } else if (tid >= WK_THREADS - 2 * WK_LMAX) {
    // the bonus of each row: two threads a row, one shuffle
    const int row = (tid - (WK_THREADS - 2 * WK_LMAX)) / 2, half = tid % 2;
    float d = 0.f;
#pragma unroll
    for (int cc = 0; cc < WK_E / 2; cc += 4) {
      const int c0 = half * (WK_E / 2) + cc;
      d = dot4(mul4(ld4(Rs + row * WK_P + c0), ld4(us + c0)),
               ld4(Ks + row * WK_P + c0), d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) dg[row] = d;
  }
  __syncthreads();

  const int c = tid % WK_E, q = tid / WK_E;
  {  // exp(C_q) and the pair factors exp(C_2 - C_1), exp(C_3 - C_2),
     // exp(C_3 - C_1)
    const float cq = Cp[q * WK_SUB * WK_P + c];
    Gs[q * WK_E + c] = decay(cq);
    if (q > 0) {
      const float c1 = Cp[WK_SUB * WK_P + c], c2 = Cp[2 * WK_SUB * WK_P + c],
                  c3 = Cp[3 * WK_SUB * WK_P + c];
      Fs[(q - 1) * WK_E + c] =
          decay(q == 1 ? c2 - c1 : q == 2 ? c3 - c2 : c3 - c1);
    }
  }
  // the diagonal blocks' strictly lower halves, one exp a pair and channel:
  // the 120 pairs (i, j), j < i, of a block as a 15 x 8 rectangle (y, x):
  // (y + 1, x) where x <= y, else (15 - y, 15 - x); two blocks a round
  if (tid < 2 * PAIRS) {
    const int y = (tid % PAIRS) / (WK_SUB / 2), x = tid % (WK_SUB / 2);
    const int ti = x <= y ? y + 1 : WK_SUB - 1 - y;
    const int tj = x <= y ? x : WK_SUB - 1 - x;
#pragma unroll
    for (int round = 0; round < NSUB / 2; ++round) {
      const int a = 2 * round + tid / PAIRS;
      const int i = a * WK_SUB + ti, j = a * WK_SUB + tj;
      float acc = 0.f;
#pragma unroll 4
      for (int cc = 0; cc < WK_E; cc += 4) {
        const float4 ri = ld4(Rs + i * WK_P + cc);
        const float4 kj = ld4(Ks + j * WK_P + cc);
        const float4 pi = ld4(Cp + i * WK_P + cc);
        const float4 wj = ld4(Cw + j * WK_P + cc);
        acc = fmaf(ri.x * kj.x, decay(pi.x - wj.x), acc);
        acc = fmaf(ri.y * kj.y, decay(pi.y - wj.y), acc);
        acc = fmaf(ri.z * kj.z, decay(pi.z - wj.z), acc);
        acc = fmaf(ri.w * kj.w, decay(pi.w - wj.w), acc);
      }
      Dd[(a * WK_SUB + ti) * WK_SUB + tj] = acc;
    }
  }
  __syncthreads();
  {  // r ⊙ exp(cw_prev - C_q) and k ⊙ exp(C_{q+1} - cw), one thread a (c, q)
    const float cq = Cp[q * WK_SUB * WK_P + c];
    const float cn = q + 1 < NSUB ? Cp[(q + 1) * WK_SUB * WK_P + c]
                                  : Cw[(WK_LMAX - 1) * WK_P + c];
#pragma unroll 4
    for (int t = 0; t < WK_SUB; ++t) {
      const int row = q * WK_SUB + t;
      Rs[row * WK_P + c] *= decay(Cp[row * WK_P + c] - cq);
      Ks[row * WK_P + c] *= decay(cn - Cw[row * WK_P + c]);
    }
  }
  __syncthreads();
  // the six off-diagonal blocks (q, p), one warp a block: lane l a 4 x 2
  // tile, rows 4 (l / 8) + r, columns 2 (l % 8) + c of the block; A over
  // cw_prev.  Warps 6 and 7 write the diagonal blocks: the pairs, the bonus
  // on the diagonal, zeros above it.
  if (tid < 6 * 32) {
    const int w = tid / 32, l = tid % 32;
    // (q, p) of warp w, a nibble each: (1,0) (2,1) (3,2) (2,0) (3,1)
    // (3,0); the last three take the pair factors exp(C_q - C_{p+1})
    const int bq = (0x332321 >> (4 * w)) & 15, bp = (0x010210 >> (4 * w)) & 15;
    const int i0 = bq * WK_SUB + 4 * (l / 8), j0 = bp * WK_SUB + 2 * (l % 8);
    const float* fac = w < 3 ? nullptr : Fs + (w - 3) * WK_E;
    float acc[4][2] = {};
#pragma unroll 2
    for (int cc = 0; cc < WK_E; cc += 4) {
      float4 kj[2];
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        kj[c2] = ld4(Ks + (j0 + c2) * WK_P + cc);
        if (fac) kj[c2] = mul4(kj[c2], ld4(fac + cc));
      }
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) {
        const float4 ri = ld4(Rs + (i0 + r4) * WK_P + cc);
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) acc[r4][c2] = dot4(ri, kj[c2], acc[r4][c2]);
      }
    }
#pragma unroll
    for (int r4 = 0; r4 < 4; ++r4)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2)
        As[(i0 + r4) * WK_P + j0 + c2] = acc[r4][c2];
  } else {
    for (int x = tid - 6 * 32; x < NSUB * WK_SUB * WK_SUB; x += 64) {
      const int a = x / (WK_SUB * WK_SUB), ti = (x / WK_SUB) % WK_SUB,
                tj = x % WK_SUB;
      As[(a * WK_SUB + ti) * WK_P + a * WK_SUB + tj] =
          tj < ti    ? Dd[(a * WK_SUB + ti) * WK_SUB + tj]
          : tj == ti ? dg[a * WK_SUB + ti]
                     : 0.f;
    }
  }
  __syncthreads();
  // r ⊙ exp(cw_prev) = (r ⊙ exp(cw_prev - C_q)) exp(C_q)
#pragma unroll 4
  for (int t = 0; t < WK_SUB; ++t)
    Rs[(q * WK_SUB + t) * WK_P + c] *= Gs[q * WK_E + c];
  __syncthreads();
  // o = A v (A lower triangular, the bonus on its diagonal) + Q S_prev, as
  // two partial sums of about 52 terms each: threads 0-127 take A v (j in
  // order, the lower blocks only) and the keys below SPLIT_E, threads
  // 128-255 the other keys (in order); each thread an 8 x 4 tile, rows
  // ry + 8 a (sub-chunk a / 2), columns 4 cx + b.  The second half's sums
  // go through cw's slot, and o = first + second, stored once.
  {
    const int half = tid / 128, ry = (tid % 128) / 16, cx = tid % 16;
    float acc[8][4] = {};
    auto keys = [&](int e0, int e1) {
#pragma unroll 1
      for (int e = e0; e < e1; e += 4) {
        const float4 s0 = ld4(Ss + e * WK_P + 4 * cx);
        const float4 s1 = ld4(Ss + (e + 1) * WK_P + 4 * cx);
        const float4 s2 = ld4(Ss + (e + 2) * WK_P + 4 * cx);
        const float4 s3 = ld4(Ss + (e + 3) * WK_P + 4 * cx);
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const float4 qv = ld4(Rs + (ry + 8 * a) * WK_P + e);
          axpy4(qv.x, s0, acc[a]);
          axpy4(qv.y, s1, acc[a]);
          axpy4(qv.z, s2, acc[a]);
          axpy4(qv.w, s3, acc[a]);
        }
      }
    };
    if (half == 0) {
#pragma unroll
      for (int jb = 0; jb < NSUB; ++jb) {
#pragma unroll 1
        for (int j = jb * WK_SUB; j < (jb + 1) * WK_SUB; j += 4) {
          const float4 v0 = ld4(Vs + j * WK_P + 4 * cx);
          const float4 v1 = ld4(Vs + (j + 1) * WK_P + 4 * cx);
          const float4 v2 = ld4(Vs + (j + 2) * WK_P + 4 * cx);
          const float4 v3 = ld4(Vs + (j + 3) * WK_P + 4 * cx);
#pragma unroll
          for (int a = 2 * jb; a < 8; ++a) {
            const float4 av = ld4(As + (ry + 8 * a) * WK_P + j);
            axpy4(av.x, v0, acc[a]);
            axpy4(av.y, v1, acc[a]);
            axpy4(av.z, v2, acc[a]);
            axpy4(av.w, v3, acc[a]);
          }
        }
      }
      keys(0, SPLIT_E);
    } else {
      keys(SPLIT_E, WK_E);
#pragma unroll
      for (int a = 0; a < 8; ++a)
        st4(Cw + (ry + 8 * a) * WK_P + 4 * cx,
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
    }
    __syncthreads();
    if (half == 0) {
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = ry + 8 * a;
        const float4 second = ld4(Cw + i * WK_P + 4 * cx);
        if (i < n)
          store4(o + base + i * step + 4 * cx,
                 make_float4(acc[a][0] + second.x, acc[a][1] + second.y,
                             acc[a][2] + second.z, acc[a][3] + second.w));
      }
    }
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* s_in, void* o, void* s_out,
           void* scratch, int b, int s, int H, int L, cudaStream_t st) {
  static std::atomic<unsigned long long> opted_state{0}, opted_out{0};
  cudaError_t e =
      hopper::opt_in_smem(wkv6_chunk_state<T>, STATE_SMEM, opted_state);
  if (e != cudaSuccess) return (int)e;
  e = hopper::opt_in_smem(wkv6_chunk_out<T>, OUT_SMEM, opted_out);
  if (e != cudaSuccess) return (int)e;
  const int nc = (s + L - 1) / L;
  const long items = (long)b * H * nc;
  float* U = static_cast<float*>(scratch);
  float* D = U + items * WK_E * WK_E;
  wkv6_chunk_state<T><<<(unsigned)items, WK_THREADS, STATE_SMEM, st>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(logw), U, D, s, H, L, nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  wkv6_walk<<<(unsigned)((long)b * H * WK_E * WK_E / WK_WALK_THREADS),
              WK_WALK_THREADS, 0, st>>>(
      U, D, static_cast<const float*>(s_in), static_cast<float*>(s_out), nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  wkv6_chunk_out<T><<<(unsigned)items, WK_THREADS, OUT_SMEM, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), U, static_cast<T*>(o), s, H, L, nc);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, o of the entry's type; logw, u, s_in (or null) and s_out fp32;
// scratch fp32 of b * H * ceil(s / L) * (E * E + E) elements; head width
// 64; 1 <= L <= 64; every pointer 16-byte aligned.  Returns
// cudaGetLastError().
extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* logw, const void* u, const void* s_in,
                        void* o, void* s_out, void* scratch, int b, int s,
                        int H, int L, void* stream) {
  if (b < 1 || s < 1 || H < 1 || L < 1 || L > WK_LMAX)
    return (int)cudaErrorInvalidValue;
  return launch<float>(r, k, v, logw, u, s_in, o, s_out, scratch, b, s, H, L,
                       (cudaStream_t)stream);
}

extern "C" int wkv6_bf16(const void* r, const void* k, const void* v,
                         const void* logw, const void* u, const void* s_in,
                         void* o, void* s_out, void* scratch, int b, int s,
                         int H, int L, void* stream) {
  if (b < 1 || s < 1 || H < 1 || L < 1 || L > WK_LMAX)
    return (int)cudaErrorInvalidValue;
  return launch<__nv_bfloat16>(r, k, v, logw, u, s_in, o, s_out, scratch, b,
                               s, H, L, (cudaStream_t)stream);
}
