// K10: flash attention forward, out = softmax(mask(cap(q k^T * scale))) v,
// with an online softmax in fp32.  q [b, sq, h, hd], k and v [b, skv, kvh,
// hd], out like q, all contiguous, all fp32 or all bf16; head h reads kv
// head h / (h / kvh) (GQA without copying the kv heads).
//
// Replaces the TPU kernel src/repro/kernels/attention/kernel.py
// flash_attention_pallas -> _kernel: the same scores (fp32 q.k * scale,
// then cap * tanh(s / cap)), the same masks (kv padding k < skv, causal
// q >= k, window k > q - window), the same running max m, sum l and
// accumulator in fp32, p = 0 on a row that has seen no visible key, p.v
// with p in fp32, out = acc / max(l, 1e-30) stored once in the output
// type.  With m and l given (the backward's residuals, fp32 [b, h, sq]),
// each row's final running max and sum are stored beside out (l before
// the 1e-30 floor), as JAX's _flash_fwd_scan returns them; a call without
// them launches the same kernel and stores nothing more.  Every block
// walks the kv tiles its rows can see, in order (the
// TPU kernel's pl.when skip), so every sum has a fixed order: no atomics,
// no split over kv, the same bits on every run.
//
// Bound on the H100: operations.  At gemma2-2b's prefill (h 8, hd 256, a
// 4500-token prompt, window 4096) a layer's attention is about 83 GFLOP
// over 9 MB of q, k, v and out.  Two paths, chosen by the host from the
// type and the shape (k10_path in kernels/attention/ops.py):
//
// * Tensor cores (path 1, bf16, flash_wgmma).  A block of 384 threads owns
//   128 query rows of one (batch, head).  Warpgroup 0 is the producer: one
//   thread has TMA copy the q tile once, then each visible 64-row k and v
//   tile into a ring of two stages (128-byte swizzle, one full and one
//   empty mbarrier a stage).  Warpgroups 1 and 2 each own 64 query rows:
//   S = q k^T by wgmma m64n64k16 from shared memory (both operands
//   K-major; products of bf16 values are exact in fp32, so only the order
//   of the fp32 sum differs), the softcap (s / cap correctly rounded by
//   div_rn, without the division's slow-path call), the masks (only on
//   tiles that cross the diagonal, the window's edge or skv) and the
//   online softmax on the fp32 accumulator fragment, whose layout is
//   wgmma's register A operand layout.  p stays fp32 to within 2^-17:
//   each p.v step issues two wgmma m64n{hd}k16 over the same v tile
//   (MN-major), one with P_hi = bf16(p) and one with P_lo = bf16(p -
//   P_hi), each product of a bf16 weight and a bf16 v exact in fp32 (what
//   neither term carries is at most 2^-18 |p|), at 1.5x the tensor-core
//   work of a bf16 p.  Blocks are issued heaviest first (the last query
//   tiles under causal masking) so that the last wave is not the longest.
// * CUDA cores (path 0, fp32, and bf16 when asked, flash_fwd).  One block
//   of 256 threads owns 64 query rows: q is converted to fp32 into shared
//   memory once, each thread keeps a 4 x hd/16 slice of the accumulator in
//   registers, and 64-row k and v tiles are streamed through shared memory
//   (214 KB at hd 256, hence the opt-in); both products are scalar fp32
//   FMAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;        // query rows a block
constexpr int BK = 64;        // kv rows a tile
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG_INF = -1e30f;

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

// x / d correctly rounded, given inv_d = 1 / d correctly rounded: the
// product and two remainder corrections (Markstein), with no call of the
// division's slow path (which took half of the softcapped kernel's time)
__device__ __forceinline__ float div_rn(float x, float d, float inv_d) {
  float q = x * inv_d;
  q = fmaf(fmaf(-q, d, x), inv_d, q);
  return fmaf(fmaf(-q, d, x), inv_d, q);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1) + 3 * BQ);
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out,
          float* __restrict__ m_out, float* __restrict__ l_out, int sq,
          int skv, int H, int KVH, int causal, int window, float scale,
          float cap) {
  extern __shared__ float smem[];
  constexpr int QS = HD + 1;  // padded rows: a warp's 16 k rows hit 16 banks
  constexpr int SS = BK + 1;
  constexpr int CPT = HD / 16;  // accumulator columns a thread
  float* Qs = smem;             // [BQ][QS]
  float* Ks = Qs + BQ * QS;     // [BK][QS]
  float* Vs = Ks + BK * QS;     // [BK][HD]
  float* Ss = Vs + BK * HD;     // [BQ][SS]: scores, then p
  float* m_s = Ss + BQ * SS;    // [BQ] running max
  float* l_s = m_s + BQ;        // [BQ] running sum
  float* a_s = l_s + BQ;        // [BQ] this tile's rescale factor

  const int bh = blockIdx.y;
  const int bb = bh / H, hh = bh % H;
  const int kh = hh / (H / KVH);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long q_step = (long)H * HD;
  const long kv_step = (long)KVH * HD;
  const T* qb = q + (long)bb * sq * q_step + (long)hh * HD;
  const T* kb = k + (long)bb * skv * kv_step + (long)kh * HD;
  const T* vb = v + (long)bb * skv * kv_step + (long)kh * HD;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    Qs[r * QS + d] = (q0 + r < sq) ? to_f(qb[(long)(q0 + r) * q_step + d]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // the kv tiles with any visible key for rows [q0, q0 + BQ)
  // (tests/test_torch_attention.py kv_tile_range restates it in Python)
  const int n_kv = (skv + BK - 1) / BK;
  int j_hi = n_kv - 1;
  if (causal) j_hi = min(j_hi, (q0 + BQ - 1) / BK);
  int j_lo = 0;
  if (window > 0) {
    const int t = q0 - window + 2 - BK;
    if (t > 0) j_lo = (t + BK - 1) / BK;
  }
  __syncthreads();

  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * BK;
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int r = e / HD, d = e % HD;
      const bool in = k0 + r < skv;
      const long off = (long)(k0 + r) * kv_step + d;
      Ks[r * QS + d] = in ? to_f(kb[off]) : 0.f;
      Vs[r * HD + d] = in ? to_f(vb[off]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = ty + 16 * i, cc = tx + 16 * c;
        const int qp = q0 + r, kp = k0 + cc;
        float x = s[i][c] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        bool ok = kp < skv;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && kp > qp - window;
        Ss[r * SS + cc] = ok ? x : NEG_INF;
      }
    __syncthreads();

    // online softmax: four neighbouring lanes a row, 16 keys each
    {
      const int r = tid >> 2, part = tid & 3;
      float* row = Ss + r * SS + part * 16;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float row_ok = m_new > NEG_INF / 2 ? 1.f : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(row[c] - m_new) * row_ok;
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v, in fp32
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) acc[i][jj] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * SS + c];
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) {
        const float vv = Vs[c * HD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= sq) continue;
    if (m_out != nullptr && tx == 0) {
      m_out[(long)bh * sq + q0 + r] = m_s[r];
      l_out[(long)bh * sq + q0 + r] = l_s[r];
    }
    const float l = fmaxf(l_s[r], 1e-30f);
    T* o = out + ((long)bb * sq + q0 + r) * q_step + (long)hh * HD;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) o[tx + 16 * jj] = from_f<T>(acc[i][jj] / l);
  }
}

template <int HD, typename T>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                float* m, float* l, int b, int sq, int skv, int H, int KVH,
                int causal, int window, float scale, float cap,
                cudaStream_t st) {
  static std::atomic<unsigned long long> opted{0};
  const size_t smem = smem_bytes<HD>();
  cudaError_t e = opt_in_smem(flash_fwd<HD, T>, (int)smem, opted);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((sq + BQ - 1) / BQ, b * H);
  flash_fwd<HD, T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), m, l, sq, skv, H, KVH,
      causal, window, scale, cap);
  return (int)cudaGetLastError();
}

// -- path 1: TMA + wgmma (bf16) --------------------------------------------

// a block owns FA_BQ query rows (a consumer warpgroup each 64) and walks
// the kv tiles FA_BK rows at a time through a ring of FA_STAGES stages,
// each a k tile and a v tile of HD / 64 boxes of [64 rows, 64 columns]
constexpr int FA_BQ = 128;
constexpr int FA_BK = 64;
constexpr int FA_STAGES = 2;
constexpr int FA_THREADS = 384;
constexpr int FA_BOX = 64;  // bf16 columns of a box: one 128-byte swizzle row

template <int HD>
struct FaSmem {
  static constexpr int Q_BYTES = FA_BQ * HD * 2;
  static constexpr int KV_BYTES = FA_BK * HD * 2;  // one k or v tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // the q tile, the ring, 1 KB to align them to the swizzle's 1 KB pattern,
  // and the barriers: q's, then a full and an empty one per stage
  static constexpr int BYTES =
      Q_BYTES + FA_STAGES * STAGE_BYTES + 1024 + 8 * (1 + 2 * FA_STAGES);
};

#define D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d = a (64 x 16, K-major, shared memory) * b (16 x 64, K-major, shared
// memory) + (acc ? d : 0), fp32
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(acc));
}

// d = a (64 x 16, bf16 pairs in registers) * b (16 x 64, MN-major,
// shared memory) + (acc ? d : 0), fp32
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d = a (64 x 16, bf16 pairs in registers) * b (16 x 128, MN-major,
// shared memory) + (acc ? d : 0), fp32
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d = a (64 x 16, bf16 pairs in registers) * b (16 x 256, MN-major,
// shared memory) + (acc ? d : 0), fp32
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db,
                                         uint32_t acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56),
        D8(64), D8(72), D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef D8

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap,
            __nv_bfloat16* __restrict__ out, float* __restrict__ m_out,
            float* __restrict__ l_out, int n_bh, int n_q, int sq, int skv,
            int H, int KVH, int causal, int window, float scale, float cap) {
  using SM = FaSmem<HD>;
  constexpr int BOXES = HD / FA_BOX;
  constexpr int Q_BOX = FA_BQ * 128;  // bytes of a q box
  constexpr int KV_BOX = FA_BK * 128;  // bytes of a k or v box
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = q_s + SM::Q_BYTES;
  const uint32_t bars = ring + FA_STAGES * SM::STAGE_BYTES;
  auto k_at = [&](int s) { return ring + s * SM::STAGE_BYTES; };
  auto v_at = [&](int s) { return ring + s * SM::STAGE_BYTES + SM::KV_BYTES; };
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + FA_STAGES + s); };

  // heaviest first: under causal masking the last query tiles see the most
  // keys, and the block scheduler issues low indices first
  const int qt = blockIdx.x / n_bh, bh = blockIdx.x % n_bh;
  const int q0 = (causal ? n_q - 1 - qt : qt) * FA_BQ;
  const int bb = bh / H, hh = bh % H, kh = hh / (H / KVH);
  // the kv tiles with any visible key for rows [q0, q0 + FA_BQ)
  // (tests/test_torch_attention.py kv_tile_range restates it in Python)
  const int n_kv = (skv + FA_BK - 1) / FA_BK;
  int j_hi = n_kv - 1;
  if (causal) j_hi = min(j_hi, (q0 + FA_BQ - 1) / FA_BK);
  int j_lo = 0;
  if (window > 0) {
    const int t = q0 - window + 2 - FA_BK;
    if (t > 0) j_lo = (t + FA_BK - 1) / FA_BK;
  }
  const int n_tiles = max(0, j_hi - j_lo + 1);

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < FA_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == 0) {
    // producer: one thread loads q, then keeps the ring full.  TMA fills
    // rows past sq and skv (of this batch: the maps are 4-D) with zeros.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(bars, SM::Q_BYTES);
      for (int i = 0; i < BOXES; ++i)
        tma_load_4d(q_s + i * Q_BOX, &qmap, bars, FA_BOX * i, hh, q0, bb);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % FA_STAGES, k0 = (j_lo + t) * FA_BK;
        if (t >= FA_STAGES) mbar_wait(empty(s), (t / FA_STAGES - 1) & 1);
        mbar_expect_tx(full(s), SM::STAGE_BYTES);
        for (int i = 0; i < BOXES; ++i) {
          tma_load_4d(k_at(s) + i * KV_BOX, &kmap, full(s), FA_BOX * i, kh,
                      k0, bb);
          tma_load_4d(v_at(s) + i * KV_BOX, &vmap, full(s), FA_BOX * i, kh,
                      k0, bb);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows r_lo .. r_lo + 63.  A thread holds
  // rows row0 and row0 + 8 (h = 0, 1): fragment element 4 j + 2 h + e of
  // S (or of o) is column 8 j + col + e.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1, lane = tid % 32;
  const int r_lo = q0 + 64 * c;
  const int row0 = r_lo + 16 * (tid / 32) + lane / 4, col = 2 * (lane % 4);
  const uint32_t q_wg = q_s + c * 64 * 128;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  const float inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  mbar_wait(bars, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % FA_STAGES, k0 = (j_lo + t) * FA_BK;
    mbar_wait(full(s), (t / FA_STAGES) & 1);
    // a tile none of this warpgroup's rows can see leaves m, l and o as
    // they are: skip its arithmetic (uniform over the warpgroup)
    const bool seen = r_lo < sq && (!causal || k0 <= r_lo + 63) &&
                      (window <= 0 || k0 + FA_BK - 1 > r_lo - window);
    if (seen) {
      float sc[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(sc,
                     wg_desc(q_wg + (kk / 4) * Q_BOX + 32 * (kk % 4), 16, 1024),
                     wg_desc(k_at(s) + (kk / 4) * KV_BOX + 32 * (kk % 4), 16,
                             1024),
                     kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_acc(sc);
      // masks only where a key of the tile is past skv, past a row's
      // diagonal or before a row's window
      const bool edge = k0 + FA_BK > skv || (causal && k0 + FA_BK - 1 > r_lo) ||
                        (window > 0 && k0 <= r_lo + 63 - window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i / 2) % 2;
        float x = sc[i] * scale;
        if (cap > 0.f) x = cap * tanhf(div_rn(x, cap, inv_cap));
        if (edge) {
          const int qp = row0 + 8 * h, kp = k0 + 8 * (i / 4) + col + i % 2;
          bool ok = kp < skv;
          if (causal) ok = ok && qp >= kp;
          if (window > 0) ok = ok && kp > qp - window;
          x = ok ? x : NEG_INF;
        }
        sc[i] = x;
        mx[h] = fmaxf(mx[h], x);
      }
      float m_new[2], row_ok[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        m_new[h] = fmaxf(m_r[h], mx[h]);
        row_ok[h] = m_new[h] > NEG_INF / 2 ? 1.f : 0.f;
        alpha[h] = expf(m_r[h] - m_new[h]);
        m_r[h] = m_new[h];
      }
      // p in fp32, and its bf16 hi/lo pairs: pair i holds elements 2 i and
      // 2 i + 1 (row h = i % 2), so pairs 4 kk .. 4 kk + 3 are the A
      // operand of keys 16 kk .. 16 kk + 15
      uint32_t p_hi[16], p_lo[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int h = i % 2;
        const float p0 = expf(sc[2 * i] - m_new[h]) * row_ok[h];
        const float p1 = expf(sc[2 * i + 1] - m_new[h]) * row_ok[h];
        sum[h] += p0;
        sum[h] += p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[i] = bf16x2_bits(hi);
        p_lo[i] = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * alpha[h] + sum[h];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      // o += P_hi v + P_lo v, 16 keys a step
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < FA_BK / 16; ++kk) {
        const uint64_t dv = wg_desc(v_at(s) + kk * 16 * 128, KV_BOX, 1024);
        const uint32_t a_hi[4] = {p_hi[4 * kk], p_hi[4 * kk + 1],
                                  p_hi[4 * kk + 2], p_hi[4 * kk + 3]};
        const uint32_t a_lo[4] = {p_lo[4 * kk], p_lo[4 * kk + 1],
                                  p_lo[4 * kk + 2], p_lo[4 * kk + 3]};
        wgmma_rs(o, a_hi, dv, 1);
        wgmma_rs(o, a_lo, dv, 1);
      }
      wg_commit();
      wg_wait<0>();
      fence_acc(o);
    }
    // this warp is done with stage s: release it to the producer
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // out = o / max(l, 1e-30), the row's l summed over its four lanes
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
    const int row = row0 + 8 * h;
    if (row >= sq) continue;
    if (m_out != nullptr && lane % 4 == 0) {
      m_out[(long)bh * sq + row] = m_r[h];
      l_out[(long)bh * sq + row] = l_r[h];
    }
    const float l = fmaxf(l_r[h], 1e-30f);
    __nv_bfloat16* dst = out + (((long)bb * sq + row) * H + hh) * HD + col;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * h] / l, o[4 * j + 2 * h + 1] / l);
  }
}

// the bf16 [b, rows, heads, HD] tensor at base as a 4-D tensor map (HD,
// heads, rows, b) with boxes of 64 columns of one head, box_rows rows
bool head_map(CUtensorMap* map, const void* base, int b, int rows, int heads,
              int hd, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)b};
  const cuuint64_t row = (cuuint64_t)heads * hd * 2;
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, row, row * rows};
  const cuuint32_t box[4] = {FA_BOX, 1, (cuuint32_t)box_rows, 1};
  return tensor_map_bf16(map, base, 4, dims, strides, box);
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* m, float* l, int b, int sq, int skv, int H, int KVH,
                 int causal, int window, float scale, float cap,
                 cudaStream_t st) {
  static std::atomic<unsigned long long> opted{0};
  CUtensorMap qmap, kmap, vmap;
  if (!head_map(&qmap, q, b, sq, H, HD, FA_BQ) ||
      !head_map(&kmap, k, b, skv, KVH, HD, FA_BK) ||
      !head_map(&vmap, v, b, skv, KVH, HD, FA_BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = opt_in_smem(flash_wgmma<HD>, FaSmem<HD>::BYTES, opted);
  if (e != cudaSuccess) return (int)e;
  const int n_q = (sq + FA_BQ - 1) / FA_BQ, n_bh = b * H;
  flash_wgmma<HD><<<n_q * n_bh, FA_THREADS, FaSmem<HD>::BYTES, st>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), m, l, n_bh, n_q,
      sq, skv, H, KVH, causal, window, scale, cap);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* m,
           float* l, int b, int sq, int skv, int H, int KVH, int causal,
           int window, float scale, float cap, int bf16, int path,
           cudaStream_t st) {
  if (path == 1)
    return bf16 ? launch_wgmma<HD>(q, k, v, out, m, l, b, sq, skv, H, KVH,
                                   causal, window, scale, cap, st)
                : (int)cudaErrorInvalidValue;
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_simt<HD, __nv_bfloat16>(q, k, v, out, m, l, b, sq, skv, H,
                                          KVH, causal, window, scale, cap, st);
  return launch_simt<HD, float>(q, k, v, out, m, l, b, sq, skv, H, KVH,
                                causal, window, scale, cap, st);
}

}  // namespace

// hd one of 64, 128, 256; H a multiple of KVH; window 0 = none; cap 0 =
// none; bf16 = 1 for bfloat16 tensors, 0 for float32; path 0 the CUDA-core
// kernel, 1 the TMA + wgmma kernel (bf16 only; q, k, v and out 16-byte
// aligned); m and l fp32 [b, H, sq], both or neither (null).  Returns a
// CUDA error code, 0 when the launch was taken.
extern "C" int flash_attention_fwd_ml(const void* q, const void* k,
                                      const void* v, void* out, float* m,
                                      float* l, int b, int sq, int skv, int H,
                                      int KVH, int hd, int causal, int window,
                                      float scale, float cap, int bf16,
                                      int path, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || KVH < 1 || H % KVH != 0 ||
      (m == nullptr) != (l == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 64)
    return launch<64>(q, k, v, out, m, l, b, sq, skv, H, KVH, causal, window,
                      scale, cap, bf16, path, st);
  if (hd == 128)
    return launch<128>(q, k, v, out, m, l, b, sq, skv, H, KVH, causal,
                       window, scale, cap, bf16, path, st);
  if (hd == 256)
    return launch<256>(q, k, v, out, m, l, b, sq, skv, H, KVH, causal,
                       window, scale, cap, bf16, path, st);
  return (int)cudaErrorInvalidValue;
}

// the forward alone: flash_attention_fwd_ml without m and l
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int b, int sq, int skv, int H,
                                   int KVH, int hd, int causal, int window,
                                   float scale, float cap, int bf16, int path,
                                   void* stream) {
  return flash_attention_fwd_ml(q, k, v, out, nullptr, nullptr, b, sq, skv, H,
                                KVH, hd, causal, window, scale, cap, bf16,
                                path, stream);
}
