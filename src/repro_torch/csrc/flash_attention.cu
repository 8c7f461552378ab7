// K10: flash attention forward, out = softmax(mask(cap(q k^T * scale))) v,
// with an online softmax in fp32.  q [b, sq, h, hd], k and v [b, skv, kvh,
// hd], out like q, all contiguous, all fp32 or all bf16; head h reads kv
// head h / (h / kvh) (GQA without copying the kv heads).
//
// Replaces the TPU kernel src/repro/kernels/attention/kernel.py
// flash_attention_pallas -> _kernel: the same scores (fp32 q.k * scale,
// then cap * tanh(s / cap)), the same masks (kv padding k < skv, causal
// q >= k, window k > q - window), the same running max m, sum l and
// accumulator in fp32, p = 0 on a row that has seen no visible key, p.v in
// fp32 (p is not cast to bf16), out = acc / max(l, 1e-30) stored once in
// the output type.
//
// Bound on the H100: operations.  At gemma2-2b's prefill (h 8, hd 256, a
// 4500-token prompt) a layer's attention is about 80 GFLOP over 9 MB of q,
// k, v and out.  This first version runs fp32 FMAs on CUDA cores (no
// tensor cores: p.v stays fp32, as on the TPU).  One block of 256 threads
// owns 64 query rows of one (batch, head): q is converted to fp32 into
// shared memory once, each thread keeps a 4 x hd/16 slice of the
// accumulator in registers, and 64-row k and v tiles are streamed through
// shared memory (214 KB at hd 256, hence the opt-in).  The block loops
// only over the kv tiles its rows can see, computed from the causal and
// window bounds (the TPU kernel's pl.when skip), in order, so every sum
// has a fixed order: no atomics, no split over kv, the same bits on
// every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1) + 3 * BQ);
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
          int H, int KVH, int causal, int window, float scale, float cap) {
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
    const float l = fmaxf(l_s[r], 1e-30f);
    T* o = out + ((long)bb * sq + q0 + r) * q_step + (long)hh * HD;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) o[tx + 16 * jj] = from_f<T>(acc[i][jj] / l);
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int H, int KVH, int causal, int window,
           float scale, float cap, cudaStream_t st) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((sq + BQ - 1) / BQ, b * H);
  flash_fwd<HD, T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, H, KVH, causal,
      window, scale, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             int b, int sq, int skv, int H, int KVH, int causal, int window,
             float scale, float cap, cudaStream_t st) {
  if (hd == 64)
    return launch<64, T>(q, k, v, out, b, sq, skv, H, KVH, causal, window, scale, cap, st);
  if (hd == 128)
    return launch<128, T>(q, k, v, out, b, sq, skv, H, KVH, causal, window, scale, cap, st);
  if (hd == 256)
    return launch<256, T>(q, k, v, out, b, sq, skv, H, KVH, causal, window, scale, cap, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// hd one of 64, 128, 256; H a multiple of KVH; window 0 = none; cap 0 =
// none; bf16 = 1 for bfloat16 tensors, 0 for float32.  Returns
// cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int b, int sq, int skv, int H,
                                   int KVH, int hd, int causal, int window,
                                   float scale, float cap, int bf16,
                                   void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || KVH < 1 || H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(hd, q, k, v, out, b, sq, skv, H, KVH,
                                   causal, window, scale, cap, st);
  return dispatch<float>(hd, q, k, v, out, b, sq, skv, H, KVH, causal, window,
                         scale, cap, st);
}
