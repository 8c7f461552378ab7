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
//   S      <- S exp(cw_L) + sum_j (k_j ⊙ exp(cw_L - cw_j)) v_j^T
//
// Every exponent is a difference that is at most 0 (up to rounding), so no
// factor exceeds 1: exp(cw_prev_i) exp(-cw_j) would overflow fp32 once the
// decays of a chunk sum below about -88.
//
// Design.  CUDA blocks have no sequential grid axis, so one block of 256
// threads owns one (batch, head) and walks its chunks in order; the E x E
// state stays in shared memory for the whole walk.  A chunk's r, k, v and
// logw rows are loaded once as fp32 into shared memory (rows past the
// sequence zeroed).  The TPU kernel kept the [L, L, E] decay tensor in VMEM
// (at L = 32); at L = 64 it would be 1 MiB of fp32, so here each decay is
// formed where it is used: each thread owns a 4 x 4 grid of A's entries
// (rows ty + 16 a, columns tx + 16 b) and skips the sub-tiles above the
// diagonal (b > a), which is uniform over the block.  Then o (4 x 4 a
// thread, rows by A v, the diagonal bonus and the state term) and the state
// update (4 x 4 state entries a thread) are small products out of shared
// memory.  133 KB of shared memory a block (opt-in above 48 KB).
//
// Bound on the H100: operations.  A 4500-token prefill of rwkv6-1.6b (b 1,
// 32 heads) needs about 4.5 G operations (fp32, CUDA cores; the exps of A
// dominate) for 111 MB of bytes moved.  This first version has only b * h
// = 32 blocks on 132 SMs and computes each decay with expf; both are the
// first things to change.
//
// Determinism: every sum runs in a fixed order, there are no atomics, and
// a repeated launch gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int E = 64;         // head width
constexpr int LMAX = 64;      // longest chunk
constexpr int THREADS = 256;  // 16 x 16
constexpr int P = E + 1;      // padded row stride in floats: a column read
                              // by 16 rows hits 16 banks

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

constexpr size_t smem_bytes() {
  return sizeof(float) * (7 * LMAX * P + E * P + LMAX);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
wkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ logw,
         const float* __restrict__ u, const float* __restrict__ s_in,
         T* __restrict__ o, float* __restrict__ s_out, int S_len, int H,
         int L) {
  extern __shared__ float smem[];
  float* Rs = smem;              // [LMAX][P] r; then k ⊙ exp(cw_L - cw)
  float* Ks = Rs + LMAX * P;     // [LMAX][P] k
  float* Vs = Ks + LMAX * P;     // [LMAX][P] v
  float* Cp = Vs + LMAX * P;     // [LMAX][P] logw; then cw_prev
  float* Cw = Cp + LMAX * P;     // [LMAX][P] cw (inclusive)
  float* As = Cw + LMAX * P;     // [LMAX][P] A
  float* Qs = As + LMAX * P;     // [LMAX][P] r ⊙ exp(cw_prev)
  float* Ss = Qs + LMAX * P;     // [E][P] the state
  float* dg = Ss + E * P;        // [LMAX] sum_c r u k per row

  const int bh = blockIdx.x;
  const int bb = bh / H, hh = bh % H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long step = (long)H * E;  // from one time step to the next
  const long base = (long)bb * S_len * step + (long)hh * E;
  const float* ub = u + (long)hh * E;

  for (int x = tid; x < E * E; x += THREADS)
    Ss[(x / E) * P + x % E] = s_in ? s_in[(long)bh * E * E + x] : 0.f;

  const int n_chunks = (S_len + L - 1) / L;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * L;
    const int n = min(L, S_len - t0);  // rows of this chunk in the sequence

    for (int x = tid; x < LMAX * E; x += THREADS) {
      const int row = x / E, c = x % E;
      float rv = 0.f, kv = 0.f, vv = 0.f, wv = 0.f;
      if (row < n) {
        const long off = base + (long)(t0 + row) * step + c;
        rv = to_f(r[off]);
        kv = to_f(k[off]);
        vv = to_f(v[off]);
        wv = logw[off];
      }
      Rs[row * P + c] = rv;
      Ks[row * P + c] = kv;
      Vs[row * P + c] = vv;
      Cp[row * P + c] = wv;
    }
    __syncthreads();

    // cumulative decays, one thread a channel, in row order; the bonus
    // sum of each row, one thread a row
    if (tid < E) {
      float acc = 0.f;
      for (int t = 0; t < LMAX; ++t) {
        const float w = Cp[t * P + tid];
        acc += w;
        Cw[t * P + tid] = acc;
        Cp[t * P + tid] = acc - w;
      }
    } else if (tid < E + LMAX) {
      const int i = tid - E;
      float d = 0.f;
      for (int c = 0; c < E; ++c)
        d = fmaf(Rs[i * P + c] * ub[c], Ks[i * P + c], d);
      dg[i] = d;
    }
    __syncthreads();

    // r ⊙ exp(cw_prev), and A's lower sub-tiles
    for (int x = tid; x < LMAX * E; x += THREADS) {
      const int row = x / E, c = x % E;
      Qs[row * P + c] = Rs[row * P + c] * expf(Cp[row * P + c]);
    }
    {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 4
      for (int c = 0; c < E; ++c) {
        float ri[4], pi[4], kj[4], cj[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ri[a] = Rs[(ty + 16 * a) * P + c];
          pi[a] = Cp[(ty + 16 * a) * P + c];
          kj[a] = Ks[(tx + 16 * a) * P + c];
          cj[a] = Cw[(tx + 16 * a) * P + c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          if (16 * a >= n) continue;  // rows past the sequence
#pragma unroll
          for (int b = 0; b <= a; ++b)
            acc[a][b] = fmaf(ri[a] * kj[b], expf(pi[a] - cj[b]), acc[a][b]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = ty + 16 * a, j = tx + 16 * b;
          As[i * P + j] = (b <= a && j < i && i < n) ? acc[a][b] : 0.f;
        }
    }
    __syncthreads();

    // o = A v + (r u k) v + (r ⊙ exp(cw_prev)) S, for the rows in the
    // sequence; k ⊙ exp(cw_L - cw) into Rs for the state update
    {
      float oa[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) oa[a][b] = 0.f;
      for (int j = 0; j < n; ++j) {
        float aj[4], vj[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          aj[a] = As[(ty + 16 * a) * P + j];
          vj[a] = Vs[j * P + tx + 16 * a];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) oa[a][b] = fmaf(aj[a], vj[b], oa[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        const float d = dg[i];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          oa[a][b] = fmaf(d, Vs[i * P + tx + 16 * b], oa[a][b]);
      }
      float os[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) os[a][b] = 0.f;
#pragma unroll 4
      for (int c = 0; c < E; ++c) {
        float qa[4], sb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          qa[a] = Qs[(ty + 16 * a) * P + c];
          sb[a] = Ss[c * P + tx + 16 * a];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) os[a][b] = fmaf(qa[a], sb[b], os[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        if (i >= n) continue;
        T* orow = o + base + (long)(t0 + i) * step;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          orow[tx + 16 * b] = from_f<T>(oa[a][b] + os[a][b]);
      }
      for (int x = tid; x < LMAX * E; x += THREADS) {
        const int row = x / E, c = x % E;
        Rs[row * P + c] =
            Ks[row * P + c] * expf(Cw[(LMAX - 1) * P + c] - Cw[row * P + c]);
      }
    }
    __syncthreads();

    // S <- S exp(cw_L) + sum_j (k_j ⊙ exp(cw_L - cw_j)) v_j^T; padded rows
    // have logw = 0, so row LMAX - 1 of cw is the chunk's total
    {
      float sc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) sc[a][b] = 0.f;
      for (int j = 0; j < n; ++j) {
        float kq[4], vj[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          kq[a] = Rs[j * P + ty + 16 * a];
          vj[a] = Vs[j * P + tx + 16 * a];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) sc[a][b] = fmaf(kq[a], vj[b], sc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int c = ty + 16 * a;
        const float decay = expf(Cw[(LMAX - 1) * P + c]);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          float* s = Ss + c * P + tx + 16 * b;
          *s = *s * decay + sc[a][b];
        }
      }
    }
    __syncthreads();
  }

  for (int x = tid; x < E * E; x += THREADS)
    s_out[(long)bh * E * E + x] = Ss[(x / E) * P + x % E];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* s_in, void* o, void* s_out, int b,
           int s, int H, int L, cudaStream_t st) {
  const size_t smem = smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wkv6_fwd<T><<<b * H, THREADS, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s_in),
      static_cast<T*>(o), static_cast<float*>(s_out), s, H, L);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, o of the entry's type; logw, u, s_in (or null) and s_out fp32;
// head width 64; 1 <= L <= 64.  Returns cudaGetLastError().
extern "C" int wkv6_f32(const void* r, const void* k, const void* v,
                        const void* logw, const void* u, const void* s_in,
                        void* o, void* s_out, int b, int s, int H, int L,
                        void* stream) {
  if (b < 1 || s < 1 || H < 1 || L < 1 || L > LMAX)
    return (int)cudaErrorInvalidValue;
  return launch<float>(r, k, v, logw, u, s_in, o, s_out, b, s, H, L,
                       (cudaStream_t)stream);
}

extern "C" int wkv6_bf16(const void* r, const void* k, const void* v,
                         const void* logw, const void* u, const void* s_in,
                         void* o, void* s_out, int b, int s, int H, int L,
                         void* stream) {
  if (b < 1 || s < 1 || H < 1 || L < 1 || L > LMAX)
    return (int)cudaErrorInvalidValue;
  return launch<__nv_bfloat16>(r, k, v, logw, u, s_in, o, s_out, b, s, H, L,
                               (cudaStream_t)stream);
}
