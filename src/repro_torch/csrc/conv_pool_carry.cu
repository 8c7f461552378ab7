// K5: fused convolution -> bias -> ReLU -> VALID max/avg pool -> ReLU (no
// LRN) with a sliding-window pool carry: each band step convolves only its
// fresh conv rows and reuses the K = pkh - psy rows its pool windows share
// with the step before.
//
// Replaces the TPU kernel src/repro/kernels/conv2d/kernels.py
// conv2d_advanced_simd -> _advanced_simd_carry_kernel.  On the main path it
// runs AlexNet's conv1 -> pool1 (norm1 unfused).
//
// Bound on the H100: operations, as K1 (the same function).  K1 recomputes
// the conv rows that two neighbouring blocks' pool windows share (1.5x the
// conv rows of AlexNet's conv1 at one pooled row a block).  The TPU kernel
// walks the bands of a frame in order ("arbitrary" grid axis) and keeps
// those rows in VMEM scratch.  CUDA blocks have no order, so here one block
// walks `run` consecutive bands (`blk` pooled rows each) itself, holding
// the carried rows in shared memory: before each band it has conv rows
// [q*psy, q*psy + K) at the head of its buffer, convolves the band's
// blk*psy fresh rows behind them, pools the band, and slides the last K
// rows to the head.  A frame is split into a few such runs so that the grid
// (runs x N x oc tiles) fills the card; each run opens with a seed step
// that convolves its first K rows, what the TPU's step 0 over the zero
// prepad does.  The carried rows are held after bias and ReLU (ReLU is
// idempotent, and the pool reads them as they are).  Every pooled row is
// written once, by the block whose run holds its band; no atomics.
#include "conv_common.cuh"

namespace cnnk {

__global__ void __launch_bounds__(THREADS, 1)
conv_pool_carry_kernel(Geo g, const float* __restrict__ x, float* out) {
  __shared__ Tiles tiles[GROUPS];
  extern __shared__ float buf[];
  const Stage& st = g.st[0];
  const int r = blockIdx.x;
  const int n = blockIdx.y;
  const int u = blockIdx.z;
  const int K = g.pkh - g.psy;                 // carried conv rows
  const int OW = st.OW;
  const long cs = (long)(K + g.blk * g.psy) * OW;  // buffer floats a channel
  const int o0 = u * g.ocb;
  const int noc = min(g.ocb, st.OC - o0);
  const long in_cs = (long)st.H * st.W;
  const float* xin = x + (long)n * st.C * in_cs;
  float* oframe = out + ((long)n * st.OC + o0) * g.out_h * g.out_w;
  const int j0 = r * g.run;
  const int j1 = min(j0 + g.run, g.n_tiles);
  // seed: conv rows [q*psy, q*psy + K) of the run's first band
  int r0 = j0 * g.blk * g.psy;
  conv_band(st, xin, in_cs, 0, r0, r0 + K, buf, cs, r0, tiles, o0, noc);
  for (int j = j0; j < j1; ++j) {
    const int q = j * g.blk;
    const int q1 = min(q + g.blk, g.total);
    r0 = q * g.psy;  // the conv row at the head of the buffer
    __syncthreads();  // the carry is in place and the last pool is done
    conv_band(st, xin, in_cs, 0, r0 + K, q1 * g.psy + K, buf, cs, r0, tiles,
              o0, noc);
    __syncthreads();
    pool_tail(g, buf, cs, r0, noc, OW, q, q1, oframe, nullptr);
    if (j + 1 < j1) {
      __syncthreads();
      // slide: conv rows [q1*psy, q1*psy + K) to the head; the host keeps
      // blk*psy >= K, so source and destination rows do not overlap
      const int src = (q1 - q) * g.psy * OW;
      const int count = noc * K * OW;
      for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
        int o = idx / (K * OW);
        int rem = idx - o * K * OW;
        buf[o * cs + rem] = buf[o * cs + src + rem];
      }
    }
  }
}

}  // namespace cnnk

// x [N, C, H, W], w [OC, C, KH, KW], b [OC], out [N, OC, out_h, out_w]; geo
// and lrn as conv_common.cuh describes (a pool with pkh > psy, no LRN; blk
// = pooled rows a band, n_tiles = bands a frame), tile = {ocb, oc_tiles,
// run}; smem the dynamic shared memory in bytes (ocb x (K + blk*psy) conv
// rows).  Returns cudaGetLastError() after the launch.
extern "C" int conv_pool_carry_f32(const void* x, const void* w,
                                   const void* b, void* out, const int* geo,
                                   const float* lrn, const int* tile,
                                   long long smem, void* stream) {
  cnnk::Geo g;
  const void* ws[1] = {w};
  const void* bs[1] = {b};
  if (cnnk::read_geo(&g, geo, lrn, ws, bs) || g.n_stages != 1 ||
      !g.pool_kind || g.lrn_n || g.pkh <= g.psy ||
      g.blk * g.psy < g.pkh - g.psy || cnnk::read_tile(&g, tile))
    return (int)cudaErrorInvalidValue;
  if (smem > 0) {  // with the static tiles it may pass 48 KB: opt in
    cudaError_t e = cudaFuncSetAttribute(
        cnnk::conv_pool_carry_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((g.n_tiles + g.run - 1) / g.run, g.N, g.oc_tiles);
  cnnk::conv_pool_carry_kernel<<<grid, cnnk::THREADS, (size_t)smem,
                                 (cudaStream_t)stream>>>(
      g, static_cast<const float*>(x), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
