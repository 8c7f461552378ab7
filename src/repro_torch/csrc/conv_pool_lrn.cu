// K1: fused convolution -> bias -> ReLU -> VALID max/avg pool -> ReLU ->
// channel LRN, one launch per layer group.
//
// Replaces the TPU kernel src/repro/kernels/conv2d/kernels.py
// conv2d_advanced_simd -> _advanced_simd_kernel with its _pool_epilogue
// (pool2d/kernels.py pool_band, conv2d/kernels.py lrn_band).  The pool and
// LRN stages are optional; without a pool it is the plain per-layer conv.
//
// Bound on the H100: operations.  AlexNet conv2 does 0.9 GFLOP per frame on
// 0.75 MB of input and 2.5 MB of weights, far above the card's fp32 ridge.
// The design keeps the conv activation out of device memory: each block owns
// `blk` pooled output rows of one frame at full channel width (LRN needs
// every channel of a pooled pixel), computes the conv rows those pooled rows
// read into shared memory, pools and normalises them there and writes only
// the final band.  The conv itself is an implicit GEMM over 64 x 64 tiles
// with fp32 FMAs on CUDA cores (4 x 4 outputs a thread), which the block's
// four 256-thread groups take in turn (conv_band).  Pool windows that
// straddle two blocks' bands are recomputed by both (1.5x the conv rows at
// blk = 1, pool 3/2); the host picks blk to trade that against filling the
// SMs.  No atomics: every output is written once, in a fixed order.
#include "conv_common.cuh"

namespace cnnk {

__global__ void __launch_bounds__(THREADS, 1)
conv_pool_lrn_kernel(Geo g, const float* __restrict__ x, float* out) {
  __shared__ Tiles tiles[GROUPS];
  extern __shared__ float dyn[];
  const Stage& st = g.st[0];
  const int t = blockIdx.x;
  const int n = blockIdx.y;
  int a[1], b[1];
  band_rows(g, t, a, b);
  const float* xin = x + (long)n * st.C * st.H * st.W;
  float* oframe = out + (long)n * st.OC * g.out_h * g.out_w;
  if (!g.pool_kind) {
    conv_band(st, xin, (long)st.H * st.W, 0, a[0], b[0], oframe,
              (long)st.OH * st.OW, 0, tiles);
    return;
  }
  const long cs = (long)(b[0] - a[0]) * st.OW;
  float* band = dyn;
  float* pooled = dyn + st.OC * cs;
  conv_band(st, xin, (long)st.H * st.W, 0, a[0], b[0], band, cs, a[0], tiles);
  __syncthreads();
  const int f0 = t * g.blk;
  const int f1 = min(f0 + g.blk, g.total);
  pool_tail(g, band, cs, a[0], st.OC, st.OW, f0, f1, oframe, pooled);
}

}  // namespace cnnk

// x [N, C, H, W], w [OC, C, KH, KW], b [OC], out [N, OC, out_h, out_w]; geo
// and lrn are host arrays in the layout conv_common.cuh describes; smem is
// the dynamic shared memory in bytes (conv band + pooled band).  Returns
// cudaGetLastError() after the launch.
extern "C" int conv_pool_lrn_f32(const void* x, const void* w, const void* b,
                                 void* out, const int* geo, const float* lrn,
                                 long long smem, void* stream) {
  cnnk::Geo g;
  const void* ws[1] = {w};
  const void* bs[1] = {b};
  if (cnnk::read_geo(&g, geo, lrn, ws, bs) || g.n_stages != 1)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cnnk::conv_pool_lrn_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(g.n_tiles, g.N);
  cnnk::conv_pool_lrn_kernel<<<grid, cnnk::THREADS, (size_t)smem,
                               (cudaStream_t)stream>>>(
      g, static_cast<const float*>(x), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
