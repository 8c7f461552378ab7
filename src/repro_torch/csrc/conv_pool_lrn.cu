// K4: fused convolution -> bias -> ReLU -> VALID max/avg pool -> ReLU ->
// channel LRN, one launch per layer group, with the output channels split
// across blocks.  K1, the same group on one channel tile, runs the
// stage-major kernel (conv_chain.cu).
//
// K4 replaces the TPU kernel src/repro/kernels/conv2d/kernels.py
// conv2d_advanced_simd -> _advanced_simd_halo_kernel, the two-pass channel-halo cell with
// _pool_epilogue_halo / lrn_band_halo.  It keeps the band body of
// conv_common.cuh: each block owns `blk` pooled rows of one frame for the
// channels [u*ocb - lo, u*ocb + ocb + hi) (lo = n/2, hi = n-1-lo): its own
// tile plus the n-1 halo channels the LRN window reaches.  It convolves
// the conv rows those pooled rows read (conv_band: an implicit GEMM over
// 64 x 64 tiles, 4 x 4 outputs a thread, fp32 FMAs), pools and normalises
// them in shared memory and writes only its `ocb` core, so no block needs
// another's channels: grid bands x N x oc tiles.  Halo channels outside
// [0, OC) have zero weights and bias (conv_band's o_base), so they are
// exact zeros, the zero-padded window of the plain LRN.  Pool windows that
// straddle two blocks' bands are recomputed by both; the host picks blk
// and ocb = 64k - (n - 1) by a time model (ops.k4_geometry).  No atomics:
// every output is written once, in a fixed order.
#include "conv_common.cuh"

namespace cnnk {

__global__ void __launch_bounds__(THREADS, 1)
conv_pool_lrn_halo_kernel(Geo g, const float* __restrict__ x, float* out) {
  __shared__ Tiles tiles[GROUPS];
  extern __shared__ float dyn[];
  const Stage& st = g.st[0];
  const int t = blockIdx.x;
  const int n = blockIdx.y;
  const int u = blockIdx.z;
  int a[1], b[1];
  band_rows(g, t, a, b);
  const float* xin = x + (long)n * st.C * st.H * st.W;
  float* oframe = out + (long)n * st.OC * g.out_h * g.out_w;
  const int halo = g.lrn_n - 1;
  const int lo = g.lrn_n / 2;
  const int c0 = u * g.ocb - lo;                   // the tile's first channel
  const int width = g.ocb + halo;                  // tile channels: core + halo
  const int core = min(g.ocb, st.OC - u * g.ocb);  // channels written
  const long cs = (long)(b[0] - a[0]) * st.OW;
  float* band = dyn;
  float* pooled = dyn + width * cs;
  conv_band(st, xin, (long)st.H * st.W, 0, a[0], b[0], band, cs, a[0], tiles,
            c0, width);
  __syncthreads();
  const int f0 = t * g.blk;
  const int f1 = min(f0 + g.blk, g.total);
  pool_tail(g, band, cs, a[0], width, st.OW, f0, f1, oframe, pooled, lo,
            lo + core, c0);
}

}  // namespace cnnk

// K4.  x [N, C, H, W], w [OC, C, KH, KW] (OIHW), b [OC], out [N, OC,
// out_h, out_w]; geo and lrn as conv_common.cuh describes (one stage, a
// pool and an LRN), tile = {ocb, oc_tiles}; smem the dynamic shared
// memory in bytes (the widened conv band plus its pooled band).  Returns
// cudaGetLastError() after the launch.
extern "C" int conv_pool_lrn_halo_f32(const void* x, const void* w,
                                      const void* b, void* out,
                                      const int* geo, const float* lrn,
                                      const int* tile, long long smem,
                                      void* stream) {
  cnnk::Geo g;
  const void* ws[1] = {w};
  const void* bs[1] = {b};
  if (cnnk::read_geo(&g, geo, lrn, ws, bs) || g.n_stages != 1 ||
      !g.pool_kind || !g.lrn_n || cnnk::read_tile(&g, tile))
    return (int)cudaErrorInvalidValue;
  if (smem > 0) {  // with the static tiles it may pass 48 KB: opt in
    cudaError_t e = cudaFuncSetAttribute(
        cnnk::conv_pool_lrn_halo_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(g.n_tiles, g.N, g.oc_tiles);
  cnnk::conv_pool_lrn_halo_kernel<<<grid, cnnk::THREADS, (size_t)smem,
                                    (cudaStream_t)stream>>>(
      g, static_cast<const float*>(x), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
