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
//
// K4 is the same kernel with the output channels split across blocks
// (conv_pool_lrn_halo_f32; the TPU kernel conv2d_advanced_simd ->
// _advanced_simd_halo_kernel, the two-pass channel-halo cell with
// _pool_epilogue_halo / lrn_band_halo).  K1 keeps every channel of a pooled
// row in one block because the LRN window reads its neighbours; that caps
// the grid at N x bands blocks (96 at batch 16 for AlexNet's conv2 group).
// K4 splits the channels into tiles of `ocb` and gives each block the conv
// rows of its `blk` pooled rows for channels [u*ocb - lo, u*ocb + ocb + hi)
// (lo = n/2, hi = n-1-lo): its own tile plus the n-1 halo channels the
// window reaches.  It convolves, pools and normalises all of them in shared
// memory and writes only its `ocb` core, so no block needs another's
// channels: grid bands x N x oc tiles.  Halo channels outside [0, OC) have
// zero weights and bias (conv_band's o_base), so they are exact zeros, the
// zero-padded window of the plain LRN; the sums come out in K1's order, so
// K4 and K1 agree bit for bit.  The price is the halo's extra conv channels:
// (ocb + n - 1) / ocb of the MACs, rounded up to the 64-channel GEMM tile,
// which is why the host picks ocb = 64k - (n - 1).  K1 is the one-tile case
// without a halo.
#include "conv_common.cuh"

namespace cnnk {

__global__ void __launch_bounds__(THREADS, 1)
conv_pool_lrn_kernel(Geo g, const float* __restrict__ x, float* out,
                     int halo) {
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
  if (!g.pool_kind) {
    conv_band(st, xin, (long)st.H * st.W, 0, a[0], b[0], oframe,
              (long)st.OH * st.OW, 0, tiles);
    return;
  }
  const int lo = halo ? g.lrn_n / 2 : 0;
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

// Both entry points: K1 without tile[] (one full-width tile, no halo), K4
// with it (pool and LRN required).
static int launch_pool_lrn(const void* x, const void* w, const void* b,
                           void* out, const int* geo, const float* lrn,
                           const int* tile, long long smem, void* stream) {
  Geo g;
  const void* ws[1] = {w};
  const void* bs[1] = {b};
  if (read_geo(&g, geo, lrn, ws, bs) || g.n_stages != 1)
    return (int)cudaErrorInvalidValue;
  if (tile && (!g.pool_kind || !g.lrn_n || read_tile(&g, tile)))
    return (int)cudaErrorInvalidValue;
  if (smem > 0) {  // with the static tiles it may pass 48 KB: opt in
    cudaError_t e = cudaFuncSetAttribute(
        conv_pool_lrn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(g.n_tiles, g.N, g.oc_tiles);
  conv_pool_lrn_kernel<<<grid, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      g, static_cast<const float*>(x), static_cast<float*>(out),
      tile ? g.lrn_n - 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace cnnk

// K1.  x [N, C, H, W], w [OC, C, KH, KW], b [OC], out [N, OC, out_h,
// out_w]; geo and lrn are host arrays in the layout conv_common.cuh
// describes; smem is the dynamic shared memory in bytes (conv band + pooled
// band).  Returns cudaGetLastError() after the launch.
extern "C" int conv_pool_lrn_f32(const void* x, const void* w, const void* b,
                                 void* out, const int* geo, const float* lrn,
                                 long long smem, void* stream) {
  return cnnk::launch_pool_lrn(x, w, b, out, geo, lrn, nullptr, smem, stream);
}

// K4.  As K1 with tile = {ocb, oc_tiles, 1}; smem covers the widened conv
// band plus its pooled band.
extern "C" int conv_pool_lrn_halo_f32(const void* x, const void* w,
                                      const void* b, void* out,
                                      const int* geo, const float* lrn,
                                      const int* tile, long long smem,
                                      void* stream) {
  return cnnk::launch_pool_lrn(x, w, b, out, geo, lrn, tile, smem, stream);
}
