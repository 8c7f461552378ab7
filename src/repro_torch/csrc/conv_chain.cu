// K2: a chain of convolutions (each with bias and optional ReLU), then an
// optional VALID pool -> ReLU -> channel LRN tail, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/conv2d/kernels.py
// conv2d_chain_simd -> _chain_simd_kernel (with _band_conv and the
// chain_band_geometry band sizing).  On the main path it runs AlexNet's
// conv3 -> conv4 -> conv5 -> pool5.
//
// Bound on the H100: operations (AlexNet's chain does 1.05 GFLOP per frame
// on 0.17 MB of input and 12 MB of weights).  Each block owns `blk` final
// rows of one frame and walks the stages in order: a stage computes the rows
// of its output the next stage reads (band_rows, clipped to the stage's
// valid output, so vertical padding between stages is read as zeros, never
// as conv-of-padding) at full channel width.  The intermediate bands do not
// fit shared memory (AlexNet at blk = 2: 9 x 13 x 384 and 7 x 13 x 384 fp32,
// 180 KB and 140 KB), so they go to a per-block slice of a scratch buffer
// the caller allocates, two bands ping-ponging; at these sizes the slices
// stay in the 50 MB L2.  The block synchronises between stages.  No full
// intermediate activation is ever written.
//
// The conv itself is the same 64 x 64 fp32 implicit GEMM as K1.
//
// K6 is the same kernel with the final stage's output channels split across
// blocks (conv_chain_ocb_f32; the TPU kernel's oc-blocked grid,
// oc_block_final).  K2's grid is only N x bands blocks (96 at batch 16, 6 at
// batch 1 for AlexNet's chain), too few for 132 SMs, and halo rows are
// recomputed by neighbouring blocks.  Nothing inside the chain reads the
// final stage's channels, so a third grid axis takes them in tiles of ocb:
// block (t, n, u) computes every earlier stage's band at full width, then
// only output channels [u*ocb, u*ocb + ocb) of the final stage, and pools
// those.  The earlier stages are recomputed once per channel tile, so the
// host picks ocb (at least the width asked for) to trade that recomputation
// against filling the SMs.  K2 is the one-tile case (ocb = OC); an LRN tail
// reads every channel and needs it.  No atomics: every output is written
// once, in a fixed order.
#include "conv_common.cuh"

namespace cnnk {

__global__ void __launch_bounds__(THREADS, 1)
conv_chain_kernel(Geo g, const float* __restrict__ x, float* out,
                  float* scratch, long scratch_stride) {
  __shared__ Tiles tiles[GROUPS];
  extern __shared__ float pooled[];
  const int t = blockIdx.x;
  const int n = blockIdx.y;
  const int u = blockIdx.z;
  int a[MAX_STAGES], b[MAX_STAGES];
  band_rows(g, t, a, b);
  const int last = g.n_stages - 1;
  const Stage& s0 = g.st[0];
  const Stage& sl = g.st[last];
  const int o0 = u * g.ocb;  // the final stage's channel tile
  const int noc = min(g.ocb, sl.OC - o0);
  float* buf[2];
  buf[0] = scratch +
           (((long)n * g.n_tiles + t) * g.oc_tiles + u) * 2 * scratch_stride;
  buf[1] = buf[0] + scratch_stride;
  float* oframe = out + ((long)n * sl.OC + o0) * g.out_h * g.out_w;
  const float* in = x + (long)n * s0.C * s0.H * s0.W;
  long in_cs = (long)s0.H * s0.W;
  int in_row0 = 0;
  for (int s = 0; s <= last; ++s) {
    const Stage& st = g.st[s];
    float* dst;
    long cs;
    int row0;
    if (s == last && !g.pool_kind) {
      dst = oframe;
      cs = (long)st.OH * st.OW;
      row0 = 0;
    } else {
      dst = buf[s & 1];
      cs = (long)(b[s] - a[s]) * st.OW;
      row0 = a[s];
    }
    if (s == last)
      conv_band(st, in, in_cs, in_row0, a[s], b[s], dst, cs, row0, tiles, o0,
                noc);
    else
      conv_band(st, in, in_cs, in_row0, a[s], b[s], dst, cs, row0, tiles);
    __syncthreads();  // the band is complete before the next stage reads it
    in = dst;
    in_cs = cs;
    in_row0 = row0;
  }
  if (!g.pool_kind) return;
  const int f0 = t * g.blk;
  const int f1 = min(f0 + g.blk, g.total);
  pool_tail(g, in, in_cs, in_row0, noc, sl.OW, f0, f1, oframe, pooled);
}

// Both entry points: K2 without tile[] (one full-width channel tile), K6
// with it (no LRN).
static int launch_chain(const void* x, const void* const* ws,
                        const void* const* bs, void* out, void* scratch,
                        long long scratch_stride, const int* geo,
                        const float* lrn, const int* tile, long long smem,
                        void* stream) {
  Geo g;
  if (read_geo(&g, geo, lrn, ws, bs)) return (int)cudaErrorInvalidValue;
  if (tile && (read_tile(&g, tile) || g.lrn_n))
    return (int)cudaErrorInvalidValue;
  if (smem > 0) {  // with the static tiles it may pass 48 KB: opt in
    cudaError_t e = cudaFuncSetAttribute(
        conv_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(g.n_tiles, g.N, g.oc_tiles);
  conv_chain_kernel<<<grid, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      g, static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<float*>(scratch), (long)scratch_stride);
  return (int)cudaGetLastError();
}

}  // namespace cnnk

// K2.  x [N, C0, H0, W0]; ws/bs host arrays of n_stages device pointers
// (OIHW weights, biases); out [N, OC_last, out_h, out_w]; scratch holds
// N * n_tiles * 2 * scratch_stride floats; smem the dynamic shared memory in
// bytes (the pooled band, LRN only).  Returns cudaGetLastError().
extern "C" int conv_chain_f32(const void* x, const void* const* ws,
                              const void* const* bs, void* out, void* scratch,
                              long long scratch_stride, const int* geo,
                              const float* lrn, long long smem, void* stream) {
  return cnnk::launch_chain(x, ws, bs, out, scratch, scratch_stride, geo, lrn,
                            nullptr, smem, stream);
}

// K6.  As K2, with tile = {ocb, oc_tiles, 1} of the final stage, no LRN and
// no dynamic shared memory; scratch holds N * n_tiles * oc_tiles * 2 *
// scratch_stride floats.
extern "C" int conv_chain_ocb_f32(const void* x, const void* const* ws,
                                  const void* const* bs, void* out,
                                  void* scratch, long long scratch_stride,
                                  const int* geo, const float* lrn,
                                  const int* tile, void* stream) {
  return cnnk::launch_chain(x, ws, bs, out, scratch, scratch_stride, geo, lrn,
                            tile, 0, stream);
}
