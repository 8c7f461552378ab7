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
// Known weakness, left for a later PR: the grid is only N x n_tiles blocks
// (AlexNet: 6 final rows, so at most 6 blocks a frame) and fills few of the
// 132 SMs at small batch, and halo rows are recomputed by neighbouring
// blocks.  The conv itself is the same 64 x 64 fp32 implicit GEMM as K1.
#include "conv_common.cuh"

namespace cnnk {

__global__ void __launch_bounds__(THREADS, 1)
conv_chain_kernel(Geo g, const float* __restrict__ x, float* out,
                  float* scratch, long scratch_stride) {
  __shared__ Tiles tiles[GROUPS];
  extern __shared__ float pooled[];
  const int t = blockIdx.x;
  const int n = blockIdx.y;
  int a[MAX_STAGES], b[MAX_STAGES];
  band_rows(g, t, a, b);
  const int last = g.n_stages - 1;
  const Stage& s0 = g.st[0];
  const Stage& sl = g.st[last];
  float* buf[2];
  buf[0] = scratch + ((long)n * g.n_tiles + t) * 2 * scratch_stride;
  buf[1] = buf[0] + scratch_stride;
  float* oframe = out + (long)n * sl.OC * g.out_h * g.out_w;
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
    conv_band(st, in, in_cs, in_row0, a[s], b[s], dst, cs, row0, tiles);
    __syncthreads();  // the band is complete before the next stage reads it
    in = dst;
    in_cs = cs;
    in_row0 = row0;
  }
  if (!g.pool_kind) return;
  const int f0 = t * g.blk;
  const int f1 = min(f0 + g.blk, g.total);
  pool_tail(g, in, in_cs, in_row0, sl.OC, sl.OW, f0, f1, oframe, pooled);
}

}  // namespace cnnk

// x [N, C0, H0, W0]; ws/bs host arrays of n_stages device pointers (OIHW
// weights, biases); out [N, OC_last, out_h, out_w]; scratch holds
// N * n_tiles * 2 * scratch_stride floats; smem the dynamic shared memory in
// bytes (the pooled band, LRN only).  Returns cudaGetLastError().
extern "C" int conv_chain_f32(const void* x, const void* const* ws,
                              const void* const* bs, void* out, void* scratch,
                              long long scratch_stride, const int* geo,
                              const float* lrn, long long smem, void* stream) {
  cnnk::Geo g;
  if (cnnk::read_geo(&g, geo, lrn, ws, bs)) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cnnk::conv_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(g.n_tiles, g.N);
  cnnk::conv_chain_kernel<<<grid, cnnk::THREADS, (size_t)smem,
                            (cudaStream_t)stream>>>(
      g, static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<float*>(scratch), (long)scratch_stride);
  return (int)cudaGetLastError();
}
