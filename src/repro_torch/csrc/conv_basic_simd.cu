// K7: the paper's §4.3 basic SIMD convolution (dimension swapping): NHWC
// input with the channels innermost, HWIO weights, and for every output a
// sum over the kernel positions of a dot over the channels, in fp32; then
// bias and the optional ReLU.  Two kernels:
//   * conv_basic_simd_kernel: the per-layer conv, output written NCHW;
//   * conv_basic_simd_pool_kernel: the fused super-layer conv -> ReLU ->
//     VALID max/avg pool -> ReLU -> channel LRN, pooled output NCHW.
//
// Replaces the TPU kernel src/repro/kernels/conv2d/kernels.py
// conv2d_basic_simd -> _basic_simd_kernel with its _pool_epilogue, which
// runs one [rows, C] x [C, OC] dot per kernel position on the matrix unit.
// As in the JAX package (kernels/conv2d/ops.py), the wrapper does the
// dimension swap outside the kernel: NCHW -> NHWC with the channels
// zero-padded to a multiple of 4 (one float4), OIHW -> HWIO with the same
// padding.
//
// Bound on the H100: fp32 operations (AlexNet conv2 does 0.9 GFLOP a frame
// on 0.28 MB of input and 2.5 MB of weights; 66.9 TFLOP/s on the CUDA
// cores).  Both kernels run the same register-tiled GEMM core: a group of
// ST_THREADS threads owns ST_TP output pixels x ST_TO output channels, each
// thread an 8 x 8 micro-tile (conv_simt_tile.cuh), and walks the reduction
// k = (i * KW + j) * C + c (HWIO's row order: the positions outer, the
// channels ascending inside) in stages of K7_CK rows.  A stage holds the
// tile's pixels' K7_CK channel values at their shifted positions (A, pixel
// rows of K7_AROW floats: the thread's float4 reads of eight pixels then
// fall on distinct banks) and K7_CK rows of W (B); two stages form a ring,
// so cp.async brings stage s + 1 while stage s computes: 16 float4 shared
// loads per 256 FMAs.  A comes by 16-byte cp.async (NHWC with the channels
// padded to 4 keeps every chunk 16-byte aligned), zero-filled where the
// position lies in the padding; B by 4-byte cp.async, since OC need not be
// a multiple of 4.  cp.async rather than TMA: a tile's pixels are a run of
// row-major outputs whose shifted inputs are no box, and each stage's
// addresses are a few integer operations a thread.
//
// The fused kernel gives a block one pooled row of one frame at full
// channel width (LRN needs every channel of a pooled pixel): its groups
// (up to K7_MAX_GROUPS, the host picks how many fit shared memory; four
// groups would cap a thread at 128 registers, where the core spills) take
// the band's tiles in turn and write the conv rows channel-major into shared
// memory, then conv_common.cuh's pool_tail pools, applies the ReLU and the
// LRN, the same epilogue as K1 and K2.  Overlapping pool windows make
// neighbouring blocks recompute their shared conv rows.
//
// Each output's sum runs the kernel positions (i, j) outer and the
// channels ascending inside, padding zeros included as fma(0, w, acc); no
// split of the reduction, no atomics.  A tile lies in one frame and a
// pixel's order is the same wherever it sits, so repeated runs give the
// same bits and a frame's output depends on that frame alone.
#include "conv_common.cuh"
#include "conv_simt_tile.cuh"

namespace cnnk {

constexpr int K7_CK = 16;          // reduction rows of a stage
constexpr int K7_AROW = 20;        // floats of a pixel's row in A (16 + 4)
constexpr int K7_STAGE = ST_TP * K7_AROW + K7_CK * ST_BROW;  // floats
constexpr int K7_RING = 2 * K7_STAGE;  // floats of one group's two stages
constexpr int K7_MAX_GROUPS = 2;   // tile groups of a fused block
constexpr long long K7_SMEM_LIMIT = 232448;  // 227 KB a block may opt in to
constexpr int K7_GEO_TAIL = 2;     // geo[] after the stage: groups, ring_off
static_assert(K7_GEO_TAIL == 2, "the entry point reads groups, ring_off");

// acc = the conv before bias at the tile's pixels q = p0 + tx + 16 m of a
// run of npx row-major output pixels that starts at output row row0 of the
// frame xf, channels o0 + tile_chan(ty, u).  One group (g, its thread gtid)
// runs it on its ring; the ring is free again when it returns.
__device__ inline void k7_tile(const Stage& st, const float* __restrict__ xf,
                               int row0, int npx, int p0, int o0, float* ring,
                               int g, int gtid, float (&acc)[8][8]) {
  const int tx = gtid & 15, ty = gtid >> 4;
  const int Kd = st.KH * st.KW * st.C;
  // a thread copies the channel quad q4 of pixels (gtid >> 2) + 32 r of A
  // and column gtid & 63 of B's rows (gtid >> 6) + 2 r
  const int q4 = gtid & 3;
  int iyb[4], ixb[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = p0 + (gtid >> 2) + 32 * r;
    iyb[r] = -(1 << 24);  // past the run: every position reads as padding
    ixb[r] = 0;
    if (q < npx) {
      const int oy = row0 + q / st.OW;
      iyb[r] = oy * st.sy - st.py;
      ixb[r] = (q % st.OW) * st.sx - st.px;
    }
  }
  const int bo = gtid & 63;
  auto load = [&](int s, float* dst) {
    const int k0 = s * K7_CK;
    const int kg = k0 + q4 * 4;
    const int pos = kg / st.C;
    const int c = kg - pos * st.C;
    const int i = pos / st.KW;
    const int j = pos - i * st.KW;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int iy = iyb[r] + i;
      const int ix = ixb[r] + j;
      const bool v = kg < Kd && (unsigned)iy < (unsigned)st.H &&
                     (unsigned)ix < (unsigned)st.W;
      cp_async16(dst + ((gtid >> 2) + 32 * r) * K7_AROW + q4 * 4,
                 v ? xf + ((long long)iy * st.W + ix) * st.C + c : xf, v);
    }
    float* bs = dst + ST_TP * K7_AROW;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int k = (gtid >> 6) + 2 * r;
      const bool v = k0 + k < Kd && o0 + bo < st.OC;
      cp_async4(bs + k * ST_BROW + bo,
                v ? st.w + (long long)(k0 + k) * st.OC + o0 + bo : st.w, v);
    }
  };

#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[m][u] = 0.f;
  const int nst = (Kd + K7_CK - 1) / K7_CK;
  load(0, ring);
  cp_async_commit();
  for (int s = 0; s < nst; ++s) {
    cp_async_wait_all();
    tile_group_sync(g);  // stage s landed; stage s - 1's buffer is free
    if (s + 1 < nst) load(s + 1, ring + ((s + 1) & 1) * K7_STAGE);
    cp_async_commit();
    const float* as = ring + (s & 1) * K7_STAGE;
    const float* bs = as + ST_TP * K7_AROW;
#pragma unroll
    for (int kq = 0; kq < K7_CK / 4; ++kq) {
      float4 a4[8];
#pragma unroll
      for (int m = 0; m < 8; ++m)
        a4[m] = *reinterpret_cast<const float4*>(as + (tx + 16 * m) * K7_AROW +
                                                 kq * 4);
#pragma unroll
      for (int u4 = 0; u4 < 4; ++u4) {  // k ascending: channels inside
        float a[8];
#pragma unroll
        for (int m = 0; m < 8; ++m)
          a[m] = u4 == 0 ? a4[m].x : u4 == 1 ? a4[m].y
                 : u4 == 2 ? a4[m].z : a4[m].w;
        outer8x8(acc, a, bs + (kq * 4 + u4) * ST_BROW, ty);
      }
    }
  }
  tile_group_sync(g);  // every thread is done with the ring
}

__global__ void __launch_bounds__(ST_THREADS)
conv_basic_simd_kernel(Geo g, int n_pt, const float* __restrict__ x,
                       float* __restrict__ out) {
  extern __shared__ float4 dyn4[];
  const Stage& st = g.st[0];
  const int P = st.OH * st.OW;
  const int n = blockIdx.x / n_pt;
  const int p0 = (blockIdx.x - n * n_pt) * ST_TP;
  const int o0 = blockIdx.y * ST_TO;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
  k7_tile(st, x + (long long)n * st.H * st.W * st.C, 0, P, p0, o0,
          reinterpret_cast<float*>(dyn4), 0, threadIdx.x, acc);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int o = o0 + tile_chan(ty, u);
    if (o >= st.OC) continue;
    const float bias = st.b[o];
    float* orow = out + ((long long)n * st.OC + o) * P;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int p = p0 + tx + 16 * m;
      if (p >= P) continue;
      float v = acc[m][u] + bias;
      if (st.relu) v = fmaxf(v, 0.f);
      orow[p] = v;
    }
  }
}

__global__ void __launch_bounds__(ST_THREADS * K7_MAX_GROUPS, 1)
conv_basic_simd_pool_kernel(Geo g, int groups, int ring_off,
                            const float* __restrict__ x, float* out) {
  extern __shared__ float4 dyn4[];
  float* dyn = reinterpret_cast<float*>(dyn4);
  const Stage& st = g.st[0];
  const int t = blockIdx.x;
  const int n = blockIdx.y;
  int a[1], b[1];
  band_rows(g, t, a, b);
  const float* xin = x + (long long)n * st.H * st.W * st.C;
  float* oframe = out + (long long)n * st.OC * g.out_h * g.out_w;
  const int npx = (b[0] - a[0]) * st.OW;
  const long cs = npx;
  float* band = dyn;                 // [OC][rows][OW]: pool_tail's layout
  float* pooled = dyn + st.OC * cs;  // the pooled rows, LRN only
  const int gi = threadIdx.x / ST_THREADS;
  const int gtid = threadIdx.x - gi * ST_THREADS;
  const int tx = gtid & 15, ty = gtid >> 4;
  float* ring = dyn + ring_off + gi * K7_RING;
  const int n_ot = (st.OC + ST_TO - 1) / ST_TO;
  const int tiles = (npx + ST_TP - 1) / ST_TP * n_ot;
  for (int tile = gi; tile < tiles; tile += groups) {
    const int p0 = tile / n_ot * ST_TP;
    const int o0 = (tile - tile / n_ot * n_ot) * ST_TO;
    float acc[8][8];
    k7_tile(st, xin, a[0], npx, p0, o0, ring, gi, gtid, acc);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int o = o0 + tile_chan(ty, u);
      if (o >= st.OC) continue;
      const float bias = st.b[o];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int q = p0 + tx + 16 * m;
        if (q >= npx) continue;
        float v = acc[m][u] + bias;
        if (st.relu) v = fmaxf(v, 0.f);
        band[o * cs + q] = v;
      }
    }
  }
  __syncthreads();
  const int f0 = t * g.blk;
  const int f1 = min(f0 + g.blk, g.total);
  pool_tail(g, band, cs, a[0], st.OC, st.OW, f0, f1, oframe, pooled);
}

}  // namespace cnnk

// x [N, H, W, C] (C a multiple of 4), w [KH, KW, C, OC], b [OC], out NCHW
// [N, OC, out_h, out_w]; geo and lrn are host arrays in the layout
// conv_common.cuh describes, one stage, its C the padded channel count,
// followed by K7_GEO_TAIL ints: the fused kernel's tile groups and the
// float offset of their rings in shared memory (after the band and, with
// LRN, the pooled row).  Without a pool (geo pool_kind 0) the per-layer
// kernel runs on (pixel tiles x N, channel tiles) blocks of ST_THREADS
// with one ring; with one the fused kernel runs on n_tiles x N blocks of
// groups x ST_THREADS threads with smem bytes of dynamic shared memory.
// Returns cudaGetLastError() after the launch.
extern "C" int conv_basic_simd_f32(const void* x, const void* w, const void* b,
                                   void* out, const int* geo, const float* lrn,
                                   long long smem, void* stream) {
  cnnk::Geo g;
  const void* ws[1] = {w};
  const void* bs[1] = {b};
  if (cnnk::read_geo(&g, geo, lrn, ws, bs) || g.n_stages != 1 ||
      (g.st[0].C & 3) || g.N < 1)
    return (int)cudaErrorInvalidValue;
  const cnnk::Stage& st = g.st[0];
  const long long n_ot = (st.OC + cnnk::ST_TO - 1) / cnnk::ST_TO;
  if (!g.pool_kind) {
    const long long n_pt = ((long long)st.OH * st.OW + cnnk::ST_TP - 1) /
                           cnnk::ST_TP;
    if (n_pt * g.N > 0x7fffffff || n_ot > 65535)
      return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)(n_pt * g.N), (unsigned)n_ot);
    cnnk::conv_basic_simd_kernel<<<grid, cnnk::ST_THREADS,
                                   4 * cnnk::K7_RING, (cudaStream_t)stream>>>(
        g, (int)n_pt, static_cast<const float*>(x), static_cast<float*>(out));
    return (int)cudaGetLastError();
  }
  const int* tail = geo + cnnk::HEADER_INTS + cnnk::STAGE_INTS;
  const int groups = tail[0];
  const long long ring_off = tail[1];
  // the largest band any block writes, and with LRN its pooled rows
  const long long band = (long long)st.OC *
                             ((g.blk - 1) * g.psy + g.pkh) * st.OW +
                         (g.lrn_n ? (long long)st.OC * g.blk * g.out_w : 0);
  if (groups < 1 || groups > cnnk::K7_MAX_GROUPS || ring_off < band ||
      (ring_off & 3) || smem < 4 * (ring_off + groups * cnnk::K7_RING) ||
      smem > cnnk::K7_SMEM_LIMIT || g.N > 65535)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cnnk::conv_basic_simd_pool_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(g.n_tiles, g.N);
  cnnk::conv_basic_simd_pool_kernel<<<grid, groups * cnnk::ST_THREADS,
                                      (size_t)smem, (cudaStream_t)stream>>>(
      g, groups, (int)ring_off, static_cast<const float*>(x),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
