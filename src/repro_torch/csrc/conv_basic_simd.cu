// K7: the paper's §4.3 basic SIMD convolution (dimension swapping): NHWC
// input with the channels innermost, HWIO weights, and for every output a
// sum over the kernel positions of a float4-vectorized dot over the
// channels, in fp32; then bias and the optional ReLU.  Two kernels:
//   * conv_basic_simd_kernel: the per-layer conv, output written NCHW;
//   * conv_basic_simd_pool_kernel: the fused super-layer conv -> ReLU ->
//     VALID max/avg pool -> ReLU -> channel LRN, pooled output NCHW.
//
// Replaces the TPU kernel src/repro/kernels/conv2d/kernels.py
// conv2d_basic_simd -> _basic_simd_kernel with its _pool_epilogue.  As in
// the JAX package (kernels/conv2d/ops.py), the wrapper does the dimension
// swap outside the kernel: NCHW -> NHWC with the channels zero-padded to a
// multiple of 4 (one float4), OIHW -> HWIO with the same padding.
//
// Bound on the H100: operations (AlexNet conv2 does 0.9 GFLOP a frame on
// 0.28 MB of input and 2.5 MB of weights).  This rung is the paper's middle
// one and is kept simple: no shared-memory GEMM tiles (that is K1's §4.4
// rung).  A thread computes one output channel of one pixel and threads of
// a warp take consecutive output channels, so the float4 input load is a
// broadcast and the four weight loads of a channel step are coalesced rows
// of HWIO.  The fused kernel gives each block one pooled output row of one
// frame at full channel width (LRN needs every channel of a pooled pixel):
// the block computes the conv rows that row reads into shared memory,
// channel-major, and runs conv_common.cuh's pool_tail on them, the same
// epilogue as K1 and K2.  AlexNet conv2's band is 3 rows x 27 x 256 floats
// (83 KB) plus the 13 KB pooled row, so at most two blocks fit an SM; the
// block has 1024 threads, since the kernel is bound by load latency and
// needs the warps (256 threads ran the conv2 group 5x slower than the
// per-layer conv, which has no shared memory and fills the SMs).  Every output is written once by one
// thread in a fixed order: repeated runs give the same bits, and a frame's
// output depends on that frame alone.
#include "conv_common.cuh"

namespace cnnk {

constexpr int SIMD_THREADS = 256;        // per-layer kernel
constexpr int SIMD_POOL_THREADS = 1024;  // fused kernel: one block an SM
constexpr long long SIMD_MAX_BLOCKS = 65535;  // then the grid-stride loop

// The conv at output pixel (oy, ox), channel o, before bias: x is one
// frame's NHWC input with st.C (a multiple of 4) channels, w the HWIO
// weights.  Kernel positions outside the input (the padding) are skipped.
__device__ __forceinline__ float simd_dot(const Stage& st,
                                          const float* __restrict__ x,
                                          int oy, int ox, int o) {
  const int iy0 = oy * st.sy - st.py;
  const int ix0 = ox * st.sx - st.px;
  const int c4n = st.C >> 2;
  const long long oc = st.OC;
  float acc = 0.f;
  for (int i = 0; i < st.KH; ++i) {
    const int iy = iy0 + i;
    if ((unsigned)iy >= (unsigned)st.H) continue;
    for (int j = 0; j < st.KW; ++j) {
      const int ix = ix0 + j;
      if ((unsigned)ix >= (unsigned)st.W) continue;
      const float4* xv = reinterpret_cast<const float4*>(
          x + ((long long)iy * st.W + ix) * st.C);
      const float* wp = st.w + (long long)(i * st.KW + j) * st.C * oc + o;
      for (int c4 = 0; c4 < c4n; ++c4) {
        const float4 v = __ldg(xv + c4);
        const float* wc = wp + 4 * c4 * oc;
        acc = fmaf(v.x, __ldg(wc), acc);
        acc = fmaf(v.y, __ldg(wc + oc), acc);
        acc = fmaf(v.z, __ldg(wc + 2 * oc), acc);
        acc = fmaf(v.w, __ldg(wc + 3 * oc), acc);
      }
    }
  }
  return acc;
}

__global__ void __launch_bounds__(SIMD_THREADS)
conv_basic_simd_kernel(Geo g, const float* __restrict__ x,
                       float* __restrict__ out) {
  const Stage& st = g.st[0];
  const long long total = (long long)g.N * st.OH * st.OW * st.OC;
  const long long frame = (long long)st.H * st.W * st.C;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int o = (int)(idx % st.OC);
    long long r = idx / st.OC;
    const int ox = (int)(r % st.OW);
    r /= st.OW;
    const int oy = (int)(r % st.OH);
    const int n = (int)(r / st.OH);
    float v = simd_dot(st, x + n * frame, oy, ox, o) + st.b[o];
    if (st.relu) v = fmaxf(v, 0.f);
    out[(((long long)n * st.OC + o) * st.OH + oy) * st.OW + ox] = v;
  }
}

__global__ void __launch_bounds__(SIMD_POOL_THREADS, 1)
conv_basic_simd_pool_kernel(Geo g, const float* __restrict__ x, float* out) {
  extern __shared__ float dyn[];
  const Stage& st = g.st[0];
  const int t = blockIdx.x;
  const int n = blockIdx.y;
  int a[1], b[1];
  band_rows(g, t, a, b);
  const float* xin = x + (long long)n * st.H * st.W * st.C;
  float* oframe = out + (long long)n * st.OC * g.out_h * g.out_w;
  const long cs = (long)(b[0] - a[0]) * st.OW;
  float* band = dyn;                 // [OC][rows][OW]: pool_tail's layout
  float* pooled = dyn + st.OC * cs;  // the pooled rows, LRN only
  const int count = (int)cs * st.OC;
  for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
    const int o = idx % st.OC;
    const int p = idx / st.OC;
    const int r = p / st.OW;
    const int ox = p - r * st.OW;
    float v = simd_dot(st, xin, a[0] + r, ox, o) + st.b[o];
    if (st.relu) v = fmaxf(v, 0.f);
    band[o * cs + p] = v;
  }
  __syncthreads();
  const int f0 = t * g.blk;
  const int f1 = min(f0 + g.blk, g.total);
  pool_tail(g, band, cs, a[0], st.OC, st.OW, f0, f1, oframe, pooled);
}

}  // namespace cnnk

// x [N, H, W, C] (C a multiple of 4), w [KH, KW, C, OC], b [OC], out NCHW
// [N, OC, out_h, out_w]; geo and lrn are host arrays in the layout
// conv_common.cuh describes, one stage, its C the padded channel count.
// Without a pool (geo pool_kind 0) the per-layer kernel runs, on a grid of
// at most SIMD_MAX_BLOCKS blocks; with one the fused kernel runs on
// n_tiles x N blocks with smem bytes of dynamic shared memory.  Returns
// cudaGetLastError() after the launch.
extern "C" int conv_basic_simd_f32(const void* x, const void* w, const void* b,
                                   void* out, const int* geo, const float* lrn,
                                   long long smem, void* stream) {
  cnnk::Geo g;
  const void* ws[1] = {w};
  const void* bs[1] = {b};
  if (cnnk::read_geo(&g, geo, lrn, ws, bs) || g.n_stages != 1 ||
      (g.st[0].C & 3))
    return (int)cudaErrorInvalidValue;
  if (!g.pool_kind) {
    const cnnk::Stage& st = g.st[0];
    const long long total = (long long)g.N * st.OH * st.OW * st.OC;
    long long blocks = (total + cnnk::SIMD_THREADS - 1) / cnnk::SIMD_THREADS;
    if (blocks > cnnk::SIMD_MAX_BLOCKS) blocks = cnnk::SIMD_MAX_BLOCKS;
    cnnk::conv_basic_simd_kernel<<<(unsigned)blocks, cnnk::SIMD_THREADS, 0,
                                   (cudaStream_t)stream>>>(
        g, static_cast<const float*>(x), static_cast<float*>(out));
    return (int)cudaGetLastError();
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cnnk::conv_basic_simd_pool_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(g.n_tiles, g.N);
  cnnk::conv_basic_simd_pool_kernel<<<grid, cnnk::SIMD_POOL_THREADS,
                                      (size_t)smem, (cudaStream_t)stream>>>(
      g, static_cast<const float*>(x), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
