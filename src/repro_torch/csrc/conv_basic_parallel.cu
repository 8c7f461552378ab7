// K8: the paper's §4.2 basic parallel convolution: NCHW, one thread per
// output element, channels as the outer loop of the reduction, a scalar
// weight times input FMA in fp32, then bias and the optional ReLU.  No pool.
//
// Replaces the TPU kernel src/repro/kernels/conv2d/kernels.py
// conv2d_basic_parallel -> _basic_parallel_kernel, which keeps the
// un-swapped NCHW layout and loops channels outermost, kernel rows, kernel
// columns inside, one scalar weight times a spatial plane at a time.
//
// Bound on the H100: operations (AlexNet's five convs do 34.6 GFLOP at batch
// 16 on about 41 MB of inputs and weights).  By design this rung does not
// reach that bound: it is the paper's slow method, the one that does not
// vectorize over channels.  The design keeps the TPU kernel's loop order per
// output.  Block (x, y) takes 256 output pixels of the planes y, y +
// gridDim.y, ... (a plane is one frame and output channel), so every thread
// of a block reads the same weight at the same step (a broadcast load) and
// neighbouring threads read neighbouring input columns.  Padding is never
// materialized: rows and columns outside the input are skipped, which adds
// the same zeros.  Every output is written once by one thread in a fixed
// order: repeated runs give the same bits, and a frame's output depends on
// that frame alone.
#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int BP_THREADS = 256;

// dims[] from the host: N, C, H, W, OC, KH, KW, sy, sx, py, px, OH, OW, relu
struct Dims {
  int N, C, H, W, OC, KH, KW, sy, sx, py, px, OH, OW, relu;
};

__global__ void __launch_bounds__(BP_THREADS)
conv_basic_parallel_kernel(Dims d, const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ b,
                           float* __restrict__ out) {
  const int P = d.OH * d.OW;
  const int p = blockIdx.x * BP_THREADS + threadIdx.x;
  if (p >= P) return;
  const int oy = p / d.OW;
  const int ox = p - oy * d.OW;
  const int iy0 = oy * d.sy - d.py;
  const int ix0 = ox * d.sx - d.px;
  const long long hw = (long long)d.H * d.W;
  const int planes = d.N * d.OC;
  for (int plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const int n = plane / d.OC;              // plane = n * OC + o
    const int o = plane - n * d.OC;
    const float* xf = x + (long long)n * d.C * hw;
    const float* wo = w + (long long)o * d.C * d.KH * d.KW;
    float acc = 0.f;
    for (int c = 0; c < d.C; ++c) {          // channels OUTER (§4.2)
      const float* xc = xf + c * hw;
      const float* wc = wo + c * d.KH * d.KW;
      for (int i = 0; i < d.KH; ++i) {
        const int iy = iy0 + i;
        if ((unsigned)iy >= (unsigned)d.H) continue;
        for (int j = 0; j < d.KW; ++j) {
          const int ix = ix0 + j;
          if ((unsigned)ix >= (unsigned)d.W) continue;
          acc = fmaf(xc[iy * d.W + ix], wc[i * d.KW + j], acc);
        }
      }
    }
    acc += b[o];
    if (d.relu) acc = fmaxf(acc, 0.f);
    out[(long long)plane * P + p] = acc;
  }
}

}  // namespace

// x [N, C, H, W], w [OC, C, KH, KW], b [OC], out [N, OC, OH, OW]; dims a host
// array of 14 ints (the Dims order).  Returns cudaGetLastError().
extern "C" int conv_basic_parallel_f32(const void* x, const void* w,
                                       const void* b, void* out,
                                       const int* dims, void* stream) {
  static_assert(sizeof(Dims) == 14 * sizeof(int), "Dims is 14 ints");
  Dims d;
  memcpy(&d, dims, sizeof(Dims));
  const long long planes = (long long)d.N * d.OC;
  if (planes < 1 || planes > 0x7fffffff || d.OH < 1 || d.OW < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid((d.OH * d.OW + BP_THREADS - 1) / BP_THREADS,
            (unsigned)(planes < 65535 ? planes : 65535));
  conv_basic_parallel_kernel<<<grid, BP_THREADS, 0, (cudaStream_t)stream>>>(
      d, static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
