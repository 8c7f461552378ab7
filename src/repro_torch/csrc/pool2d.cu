// K9: standalone VALID max/avg pooling with an optional ReLU, on NCHW fp32.
//
// Replaces the TPU kernel src/repro/kernels/pool2d/kernels.py pool2d_nhwc ->
// _pool2d_kernel (with pool_band).  It runs every pool of an unfused plan:
// AlexNet's pool1/2/5 (3x3 stride 2 max), LeNet-5's 2x2 stride 2 max pools,
// the CIFAR-10 net's max and avg pools.
//
// Bound on the H100: bytes.  A 3x3 stride 2 pool reads each input element
// about 2.25 times and does one operation per read; AlexNet pool1 at batch 16
// moves 18.6 MB in and 4.5 MB out, about 7 us at 3.35 TB/s.  The TPU kernel
// works on NHWC row bands because its vector lanes run along channels; here
// the activations stay NCHW (the port's layout between layers), one thread
// computes one output element, and neighbouring threads take neighbouring
// output columns, so a warp reads a few contiguous input rows of one plane
// (the L1 cache serves the window overlap).  There is no channel padding, so
// nothing can leak into a max from pad lanes.  Max starts from -inf, avg sums
// the window in row-major order and divides by kh * kw; every output is
// written once, so repeated runs give the same bits.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int POOL_THREADS = 256;
constexpr long long POOL_MAX_BLOCKS = 65535;  // then the grid-stride loop

__global__ void __launch_bounds__(POOL_THREADS)
pool2d_kernel(const float* __restrict__ x, float* __restrict__ y, long long nc,
              int H, int W, int OH, int OW, int kh, int kw, int sy, int sx,
              int kind, int relu) {
  const long long total = nc * OH * OW;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int ox = (int)(idx % OW);
    const long long r = idx / OW;
    const int oy = (int)(r % OH);
    const long long plane = r / OH;
    const float* src = x + plane * H * W + (long long)oy * sy * W + ox * sx;
    float v;
    if (kind == 1) {
      v = -INFINITY;
      for (int i = 0; i < kh; ++i)
        for (int j = 0; j < kw; ++j) v = fmaxf(v, src[i * W + j]);
    } else {
      v = 0.f;
      for (int i = 0; i < kh; ++i)
        for (int j = 0; j < kw; ++j) v += src[i * W + j];
      v = v / (float)(kh * kw);
    }
    if (relu) v = fmaxf(v, 0.f);
    y[idx] = v;
  }
}

}  // namespace

// x [nc planes, H, W] -> y [nc, OH, OW] (NCHW with N*C planes); kind 1 max,
// 2 avg.  Returns cudaGetLastError() after the launch.
extern "C" int pool2d_f32(const void* x, void* y, long long nc, int H, int W,
                          int OH, int OW, int kh, int kw, int sy, int sx,
                          int kind, int relu, void* stream) {
  if (kind != 1 && kind != 2) return (int)cudaErrorInvalidValue;
  const long long total = nc * OH * OW;
  if (total <= 0) return (int)cudaSuccess;
  long long blocks = (total + POOL_THREADS - 1) / POOL_THREADS;
  if (blocks > POOL_MAX_BLOCKS) blocks = POOL_MAX_BLOCKS;
  pool2d_kernel<<<(unsigned)blocks, POOL_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y), nc, H, W, OH, OW,
      kh, kw, sy, sx, kind, relu);
  return (int)cudaGetLastError();
}
