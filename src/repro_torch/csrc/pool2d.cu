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
// the activations stay NCHW (the port's layout between layers).
//
// Design: one thread an output, neighbouring threads on neighbouring output
// columns, so a warp reads a few contiguous input rows of a plane and the
// L1 cache serves the windows' overlap.  A block takes ``ppb`` whole planes
// (as many as its threads cover, at least one), so the plane comes from the
// block index and one 32-bit division a thread, and every offset inside a
// plane is 32-bit; the nets' windows (3x3, 2x2) are compile-time, so a
// window's loads are all in flight at once.  Measured on an H100 against the
// previous kernel (one thread an output over a flat 64-bit index, its
// window read at run time) and against strips of 2 and 4 adjacent outputs
// a thread that read each input column once into registers: the strips
// were the slowest at every AlexNet shape (fewer threads, each with a
// serial column walk), this the fastest.  There is no channel padding, so
// nothing can leak into a max from pad lanes.  Max starts from -inf; avg
// sums each window in row-major order and divides by kh * kw, as before, so
// its bits are unchanged; every output is written once, so repeated runs
// give the same bits.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int POOL_THREADS = 256;

// KH, KW > 0: that window at compile time; 0: kh, kw at run time
template <int KH, int KW>
__global__ void __launch_bounds__(POOL_THREADS)
pool2d_kernel(const float* __restrict__ x, float* __restrict__ y, int planes,
              int H, int W, int OH, int OW, int kh, int kw, int sy, int sx,
              int kind, int relu, int ppb) {
  const int wh = KH > 0 ? KH : kh, ww = KW > 0 ? KW : kw;
  const int per_plane = OH * OW;
  const int plane0 = blockIdx.x * ppb;
  const int span = ppb * per_plane;
  for (int t = threadIdx.x; t < span; t += POOL_THREADS) {
    const int pl = plane0 + t / per_plane;
    if (pl >= planes) return;  // t grows, so pl does
    const int it = t % per_plane;
    const int oy = it / OW, ox = it % OW;
    const float* src = x + (size_t)pl * H * W + oy * sy * W + ox * sx;
    float v = kind == 1 ? -INFINITY : 0.f;
#pragma unroll
    for (int i = 0; i < wh; ++i)
#pragma unroll
      for (int j = 0; j < ww; ++j) {
        const float e = __ldg(src + i * W + j);
        v = kind == 1 ? fmaxf(v, e) : v + e;
      }
    if (kind != 1) v = v / (float)(wh * ww);
    if (relu) v = fmaxf(v, 0.f);
    y[(size_t)pl * per_plane + it] = v;
  }
}

}  // namespace

// x [nc planes, H, W] -> y [nc, OH, OW] (NCHW with N*C planes); kind 1 max,
// 2 avg.  A plane must hold fewer than 2^31 elements.  Returns
// cudaGetLastError() after the launch.
extern "C" int pool2d_f32(const void* x, void* y, long long nc, int H, int W,
                          int OH, int OW, int kh, int kw, int sy, int sx,
                          int kind, int relu, void* stream) {
  if (kind != 1 && kind != 2) return (int)cudaErrorInvalidValue;
  if (nc <= 0 || OH <= 0 || OW <= 0) return (int)cudaSuccess;
  const long long per_plane = (long long)OH * OW;
  const int ppb =
      per_plane >= POOL_THREADS ? 1 : (int)(POOL_THREADS / per_plane);
  const long long blocks = (nc + ppb - 1) / ppb;
  if (nc > 0x7fffffffLL || (long long)H * W > 0x7fffffffLL ||
      blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto kern = kh == 3 && kw == 3   ? pool2d_kernel<3, 3>
              : kh == 2 && kw == 2 ? pool2d_kernel<2, 2>
                                   : pool2d_kernel<0, 0>;
  kern<<<(unsigned)blocks, POOL_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y), (int)nc, H, W, OH,
      OW, kh, kw, sy, sx, kind, relu, ppb);
  return (int)cudaGetLastError();
}
