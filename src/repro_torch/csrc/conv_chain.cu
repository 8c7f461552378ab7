// The stage-major convolution kernel (conv_stage_major.cuh) and its five
// entry points, each one cooperative launch of the same __global__:
//
// K2 (conv_chain_f32): a chain of convolutions (each with bias and
// optional ReLU), then an optional VALID pool -> ReLU -> channel LRN tail.
// K6 (conv_chain_ocb_f32) is K2 with the final stage's output channels
// taken in tiles of at least the width asked for (the TPU kernel's
// oc-blocked grid, oc_block_final).  K2 replaces the TPU kernel
// src/repro/kernels/conv2d/kernels.py conv2d_chain_simd ->
// _chain_simd_kernel (with _band_conv, and the oc-blocked grid for K6).
// On the main path it runs AlexNet's conv3 -> conv4 -> conv5 -> pool5.
// Bound on the H100: fp32 operations (AlexNet's chain does 1.05 GFLOP a
// frame on 0.17 MB of input and 13.3 MB of weights; 66.9 TFLOP/s on the
// CUDA cores).  The TPU kernel walks one band of final rows through every
// stage; on 132 SMs that leaves too few blocks (one per pooled row and
// frame) and recomputes every band's halo rows.  Stage-major, every stage
// is one implicit GEMM over every frame spread over every SM.  AlexNet's
// chain stages (Cp 256 and 384: taps of one kernel position, two or three
// chunks a tap) take items of one chunk at batch 1 and of a kernel row at
// batch 16, and the reduce pass adds their partials.
//
// K1 (conv_pool_lrn_f32): one stage, conv -> bias -> ReLU [-> VALID
// max/avg pool -> ReLU -> channel LRN], one launch per layer group;
// without a pool it is the plain per-layer conv of the advanced SIMD
// method.  It replaces the TPU kernel conv2d_advanced_simd ->
// _advanced_simd_kernel with its _pool_epilogue (pool2d/kernels.py
// pool_band, conv2d/kernels.py lrn_band).  Bound on the H100: operations
// (AlexNet conv2 does 0.9 GFLOP per frame on 0.75 MB of input and 2.5 MB
// of weights, far above the card's fp32 ridge).  The conv is one implicit
// GEMM over the whole batch, every output computed once (the TPU kernel's
// bands recompute the conv rows that neighbouring pool windows share),
// written NHWC to scratch; after a grid barrier the tail pools a pixel's
// channels, takes the ReLU and the LRN.  A narrow input (AlexNet's conv1,
// Cp 4) walks its reduction a kernel row at a time; a stage whose pixel
// tiles x channel tiles already fill the grid takes the whole reduction an
// item (no partials, no reduce pass).
//
// K5 (conv_pool_carry_f32): one stage with a pool and no LRN.  It replaces
// the TPU kernel conv2d_advanced_simd -> _advanced_simd_carry_kernel,
// which walks the bands of a frame in order ("arbitrary" grid axis) and
// carries the K = pkh - psy conv rows that neighbouring pool windows share
// in VMEM, so that each conv row is computed once.  Stage-major, that
// holds by construction, so K5 is K1's launch without an LRN, on the same
// plan: the two give the same bits on the same group.
//
// K4 (conv_pool_lrn_halo_f32): one stage with a pool and an LRN.  It
// replaces the TPU kernel conv2d_advanced_simd ->
// _advanced_simd_halo_kernel (with _pool_epilogue_halo and
// lrn_band_halo), which splits the output channels into tiles, each
// widened by the n - 1 halo channels its LRN window reads, and recomputes
// those halos and the pool windows that straddle two bands.  Stage-major,
// the LRN tail runs after a grid barrier and sees every channel of a
// pixel, so no halo is left to compute: K4 is K1's launch on K1's plan,
// and the two give the same bits on the same group.
#include <atomic>

#include "conv_stage_major.cuh"
#include "hopper_common.cuh"

namespace cnnk {

__global__ void __launch_bounds__(CH_THREADS, CH_MIN_BLOCKS)
stage_major_kernel(Geo g, Plan p, const float* __restrict__ x, float* out,
                   float* scratch) {
  stage_major(g, p, x, out, scratch);
}

// Opts the kernel in to CH_SMEM bytes of dynamic shared memory on the
// current device, once a device (a runtime call a launch would pay on the
// small nets' host-bound calls otherwise).
inline cudaError_t opt_in_smem() {
  static std::atomic<unsigned long long> done{0};
  return hopper::opt_in_smem(stage_major_kernel, CH_SMEM, done);
}

// Reads geo[], lrn[] and plan[] (ws/bs: host arrays of each stage's device
// pointers) and launches the stage-major kernel cooperatively: every block
// must be resident at once for the grid barriers, and the runtime refuses
// a larger grid (cudaErrorCooperativeLaunchTooLarge).  K6 passes its
// tile[] (its final stage's items tile[0] channels wide or more, no LRN).
// Returns a CUDA error code, 0 when the launch was taken.
int launch_stage_major(const void* x, const void* const* ws,
                       const void* const* bs, void* out, void* scratch,
                       const int* geo, const float* lrn, const int* plan,
                       const int* tile, void* stream) {
  Geo g;
  Plan p;
  if (read_geo(&g, geo, lrn, ws, bs) || read_plan(&p, plan, g) || g.N < 1)
    return (int)cudaErrorInvalidValue;
  const int last = g.n_stages - 1;
  if (tile && (read_tile(&g, tile) || g.lrn_n ||
               p.ot_item[last] * ST_TO < g.ocb))
    return (int)cudaErrorInvalidValue;
  // the tail's pooled outputs of a block: CH_TAIL, or one wider pixel
  if (g.lrn_n && g.st[last].OC > CH_SMEM / 4) return (int)cudaErrorInvalidValue;
  cudaError_t e = opt_in_smem();
  if (e != cudaSuccess) return (int)e;
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  float* sp = static_cast<float*>(scratch);
  void* args[] = {&g, &p, &xp, &op, &sp};
  e = cudaLaunchCooperativeKernel((const void*)stage_major_kernel,
                                  dim3(p.grid), dim3(CH_THREADS), args,
                                  (size_t)CH_SMEM, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace cnnk

// K2.  x [N, C0, H0, W0] NCHW; ws/bs host arrays of n_stages device
// pointers: each stage's weights as [KH, KW, Cp, OCp] (HWIO, C and OC
// zero-padded to multiples of 4) and its bias [OC]; out [N, OC_last,
// out_h, out_w]; scratch the floats ops.chain_plan sizes; geo and lrn as
// conv_common.cuh describes, plan as conv_stage_major.cuh's Plan.  Returns
// cudaGetLastError() after the launch (an error of its own when a check or
// the launch fails).
extern "C" int conv_chain_f32(const void* x, const void* const* ws,
                              const void* const* bs, void* out, void* scratch,
                              const int* geo, const float* lrn,
                              const int* plan, void* stream) {
  return cnnk::launch_stage_major(x, ws, bs, out, scratch, geo, lrn, plan,
                                  nullptr, stream);
}

// K6.  As K2, with tile = {ocb, oc_tiles} of the final stage and no LRN.
extern "C" int conv_chain_ocb_f32(const void* x, const void* const* ws,
                                  const void* const* bs, void* out,
                                  void* scratch, const int* geo,
                                  const float* lrn, const int* plan,
                                  const int* tile, void* stream) {
  return cnnk::launch_stage_major(x, ws, bs, out, scratch, geo, lrn, plan,
                                  tile, stream);
}

// K1.  As K2 with one stage.
extern "C" int conv_pool_lrn_f32(const void* x, const void* const* ws,
                                 const void* const* bs, void* out,
                                 void* scratch, const int* geo,
                                 const float* lrn, const int* plan,
                                 void* stream) {
  if (geo[1] != 1) return (int)cudaErrorInvalidValue;
  return cnnk::launch_stage_major(x, ws, bs, out, scratch, geo, lrn, plan,
                                  nullptr, stream);
}

// K4.  As K2 with one stage, a pool and an LRN.
extern "C" int conv_pool_lrn_halo_f32(const void* x, const void* const* ws,
                                      const void* const* bs, void* out,
                                      void* scratch, const int* geo,
                                      const float* lrn, const int* plan,
                                      void* stream) {
  if (geo[1] != 1 || !geo[2] || !geo[8]) return (int)cudaErrorInvalidValue;
  return cnnk::launch_stage_major(x, ws, bs, out, scratch, geo, lrn, plan,
                                  nullptr, stream);
}

// K5.  As K2 with one stage, a pool and no LRN.
extern "C" int conv_pool_carry_f32(const void* x, const void* const* ws,
                                   const void* const* bs, void* out,
                                   void* scratch, const int* geo,
                                   const float* lrn, const int* plan,
                                   void* stream) {
  if (geo[1] != 1 || !geo[2] || geo[8]) return (int)cudaErrorInvalidValue;
  return cnnk::launch_stage_major(x, ws, bs, out, scratch, geo, lrn, plan,
                                  nullptr, stream);
}

// Blocks of the stage-major kernel an SM holds at once (a cooperative grid
// may be this many times the SMs), or minus a CUDA error.
extern "C" int stage_major_blocks_per_sm(void) {
  cudaError_t e = cnnk::opt_in_smem();
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cnnk::stage_major_kernel, cnnk::CH_THREADS, cnnk::CH_SMEM);
  return e == cudaSuccess ? per_sm : -(int)e;
}
