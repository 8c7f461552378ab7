// The register-tiled fp32 core that K7 (conv_basic_simd.cu) and K8
// (conv_basic_parallel.cu) share: a group of ST_THREADS threads owns an
// output tile of ST_TP pixels x ST_TO channels, each thread an 8 x 8
// micro-tile of it in registers, fed from shared-memory tiles that
// cp.async brings in while the previous tile computes.  Every product is
// an fp32 FMA on the CUDA cores; no tensor core.
//
// Thread (tx, ty) = (tid % 16, tid / 16) holds the pixels tx + 16 m (m < 8)
// and the channels ty * 4 + u, 32 + ty * 4 + u (u < 4) of the tile: a
// warp's sixteen tx read sixteen neighbouring pixels, its two ty the same
// weights (a broadcast).  A weight tile is stored k-major with rows of
// ST_BROW floats, so a thread's eight channels are two float4 loads.
#pragma once

#include <cuda_runtime.h>

namespace cnnk {

constexpr int ST_THREADS = 128;  // threads of one tile group
constexpr int ST_TP = 128;       // output pixels of a tile
constexpr int ST_TO = 64;        // output channels of a tile
constexpr int ST_BROW = 72;      // floats of a weight tile's row (64 + 8)

// 4 bytes from global to shared memory, or 4 zero bytes when !valid (src
// is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// 16 bytes (both addresses 16-byte aligned), or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Barrier over the ST_THREADS threads of tile group g (named barrier g + 1;
// 0 is __syncthreads).
__device__ __forceinline__ void tile_group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(ST_THREADS) : "memory");
}

// The tile channel of a thread's accumulator column u.
__device__ __forceinline__ int tile_chan(int ty, int u) {
  return (u < 4 ? 0 : 28) + ty * 4 + u;
}

// acc[m][u] += a[m] * b[u] for the thread's 8 pixels and 8 channels; b is
// the weight row of one reduction step at the thread's channels.
__device__ __forceinline__ void outer8x8(float (&acc)[8][8],
                                         const float (&a)[8],
                                         const float* brow, int ty) {
  const float4 b0 = *reinterpret_cast<const float4*>(brow + ty * 4);
  const float4 b1 = *reinterpret_cast<const float4*>(brow + 32 + ty * 4);
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[m][u] = fmaf(a[m], b[u], acc[m][u]);
}

}  // namespace cnnk
