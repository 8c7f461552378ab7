// Variants of K11's state walk (csrc/wkv6.cu, wkv6_walk) on the card: the
// same recurrence S_c = D_c S_{c-1} + U_c over the chunks of rwkv6-1.6b's
// 4500-token prefill (32 heads, 71 chunks), one thread a state element
// (scalar) or four (vec4), loading the next 4, 8 or 16 chunks (scalar,
// vec4) or keeping them in flight while it consumes the current window
// (pipe, the kernel's choice); a device copy of U's bytes as the floor.
// Every variant's S_prev must equal the first's bit for bit.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o build/walk tools/wkv6_walk_probe.cu && build/walk
// walk variants: U [items][64*64], D [items][64], items = bh * nc
#include <cstdio>
#include <cuda_runtime.h>
#include <vector>
#include <cstring>
constexpr int E = 64;
template <int AHEAD>
__global__ void __launch_bounds__(256) w_scalar(float* __restrict__ U, const float* __restrict__ D, float* __restrict__ s_out, int nc) {
  const long g = (long)blockIdx.x * 256 + threadIdx.x;
  const long bh = g / (E * E);
  const int x = (int)(g % (E * E)), e = x / E;
  float s = 0.f;
  float* u = U + bh * nc * E * E + x;
  const float* d = D + bh * nc * E + e;
  for (int c0 = 0; c0 < nc; c0 += AHEAD) {
    float uc[AHEAD], dc[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) if (c0 + i < nc) { uc[i] = u[(long)(c0 + i) * E * E]; dc[i] = d[(long)(c0 + i) * E]; }
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) if (c0 + i < nc) { u[(long)(c0 + i) * E * E] = s; s = fmaf(dc[i], s, uc[i]); }
  }
  s_out[g] = s;
}
template <int AHEAD>
__global__ void __launch_bounds__(256) w_vec(float* __restrict__ U, const float* __restrict__ D, float* __restrict__ s_out, int nc) {
  const long g = (long)blockIdx.x * 256 + threadIdx.x;   // one float4 a thread
  const long bh = g / (E * E / 4);
  const int x = (int)(g % (E * E / 4)) * 4, e = x / E;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  float* u = U + bh * nc * E * E + x;
  const float* d = D + bh * nc * E + e;
  for (int c0 = 0; c0 < nc; c0 += AHEAD) {
    float4 uc[AHEAD]; float dc[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) if (c0 + i < nc) { uc[i] = *reinterpret_cast<const float4*>(u + (long)(c0 + i) * E * E); dc[i] = d[(long)(c0 + i) * E]; }
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) if (c0 + i < nc) {
      *reinterpret_cast<float4*>(u + (long)(c0 + i) * E * E) = s;
      s.x = fmaf(dc[i], s.x, uc[i].x); s.y = fmaf(dc[i], s.y, uc[i].y); s.z = fmaf(dc[i], s.z, uc[i].z); s.w = fmaf(dc[i], s.w, uc[i].w);
    }
  }
  *reinterpret_cast<float4*>(s_out + 4 * g) = s;
}
// all loads of a thread in flight at once through a register window of AHEAD, double-buffered
template <int AHEAD>
__global__ void __launch_bounds__(256) w_pipe(float* __restrict__ U, const float* __restrict__ D, float* __restrict__ s_out, int nc) {
  const long g = (long)blockIdx.x * 256 + threadIdx.x;
  const long bh = g / (E * E);
  const int x = (int)(g % (E * E)), e = x / E;
  float s = 0.f;
  float* u = U + bh * nc * E * E + x;
  const float* d = D + bh * nc * E + e;
  float uc[AHEAD], dc[AHEAD];
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) if (i < nc) { uc[i] = u[(long)i * E * E]; dc[i] = d[(long)i * E]; }
  for (int c0 = 0; c0 < nc; c0 += AHEAD) {
    float un[AHEAD], dn[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) if (c0 + AHEAD + i < nc) { un[i] = u[(long)(c0 + AHEAD + i) * E * E]; dn[i] = d[(long)(c0 + AHEAD + i) * E]; }
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) if (c0 + i < nc) { u[(long)(c0 + i) * E * E] = s; s = fmaf(dc[i], s, uc[i]); }
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) { uc[i] = un[i]; dc[i] = dn[i]; }
  }
  s_out[g] = s;
}
int main() {
  const int bh = 32, nc = 71; const long items = (long)bh * nc;
  std::vector<float> hU(items * E * E), hD(items * E);
  for (size_t i = 0; i < hU.size(); ++i) hU[i] = (float)((i * 2654435761u) % 1000) / 1000.f - 0.5f;
  for (size_t i = 0; i < hD.size(); ++i) hD[i] = 0.3f + (float)(i % 7) / 10.f;
  float *U, *U0, *D, *S; cudaMalloc(&U, hU.size() * 4); cudaMalloc(&U0, hU.size() * 4); cudaMalloc(&D, hD.size() * 4); cudaMalloc(&S, bh * E * E * 4);
  cudaMemcpy(U0, hU.data(), hU.size() * 4, cudaMemcpyHostToDevice); cudaMemcpy(D, hD.data(), hD.size() * 4, cudaMemcpyHostToDevice);
  std::vector<float> ref; std::vector<float> outv(hU.size());
  auto run = [&](const char* name, auto launch) {
    cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
    float best = 1e9, tot = 0; int reps = 20;
    for (int r = 0; r < reps + 3; ++r) {
      cudaMemcpy(U, U0, hU.size() * 4, cudaMemcpyDeviceToDevice);
      cudaEventRecord(a); launch(); cudaEventRecord(b); cudaEventSynchronize(b);
      float ms; cudaEventElapsedTime(&ms, a, b); if (r >= 3) { tot += ms; if (ms < best) best = ms; }
    }
    cudaMemcpy(outv.data(), U, hU.size() * 4, cudaMemcpyDeviceToHost);
    bool same = true; if (ref.empty()) ref = outv; else same = memcmp(ref.data(), outv.data(), outv.size() * 4) == 0;
    printf("%-14s mean %.4f ms min %.4f ms same %d err %s\n", name, tot / reps, best, (int)same, cudaGetErrorString(cudaGetLastError()));
  };
  run("scalar8", [&] { w_scalar<8><<<bh * 16, 256>>>(U, D, S, nc); });
  run("scalar16", [&] { w_scalar<16><<<bh * 16, 256>>>(U, D, S, nc); });
  run("scalar4", [&] { w_scalar<4><<<bh * 16, 256>>>(U, D, S, nc); });
  run("vec4x8", [&] { w_vec<8><<<bh * 4, 256>>>(U, D, S, nc); });
  run("vec4x16", [&] { w_vec<16><<<bh * 4, 256>>>(U, D, S, nc); });
  run("pipe8", [&] { w_pipe<8><<<bh * 16, 256>>>(U, D, S, nc); });
  run("pipe16", [&] { w_pipe<16><<<bh * 16, 256>>>(U, D, S, nc); });
  run("scalar8b", [&] { w_scalar<8><<<bh * 16, 256>>>(U, D, S, nc); });
  // a plain copy of the same bytes, for the floor
  run("memcpy", [&] { cudaMemcpyAsync(U, U0, hU.size() * 4, cudaMemcpyDeviceToDevice); });
  return 0;
}
