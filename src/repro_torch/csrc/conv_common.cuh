// Shared device code of the fused convolution kernels (K4 in
// conv_pool_lrn.cu, K7 in conv_basic_simd.cu; the stage-major kernel of
// conv_stage_major.cuh, which K1, K2, K5 and K6 launch, takes only the
// geometry block):
// a geometry block passed by value, a band convolution (implicit GEMM over
// shared-memory tiles, fp32 FMAs on CUDA cores) and the pool -> ReLU ->
// LRN tail.
//
// Layouts: activations are NCHW, weights OIHW, both fp32 and contiguous.
// A "band" is a run of output rows [a, b) of one conv stage for one frame,
// stored channel-major: band[o * cstride + (row - row0) * OW + col].
// Rows of a stage that lie outside its valid output [0, OH) are never
// computed: the next stage reads them as activation zeros (the same
// zero-masking the TPU chain kernel applies by global row).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cnnk {

constexpr int MAX_STAGES = 8;
constexpr int GROUP = 256;    // threads of one GEMM group: 16 x 16, 4 x 4 outputs each
constexpr int GROUPS = 4;     // independent groups per block
constexpr int THREADS = GROUP * GROUPS;
constexpr int TP = 64;        // output pixels per GEMM tile
constexpr int TO = 64;        // output channels per GEMM tile
constexpr int TK = 16;        // reduction depth per shared-memory stage
constexpr int TOP = TO + 4;   // padded weight-tile row: 2-way bank conflicts on store

// One group's shared-memory GEMM staging (8.5 KB; a block holds GROUPS).
struct __align__(16) Tiles {
  float A[TK][TP];   // im2col patch tile, k-major
  float B[TK][TOP];  // weight tile, k-major
};

// geo[] from the host, per stage: C, H, W, OC, KH, KW, sy, sx, py, px,
// relu, OH, OW (STAGE_INTS ints).  Header: N, n_stages, pool_kind (0 none,
// 1 max, 2 avg), pkh, pkw, psy, psx, pool_relu, lrn_n (0 none), blk
// (final rows per block), n_tiles, total (final rows), out_h, out_w.
// The oc-blocked kernels (K4, K6) take a second array, tile[] = {ocb,
// oc_tiles}: output channels a block owns of the blocked stage, and blocks
// along the channel axis.
constexpr int HEADER_INTS = 14;
constexpr int TILE_INTS = 2;
constexpr int STAGE_INTS = 13;

struct Stage {
  const float* w;
  const float* b;
  int C, H, W, OC, KH, KW, sy, sx, py, px, relu, OH, OW;
};

struct Geo {
  int N, n_stages, pool_kind, pkh, pkw, psy, psx, pool_relu, lrn_n, blk,
      n_tiles, total, out_h, out_w;
  int ocb, oc_tiles;  // tile[]; full width and one tile without it
  float alpha, beta, k;
  Stage st[MAX_STAGES];
};

inline int read_geo(Geo* g, const int* geo, const float* lrn,
                    const void* const* ws, const void* const* bs) {
  g->N = geo[0];
  g->n_stages = geo[1];
  g->pool_kind = geo[2];
  g->pkh = geo[3];
  g->pkw = geo[4];
  g->psy = geo[5];
  g->psx = geo[6];
  g->pool_relu = geo[7];
  g->lrn_n = geo[8];
  g->blk = geo[9];
  g->n_tiles = geo[10];
  g->total = geo[11];
  g->out_h = geo[12];
  g->out_w = geo[13];
  g->alpha = lrn[0];
  g->beta = lrn[1];
  g->k = lrn[2];
  if (g->n_stages < 1 || g->n_stages > MAX_STAGES) return 1;
  for (int s = 0; s < g->n_stages; ++s) {
    const int* p = geo + HEADER_INTS + s * STAGE_INTS;
    Stage& st = g->st[s];
    st.w = static_cast<const float*>(ws[s]);
    st.b = static_cast<const float*>(bs[s]);
    st.C = p[0]; st.H = p[1]; st.W = p[2]; st.OC = p[3];
    st.KH = p[4]; st.KW = p[5]; st.sy = p[6]; st.sx = p[7];
    st.py = p[8]; st.px = p[9]; st.relu = p[10]; st.OH = p[11]; st.OW = p[12];
  }
  g->ocb = g->st[g->n_stages - 1].OC;
  g->oc_tiles = 1;
  return 0;
}

// The oc-blocked kernels' tile[] (see TILE_INTS); 1 if it is malformed.
inline int read_tile(Geo* g, const int* tile) {
  g->ocb = tile[0];
  g->oc_tiles = tile[1];
  const int oc = g->st[g->n_stages - 1].OC;
  if (g->ocb < 1 || g->oc_tiles < 1) return 1;
  if ((long)g->ocb * g->oc_tiles < oc) return 1;
  return 0;
}

// Rows [a[s], b[s]) every stage must produce so that the block's final rows
// [t*blk, min((t+1)*blk, total)) come out: walked back from the last stage,
// clipped to each stage's valid output.  Mirrors
// repro_torch.kernels.conv2d.ops.band_rows, which sizes the bands.
__device__ inline void band_rows(const Geo& g, int t, int* a, int* b) {
  int f0 = t * g.blk;
  int f1 = min(f0 + g.blk, g.total);
  int last = g.n_stages - 1;
  if (g.pool_kind) {
    a[last] = f0 * g.psy;
    b[last] = (f1 - 1) * g.psy + g.pkh;
  } else {
    a[last] = f0;
    b[last] = f1;
  }
  for (int s = last; s > 0; --s) {
    const Stage& st = g.st[s];
    a[s - 1] = max(0, a[s] * st.sy - st.py);
    b[s - 1] = min(st.H, (b[s] - 1) * st.sy - st.py + st.KH);
  }
}

__device__ __forceinline__ void group_sync(int g) {
  // named barrier g + 1 over the GROUP threads of group g (0 is
  // __syncthreads)
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(GROUP) : "memory");
}

// Rows [a, b) x all columns x n_oc channels of one conv stage, plus bias and
// the optional ReLU: an implicit GEMM of [pixels, C*KH*KW] x [C*KH*KW, n_oc]
// in 64 x 64 tiles.  Band channel o is the stage's output channel
// o_base + o (default: all OC channels from 0); a channel outside [0, OC)
// has zero weights and zero bias, so it comes out an exact zero (K4's LRN
// halo at the frame's channel edges).  The block's GROUPS groups take the
// tiles in turn, each on its own Tiles; within a tile the next TK slice's
// global loads are issued into registers before the current slice's FMAs.
// The input is read at in[c * in_cs + (gy - in_row0) * W + gx]; rows and
// columns outside [0, H) x [0, W) are zeros (the stage's padding).  The
// caller synchronises the block afterwards.
__device__ inline void conv_band(const Stage& st, const float* in, long in_cs,
                                 int in_row0, int a, int b, float* out,
                                 long out_cs, int out_row0, Tiles* tiles,
                                 int o_base = 0, int n_oc = -1) {
  const int g = threadIdx.x / GROUP;
  const int tid = threadIdx.x - g * GROUP;
  Tiles& T = tiles[g];
  const int tx = tid & 15;   // 4 consecutive pixels
  const int ty = tid >> 4;   // 4 consecutive channels
  const int OW = st.OW;
  const int P = (b - a) * OW;
  const int KHW = st.KH * st.KW;
  const int Kd = st.C * KHW;
  const int OCn = n_oc < 0 ? st.OC : n_oc;  // channels of the band
  const int n_ot = (OCn + TO - 1) / TO;
  const int n_tiles = ((P + TP - 1) / TP) * n_ot;
  const int lp = tid & (TP - 1);  // gather: pixel lp, k rows lk + 4r
  const int lk = tid / TP;
  const int bk = tid & (TK - 1);  // weights: k row bk, channels bo + 16r
  const int bo = tid / TK;
  for (int tile = g; tile < n_tiles; tile += GROUPS) {
    const int p0 = (tile / n_ot) * TP;
    const int o0 = (tile - (tile / n_ot) * n_ot) * TO;
    const int p = p0 + lp;
    const bool pv = p < P;
    int gy0 = 0, gx0 = 0;
    long poff = 0;
    if (pv) {
      int orow = p / OW;
      int ox = p - orow * OW;
      gy0 = (a + orow) * st.sy - st.py;
      gx0 = ox * st.sx - st.px;
      poff = (long)(gy0 - in_row0) * st.W + gx0;
    }
    float ra[4], rb[4];
    auto load = [&](int k0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int k = k0 + lk + 4 * r;
        float v = 0.f;
        if (pv && k < Kd) {
          int c = k / KHW;
          int rem = k - c * KHW;
          int kh = rem / st.KW;
          int kw = rem - kh * st.KW;
          if ((unsigned)(gy0 + kh) < (unsigned)st.H &&
              (unsigned)(gx0 + kw) < (unsigned)st.W)
            v = in[c * in_cs + poff + kh * st.W + kw];
        }
        ra[r] = v;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        int k = k0 + bk;
        int o = o0 + bo + 16 * r;
        int og = o_base + o;
        rb[r] = (k < Kd && o < OCn && (unsigned)og < (unsigned)st.OC)
                    ? st.w[(long)og * Kd + k]
                    : 0.f;
      }
    };
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    load(0);
    for (int k0 = 0; k0 < Kd; k0 += TK) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        T.A[lk + 4 * r][lp] = ra[r];
        T.B[bk][bo + 16 * r] = rb[r];
      }
      group_sync(g);
      if (k0 + TK < Kd) load(k0 + TK);  // in flight during the FMAs
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        float4 av = *reinterpret_cast<const float4*>(&T.A[kk][tx * 4]);
        float4 bv = *reinterpret_cast<const float4*>(&T.B[kk][ty * 4]);
        const float a4[4] = {av.x, av.y, av.z, av.w};
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
      }
      group_sync(g);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int pp = p0 + tx * 4 + i;
      if (pp >= P) continue;
      int orow = pp / OW;
      int ox = pp - orow * OW;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int o = o0 + ty * 4 + j;
        if (o >= OCn) continue;
        int og = o_base + o;
        float v = acc[i][j] + ((unsigned)og < (unsigned)st.OC ? st.b[og] : 0.f);
        if (st.relu) v = fmaxf(v, 0.f);
        out[o * out_cs + (long)(a + orow - out_row0) * OW + ox] = v;
      }
    }
  }
}

// VALID max/avg pool of the final band's rows [f0, f1) (pooled rows), then
// the optional ReLU and the optional channel LRN
//   y = x / (k + alpha * sum_{c' in [c - n/2, c + (n-1)/2]} x_c'^2)^beta
// (alpha is NOT divided by n), written to out (frame base, NCHW).  With LRN
// the pooled values of every channel are staged in `pooled` (shared memory,
// OC * (f1 - f0) * PW floats) first, since each output needs its neighbours.
// Only band channels [w_lo, w_hi) are written (default: all OC), band
// channel o to output channel o + out_c0: K4 pools its halo channels but
// writes its core only.
__device__ inline void pool_tail(const Geo& g, const float* band, long cs,
                                 int row0, int OC, int OW, int f0, int f1,
                                 float* out, float* pooled, int w_lo = 0,
                                 int w_hi = -1, int out_c0 = 0) {
  const int PW = g.out_w;
  const int rows = f1 - f0;
  if (w_hi < 0) w_hi = OC;
  const int count = OC * rows * PW;
  const long plane = (long)g.out_h * PW;
  for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
    int o = idx / (rows * PW);
    int rem = idx - o * rows * PW;
    int pr = rem / PW;
    int q = rem - pr * PW;
    const float* src = band + o * cs + (long)((f0 + pr) * g.psy - row0) * OW +
                       q * g.psx;
    float v;
    if (g.pool_kind == 1) {
      v = -INFINITY;
      for (int i = 0; i < g.pkh; ++i)
        for (int j = 0; j < g.pkw; ++j) v = fmaxf(v, src[i * OW + j]);
    } else {
      v = 0.f;
      for (int i = 0; i < g.pkh; ++i)
        for (int j = 0; j < g.pkw; ++j) v += src[i * OW + j];
      v = v / (float)(g.pkh * g.pkw);
    }
    if (g.pool_relu) v = fmaxf(v, 0.f);
    if (g.lrn_n)
      pooled[idx] = v;
    else if (o >= w_lo && o < w_hi)
      out[(o + out_c0) * plane + (long)(f0 + pr) * PW + q] = v;
  }
  if (!g.lrn_n) return;
  __syncthreads();
  const int lo = g.lrn_n / 2;
  const int hi = g.lrn_n - 1 - lo;
  const int count_w = (w_hi - w_lo) * rows * PW;
  for (int idx = threadIdx.x; idx < count_w; idx += blockDim.x) {
    int o = w_lo + idx / (rows * PW);
    int rem = idx - (o - w_lo) * rows * PW;
    int pr = rem / PW;
    int q = rem - pr * PW;
    float s = 0.f;
    for (int c = max(0, o - lo); c <= min(OC - 1, o + hi); ++c) {
      float u = pooled[c * rows * PW + rem];
      s = fmaf(u, u, s);
    }
    float v = pooled[o * rows * PW + rem] / powf(g.k + g.alpha * s, g.beta);
    out[(o + out_c0) * plane + (long)(f0 + pr) * PW + q] = v;
  }
}

}  // namespace cnnk
