// Shared device code of the fused convolution kernels (K7 in
// conv_basic_simd.cu; the stage-major kernel of conv_stage_major.cuh,
// which K1, K2, K4, K5 and K6 launch, takes only the geometry block): a
// geometry block passed by value, the rows of a band, and the pool ->
// ReLU -> LRN tail of a band.
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

// geo[] from the host, per stage: C, H, W, OC, KH, KW, sy, sx, py, px,
// relu, OH, OW (STAGE_INTS ints).  Header: N, n_stages, pool_kind (0 none,
// 1 max, 2 avg), pkh, pkw, psy, psx, pool_relu, lrn_n (0 none), blk
// (final rows per block), n_tiles, total (final rows), out_h, out_w.
// The oc-blocked kernel (K6) takes a second array, tile[] = {ocb,
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

// The oc-blocked kernel's tile[] (see TILE_INTS); 1 if it is malformed.
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

// VALID max/avg pool of the final band's rows [f0, f1) (pooled rows), then
// the optional ReLU and the optional channel LRN
//   y = x / (k + alpha * sum_{c' in [c - n/2, c + (n-1)/2]} x_c'^2)^beta
// (alpha is NOT divided by n), written to out (frame base, NCHW).  With LRN
// the pooled values of every channel are staged in `pooled` (shared memory,
// OC * (f1 - f0) * PW floats) first, since each output needs its neighbours.
__device__ inline void pool_tail(const Geo& g, const float* band, long cs,
                                 int row0, int OC, int OW, int f0, int f1,
                                 float* out, float* pooled) {
  const int PW = g.out_w;
  const int rows = f1 - f0;
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
    else
      out[o * plane + (long)(f0 + pr) * PW + q] = v;
  }
  if (!g.lrn_n) return;
  __syncthreads();
  const int lo = g.lrn_n / 2;
  const int hi = g.lrn_n - 1 - lo;
  for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
    int o = idx / (rows * PW);
    int rem = idx - o * rows * PW;
    int pr = rem / PW;
    int q = rem - pr * PW;
    float s = 0.f;
    for (int c = max(0, o - lo); c <= min(OC - 1, o + hi); ++c) {
      float u = pooled[c * rows * PW + rem];
      s = fmaf(u, u, s);
    }
    float v = pooled[o * rows * PW + rem] / powf(g.k + g.alpha * s, g.beta);
    out[o * plane + (long)(f0 + pr) * PW + q] = v;
  }
}

}  // namespace cnnk
