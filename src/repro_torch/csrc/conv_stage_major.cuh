// The stage-major schedule of the fp32 convolution kernels K1, K2, K4, K5
// and K6 (one kernel, conv_chain.cu, with an entry point each):
// a chain of convolutions (each with bias and optional ReLU; K1, K4 and K5
// are the one-stage case), then an optional VALID pool -> ReLU -> channel LRN
// tail, in one cooperative launch whose blocks all stay resident.  Each
// stage is one implicit GEMM over every frame's output pixels at once,
// [N*OH*OW, KH*KW*C] x [KH*KW*C, OC], cut into tiles of ST_TP pixels x
// ST_TO channels that cover the output once (a tile may cross a frame
// boundary).  A grid-wide barrier separates the phases:
//
//   0. the input, NCHW, is copied to NHWC scratch with its channels
//      zero-padded to a float4 (Cp);
//   per stage:
//   1. items: a block takes (pixel tile, channel tiles, partial q) items
//      in a fixed static order and runs them on the register-tiled core
//      of conv_simt_tile.cuh (8 x 8 accumulators a thread, cp.async into a
//      two-slot ring: A by 16 bytes from the NHWC input, B by 16 bytes
//      from the weights, which the wrapper converts once to HWIO with C
//      and OC padded to float4s);
//   2. reduce: every output adds its partials in a fixed order, then the
//      bias and the ReLU, and is written NHWC (padded channels zero) for
//      the next stage, or NCHW to the output for a last stage without a
//      pool.  An item that takes the whole reduction does this itself, and
//      the stage has no reduce pass;
//   3. the tail (after the last stage): a block takes a few pooled pixels
//      and pools every channel of each (max from -inf, avg over the whole
//      window), the ReLU, then the LRN over the neighbouring channels of
//      the pixel (alpha not divided by n).
//
// The walk of the reduction.  k is the HWIO row order, k = (i * KW + j) *
// Cp + c, cut into taps: with Cp >= CH_CK a tap is one kernel position
// (i, j) of Cp channels (KW taps a kernel row); with Cp < CH_CK it is one
// kernel row i, the KW * Cp floats (j, c) that lie side by side in NHWC
// for a fixed output pixel, KW * Cp consecutive weight rows too (one tap a
// row).  The narrow walk fills the CH_CK rows of a ring slot with real
// rows: AlexNet's conv1 (Cp 4, 11 x 11) takes 3 slots a kernel row, 528
// rows for its 363, where a tap a slot would take 1936.  Each tap's run is
// cut into `split` chunks of at most CH_CHUNK_SLOTS ring slots (split =
// the fewest that allows: a function of the shape).
//
// The reduction order of an output is fixed by the stage's shape alone.
// Each chunk is summed on its own by FMAs over its rows ascending from
// zero; a tap adds its chunks left to right, a kernel row its taps left to
// right, the output its rows top to bottom.  An item takes `unit` chunks:
// one chunk (unit 1) writes a partial a chunk; one tap (unit = split)
// folds its chunks in shared memory and writes a partial a tap; one kernel
// row (unit = taps of a row * split) also adds its taps into its own
// partial.  The whole reduction (unit = every chunk, where the tree has at
// most two levels of more than one member: not split > 1, taps of a row >
// 1 and KH > 1 at once) folds the inner level in shared memory and adds
// the outer one into its own partial (none when there is one level), then
// adds the bias, takes the ReLU and writes the output itself.  The reduce
// adds what is left of the tree.  Every unit gives the same bits, so the
// host picks the unit by the batch (more, smaller items at batch 1) and a
// frame's output never depends on the batch.  Padding (between stages,
// zero channels, the rows past a tap's run) is an fma(0, w, acc) every
// time.  No atomics in any sum: each partial value belongs to one thread
// of one item, every output is written once.  Data written during the
// launch by other blocks is read through L2 only (cp.async.cg, __ldcg),
// never from a stale L1 line.
//
// Bound on the H100: fp32 operations (AlexNet's conv2 group does 14.3
// GFLOP at batch 16 on 3 MB of input and 2.5 MB of weights; 66.9 TFLOP/s
// on the CUDA cores).  The TPU kernels walk one band of final rows a grid
// step; on 132 SMs that leaves too few blocks (one per pooled row and
// frame) and recomputes the halo rows that two bands' pool windows share.
// Here every output of every stage is computed once, by one item.
#pragma once

#include <cooperative_groups.h>

#include "conv_common.cuh"
#include "conv_simt_tile.cuh"

namespace cnnk {

namespace cg = cooperative_groups;

constexpr int CH_THREADS = 128;    // threads of a block: one tile group
constexpr int CH_MIN_BLOCKS = 3;   // blocks an SM must hold (launch bounds)
constexpr int CH_CK = 16;          // reduction rows of a ring slot
constexpr int CH_AROW = 20;        // floats of a pixel's row in A (16 + 4)
constexpr int CH_CHUNK_SLOTS = 8;  // most ring slots of one chunk of a tap
constexpr int CH_SLOT = ST_TP * CH_AROW + CH_CK * ST_BROW;  // floats
constexpr int CH_RING = 2 * CH_SLOT;
constexpr int CH_FOLD = ST_TP * ST_TO;  // the fold: 64 floats a thread
constexpr int CH_PIX = 3 * ST_TP;       // a tile's pixels: base, iy0, ix0
constexpr int CH_SMEM = 4 * (CH_RING + CH_FOLD + CH_PIX);  // bytes
constexpr int CH_PLAN_HEAD = 2;    // plan[]: grid, partials' offset
constexpr int CH_PLAN_STAGE = 3;   // per stage: unit, tiles an item, output
static_assert(CH_THREADS == ST_THREADS, "one tile group a block");

// plan[] from the host (ops.chain_plan): the grid; the float offset of the
// partial buffer in scratch; per stage the chunks an item takes (1, a
// tap's split, a kernel row's or every chunk), the ST_TO-wide channel
// tiles an item walks, and the float offset of the stage's NHWC output in
// scratch (-1: the NCHW output).  The NHWC input copy sits at offset 0.
struct Plan {
  int grid;
  int part_off;
  int unit[MAX_STAGES];
  int ot_item[MAX_STAGES];
  int act_off[MAX_STAGES];
};

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// How a stage walks its reduction (see above): Cp, the floats of a tap's
// run, taps a kernel row, chunks a tap, ring slots a chunk, chunks of the
// stage, and the chunks one fold of a whole-reduction item sums (0: the
// stage has no whole-reduction item).
struct Walk {
  int cp, tw, tpr, split, nst, chunks, run;
};

__host__ __device__ inline Walk stage_walk(const Stage& st) {
  Walk k;
  k.cp = round4(st.C);
  const bool narrow = k.cp < CH_CK;
  k.tw = narrow ? st.KW * k.cp : k.cp;
  k.tpr = narrow ? 1 : st.KW;
  const int slots = (k.tw + CH_CK - 1) / CH_CK;
  k.split = (slots + CH_CHUNK_SLOTS - 1) / CH_CHUNK_SLOTS;
  k.nst = (slots + k.split - 1) / k.split;
  k.chunks = st.KH * k.tpr * k.split;
  if (k.split > 1 && k.tpr > 1 && st.KH > 1)
    k.run = 0;
  else
    k.run = k.split > 1 ? k.split : k.tpr > 1 ? k.tpr : st.KH;
  return k;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Phase 0: x [N, C, H, W] -> xin [N, H, W, Cp], channels past C zero.
__device__ inline void to_nhwc(const Stage& st, int N,
                               const float* __restrict__ x, float* xin) {
  const int cp = round4(st.C), quads = cp / 4, hw = st.H * st.W;
  const long long total = (long long)N * quads * hw;
  for (long long e = (long long)blockIdx.x * CH_THREADS + threadIdx.x;
       e < total; e += (long long)gridDim.x * CH_THREADS) {
    const int pix = (int)(e % hw);
    const long long r = e / hw;
    const int q = (int)(r % quads);
    const long long n = r / quads;
    float v[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int c = 4 * q + l;
      v[l] = c < st.C ? x[(n * st.C + c) * hw + pix] : 0.f;
    }
    *reinterpret_cast<float4*>(xin + (n * hw + pix) * cp + 4 * q) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// The bias and the ReLU of four channels of output m, o0..o0+3, written
// NHWC to act (padded channels zero) or, act == nullptr, NCHW to out.
__device__ __forceinline__ void finish4(const Stage& st, int P, int ocp,
                                        int m, int o0, float4 t, float* act,
                                        float* out) {
  float v[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    v[l] = o0 + l < st.OC ? v[l] + st.b[o0 + l] : 0.f;
    if (st.relu) v[l] = fmaxf(v[l], 0.f);
  }
  if (act) {
    *reinterpret_cast<float4*>(act + (long long)m * ocp + o0) =
        make_float4(v[0], v[1], v[2], v[3]);
  } else {
    const int n = m / P;
    const int pix = m - n * P;
#pragma unroll
    for (int l = 0; l < 4; ++l)
      if (o0 + l < st.OC) out[((long long)n * st.OC + o0 + l) * P + pix] = v[l];
  }
}

// Phase 1 of one stage: every item's partials (or, with the whole
// reduction, its outputs).  Item -> (pixel tile mt, channel block ob,
// partial q), mt fastest; a block takes items blockIdx.x, + gridDim.x, ...
// An item walks its channel tiles, each over its chunks q * unit + jj (jj
// < unit), each chunk over its rows in ring slots of CH_CK; the slots run
// as one stream, so cp.async brings the next slot (of the same chunk, the
// next chunk or the next tile) while this one computes.
__device__ inline void stage_items(const Stage& st, int N, const float* in,
                                   float* part, int unit, int ot_item,
                                   float* act, float* out, float* ring,
                                   float* fold, int* pix) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const Walk wk = stage_walk(st);
  const int cp = wk.cp, tw = wk.tw, split = wk.split, nst = wk.nst;
  const int ocp = round4(st.OC);
  const int P = st.OH * st.OW;
  const int M = N * P;
  const int tiles_m = (M + ST_TP - 1) / ST_TP;
  const int n_ot = (ocp + ST_TO - 1) / ST_TO;
  const int o_items = (n_ot + ot_item - 1) / ot_item;
  const int Q = wk.chunks / unit;
  const int items = tiles_m * o_items * Q;
  const bool whole = unit == wk.chunks;
  const int q4 = tid & 3;                    // A: float quad of a slot
  const int b4 = tid & 15;                   // B: float4 column of a row
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int mt = item % tiles_m;
    const int rest = item / tiles_m;
    const int ob = rest % o_items;
    const int q = rest / o_items;
    const int p0 = mt * ST_TP;
    const int ot0 = ob * ot_item;
    const int n_tiles = min(ot0 + ot_item, n_ot) - ot0;
    // the tile's pixels (thread tid computes pixel tid): the frame's
    // offset in the input and the top-left tap, in shared memory so that
    // the copies read them without holding registers
    {
      const int m = p0 + tid;
      int base = 0, iy0 = -(1 << 24), ix0 = 0;  // past the stage: padding
      if (m < M) {
        const int n = m / P;
        const int pr = m - n * P;
        const int oy = pr / st.OW;
        base = n * st.H * st.W * cp;
        iy0 = oy * st.sy - st.py;
        ix0 = (pr - oy * st.OW) * st.sx - st.px;
      }
      pix[tid] = base;
      pix[ST_TP + tid] = iy0;
      pix[2 * ST_TP + tid] = ix0;
    }
    __syncthreads();
    auto load = [&](int s, float* dst) {
      const int rs = s / nst;
      const int chunk = q * unit + rs % unit;
      const int ot = ot0 + rs / unit;
      const int tap = chunk / split;
      const int i = tap / wk.tpr;
      const int j0 = tap - i * wk.tpr;
      // the slot's first row in its tap's run; a float4 of A never
      // crosses a pixel (Cp is a multiple of 4)
      const int r0 = ((chunk - tap * split) * nst + s % nst) * CH_CK;
      const int r = r0 + q4 * 4;
      const int dj = r / cp;
      const int c = r - dj * cp;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {  // pixels (tid >> 2) + 32 rr
        const int pp = (tid >> 2) + 32 * rr;
        const int iy = pix[ST_TP + pp] + i;
        const int ix = pix[2 * ST_TP + pp] + j0 + dj;
        const bool v = r < tw && (unsigned)iy < (unsigned)st.H &&
                       (unsigned)ix < (unsigned)st.W;
        cp_async16(dst + pp * CH_AROW + q4 * 4,
                   v ? in + pix[pp] + (iy * st.W + ix) * cp + c : in, v);
      }
      float* bs = dst + ST_TP * CH_AROW;
      const int o = ot * ST_TO + b4 * 4;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int k = (tid >> 4) + 8 * rr;
        const int kr = r0 + k;
        const bool v = kr < tw && o < ocp;
        cp_async16(bs + k * ST_BROW + b4 * 4,
                   v ? st.w + ((long long)tap * tw + kr) * ocp + o : st.w, v);
      }
    };

    float acc[8][8];
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[m][u] = 0.f;
    const int steps = n_tiles * unit * nst;
    load(0, ring);
    cp_async_commit();
    for (int s = 0; s < steps; ++s) {
      cp_async_wait_all();
      __syncthreads();  // slot s landed; slot s - 1 is free
      if (s + 1 < steps) load(s + 1, ring + ((s + 1) & 1) * CH_SLOT);
      cp_async_commit();
      const float* as = ring + (s & 1) * CH_SLOT;
      const float* bsm = as + ST_TP * CH_AROW;
#pragma unroll
      for (int kq = 0; kq < CH_CK / 4; ++kq) {
        float4 a4[8];
#pragma unroll
        for (int m = 0; m < 8; ++m)
          a4[m] = *reinterpret_cast<const float4*>(as + (tx + 16 * m) * CH_AROW +
                                                   kq * 4);
#pragma unroll
        for (int u4 = 0; u4 < 4; ++u4) {  // k ascending
          float a[8];
#pragma unroll
          for (int m = 0; m < 8; ++m)
            a[m] = u4 == 0 ? a4[m].x : u4 == 1 ? a4[m].y
                   : u4 == 2 ? a4[m].z : a4[m].w;
          outer8x8(acc, a, bsm + (kq * 4 + u4) * ST_BROW, ty);
        }
      }
      if (s % nst != nst - 1) continue;
      // a chunk is complete: fold it (thread-private)
      const int rs = s / nst;
      const int jj = rs % unit;         // the item's chunk
      const int g = q * unit + jj;      // the stage's chunk
      const int k = g % split;          // its tap's chunk
      const int o0 = (ot0 + rs / unit) * ST_TO;
      // whole: the fold sums a run of wk.run chunks, the runs add up in
      // the item's partial; else the fold sums a tap's chunks
      const bool first = whole ? jj % wk.run == 0 : k == 0 || jj == 0;
      const bool done = whole ? jj % wk.run == wk.run - 1
                              : k == split - 1 || jj == unit - 1;
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          float* f = fold + (m * 8 + u) * CH_THREADS + tid;
          *f = first ? acc[m][u] : *f + acc[m][u];
          acc[m][u] = 0.f;
        }
      if (!done) continue;
      // the fold is complete: two float4 of channels for each pixel.  A
      // row item adds each tap after its row's first to the partial it
      // wrote itself; a whole item adds each run after its first, and
      // finishes the output after its last
      const bool add = whole ? jj >= wk.run
                             : unit > split && (g / split) % wk.tpr != 0;
      const bool last = whole && jj == unit - 1;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int p = p0 + tx + 16 * m;
        if (p >= M) continue;
        float* dst = part + ((long long)q * M + p) * ocp + o0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int oo = h * 32 + ty * 4;
          if (o0 + oo >= ocp) continue;
          const float* f = fold + (m * 8 + 4 * h) * CH_THREADS + tid;
          float4* d4 = reinterpret_cast<float4*>(dst + oo);
          float4 v = make_float4(f[0], f[CH_THREADS], f[2 * CH_THREADS],
                                 f[3 * CH_THREADS]);
          if (add) v = add4(*d4, v);
          if (last)
            finish4(st, P, ocp, p, o0 + oo, v, act, out);
          else
            *d4 = v;
        }
      }
    }
    __syncthreads();  // every thread is done with the ring
  }
}

// Phase 2 of one stage: each output's partials folded in the fixed order
// (chunks into taps, taps into rows, rows, each left to right; the items
// did the levels their unit covers), the bias, the ReLU.
// act: NHWC [N, OH, OW, OCp], padded channels zero; act == nullptr: the
// NCHW output.
__device__ inline void reduce_stage(const Stage& st, int N, const float* part,
                                    int unit, float* act, float* out) {
  const Walk wk = stage_walk(st);
  const int ocp = round4(st.OC), quads = ocp / 4;
  const int P = st.OH * st.OW;
  const int M = N * P;
  const int per_tap = unit == 1 ? wk.split : 1;    // partials of a tap
  const int taps = unit > wk.split ? 1 : wk.tpr;   // taps of a row to fold
  const long long stride = (long long)M * ocp;     // between partials
  const long long total = (long long)M * quads;
  for (long long e = (long long)blockIdx.x * CH_THREADS + threadIdx.x;
       e < total; e += (long long)gridDim.x * CH_THREADS) {
    const int m = (int)(e / quads);
    const int o = (int)(e - (long long)m * quads) * 4;
    const float* pm = part + (long long)m * ocp + o;
    float4 tot = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < st.KH; ++i) {
      float4 row = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < taps; ++j) {
        const float* pt = pm + (long long)(i * taps + j) * per_tap * stride;
        float4 tap = __ldcg(reinterpret_cast<const float4*>(pt));
        for (int k = 1; k < per_tap; ++k)
          tap = add4(tap, __ldcg(reinterpret_cast<const float4*>(
                              pt + k * stride)));
        row = j == 0 ? tap : add4(row, tap);
      }
      tot = i == 0 ? row : add4(tot, row);
    }
    finish4(st, P, ocp, m, o, tot, act, out);
  }
}

// Phase 3: the VALID pool, ReLU and LRN of the last stage's NHWC output,
// written NCHW.  A block takes ppb consecutive pooled pixels at a time (of
// one frame or two; ppb x OC about CH_TAIL outputs, one pixel when OC is
// wider), its threads their outputs channel fastest, CH_TAIL_ILP each,
// pooled window position by window position so that their loads are in
// flight together.  Each output's arithmetic is fixed: the max from -inf,
// the avg summed over the window in row order and divided by its size,
// the ReLU, then the LRN over its pixel's neighbouring channels (alpha
// not divided by n), the squares added in channel order.  sm holds the
// pooled values of the block's pixels for the LRN.
constexpr int CH_TAIL_ILP = 4;                       // outputs a thread
constexpr int CH_TAIL = CH_TAIL_ILP * CH_THREADS;    // outputs a block

__device__ inline void stage_tail(const Geo& g, const Stage& st,
                                  const float* act, float* out, float* sm) {
  const int ocp = round4(st.OC), OC = st.OC;
  const int PW = g.out_w, P = g.out_h * PW;
  const int pixels = g.N * P;
  const int ppb = max(1, CH_TAIL / OC);
  const int groups = (pixels + ppb - 1) / ppb;
  const long long win = (long long)st.OW * ocp;  // a conv row in act
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int px0 = grp * ppb;
    const int cnt = min(ppb, pixels - px0) * OC;  // the block's outputs
    for (int e0 = 0; e0 < cnt; e0 += CH_TAIL) {
      const float* src[CH_TAIL_ILP];
      float v[CH_TAIL_ILP];
      long long dst[CH_TAIL_ILP];
#pragma unroll
      for (int k = 0; k < CH_TAIL_ILP; ++k) {
        const int e = min(e0 + k * CH_THREADS + (int)threadIdx.x, cnt - 1);
        const int pl = e / OC;
        const int o = e - pl * OC;
        const int n = (px0 + pl) / P;
        const int pr = px0 + pl - n * P;
        const int py = pr / PW;
        src[k] = act + ((long long)n * st.OH + py * g.psy) * win +
                 (long long)(pr - py * PW) * g.psx * ocp + o;
        dst[k] = ((long long)n * OC + o) * P + pr;
        v[k] = g.pool_kind == 1 ? -INFINITY : 0.f;
      }
      for (int i = 0; i < g.pkh; ++i)
        for (int j = 0; j < g.pkw; ++j) {
          float a[CH_TAIL_ILP];
#pragma unroll
          for (int k = 0; k < CH_TAIL_ILP; ++k)
            a[k] = __ldcg(src[k] + i * win + (long long)j * ocp);
#pragma unroll
          for (int k = 0; k < CH_TAIL_ILP; ++k)
            v[k] = g.pool_kind == 1 ? fmaxf(v[k], a[k]) : v[k] + a[k];
        }
#pragma unroll
      for (int k = 0; k < CH_TAIL_ILP; ++k) {
        const int e = e0 + k * CH_THREADS + (int)threadIdx.x;
        if (e >= cnt) continue;
        float r = v[k];
        if (g.pool_kind != 1) r = r / (float)(g.pkh * g.pkw);
        if (g.pool_relu) r = fmaxf(r, 0.f);
        if (g.lrn_n)
          sm[e] = r;
        else
          out[dst[k]] = r;
      }
    }
    if (!g.lrn_n) continue;
    __syncthreads();
    const int lo = g.lrn_n / 2;
    const int hi = g.lrn_n - 1 - lo;
    for (int e = threadIdx.x; e < cnt; e += CH_THREADS) {
      const int pl = e / OC;
      const int o = e - pl * OC;
      const float* px = sm + pl * OC;
      float s = 0.f;
      for (int c = max(0, o - lo); c <= min(OC - 1, o + hi); ++c)
        s = fmaf(px[c], px[c], s);
      const int n = (px0 + pl) / P;
      out[(long long)(n * OC + o) * P + px0 + pl - n * P] =
          px[o] / powf(g.k + g.alpha * s, g.beta);
    }
    __syncthreads();  // sm is free for the next pixels
  }
}

// The body of the stage-major kernel: conv_chain.cu wraps it in the one
// __global__ (__launch_bounds__(CH_THREADS, CH_MIN_BLOCKS)) that K1, K2,
// K5 and K6 launch, with CH_SMEM bytes of dynamic shared memory.
__device__ __forceinline__ void stage_major(const Geo& g, const Plan& p,
                                            const float* __restrict__ x,
                                            float* out, float* scratch) {
  extern __shared__ float4 dyn4[];
  float* ring = reinterpret_cast<float*>(dyn4);
  float* fold = ring + CH_RING;
  int* pix = reinterpret_cast<int*>(fold + CH_FOLD);
  cg::grid_group grid = cg::this_grid();
  const int last = g.n_stages - 1;
  to_nhwc(g.st[0], g.N, x, scratch);
  const float* in = scratch;
  float* part = scratch + p.part_off;
  for (int s = 0; s <= last; ++s) {
    grid.sync();  // the stage's input is complete; the partials are free
    float* act = p.act_off[s] >= 0 ? scratch + p.act_off[s] : nullptr;
    stage_items(g.st[s], g.N, in, part, p.unit[s], p.ot_item[s], act, out,
                ring, fold, pix);
    if (p.unit[s] != stage_walk(g.st[s]).chunks) {
      grid.sync();  // every partial of the stage is written
      reduce_stage(g.st[s], g.N, part, p.unit[s], act, out);
    }
    in = act;
  }
  if (!g.pool_kind) return;
  grid.sync();  // the last stage's output is complete
  stage_tail(g, g.st[last], in, out, ring);
}

// 1 if plan[] is malformed for g (see Plan).
inline int read_plan(Plan* p, const int* plan, const Geo& g) {
  p->grid = plan[0];
  p->part_off = plan[1];
  if (p->grid < 1 || p->part_off < 0 || (p->part_off & 3)) return 1;
  for (int s = 0; s < g.n_stages; ++s) {
    const int* q = plan + CH_PLAN_HEAD + s * CH_PLAN_STAGE;
    const Stage& st = g.st[s];
    p->unit[s] = q[0];
    p->ot_item[s] = q[1];
    p->act_off[s] = q[2];
    const Walk wk = stage_walk(st);
    const int u = p->unit[s];
    if (p->ot_item[s] < 1 ||
        (u != 1 && u != wk.split && u != wk.tpr * wk.split &&
         !(u == wk.chunks && wk.run)))
      return 1;
    const bool to_out = s == g.n_stages - 1 && !g.pool_kind;
    if (to_out != (p->act_off[s] < 0) || (!to_out && (p->act_off[s] & 3)))
      return 1;
    if (s > 0 && round4(st.C) != round4(g.st[s - 1].OC)) return 1;
  }
  return 0;
}

}  // namespace cnnk
