// K2: a chain of convolutions (each with bias and optional ReLU), then an
// optional VALID pool -> ReLU -> channel LRN tail, in one launch.  K6 is the
// same kernel with the final stage's output channels taken in tiles of at
// least the width asked for (conv_chain_ocb_f32; the TPU kernel's oc-blocked
// grid, oc_block_final); the two share one schedule.
//
// Replaces the TPU kernel src/repro/kernels/conv2d/kernels.py
// conv2d_chain_simd -> _chain_simd_kernel (with _band_conv, and the
// oc-blocked grid for K6).  On the main path it runs AlexNet's
// conv3 -> conv4 -> conv5 -> pool5.
//
// Bound on the H100: fp32 operations (AlexNet's chain does 1.05 GFLOP a
// frame on 0.17 MB of input and 13.3 MB of weights; 66.9 TFLOP/s on the
// CUDA cores).  The TPU kernel walks one band of final rows through every
// stage; on 132 SMs that leaves too few blocks (one per pooled row and
// frame) and recomputes every band's halo rows.  This kernel is
// stage-major instead: one cooperative launch whose blocks all stay
// resident, and each stage is one implicit GEMM over every frame's output
// pixels at once, [N*OH*OW, KH*KW*C] x [KH*KW*C, OC], cut into tiles of
// ST_TP pixels x ST_TO channels that cover the output once (a tile may
// cross a frame boundary).  A grid-wide barrier separates the phases:
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
//      pool;
//   3. the tail (after the last stage): a block takes a pooled pixel of a
//      frame, pools every channel (max from -inf, avg over the whole
//      window), the ReLU, then the LRN over the neighbouring channels of
//      that pixel (alpha not divided by n), as pool_tail does.
//
// The reduction order of an output is fixed by the stage's shape alone:
// the k order is the JAX im2col's, k = (i * KW + j) * Cp + c, cut into
// chunks: each kernel tap (i, j) into `split` runs of at most
// CH_CHUNK_SLOTS ring slots of channels (split = the fewest that allows,
// a function of Cp).  Each chunk is summed on its own by FMAs over c
// ascending from zero; a tap adds its chunks left to right, a kernel row
// its taps left to right, the output its rows top to bottom.  An item
// takes `unit` chunks: one chunk (unit 1) writes a partial a chunk; one
// tap (unit = split) folds its chunks in shared memory and writes a
// partial a tap; one kernel row (unit = KW * split) also folds its taps
// into its own partial a row.  The reduce adds what is left of the tree.
// Every unit gives the same bits, so the host picks the unit by the batch
// (more, smaller items at batch 1) and a frame's output never depends on
// the batch.  Padding (between stages, and zero channels) is an
// fma(0, w, acc) every time.  No atomics in any sum: each partial value
// belongs to one thread of one item, every output is written once.  Data
// written during the launch by other blocks is read through L2 only
// (cp.async.cg, __ldcg), never from a stale L1 line.
#include <cooperative_groups.h>

#include "conv_common.cuh"
#include "conv_simt_tile.cuh"

namespace cg = cooperative_groups;

namespace cnnk {

constexpr int CH_THREADS = 128;    // threads of a block: one tile group
constexpr int CH_MIN_BLOCKS = 3;   // blocks an SM must hold (launch bounds)
constexpr int CH_CK = 16;          // reduction rows of a ring slot
constexpr int CH_AROW = 20;        // floats of a pixel's row in A (16 + 4)
constexpr int CH_CHUNK_SLOTS = 8;  // most ring slots of one chunk of a tap
constexpr int CH_SLOT = ST_TP * CH_AROW + CH_CK * ST_BROW;  // floats
constexpr int CH_RING = 2 * CH_SLOT;
constexpr int CH_FOLD = ST_TP * ST_TO;  // the tap fold: 64 floats a thread
constexpr int CH_PIX = 3 * ST_TP;       // a tile's pixels: base, iy0, ix0
constexpr int CH_SMEM = 4 * (CH_RING + CH_FOLD + CH_PIX);  // bytes
constexpr int CH_PLAN_HEAD = 2;    // plan[]: grid, partials' offset
constexpr int CH_PLAN_STAGE = 3;   // per stage: unit, tiles an item, output
static_assert(CH_THREADS == ST_THREADS, "one tile group a block");

// plan[] from the host (ops.chain_plan): the grid; the float offset of the
// partial buffer in scratch; per stage the chunks an item takes (1, a
// tap's split or a kernel row's KW * split), the ST_TO-wide channel tiles
// an item walks, and the float offset of the stage's NHWC output in
// scratch (-1: the NCHW output).  The NHWC input copy sits at offset 0.
struct Plan {
  int grid;
  int part_off;
  int unit[MAX_STAGES];
  int ot_item[MAX_STAGES];
  int act_off[MAX_STAGES];
};

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// Chunks of one tap of a stage with cp input channels (see above).
__host__ __device__ __forceinline__ int tap_split(int cp) {
  const int slots = (cp + CH_CK - 1) / CH_CK;
  return (slots + CH_CHUNK_SLOTS - 1) / CH_CHUNK_SLOTS;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Phase 0: x [N, C, H, W] -> xin [N, H, W, Cp], channels past C zero.
__device__ void to_nhwc(const Stage& st, int N, const float* __restrict__ x,
                        float* xin) {
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

// Phase 1 of one stage: every item's partials.  Item -> (pixel tile mt,
// channel block ob, partial q), mt fastest; a block takes items blockIdx.x,
// + gridDim.x, ...  An item walks its channel tiles, each over its chunks
// q * unit + j (j < unit), each chunk over its channels in ring slots of
// CH_CK; the slots run as one stream, so cp.async brings the next slot
// (of the same chunk, the next chunk or the next tile) while this one
// computes.
__device__ void stage_items(const Stage& st, int N, const float* in,
                            float* part, int unit, int ot_item, float* ring,
                            float* fold, int* pix) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int cp = round4(st.C), ocp = round4(st.OC);
  const int P = st.OH * st.OW;
  const int M = N * P;
  const int tiles_m = (M + ST_TP - 1) / ST_TP;
  const int n_ot = (ocp + ST_TO - 1) / ST_TO;
  const int o_items = (n_ot + ot_item - 1) / ot_item;
  const int split = tap_split(cp);
  const int Q = st.KH * st.KW * split / unit;
  const int items = tiles_m * o_items * Q;
  // ring slots of one chunk (past Cp they read zeros)
  const int nst = ((cp + CH_CK - 1) / CH_CK + split - 1) / split;
  const int q4 = tid & 3;                    // A: channel quad of a slot
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
      const int i = tap / st.KW;
      const int j = tap - i * st.KW;
      const int c0 = ((chunk - tap * split) * nst + s % nst) * CH_CK;
      const int c = c0 + q4 * 4;
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // pixels (tid >> 2) + 32 r
        const int pp = (tid >> 2) + 32 * r;
        const int iy = pix[ST_TP + pp] + i;
        const int ix = pix[2 * ST_TP + pp] + j;
        const bool v = c < cp && (unsigned)iy < (unsigned)st.H &&
                       (unsigned)ix < (unsigned)st.W;
        cp_async16(dst + pp * CH_AROW + q4 * 4,
                   v ? in + pix[pp] + (iy * st.W + ix) * cp + c : in, v);
      }
      float* bs = dst + ST_TP * CH_AROW;
      const int o = ot * ST_TO + b4 * 4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = (tid >> 4) + 8 * r;
        const int cc = c0 + k;
        const bool v = cc < cp && o < ocp;
        cp_async16(bs + k * ST_BROW + b4 * 4,
                   v ? st.w + ((long long)tap * cp + cc) * ocp + o : st.w, v);
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
        for (int u4 = 0; u4 < 4; ++u4) {  // k ascending: c ascending
          float a[8];
#pragma unroll
          for (int m = 0; m < 8; ++m)
            a[m] = u4 == 0 ? a4[m].x : u4 == 1 ? a4[m].y
                   : u4 == 2 ? a4[m].z : a4[m].w;
          outer8x8(acc, a, bsm + (kq * 4 + u4) * ST_BROW, ty);
        }
      }
      if (s % nst != nst - 1) continue;
      // a chunk is complete: fold it into its tap (thread-private)
      const int rs = s / nst;
      const int jj = rs % unit;         // the item's chunk
      const int g = q * unit + jj;      // the stage's chunk
      const int k = g % split;          // its tap's chunk
      const bool first = k == 0 || jj == 0;
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          float* f = fold + (m * 8 + u) * CH_THREADS + tid;
          *f = first ? acc[m][u] : *f + acc[m][u];
          acc[m][u] = 0.f;
        }
      if (k != split - 1 && jj != unit - 1) continue;
      // the tap (or the item's one chunk) is complete: the tile's partial
      // q, two float4 of channels for each pixel; a row item adds each
      // tap after its row's first to the partial it wrote itself
      const bool add = unit > split && (g / split) % st.KW != 0;
      const int o0 = (ot0 + rs / unit) * ST_TO;
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
          const float4 v = make_float4(f[0], f[CH_THREADS], f[2 * CH_THREADS],
                                       f[3 * CH_THREADS]);
          *d4 = add ? add4(*d4, v) : v;
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
__device__ void reduce_stage(const Stage& st, int N, const float* part,
                             int unit, float* act, float* out) {
  const int ocp = round4(st.OC), quads = ocp / 4;
  const int P = st.OH * st.OW;
  const int M = N * P;
  const int split = tap_split(round4(st.C));
  const int per_tap = unit == 1 ? split : 1;    // partials of a tap
  const int taps = unit > split ? 1 : st.KW;    // taps of a row to fold
  const long long stride = (long long)M * ocp;  // between partials
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
    float v[4] = {tot.x, tot.y, tot.z, tot.w};
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      v[l] = o + l < st.OC ? v[l] + st.b[o + l] : 0.f;
      if (st.relu) v[l] = fmaxf(v[l], 0.f);
    }
    if (act) {
      *reinterpret_cast<float4*>(act + (long long)m * ocp + o) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
      const int n = m / P;
      const int pix = m - n * P;
#pragma unroll
      for (int l = 0; l < 4; ++l)
        if (o + l < st.OC) out[((long long)n * st.OC + o + l) * P + pix] = v[l];
    }
  }
}

// Phase 3: the VALID pool, ReLU and LRN of the last stage's NHWC output,
// one pooled pixel of one frame at a time, written NCHW.  sm holds the
// pooled channels of the pixel for the LRN.
__device__ void chain_tail(const Geo& g, const Stage& st, const float* act,
                           float* out, float* sm) {
  const int ocp = round4(st.OC);
  const int PH = g.out_h, PW = g.out_w;
  const int items = g.N * PH * PW;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int n = item / (PH * PW);
    const int pr = item - n * PH * PW;
    const int py = pr / PW;
    const int px = pr - py * PW;
    const float* src =
        act + (((long long)n * st.OH + py * g.psy) * st.OW + px * g.psx) * ocp;
    float* dst = out + (long long)n * st.OC * PH * PW + pr;
    for (int o = threadIdx.x; o < st.OC; o += CH_THREADS) {
      float v;
      if (g.pool_kind == 1) {
        v = -INFINITY;
        for (int i = 0; i < g.pkh; ++i)
          for (int j = 0; j < g.pkw; ++j)
            v = fmaxf(v, __ldcg(src + (i * st.OW + j) * ocp + o));
      } else {
        v = 0.f;
        for (int i = 0; i < g.pkh; ++i)
          for (int j = 0; j < g.pkw; ++j)
            v += __ldcg(src + (i * st.OW + j) * ocp + o);
        v = v / (float)(g.pkh * g.pkw);
      }
      if (g.pool_relu) v = fmaxf(v, 0.f);
      if (g.lrn_n)
        sm[o] = v;
      else
        dst[(long long)o * PH * PW] = v;
    }
    if (!g.lrn_n) continue;
    __syncthreads();
    const int lo = g.lrn_n / 2;
    const int hi = g.lrn_n - 1 - lo;
    for (int o = threadIdx.x; o < st.OC; o += CH_THREADS) {
      float s = 0.f;
      for (int c = max(0, o - lo); c <= min(st.OC - 1, o + hi); ++c)
        s = fmaf(sm[c], sm[c], s);
      dst[(long long)o * PH * PW] = sm[o] / powf(g.k + g.alpha * s, g.beta);
    }
    __syncthreads();  // sm is free for the next pixel
  }
}

__global__ void __launch_bounds__(CH_THREADS, CH_MIN_BLOCKS)
conv_chain_kernel(Geo g, Plan p, const float* __restrict__ x, float* out,
                  float* scratch) {
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
    stage_items(g.st[s], g.N, in, part, p.unit[s], p.ot_item[s], ring, fold,
                pix);
    grid.sync();  // every partial of the stage is written
    float* act = p.act_off[s] >= 0 ? scratch + p.act_off[s] : nullptr;
    reduce_stage(g.st[s], g.N, part, p.unit[s], act, out);
    in = act;
  }
  if (!g.pool_kind) return;
  grid.sync();  // the last stage's output is complete
  chain_tail(g, g.st[last], in, out, ring);
}

// 1 if plan[] is malformed for g (see Plan).
static int read_plan(Plan* p, const int* plan, const Geo& g) {
  p->grid = plan[0];
  p->part_off = plan[1];
  if (p->grid < 1 || p->part_off < 0 || (p->part_off & 3)) return 1;
  for (int s = 0; s < g.n_stages; ++s) {
    const int* q = plan + CH_PLAN_HEAD + s * CH_PLAN_STAGE;
    const Stage& st = g.st[s];
    p->unit[s] = q[0];
    p->ot_item[s] = q[1];
    p->act_off[s] = q[2];
    const int split = tap_split(round4(st.C));
    const int u = p->unit[s];
    if (p->ot_item[s] < 1 || (u != 1 && u != split && u != st.KW * split))
      return 1;
    const bool to_out = s == g.n_stages - 1 && !g.pool_kind;
    if (to_out != (p->act_off[s] < 0) || (!to_out && (p->act_off[s] & 3)))
      return 1;
    if (s > 0 && round4(st.C) != round4(g.st[s - 1].OC)) return 1;
  }
  return 0;
}

// Both entry points: K2 without tile[] (every stage in ST_TO-wide channel
// tiles), K6 with it (no LRN; plan[] gives its final stage's items
// tile[0] channels or more).
static int launch_chain(const void* x, const void* const* ws,
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
  if (g.lrn_n && g.st[last].OC > CH_SMEM / 4)  // the tail's pooled channels
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      conv_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CH_SMEM);
  if (e != cudaSuccess) return (int)e;
  // every block must be resident at once for the grid barriers: the
  // runtime refuses a larger grid (cudaErrorCooperativeLaunchTooLarge)
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  float* sp = static_cast<float*>(scratch);
  void* args[] = {&g, &p, &xp, &op, &sp};
  e = cudaLaunchCooperativeKernel((const void*)conv_chain_kernel,
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
// conv_common.cuh describes, plan as Plan.  Returns cudaGetLastError()
// after the launch (an error of its own when a check or the launch fails).
extern "C" int conv_chain_f32(const void* x, const void* const* ws,
                              const void* const* bs, void* out, void* scratch,
                              const int* geo, const float* lrn,
                              const int* plan, void* stream) {
  return cnnk::launch_chain(x, ws, bs, out, scratch, geo, lrn, plan, nullptr,
                            stream);
}

// K6.  As K2, with tile = {ocb, oc_tiles, 1} of the final stage and no LRN.
extern "C" int conv_chain_ocb_f32(const void* x, const void* const* ws,
                                  const void* const* bs, void* out,
                                  void* scratch, const int* geo,
                                  const float* lrn, const int* plan,
                                  const int* tile, void* stream) {
  return cnnk::launch_chain(x, ws, bs, out, scratch, geo, lrn, plan, tile,
                            stream);
}

// Blocks of the chain kernel an SM holds at once (its grid may be this
// many times the SMs), or minus a CUDA error.
extern "C" int conv_chain_blocks_per_sm(void) {
  cudaError_t e = cudaFuncSetAttribute(
      cnnk::conv_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      cnnk::CH_SMEM);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cnnk::conv_chain_kernel, cnnk::CH_THREADS, cnnk::CH_SMEM);
  return e == cudaSuccess ? per_sm : -(int)e;
}
