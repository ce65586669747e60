// Fused loss front: bilinear upsample + log-softmax + NLL, forward and
// backward, from (N,h,w,C) NHWC logits and (N,oh,ow) int32 labels, without
// writing the (N,oh,ow,C) upsampled logits to device memory.
//
// Replaces the two Pallas TPU kernels of pidnet_tpu/ops/ce_front.py:
//   ce_fwd  <- _fwd_kernel (line 121): nll = logsumexp_c(z) - z[label],
//              w = cw[label], both 0 where the label is ignore or outside
//              [0, C) (the JAX package's XLA oracle, _per_pixel_ce);
//   ce_bwd  <- _bwd_kernel (line 150): dL = A^T (g * (softmax(z) - onehot)) B,
//              with g zeroed where the label is ignore or outside [0, C).
// z is the bilinear upsample of the logits, built from the 2x2 source taps
// of bilinear.cuh: the same device code as upsample_argmax.cu, so ce_bwd is
// the exact adjoint of ce_fwd, at the clamped last tap too.
//
// The TPU kernels W-interpolate every class plane into a VMEM scratch that
// persists across a sequential grid, and accumulate dL into one (C,h,w)
// block per image that every grid step revisits. Nothing persists between
// blocks on Hopper, so:
//
// Windowed (H-sharding): both kernels take four row arguments (hg, r0g,
// ohg, oy0): the labels, g and the maps are output rows [oy0, oy0 + oh) of
// an image of ohg rows, and the logits (and dL) rows [r0g, r0g + h) of its
// hg source rows, the shard's rows with their halo; every tap is the whole
// image's (bilinear.cuh's Rows). ce_bwd then writes the gradient that this
// window's pixels send to each local source row, the halo rows included;
// the caller returns the halo rows' part to their owners. (h, 0, oh, 0) is
// the whole image.
//
// ce_fwd: a column walk. A block owns a band of output rows [ya, yb) and a
//   tile of output columns [xa, xb) of one image, so each output pixel has
//   one owner and is written once. The plan (band, tile, lanes a pixel,
//   threads, the staged window's size, shared memory) is made in Python,
//   ops/ce_front.py::forward_plan, which the CPU tests walk.
//   1. The block stages the source pixels under its taps in shared memory:
//      rows y0(ya) .. y0(yb-1)+1, columns x0(xa) .. x0(xb-1)+1 (from its own
//      taps; the plan leaves room for two more of each), each pixel's
//      classes padded to whole lane slices, so that every tap load below is
//      an 8- or 16-byte vector with no class guard; and the class weights.
//      A lane's slice holds every lpp-th class (slot j of lane l holds class
//      l + lpp j), so that each lane has at least CB - 4 real classes and
//      only its last four slots need a guard on the exps. Eight loads a
//      thread are in flight before their stores.
//   2. One thread (or lpp lanes, each a slice of at most 32 classes, for
//      C > 32) per output column walks the band's rows in order. It keeps
//      in registers `top`, the W-lerp of source row y0 at its column, and
//      `dif`, row y0+1 minus it, reloaded only when y0 moves (once per
//      source row, not per pixel), and loads the next row's label ahead of
//      its use. A counted pixel takes z_c = top_c + h1 dif_c (one FMA), the
//      max over four partial maxima (and the lanes), one exp a class
//      (ex2.approx.ftz on one folded FMA: exactly C, no second exp when the
//      max moves, no branch on the data in the class loop; the walk is
//      bound by the rate at which the SM dispatches instructions, so every
//      instruction a class counts, and only a lane's last four slots take a
//      guard), the sum of four partial sums and one lg2; z[label] is lerped
//      from the staged taps by the same arithmetic.
//      nll = ln2 lg2(s) + m - z[label], w = cw[label].
//      An ignored or out-of-range pixel stores (0, 0) and takes no exp.
//      Neighbouring threads own neighbouring columns, so the label loads and
//      the two stores coalesce; with lpp > 1 one lane stores.
//   Invariants: no atomics and one fixed order of fp32 operations, so two
//   launches give bit-identical maps (chip_smoke.py checks it); at most 1024
//   classes (32 lanes of 32). In a build without -DNDEBUG device asserts
//   check that the window fits the plan and holds every tap.
//   Bound at the training main path, (6,128,128,19) bf16 -> (6,1024,1024):
//   bytes 3.74 MB of logits + 25.2 MB of labels read, 50.3 MB of maps
//   written (~24 us at 3.35 TB/s); ~113 M exps and logs on the
//   special-function units (16 per SM per clock: ~27 us) set the least
//   time, ahead of the ~0.85 GFLOP of fp32 lerps and sums (~13 us). The
//   walk runs ~5 instructions a class and pixel (FMA, max, FMA, ex2, add)
//   and ~60 more a pixel (its taps, label, z[label], sum, log, stores), so
//   the SM's dispatch rate (4 warp instructions a clock) is a closer limit
//   than the exps: more warps an SM at fewer registers (z
//   recomputed) ran slower. The 50 MB of map stores are not hidden behind
//   the walk (tools/ce_fwd_ablate.py).
//
// ce_bwd: the separable adjoint, with no atomics. A block owns a band of
//   BH source rows [i0, i0+BH) and a tile of BW source columns [j0, j0+BW)
//   of one image, and writes that part of dL once, in the logits' dtype
//   (the wrapper allocates dL with torch.empty; band pixels that no tap
//   reaches get zeros). The plan (BH, BW, lanes a pixel, threads, shared
//   memory) is made in Python, ops/ce_front.py::backward_plan, which the
//   CPU tests walk; the block finds its own output rows and columns from
//   the taps it then uses: every row y with a tap in the band (i0 <= y0, or
//   y0 == i0-1 with lambda1 > 0, and y0 < i0+BH), every column alike.
//   1. The block stages its (BH+2) x (BW+2) source pixels of logits in
//      shared memory, classes padded to whole lane slices.
//   2. One thread (or lpp lanes, each a slice of at most 32 classes, for
//      C > 32) per output column walks the band's output rows in order. It
//      keeps in registers the W-lerp of the two source rows under its
//      taps (reloaded only when y0 moves) and the H-adjoint sums of those
//      two rows. Per pixel: z = top + h1 (bot - top) (one FMA a class), the
//      max over C, one exp a
//      class (ex2 on an FMA), dz_c = g e_c / s - g [c == label], added with
//      each row's lambda to its sums. A pixel with g == 0 or an uncounted
//      label takes no exp. No barrier and no shared memory inside the walk;
//      a finished row's sums go to shared memory once.
//   3. One thread per (band row, source column, class) applies the
//      W-adjoint as a gather over the output columns whose taps hold the
//      column: lambda0 of those whose left tap is j, lambda1 of those whose
//      left tap is j-1 (where a step is 0, at the last row or column, both
//      lambdas land on the one source index).
//   Invariants: no atomics; each dL element written by one block, once;
//   each counted pixel's exps taken once, apart from the rows and columns
//   that two bands or tiles share (the rows with y0 == i0-1 are walked by
//   both bands); one fixed order of fp32 sums, so two launches give
//   bit-identical dL (chip_smoke.py checks it). In a build without
//   -DNDEBUG device asserts check that every row and column a block walks
//   has a tap in its band and tile.
//   Bound at the main path, (6,128,128,19) bf16 -> (6,1024,1024): bytes
//   3.74 MB of logits + 25.2 MB of labels + 25.2 MB of g read, 7.5 MB of
//   dL written (~18 us); operations: 120 M exps on the special-function
//   units (~27 us at 16 per SM per clock) and ~1.4 GFLOP of fp32 lerps,
//   softmax and adjoint lerps (~21 us). The exps set the least time. The
//   design takes each exp once, on the special-function unit's ex2, and
//   keeps every per-pixel step in registers; what is left between it and
//   the bound is the latency of each pixel's dependent steps (z, max, exps,
//   sum, dz) at 14 warps an SM (128 registers a thread), and the band rows
//   that two blocks walk (1 in 5 at BH = 4).

#include <assert.h>
#include <math.h>
#include <stdint.h>

#include "bilinear.cuh"
#include "walk.cuh"

namespace {

__device__ __forceinline__ bool counted(int label, int ignore, int c) {
  return label != ignore && label >= 0 && label < c;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Shared memory of one ce_bwd block, as byte offsets; the Python plan
// (ops/ce_front.py::backward_smem_bytes) mirrors it. A pixel's classes are
// cut into lpp slices of cb classes (cb a multiple of 4), one slice for
// each of the lpp lanes that share the pixel.
struct BwdLayout {
  int cs;  // class stride of the staged logits: lpp * cb
  int s;   // class stride of the accumulators: C|1
  size_t acc, xl1, colr, total;
  __host__ __device__ BwdLayout(int c, int band, int tile, int xw, int lpp, int cb,
                                int itemsize) {
    cs = lpp * cb;
    s = c | 1;
    acc = ((size_t)(band + 2) * (tile + 2) * cs * itemsize + 15) / 16 * 16;
    xl1 = acc + ((size_t)band * xw * s * 4 + 15) / 16 * 16;  // zeroed as float4
    colr = xl1 + (size_t)xw * 4;
    total = colr + (size_t)(tile + 2) * 4;
  }
};

// First output index in [0, out) whose taps reach source index `s` or
// beyond: i0 >= s, or i0 == s-1 with lambda1 > 0 (with reach == false,
// only i0 >= s). i0 does not decrease along the output, and lambda1 grows
// along a run of equal i0, so a binary search finds it.
__device__ int first_reaching(int s, bool reach, float scale, int in, int out, bool ac) {
  int lo = 0, hi = out;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    int i0, step;
    float l1;
    bilinear::source_taps(mid, scale, in, ac, &i0, &step, &l1);
    if (i0 >= s || (reach && i0 == s - 1 && l1 > 0.f)) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// Rows of the H-adjoint accumulators into shared memory, once each.
template <int CB>
__device__ __forceinline__ void flush(float* acc, int r, int i0, int i1, int xw, int s, int px,
                                      int kb, int c, const float (&u)[CB]) {
  if (r < i0 || r >= i1) return;
  float* dst = acc + ((size_t)(r - i0) * xw + px) * s + kb;
#pragma unroll
  for (int k = 0; k < CB; ++k) {
    if (kb + k < c) dst[k] = u[k];
  }
}

constexpr int kBwdThreads = 256;  // the most threads of a block
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit; results below 2^-126 flush to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int CB>
__global__ void __launch_bounds__(kBwdThreads, 2)
    ce_bwd_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
                  const float* __restrict__ g, T* __restrict__ dl, int h, int w, int c, int oh,
                  int ow, int hg, int r0g, int ohg, int oy0, int ignore, bool align_corners,
                  int band, int tile, int xw, int lpp, int bands, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout lay(c, band, tile, xw, lpp, CB, sizeof(T));
  T* stage = reinterpret_cast<T*>(smem);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  float* xl1 = reinterpret_cast<float*>(smem + lay.xl1);
  int* colr = reinterpret_cast<int*>(smem + lay.colr);

  const int img = blockIdx.x / (tiles * bands);
  const int i0 = (blockIdx.x / tiles) % bands * band, i1 = min(i0 + band, h);
  const int j0 = blockIdx.x % tiles * tile, j1 = min(j0 + tile, w);
  const int jlo = max(j0 - 1, 0);  // the halo column, whose lambda1 lands on j0
  const bilinear::Rows win(hg, r0g, ohg, oy0, align_corners);
  const float sw = bilinear::source_scale(w, ow, align_corners);

  // the output rows [ya, yb) and columns [xa, xa + nx) with a tap in the
  // band and the tile, one search a lane; rows are searched over the
  // whole image's and kept to the window's
  __shared__ int reach[4];
  if (threadIdx.x < 4) {
    const bool rows = threadIdx.x < 2, first = threadIdx.x % 2 == 0;
    if (rows) {
      const int y = first_reaching(win.in0 + (first ? i0 : i1), first, win.scale, hg, ohg,
                                   align_corners);
      reach[threadIdx.x] = min(max(y - oy0, 0), oh);
    } else {
      reach[threadIdx.x] = first_reaching(first ? j0 : j1, first, sw, w, ow, align_corners);
    }
  }
  __syncthreads();
  const int ya = reach[0], yb = reach[1], xa = reach[2], nx = reach[3] - reach[2];
  assert(nx <= xw && xw * lpp <= (int)blockDim.x);  // backward_plan's bound
  // the staged source pixels: rows [r0, r0 + nr), columns [jlo, jlo + nq)
  const int r0 = max(i0 - 1, 0), nr = min(i1, h - 1) - r0 + 1;
  const int nq = min(j1, w - 1) - jlo + 1;

  const T* src = logits + (((int64_t)img * h + r0) * w + jlo) * c;
#pragma unroll 4
  for (int e = threadIdx.x; e < nr * nq * lay.cs; e += blockDim.x) {
    const int k = e % lay.cs, px = e / lay.cs;
    const int rr = px / nq, qq = px - rr * nq;
    stage[e] = k < c ? src[((int64_t)rr * w + qq) * c + k] : T(0.f);
  }
  for (int e = threadIdx.x; e < ((i1 - i0) * xw * lay.s + 3) / 4; e += blockDim.x) {
    reinterpret_cast<float4*>(acc)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int xl = threadIdx.x; xl < nx; xl += blockDim.x) {
    int x0, step;
    bilinear::source_taps(xa + xl, sw, w, align_corners, &x0, &step, xl1 + xl);
  }
  // colr[jl]: the first of the tile's output columns whose left tap is at
  // or after source column jlo + jl
  for (int jl = threadIdx.x; jl <= j1 - jlo; jl += blockDim.x) {
    const int x = jl == 0 ? xa : jl == j1 - jlo ? xa + nx
                               : first_reaching(jlo + jl, false, sw, w, ow, align_corners);
    colr[jl] = x - xa;
  }
  __syncthreads();

  // Rows: each pixel's lpp lanes walk the tile's output column xa + px down
  // the band's output rows, with the W-lerped source rows (top, dif) and
  // the H-adjoint sums of two source rows (ua: row cur, ub: row cur + 1) in
  // registers. No barrier and no shared-memory traffic inside the walk.
  const int px = threadIdx.x / lpp, kb = threadIdx.x % lpp * CB;
  const bool live = px < nx;
  int x0 = jlo, xstep = 0;
  float wl1 = 0.f;
  if (live) {
    bilinear::source_taps(xa + px, sw, w, align_corners, &x0, &xstep, &wl1);
    assert(x0 >= jlo && x0 < j1 && (x0 >= j0 || (xstep == 1 && wl1 > 0.f)));  // in the tile
  }
  const float wl0 = 1.f - wl1;
  const T* col0 = stage + (x0 - jlo) * lay.cs + kb;
  const int dx = xstep * lay.cs;  // to the right tap
  const int64_t pix = (int64_t)img * oh * ow + xa + px;
  int label_next = 0;
  float g_next = 0.f;
  if (live && ya < yb) {
    label_next = labels[pix + (int64_t)ya * ow];
    g_next = g[pix + (int64_t)ya * ow];
  }

  // top: the W-lerp of row y0, dif: row y0 + ystep minus it; padded
  // classes sit at top = -inf, dif = 0, so that z is -inf there
  float top[CB], dif[CB], z[CB], ua[CB], ub[CB];
#pragma unroll
  for (int k = 0; k < CB; ++k) ua[k] = ub[k] = 0.f;
  int cur = -2;  // the source row of ua
  for (int y = ya; y < yb; ++y) {
    const int label = label_next;
    const float gv = g_next;
    if (live && y + 1 < yb) {  // the next row's, ahead of its use
      label_next = labels[pix + (int64_t)(y + 1) * ow];
      g_next = g[pix + (int64_t)(y + 1) * ow];
    }
    int y0, ystep;
    float hl1;
    win.taps(y, align_corners, &y0, &ystep, &hl1);
    const float hl0 = 1.f - hl1;
    assert(y0 < i1 && (y0 >= i0 || (y0 == i0 - 1 && ystep == 1 && hl1 > 0.f)));  // in the band
    if (y0 != cur) {  // a new source row: flush the finished sums, lerp the new rows
      if (live) flush(acc, cur, i0, i1, xw, lay.s, px, kb, c, ua);
      if (y0 == cur + 1) {
#pragma unroll
        for (int k = 0; k < CB; ++k) {
          ua[k] = ub[k];
          ub[k] = 0.f;
        }
      } else {
        if (live) flush(acc, cur + 1, i0, i1, xw, lay.s, px, kb, c, ub);
#pragma unroll
        for (int k = 0; k < CB; ++k) ua[k] = ub[k] = 0.f;
      }
      const T* row0 = col0 + (y0 - r0) * nq * lay.cs;
      const T* row1 = col0 + (y0 + ystep - r0) * nq * lay.cs;
      walk::w_lerp<T, CB>(row0, row0 + dx, wl0, wl1, top);
      walk::w_lerp<T, CB>(row1, row1 + dx, wl0, wl1, dif);
#pragma unroll
      for (int k = 0; k < CB; ++k) {
        const bool real = kb + k < c;
        dif[k] = real ? dif[k] - top[k] : 0.f;
        top[k] = real ? top[k] : -INFINITY;
      }
      cur = y0;
    }

    // the softmax of the pixel, its lpp lanes together
    const bool hit = live && counted(label, ignore, c) && gv != 0.f;
    const unsigned group = __ballot_sync(0xffffffffu, hit);
    if (!hit) continue;  // dz = 0: no exp
    // z = top + h1 (bot - top), one FMA, and its max as four partial
    // maxima; padded classes take no part (z = -inf, exp 0)
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      z[k] = fmaf(hl1, dif[k], top[k]);
      mx[k & 3] = fmaxf(mx[k & 3], z[k]);
    }
    float m = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    for (int lane = 1; lane < lpp; lane <<= 1) m = fmaxf(m, __shfl_xor_sync(group, m, lane));
    // one exp a class, 2^(z log2(e) - m log2(e)): one FMA and one ex2
    const float ml = m * kLog2e;
    float sp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      z[k] = exp2_approx(fmaf(z[k], kLog2e, -ml));
      sp[k & 3] += z[k];
    }
    float s = (sp[0] + sp[1]) + (sp[2] + sp[3]);
    for (int lane = 1; lane < lpp; lane <<= 1) s += __shfl_xor_sync(group, s, lane);
    const float gs = __fdividef(gv, s);
    // the H-adjoint: lambda0 to row y0, lambda1 to row y0 + ystep
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      const float d = z[k] * gs - (kb + k == label ? gv : 0.f);
      ua[k] += hl0 * d;
      if (ystep) {
        ub[k] += hl1 * d;
      } else {
        ua[k] += hl1 * d;
      }
    }
  }
  if (live) {
    flush(acc, cur, i0, i1, xw, lay.s, px, kb, c, ua);
    flush(acc, cur + 1, i0, i1, xw, lay.s, px, kb, c, ub);
  }
  __syncthreads();

  // The W-adjoint as a gather, one thread per (band row, source column,
  // class): lambda0 of the output columns whose left tap is j, lambda1 of
  // those whose left tap is j - 1 (and of its own, at the last column).
  const int owned = (j1 - j0) * c;
  T* out = dl + (((int64_t)img * h + i0) * w + j0) * c;
  for (int e = threadIdx.x; e < (i1 - i0) * owned; e += blockDim.x) {
    const int r = e / owned, jc = e - r * owned;
    const int jl = jc / c + (j0 - jlo), k = jc % c;
    const float* u = acc + (size_t)r * xw * lay.s + k;
    float sum = 0.f;
    if (jlo + jl == w - 1) {  // the last column keeps both lambdas
      for (int x = colr[jl]; x < colr[jl + 1]; ++x) sum += u[x * lay.s];
    } else {
      for (int x = colr[jl]; x < colr[jl + 1]; ++x) sum += (1.f - xl1[x]) * u[x * lay.s];
    }
    if (jl > 0) {
      for (int x = colr[jl - 1]; x < colr[jl]; ++x) sum += xl1[x] * u[x * lay.s];
    }
    store(out + (int64_t)r * w * c + jc, sum);
  }
}

constexpr int kFwdThreads = 256;  // the most threads of a forward block
constexpr float kLn2 = 0.6931471805599453f;

// log2(x) on the special-function unit (x >= 1 here).
__device__ __forceinline__ float log2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of one ce_fwd block, as byte offsets; the Python plan
// (ops/ce_front.py::forward_smem_bytes) mirrors it. `window` staged pixels,
// each of lpp slices of cb slots (slot j of slice l: class l + lpp j), then
// the C class weights.
struct FwdLayout {
  int cs;  // class stride of the staged logits: lpp * cb
  size_t cw, total;
  __host__ __device__ FwdLayout(int c, int window, int lpp, int cb, int itemsize) {
    cs = lpp * cb;
    cw = ((size_t)window * cs * itemsize + 15) / 16 * 16;
    total = cw + (size_t)c * 4;
  }
};

template <typename T, int CB>
__global__ void __launch_bounds__(kFwdThreads, CB <= 20 ? 3 : 2)
    ce_fwd_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
                  const float* __restrict__ cw, float* __restrict__ nll,
                  float* __restrict__ wmap, int h, int w, int c, int oh, int ow, int hg, int r0g,
                  int ohg, int oy0, int ignore, bool align_corners, int band, int tile, int lpp,
                  int window, int bands, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdLayout lay(c, window, lpp, CB, sizeof(T));
  const int cs = lay.cs;
  T* stage = reinterpret_cast<T*>(smem);
  float* wsh = reinterpret_cast<float*>(smem + lay.cw);

  const int img = blockIdx.x / (tiles * bands);
  const int ya = (blockIdx.x / tiles) % bands * band, yb = min(ya + band, oh);
  const int xa = blockIdx.x % tiles * tile, xb = min(xa + tile, ow);
  const bilinear::Rows win(hg, r0g, ohg, oy0, align_corners);
  const float sw = bilinear::source_scale(w, ow, align_corners);

  // the staged source pixels, local rows [r0, r0 + nr) and columns [q0, q0 +
  // nq): the taps of the band's first and last rows and of the tile's first
  // and last columns (the taps do not decrease along a row or a column)
  int r0, q0, last, st;
  float l1;
  win.taps(ya, align_corners, &r0, &st, &l1);
  win.taps(yb - 1, align_corners, &last, &st, &l1);
  const int nr = last + st - r0 + 1;
  bilinear::source_taps(xa, sw, w, align_corners, &q0, &st, &l1);
  bilinear::source_taps(xb - 1, sw, w, align_corners, &last, &st, &l1);
  const int nq = last + st - q0 + 1;
  assert(nr * nq <= window && r0 >= 0 && r0 + nr <= h);  // forward_plan's bound

  const int px = threadIdx.x / lpp, lane = threadIdx.x % lpp, kb = lane * CB;
  const bool live = xa + px < xb;
  const int64_t pix = ((int64_t)img * oh + ya) * ow + xa + px;  // the band's first row
  const int32_t* lab = labels + pix;
  int next_label = live ? lab[0] : 0;  // in flight during the staging

  // Thread t stages slots t, t + T, t + 2T, ... of the window, pixel by
  // pixel; its (pixel p, slot k) and the pixel's staged row rr advance by
  // addition, with no division a slot. Eight loads are in flight before
  // their stores.
  {
    const T* src = logits + (((int64_t)img * h + r0) * w + q0) * c;
    const int dp = blockDim.x / cs, dk = blockDim.x - dp * cs, total = nr * nq;
    int p = threadIdx.x / cs, k = threadIdx.x - p * cs, rr = 0;
    while (p < total) {
      T v[8];
      int dst[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dst[j] = -1;
        if (p < total) {
          while (p >= (rr + 1) * nq) ++rr;
          const int cls = k / CB + lpp * (k % CB);  // slot k's class
          dst[j] = p * cs + k;
          v[j] = cls < c ? src[((int64_t)rr * w + p - rr * nq) * c + cls] : T(0.f);
        }
        p += dp;
        k += dk;
        if (k >= cs) {
          k -= cs;
          ++p;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (dst[j] >= 0) stage[dst[j]] = v[j];
      }
    }
  }
  for (int k = threadIdx.x; k < c; k += blockDim.x) wsh[k] = cw[k];
  __syncthreads();

  // The walk: each pixel's lpp lanes go down output column xa + px over the
  // band's rows, with the W-lerped source rows in registers. No barrier and
  // no shared-memory store inside it.
  int x0 = q0, xstep = 0;
  float wl1 = 0.f;
  if (live) {
    bilinear::source_taps(xa + px, sw, w, align_corners, &x0, &xstep, &wl1);
    assert(x0 >= q0 && x0 + xstep < q0 + nq);  // in the window
  }
  const float wl0 = 1.f - wl1;
  const int dx = xstep * cs, rs = nq * cs;  // to the right tap, to the next staged row
  const T* col0 = stage + (x0 - q0) * cs;   // slot 0 of the left tap in staged row 0
  const int lsh = __ffs(lpp) - 1;           // lpp is a power of two

  // top: the W-lerp of row y0, dif: row y0 + ystep minus it; padded slots
  // sit at top = -inf, dif = 0, so that z is -inf there and drops out of the max
  float top[CB], dif[CB], z[CB];
  int cur = -1;  // the source row of top
  for (int y = ya; y < yb; ++y) {
    const int label = next_label;
    if (live && y + 1 < yb) next_label = lab[(int64_t)(y + 1 - ya) * ow];  // ahead of its use
    int y0, ystep;
    float hl1;
    win.taps(y, align_corners, &y0, &ystep, &hl1);
    assert(y0 >= r0 && y0 + ystep < r0 + nr);  // in the window
    const T* row0 = col0 + (y0 - r0) * rs;
    const int dy = ystep * rs;
    if (y0 != cur) {  // a new source row: W-lerp its two rows at this column
      walk::w_lerp<T, CB>(row0 + kb, row0 + kb + dx, wl0, wl1, top);
      walk::w_lerp<T, CB>(row0 + kb + dy, row0 + kb + dy + dx, wl0, wl1, dif);
#pragma unroll
      for (int k = 0; k < CB; ++k) {
        const bool real = lane + lpp * k < c;
        dif[k] = real ? dif[k] - top[k] : 0.f;
        top[k] = real ? top[k] : -INFINITY;
      }
      cur = y0;
    }

    const int64_t at = pix + (int64_t)(y - ya) * ow;
    const bool hit = live && counted(label, ignore, c);
    const unsigned lanes = lpp > 1 ? __ballot_sync(0xffffffffu, hit) : 0u;
    if (!hit) {  // ignored or outside [0, C): (0, 0), no exp
      if (live && kb == 0) {  // the (0, 0) of an uncounted pixel
        nll[at] = 0.f;
        wmap[at] = 0.f;
      }
      continue;
    }
    // z = top + h1 dif, one FMA a class, and its max as four partial maxima
    float pmax[4];
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      z[k] = fmaf(hl1, dif[k], top[k]);
      pmax[k & 3] = k < 4 ? z[k] : fmaxf(pmax[k & 3], z[k]);
    }
    float zmax = fmaxf(fmaxf(pmax[0], pmax[1]), fmaxf(pmax[2], pmax[3]));
    for (int bit = 1; bit < lpp; bit <<= 1) zmax = fmaxf(zmax, __shfl_xor_sync(lanes, zmax, bit));
    // exactly one exp a real class, 2^(z log2(e) - m log2(e)): one FMA and
    // one ex2; a lane's first CB - 4 slots are real, so only its last four
    // take a guard
    const float mlog2e = zmax * kLog2e;
    float psum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      if (k < CB - 4 || lane + lpp * k < c)
        psum[k & 3] += exp2_approx(fmaf(z[k], kLog2e, -mlog2e));
    }
    float sum = (psum[0] + psum[1]) + (psum[2] + psum[3]);
    for (int bit = 1; bit < lpp; bit <<= 1) sum += __shfl_xor_sync(lanes, sum, bit);
    // z[label], lerped from the staged taps by the registers' arithmetic
    const T* tl = row0 + (label & (lpp - 1)) * CB + (label >> lsh);
    const float tt = wl0 * bilinear::to_float(tl[0]) + wl1 * bilinear::to_float(tl[dx]);
    const float tb = wl0 * bilinear::to_float(tl[dy]) + wl1 * bilinear::to_float(tl[dy + dx]);
    const float zt = fmaf(hl1, tb - tt, tt);
    if (kb == 0) {  // one lane stores the counted pixel
      nll[at] = fmaf(log2_approx(sum), kLn2, zmax - zt);
      wmap[at] = wsh[label];
    }
  }
}

template <typename T, int CB>
int launch_fwd_cb(const void* logits, const void* labels, const void* cw, void* nll, void* wmap,
                  int n, int h, int w, int c, int oh, int ow, int hg, int r0g, int ohg, int oy0,
                  int ignore, int align_corners, int band, int tile, int lpp, int window,
                  int threads, void* stream) {
  const int bands = (oh + band - 1) / band, tiles = (ow + tile - 1) / tile;
  const int64_t blocks = (int64_t)n * bands * tiles;
  if (blocks > 2147483647LL || threads > kFwdThreads || threads % 32 != 0 || tile * lpp > threads)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = FwdLayout(c, window, lpp, CB, sizeof(T)).total;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ce_fwd_kernel<T, CB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ce_fwd_kernel<T, CB><<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)logits, (const int32_t*)labels, (const float*)cw, (float*)nll, (float*)wmap, h, w,
      c, oh, ow, hg, r0g, ohg, oy0, ignore, align_corners != 0, band, tile, lpp, window, bands,
      tiles);
  return (int)cudaGetLastError();
}

template <typename T, int CB>
int launch_bwd_cb(const void* logits, const void* labels, const void* g, void* dl, int n, int h,
                  int w, int c, int oh, int ow, int hg, int r0g, int ohg, int oy0, int ignore,
                  int align_corners, int band, int tile, int xw, int lpp, int threads,
                  void* stream) {
  const int bands = (h + band - 1) / band, tiles = (w + tile - 1) / tile;
  const int64_t blocks = (int64_t)n * bands * tiles;
  if (blocks > 2147483647LL || threads > kBwdThreads || threads % 32 != 0 || xw * lpp > threads)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = BwdLayout(c, band, tile, xw, lpp, CB, sizeof(T)).total;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ce_bwd_kernel<T, CB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ce_bwd_kernel<T, CB><<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)logits, (const int32_t*)labels, (const float*)g, (T*)dl, h, w, c, oh, ow, hg, r0g,
      ohg, oy0, ignore, align_corners != 0, band, tile, xw, lpp, bands, tiles);
  return (int)cudaGetLastError();
}

// One instantiation for each slice width.
template <typename T>
int launch_bwd(const void* logits, const void* labels, const void* g, void* dl, int n, int h,
               int w, int c, int oh, int ow, int hg, int r0g, int ohg, int oy0, int ignore,
               int align_corners, int band, int tile, int xw, int lpp, int threads, void* stream) {
  auto launch = &launch_bwd_cb<T, 32>;
  switch (walk::class_slice(c, lpp)) {
    case 4: launch = &launch_bwd_cb<T, 4>; break;
    case 8: launch = &launch_bwd_cb<T, 8>; break;
    case 12: launch = &launch_bwd_cb<T, 12>; break;
    case 16: launch = &launch_bwd_cb<T, 16>; break;
    case 20: launch = &launch_bwd_cb<T, 20>; break;
    case 24: launch = &launch_bwd_cb<T, 24>; break;
    case 28: launch = &launch_bwd_cb<T, 28>; break;
    case 32: break;
    default: return (int)cudaErrorInvalidValue;
  }
  return launch(logits, labels, g, dl, n, h, w, c, oh, ow, hg, r0g, ohg, oy0, ignore,
                align_corners, band, tile, xw, lpp, threads, stream);
}

template <typename T>
int launch_fwd(const void* logits, const void* labels, const void* cw, void* nll, void* wmap,
               int n, int h, int w, int c, int oh, int ow, int hg, int r0g, int ohg, int oy0,
               int ignore, int align_corners, int band, int tile, int lpp, int window,
               int threads, void* stream) {
  auto launch = &launch_fwd_cb<T, 32>;
  switch (walk::class_slice(c, lpp)) {
    case 4: launch = &launch_fwd_cb<T, 4>; break;
    case 8: launch = &launch_fwd_cb<T, 8>; break;
    case 12: launch = &launch_fwd_cb<T, 12>; break;
    case 16: launch = &launch_fwd_cb<T, 16>; break;
    case 20: launch = &launch_fwd_cb<T, 20>; break;
    case 24: launch = &launch_fwd_cb<T, 24>; break;
    case 28: launch = &launch_fwd_cb<T, 28>; break;
    case 32: break;
    default: return (int)cudaErrorInvalidValue;
  }
  return launch(logits, labels, cw, nll, wmap, n, h, w, c, oh, ow, hg, r0g, ohg, oy0, ignore,
                align_corners, band, tile, lpp, window, threads, stream);
}

}  // namespace

// (hg, r0g, ohg, oy0): the window of output rows (bilinear.cuh's Rows);
// (h, 0, oh, 0) for the whole image.
extern "C" int ce_fwd_bf16(const void* logits, const void* labels, const void* cw, void* nll,
                           void* wmap, int n, int h, int w, int c, int oh, int ow, int hg, int r0g,
                           int ohg, int oy0, int ignore, int align_corners, int band, int tile,
                           int lpp, int window, int threads, void* stream) {
  return launch_fwd<__nv_bfloat16>(logits, labels, cw, nll, wmap, n, h, w, c, oh, ow, hg, r0g,
                                   ohg, oy0, ignore, align_corners, band, tile, lpp, window,
                                   threads, stream);
}

extern "C" int ce_fwd_f32(const void* logits, const void* labels, const void* cw, void* nll,
                          void* wmap, int n, int h, int w, int c, int oh, int ow, int hg, int r0g,
                          int ohg, int oy0, int ignore, int align_corners, int band, int tile,
                          int lpp, int window, int threads, void* stream) {
  return launch_fwd<float>(logits, labels, cw, nll, wmap, n, h, w, c, oh, ow, hg, r0g, ohg, oy0,
                           ignore, align_corners, band, tile, lpp, window, threads, stream);
}

extern "C" int ce_bwd_bf16(const void* logits, const void* labels, const void* g, void* dl, int n,
                           int h, int w, int c, int oh, int ow, int hg, int r0g, int ohg, int oy0,
                           int ignore, int align_corners, int band, int tile, int xw, int lpp,
                           int threads, void* stream) {
  return launch_bwd<__nv_bfloat16>(logits, labels, g, dl, n, h, w, c, oh, ow, hg, r0g, ohg, oy0,
                                   ignore, align_corners, band, tile, xw, lpp, threads, stream);
}

extern "C" int ce_bwd_f32(const void* logits, const void* labels, const void* g, void* dl, int n,
                          int h, int w, int c, int oh, int ow, int hg, int r0g, int ohg, int oy0,
                          int ignore, int align_corners, int band, int tile, int xw, int lpp,
                          int threads, void* stream) {
  return launch_bwd<float>(logits, labels, g, dl, n, h, w, c, oh, ow, hg, r0g, ohg, oy0, ignore,
                           align_corners, band, tile, xw, lpp, threads, stream);
}

// The shared-memory bytes of one ce_bwd block, for the plan's cross-check.
extern "C" long long ce_bwd_smem_bytes(int c, int band, int tile, int xw, int lpp, int itemsize) {
  return (long long)BwdLayout(c, band, tile, xw, lpp, walk::class_slice(c, lpp), itemsize).total;
}

// The shared-memory bytes of one ce_fwd block, for the plan's cross-check.
extern "C" long long ce_fwd_smem_bytes(int c, int window, int lpp, int itemsize) {
  return (long long)FwdLayout(c, window, lpp, walk::class_slice(c, lpp), itemsize).total;
}
