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
// ce_fwd: one thread per output pixel, neighbouring threads on neighbouring
//   pixels of a row (the label loads and the two fp32 stores coalesce; the
//   8 pixels of an 8x upsample share their taps in L1). One pass over C
//   keeps an online logsumexp (running max m, running sum s, one exp per
//   class) and picks z[label] and cw[label] on the way.
//   Bound at the training main path, (6,128,128,19) bf16 -> (6,1024,1024):
//   bytes 3.74 MB of logits + 25.2 MB of labels read, 50.3 MB of maps
//   written (~24 us at 3.35 TB/s); 120 M exps on the special-function
//   units (16 per SM per clock: ~29 us) set the least time, ahead of the
//   ~0.85 GFLOP of fp32 lerps and sums (~13 us).
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

namespace {

__device__ __forceinline__ bool counted(int label, int ignore, int c) {
  return label != ignore && label >= 0 && label < c;
}

// Online logsumexp over the C upsampled values of one pixel: (m, s) with
// sum_c exp(z_c - m) == s, m = max_c z_c; z[label] on the way.
template <typename T>
__device__ __forceinline__ void logsumexp(const bilinear::Taps<T>& t, int c, int label,
                                          float* m_out, float* s_out, float* zt_out) {
  float m = -INFINITY, s = 0.f, zt = 0.f;
  for (int k = 0; k < c; ++k) {
    const float z = t.value(k);
    if (k == label) zt = z;
    if (z > m) {
      s = s * expf(m - z) + 1.f;
      m = z;
    } else {
      s += expf(z - m);
    }
  }
  *m_out = m;
  *s_out = s;
  *zt_out = zt;
}

template <typename T>
__global__ void ce_fwd_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
                              const float* __restrict__ cw, float* __restrict__ nll,
                              float* __restrict__ wmap, int n, int h, int w, int c, int oh,
                              int ow, int ignore, bool align_corners) {
  const int64_t total = (int64_t)n * oh * ow;
  const float sh = bilinear::source_scale(h, oh, align_corners);
  const float sw = bilinear::source_scale(w, ow, align_corners);
  for (int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; p < total;
       p += (int64_t)gridDim.x * blockDim.x) {
    const int label = labels[p];
    if (!counted(label, ignore, c)) {
      nll[p] = 0.f;
      wmap[p] = 0.f;
      continue;
    }
    const int ox = (int)(p % ow);
    const int64_t rest = p / ow;
    const int oy = (int)(rest % oh);
    const int b = (int)(rest / oh);
    const bilinear::Taps<T> t(logits, b, oy, ox, h, w, c, sh, sw, align_corners);
    float m, s, zt;
    logsumexp(t, c, label, &m, &s, &zt);
    nll[p] = logf(s) + m - zt;
    wmap[p] = cw[label];
  }
}

// Four staged logits, as floats: an 8-byte load of bf16, a 16-byte load
// of fp32.
template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Vec4<__nv_bfloat16> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    out[0] = lo.x;
    out[1] = lo.y;
    out[2] = hi.x;
    out[3] = hi.y;
  }
};

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

// The W-lerp of one staged source row at this lane's taps and classes:
// out[k] = w0 L[x0][k] + w1 L[x1][k]. No load depends on C: the staged
// pixel is padded to whole slices (ptxas miscompiled shared loads guarded
// class by class into kernels that stopped with an illegal instruction).
template <typename T, int CB>
__device__ __forceinline__ void w_lerp(const T* p0, const T* p1, float w0, float w1,
                                       float (&out)[CB]) {
#pragma unroll
  for (int v = 0; v < CB / 4; ++v) {
    float a[4], b[4];
    Vec4<T>::load(p0 + 4 * v, a);
    Vec4<T>::load(p1 + 4 * v, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[4 * v + i] = w0 * a[i] + w1 * b[i];
  }
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
                  int ow, int ignore, bool align_corners, int band, int tile, int xw, int lpp,
                  int bands, int tiles) {
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
  const float sh = bilinear::source_scale(h, oh, align_corners);
  const float sw = bilinear::source_scale(w, ow, align_corners);

  // the output rows [ya, yb) and columns [xa, xa + nx) with a tap in the
  // band and the tile, one search a lane
  __shared__ int reach[4];
  if (threadIdx.x < 4) {
    const bool rows = threadIdx.x < 2, first = threadIdx.x % 2 == 0;
    reach[threadIdx.x] = first_reaching(rows ? (first ? i0 : i1) : (first ? j0 : j1), first,
                                        rows ? sh : sw, rows ? h : w, rows ? oh : ow,
                                        align_corners);
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
    bilinear::source_taps(y, sh, h, align_corners, &y0, &ystep, &hl1);
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
      w_lerp<T, CB>(row0, row0 + dx, wl0, wl1, top);
      w_lerp<T, CB>(row1, row1 + dx, wl0, wl1, dif);
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

int blocks_for(int64_t total, int threads) {
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride loop covers the rest
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename T>
int launch_fwd(const void* logits, const void* labels, const void* cw, void* nll, void* wmap,
               int n, int h, int w, int c, int oh, int ow, int ignore, int align_corners,
               void* stream) {
  const int threads = 256;
  ce_fwd_kernel<T><<<blocks_for((int64_t)n * oh * ow, threads), threads, 0,
                     (cudaStream_t)stream>>>(
      (const T*)logits, (const int32_t*)labels, (const float*)cw, (float*)nll, (float*)wmap, n,
      h, w, c, oh, ow, ignore, align_corners != 0);
  return (int)cudaGetLastError();
}

template <typename T, int CB>
int launch_bwd_cb(const void* logits, const void* labels, const void* g, void* dl, int n, int h,
                  int w, int c, int oh, int ow, int ignore, int align_corners, int band, int tile,
                  int xw, int lpp, int threads, void* stream) {
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
      (const T*)logits, (const int32_t*)labels, (const float*)g, (T*)dl, h, w, c, oh, ow, ignore,
      align_corners != 0, band, tile, xw, lpp, bands, tiles);
  return (int)cudaGetLastError();
}

// A lane's slice of classes: ceil(C / lpp) rounded up to 4, at most 32.
__host__ __device__ inline int class_slice(int c, int lpp) { return ((c + lpp - 1) / lpp + 3) / 4 * 4; }

// One instantiation for each slice width.
template <typename T>
int launch_bwd(const void* logits, const void* labels, const void* g, void* dl, int n, int h,
               int w, int c, int oh, int ow, int ignore, int align_corners, int band, int tile,
               int xw, int lpp, int threads, void* stream) {
  auto launch = &launch_bwd_cb<T, 32>;
  switch (class_slice(c, lpp)) {
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
  return launch(logits, labels, g, dl, n, h, w, c, oh, ow, ignore, align_corners, band, tile, xw,
                lpp, threads, stream);
}

}  // namespace

extern "C" int ce_fwd_bf16(const void* logits, const void* labels, const void* cw, void* nll,
                           void* wmap, int n, int h, int w, int c, int oh, int ow, int ignore,
                           int align_corners, void* stream) {
  return launch_fwd<__nv_bfloat16>(logits, labels, cw, nll, wmap, n, h, w, c, oh, ow, ignore,
                                   align_corners, stream);
}

extern "C" int ce_fwd_f32(const void* logits, const void* labels, const void* cw, void* nll,
                          void* wmap, int n, int h, int w, int c, int oh, int ow, int ignore,
                          int align_corners, void* stream) {
  return launch_fwd<float>(logits, labels, cw, nll, wmap, n, h, w, c, oh, ow, ignore,
                           align_corners, stream);
}

extern "C" int ce_bwd_bf16(const void* logits, const void* labels, const void* g, void* dl, int n,
                           int h, int w, int c, int oh, int ow, int ignore, int align_corners,
                           int band, int tile, int xw, int lpp, int threads, void* stream) {
  return launch_bwd<__nv_bfloat16>(logits, labels, g, dl, n, h, w, c, oh, ow, ignore,
                                   align_corners, band, tile, xw, lpp, threads, stream);
}

extern "C" int ce_bwd_f32(const void* logits, const void* labels, const void* g, void* dl, int n,
                          int h, int w, int c, int oh, int ow, int ignore, int align_corners,
                          int band, int tile, int xw, int lpp, int threads, void* stream) {
  return launch_bwd<float>(logits, labels, g, dl, n, h, w, c, oh, ow, ignore, align_corners,
                           band, tile, xw, lpp, threads, stream);
}

// The shared-memory bytes of one ce_bwd block, for the plan's cross-check.
extern "C" long long ce_bwd_smem_bytes(int c, int band, int tile, int xw, int lpp, int itemsize) {
  return (long long)BwdLayout(c, band, tile, xw, lpp, class_slice(c, lpp), itemsize).total;
}
