// Fused bilinear upsample + argmax over classes: (N,h,w,C) NHWC logits ->
// (N,oh,ow) int32 class map, without ever writing the full-resolution
// logits to device memory.
//
// Replaces pidnet_tpu/ops/upsample_argmax.py::_kernel (the Pallas TPU
// kernel). That kernel W-interpolates every class plane into a VMEM
// scratch that persists across a sequential grid and then H-interpolates
// row tiles with MXU matmuls, folding each class into a running (max,
// argmax). Nothing persists between blocks on Hopper, so:
//
// upsample_argmax_kernel: a column walk, as ce_fwd_kernel (ce_front.cu).
//   A block owns a band of output rows [ya, yb) and a tile of output
//   columns [xa, xb) of one image, so each output pixel has one owner and
//   is written once. The plan (band, tile, lanes a pixel, threads, the
//   staged window's size, shared memory) is made in Python,
//   ops/upsample_argmax.py::plan (ops/_walk.py::walk_plan), which the CPU
//   tests walk.
//   1. The block stages the source pixels under its taps in shared memory
//      in fp32 (walk.cuh's layout): each pixel's classes padded to whole
//      lane slices, so that every tap load below is a 16-byte vector with
//      no class guard and no conversion. A thread stages four slots at a
//      time (one 16-byte store); the band rows' taps (y0, lambda1) are
//      taken once a block, into shared memory.
//   2. One thread (or lpp lanes, each a slice of at most 32 classes, for
//      C > 32) per output column walks the band's rows in order. It keeps
//      in registers `top`, the W-lerp of source row y0 at its column, and
//      `dif`, row y0+1 minus it, reloaded only when y0 moves (once per
//      source row, not per pixel). A pixel takes z_k = top_k + h1 dif_k
//      (one FMA a class) into a running (max, slot) kept with a strict >
//      (one compare and two selects a class), so the lowest slot wins a
//      tie; the lanes (__shfl_xor_sync) then merge so that the larger value
//      wins and, on equal values, the lower class: ties go to the lowest
//      class, as torch.argmax, the JAX XLA path and the TPU kernel. The
//      compares and selects run on the SM's ALU pipe, which takes a warp
//      instruction every other clock: they, not the FMAs, set the walk's
//      pace, so one running pair beats four partial pairs and their merge
//      (tools/ua_ablate.py; PERF.md). Padded slots sit at -inf and their
//      classes lie above every real one, so they never win (a lane's first
//      CB - 4 slots are real, so only its last four take that guard); no
//      branch depends on the data.
//   3. One int32 store a pixel; neighbouring threads own neighbouring
//      columns, so a warp's row store is one 128-byte line (with lpp > 1,
//      lane 0 of each pixel stores).
//   Windowed (H-sharding): the four row arguments (hg, r0g, ohg, oy0) make
//   the kernel compute output rows [oy0, oy0 + oh) of an image of ohg rows
//   from rows [r0g, r0g + h) of its hg source rows (bilinear.cuh's Rows),
//   the taps of the whole image's rows; (h, 0, oh, 0) is the whole image.
//   Invariants: one fixed order of fp32 operations, so two launches give
//   bit-identical maps (chip_smoke.py checks it); at most 1024 classes (32
//   lanes of 32). In a build without -DNDEBUG device asserts check that
//   the window fits the plan and holds every tap. A NaN logit does not
//   follow torch.argmax's rule (NaN wins there): here no compare takes it.
//
// upsample_argmax_direct_kernel: one thread per output pixel, each class
//   lerped from its 2x2 taps (bilinear.cuh::Taps) with a running max; for
//   what the walk does not take (more than 1024 classes, or a window that
//   does not fit a block's shared memory).
//
// Bound at the serving main path, (1,128,256,19) bf16 -> (1,1024,2048):
// bytes. It must read 1.25 MB of logits and write 8.39 MB of int32: about
// 2.9 us at 3.35 TB/s; the separable fp32 arithmetic (~0.18 GFLOP) takes
// ~2.7 us at 67 TFLOP/s. The walk issues per class one FMA and three ALU
// instructions (compare, two selects), and the ALU pipe's half rate sets
// its pace, well above either bound; the class-map stores hide behind it
// (tools/ua_ablate.py shows where the time goes).

#include <assert.h>
#include <math.h>
#include <stdint.h>

#include "bilinear.cuh"
#include "walk.cuh"

namespace {

constexpr int kThreads = 256;  // the most threads of a walk block
constexpr int kMaxBand = 64;   // the most output rows of a walk block

// Bytes of a walk block's dynamic shared memory: `window` staged pixels
// of lpp slices of `cb` fp32 slots, rounded up to 16 (ops/_walk.py::
// stage_bytes mirrors it).
__host__ __device__ inline size_t stage_bytes(int window, int lpp, int cb) {
  return ((size_t)window * lpp * cb * sizeof(float) + 15) / 16 * 16;
}

// The source pixels under the taps of output rows [ya, yb) and columns
// [xa, xb): local rows [r0, r0 + nr), columns [q0, q0 + nq), from the taps
// of the first and last row and column (the taps do not decrease along a
// row or a column).
struct Window {
  int r0, nr, q0, nq;
  __device__ __forceinline__ Window(int ya, int yb, int xa, int xb, const bilinear::Rows& rows,
                                    int w, float sw, bool align_corners) {
    int last, st;
    float l1;
    rows.taps(ya, align_corners, &r0, &st, &l1);
    rows.taps(yb - 1, align_corners, &last, &st, &l1);
    nr = last + st - r0 + 1;
    bilinear::source_taps(xa, sw, w, align_corners, &q0, &st, &l1);
    bilinear::source_taps(xb - 1, sw, w, align_corners, &last, &st, &l1);
    nq = last + st - q0 + 1;
  }
};

// Keep (v, k) or take (ov, ok): the larger value, the lower class on a tie.
__device__ __forceinline__ void take(float& v, int& k, float ov, int ok) {
  const bool t = (ov > v) | ((ov == v) & (ok < k));
  v = t ? ov : v;
  k = t ? ok : k;
}

// Stage the window's pixels in fp32, `src` pointing at its first (row r0,
// column q0 of an NHWC image w columns wide), pixel by pixel in lpp slices
// of CB slots (walk.cuh). A thread stages one quad (four slots of one lane)
// at a time: four loads of the source, converted once, and one 16-byte
// store.
template <typename T, int CB>
__device__ __forceinline__ void stage_quads(const T* __restrict__ src, float* stage,
                                            const Window& win, int w, int c, int lpp) {
  const int quads = lpp * (CB / 4);  // a pixel's quads
  for (int u = threadIdx.x; u < win.nr * win.nq * quads; u += blockDim.x) {
    const int px = lpp == 1 ? u / (CB / 4) : u / quads, qd = u - px * quads;
    const int rr = px / win.nq, qq = px - rr * win.nq;
    const int lane = 4 * qd / CB, j = 4 * qd - lane * CB;
    const T* sp = src + ((int64_t)rr * w + qq) * c + lane + lpp * j;  // slot j's class
    float4 v;
    v.x = lane + lpp * j < c ? bilinear::to_float(sp[0]) : 0.f;
    v.y = lane + lpp * (j + 1) < c ? bilinear::to_float(sp[lpp]) : 0.f;
    v.z = lane + lpp * (j + 2) < c ? bilinear::to_float(sp[2 * lpp]) : 0.f;
    v.w = lane + lpp * (j + 3) < c ? bilinear::to_float(sp[3 * lpp]) : 0.f;
    *reinterpret_cast<float4*>(stage + 4 * u) = v;
  }
}

template <typename T, int CB>
__global__ void __launch_bounds__(kThreads, CB <= 20 ? 4 : 2)
    upsample_argmax_kernel(const T* __restrict__ logits, int32_t* __restrict__ out, int h, int w,
                           int c, int oh, int ow, int hg, int r0g, int ohg, int oy0,
                           bool align_corners, int band, int tile, int lpp, int window, int bands,
                           int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  __shared__ int row_at[kMaxBand];    // a band row's staged row y0, as an offset into stage
  __shared__ int row_step[kMaxBand];  // to its row y0 + ystep
  __shared__ float row_l1[kMaxBand];  // its lambda1
  const int cs = lpp * CB;  // class stride of the staged logits

  const int img = blockIdx.x / (tiles * bands);
  const int ya = (blockIdx.x / tiles) % bands * band, yb = min(ya + band, oh);
  const int xa = blockIdx.x % tiles * tile, xb = min(xa + tile, ow);
  const bilinear::Rows rows(hg, r0g, ohg, oy0, align_corners);
  const float sw = bilinear::source_scale(w, ow, align_corners);

  const Window win(ya, yb, xa, xb, rows, w, sw, align_corners);
  assert(win.nr * win.nq <= window && win.r0 >= 0 && win.r0 + win.nr <= h);  // the plan's bound
  const int rs = win.nq * cs;         // to the next staged row
  stage_quads<T, CB>(logits + (((int64_t)img * h + win.r0) * w + win.q0) * c, stage, win, w, c,
                     lpp);
  for (int r = threadIdx.x; r < yb - ya; r += blockDim.x) {  // the band rows' taps, once
    int y0, ystep;
    float hl1;
    rows.taps(ya + r, align_corners, &y0, &ystep, &hl1);
    assert(y0 >= win.r0 && y0 + ystep < win.r0 + win.nr);  // in the window
    row_at[r] = (y0 - win.r0) * rs;
    row_step[r] = ystep * rs;
    row_l1[r] = hl1;
  }
  __syncthreads();

  // The walk: each pixel's lpp lanes go down output column xa + px over the
  // band's rows, with the W-lerped source rows in registers. No barrier and
  // no shared-memory store inside it.
  const int px = threadIdx.x / lpp, lane = threadIdx.x % lpp;
  const bool live = xa + px < xb;
  int x0 = win.q0, xstep = 0;
  float wl1 = 0.f;
  if (live) {
    bilinear::source_taps(xa + px, sw, w, align_corners, &x0, &xstep, &wl1);
    assert(x0 >= win.q0 && x0 + xstep < win.q0 + win.nq);  // in the window
  }
  const float wl0 = 1.f - wl1;
  const int dx = xstep * cs;  // to the right tap
  const float* col0 = stage + (x0 - win.q0) * cs + lane * CB;  // this lane's slice, staged row 0
  int32_t* dst = out + ((int64_t)img * oh + ya) * ow + xa + px;

  // top: the W-lerp of row y0, dif: row y0 + ystep minus it; padded slots
  // sit at top = -inf, dif = 0, so that z is -inf there. A lane's first
  // CB - 4 slots are real, so only its last four take the guard.
  float top[CB], dif[CB];
  int cur = -1;  // the staged row of top
  for (int r = 0; r < yb - ya; ++r, dst += ow) {
    const int at = row_at[r];
    const float hl1 = row_l1[r];
    if (at != cur) {  // a new source row: W-lerp its two rows at this column
      const float* row0 = col0 + at;
      const float* row1 = row0 + row_step[r];
      walk::w_lerp<float, CB>(row0, row0 + dx, wl0, wl1, top);
      walk::w_lerp<float, CB>(row1, row1 + dx, wl0, wl1, dif);
#pragma unroll
      for (int k = 0; k < CB; ++k) {
        const bool real = k < CB - 4 || lane + lpp * k < c;
        dif[k] = real ? dif[k] - top[k] : 0.f;
        top[k] = real ? top[k] : -INFINITY;
      }
      cur = at;
    }

    // z = top + h1 dif, one FMA a class, into a running (max, slot); the
    // strict > keeps the lowest slot on a tie
    float best = fmaf(hl1, dif[0], top[0]);
    int slot = 0;
#pragma unroll
    for (int k = 1; k < CB; ++k) {
      const float z = fmaf(hl1, dif[k], top[k]);
      const bool gt = z > best;
      best = gt ? z : best;
      slot = gt ? k : slot;
    }
    // then the lanes (slot j of this lane is class lane + lpp j)
    int cls = lane + lpp * slot;
    for (int bit = 1; bit < lpp; bit <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, bit);
      const int oc = __shfl_xor_sync(0xffffffffu, cls, bit);
      take(best, cls, ov, oc);
    }
    if (live && lane == 0) *dst = cls;
  }
}

template <typename T>
__global__ void upsample_argmax_direct_kernel(const T* __restrict__ logits,
                                              int32_t* __restrict__ out, int n, int h, int w,
                                              int c, int oh, int ow, int hg, int r0g, int ohg,
                                              int oy0, bool align_corners) {
  const int64_t total = (int64_t)n * oh * ow;
  const bilinear::Rows rows(hg, r0g, ohg, oy0, align_corners);
  const float sw = bilinear::source_scale(w, ow, align_corners);
  for (int64_t p = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; p < total;
       p += (int64_t)gridDim.x * blockDim.x) {
    const int ox = (int)(p % ow);
    const int64_t rest = p / ow;
    const int oy = (int)(rest % oh);
    const int b = (int)(rest / oh);

    const bilinear::Taps<T> t(logits, b, oy, ox, rows, h, w, c, sw, align_corners);

    float best = 0.f;
    int best_c = 0;
    for (int k = 0; k < c; ++k) {
      const float v = t.value(k);
      if (k == 0 || v > best) {
        best = v;
        best_c = k;
      }
    }
    out[p] = best_c;
  }
}

template <typename T, int CB>
int launch_walk_cb(const void* logits, void* out, int n, int h, int w, int c, int oh, int ow,
                   int hg, int r0g, int ohg, int oy0, int align_corners, int band, int tile,
                   int lpp, int window, int threads, void* stream) {
  const int bands = (oh + band - 1) / band, tiles = (ow + tile - 1) / tile;
  const int64_t blocks = (int64_t)n * bands * tiles;
  if (blocks > 2147483647LL || threads > kThreads || threads % 32 != 0 || tile * lpp > threads ||
      band > kMaxBand)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = stage_bytes(window, lpp, CB);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        upsample_argmax_kernel<T, CB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  upsample_argmax_kernel<T, CB><<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)logits, (int32_t*)out, h, w, c, oh, ow, hg, r0g, ohg, oy0, align_corners != 0,
      band, tile, lpp, window, bands, tiles);
  return (int)cudaGetLastError();
}

// One instantiation for each slice width.
template <typename T>
int launch_walk(const void* logits, void* out, int n, int h, int w, int c, int oh, int ow, int hg,
                int r0g, int ohg, int oy0, int align_corners, int band, int tile, int lpp,
                int window, int threads, void* stream) {
  auto launch = &launch_walk_cb<T, 32>;
  switch (walk::class_slice(c, lpp)) {
    case 4: launch = &launch_walk_cb<T, 4>; break;
    case 8: launch = &launch_walk_cb<T, 8>; break;
    case 12: launch = &launch_walk_cb<T, 12>; break;
    case 16: launch = &launch_walk_cb<T, 16>; break;
    case 20: launch = &launch_walk_cb<T, 20>; break;
    case 24: launch = &launch_walk_cb<T, 24>; break;
    case 28: launch = &launch_walk_cb<T, 28>; break;
    case 32: break;
    default: return (int)cudaErrorInvalidValue;
  }
  return launch(logits, out, n, h, w, c, oh, ow, hg, r0g, ohg, oy0, align_corners, band, tile, lpp,
                window, threads, stream);
}

template <typename T>
int launch_direct(const void* logits, void* out, int n, int h, int w, int c, int oh, int ow,
                  int hg, int r0g, int ohg, int oy0, int align_corners, void* stream) {
  const int threads = 256;
  const int64_t total = (int64_t)n * oh * ow;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride loop covers the rest
  if (blocks < 1) blocks = 1;
  upsample_argmax_direct_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)logits, (int32_t*)out, n, h, w, c, oh, ow, hg, r0g, ohg, oy0, align_corners != 0);
  return (int)cudaGetLastError();
}

}  // namespace

// (hg, r0g, ohg, oy0): the window of output rows (bilinear.cuh's Rows);
// (h, 0, oh, 0) for the whole image.
extern "C" int upsample_argmax_bf16(const void* logits, void* out, int n, int h, int w, int c,
                                    int oh, int ow, int hg, int r0g, int ohg, int oy0,
                                    int align_corners, int band, int tile, int lpp, int window,
                                    int threads, void* stream) {
  return launch_walk<__nv_bfloat16>(logits, out, n, h, w, c, oh, ow, hg, r0g, ohg, oy0,
                                    align_corners, band, tile, lpp, window, threads, stream);
}

extern "C" int upsample_argmax_f32(const void* logits, void* out, int n, int h, int w, int c,
                                   int oh, int ow, int hg, int r0g, int ohg, int oy0,
                                   int align_corners, int band, int tile, int lpp, int window,
                                   int threads, void* stream) {
  return launch_walk<float>(logits, out, n, h, w, c, oh, ow, hg, r0g, ohg, oy0, align_corners,
                            band, tile, lpp, window, threads, stream);
}

extern "C" int upsample_argmax_direct_bf16(const void* logits, void* out, int n, int h, int w,
                                           int c, int oh, int ow, int hg, int r0g, int ohg,
                                           int oy0, int align_corners, void* stream) {
  return launch_direct<__nv_bfloat16>(logits, out, n, h, w, c, oh, ow, hg, r0g, ohg, oy0,
                                      align_corners, stream);
}

extern "C" int upsample_argmax_direct_f32(const void* logits, void* out, int n, int h, int w,
                                          int c, int oh, int ow, int hg, int r0g, int ohg,
                                          int oy0, int align_corners, void* stream) {
  return launch_direct<float>(logits, out, n, h, w, c, oh, ow, hg, r0g, ohg, oy0, align_corners,
                              stream);
}

// The dynamic shared-memory bytes of one walk block (the staged window in
// fp32), for the plan's cross-check.
extern "C" long long upsample_argmax_smem_bytes(int c, int window, int lpp) {
  return (long long)stage_bytes(window, lpp, walk::class_slice(c, lpp));
}
