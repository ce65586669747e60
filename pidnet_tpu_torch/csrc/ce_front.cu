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
// ce_bwd: a block owns a tile of output pixels, one thread per pixel at a
//   time. Each thread recomputes z with the same taps, takes the softmax in
//   two passes over C (max and sum, then p_c), forms dz_c = g (p_c - [c ==
//   label]) and scatters lambda * dz_c to its 2x2 taps in a shared-memory
//   window of the source pixels the tile touches (under an 8x upsample a
//   32x32 tile touches 7x7 pixels x C). The block then adds the window to
//   an fp32 (N,h,w,C) dL with atomicAdd; the wrapper zeroes dL first. The
//   wrapper (ops/ce_front.py::backward_tile) sizes the window to hold every
//   tap of the tile (tests/test_torch_ce_front.py checks the bound); in a
//   build without -DNDEBUG a device assert stops the kernel at a tap
//   outside it.
//   fp32 atomics make the summation order, and so the last bits of dL, vary
//   from run to run.
//   Bound at the main path: bytes 3.74 MB of logits + 25.2 MB of labels +
//   25.2 MB of g read, 7.5 MB of dL written (~18 us); operations: 120 M
//   exps (~29 us) and ~1.4 GFLOP of fp32 lerps, softmax and scatter
//   (~21 us). The exps set the least time.

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

template <typename T>
__global__ void ce_bwd_kernel(const T* __restrict__ logits, const int32_t* __restrict__ labels,
                              const float* __restrict__ g, float* __restrict__ dl, int n, int h,
                              int w, int c, int oh, int ow, int ignore, bool align_corners,
                              int tile_h, int tile_w, int win_h, int win_w) {
  extern __shared__ float win[];  // (win_h, win_w, c) fp32
  const int tiles_x = (ow + tile_w - 1) / tile_w;
  const int tiles_y = (oh + tile_h - 1) / tile_h;
  const int tx = blockIdx.x % tiles_x;
  const int ty = (blockIdx.x / tiles_x) % tiles_y;
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int oy0 = ty * tile_h, ox0 = tx * tile_w;
  const float sh = bilinear::source_scale(h, oh, align_corners);
  const float sw = bilinear::source_scale(w, ow, align_corners);

  // The window starts at the first tap of the tile's first row and column;
  // source indices do not decrease along a row or column.
  int base_y, base_x, unused_step;
  float unused_l;
  bilinear::source_taps(oy0, sh, h, align_corners, &base_y, &unused_step, &unused_l);
  bilinear::source_taps(ox0, sw, w, align_corners, &base_x, &unused_step, &unused_l);

  const int win_size = win_h * win_w * c;
  for (int i = threadIdx.x; i < win_size; i += blockDim.x) win[i] = 0.f;
  __syncthreads();

  for (int i = threadIdx.x; i < tile_h * tile_w; i += blockDim.x) {
    const int oy = oy0 + i / tile_w, ox = ox0 + i % tile_w;
    if (oy >= oh || ox >= ow) continue;
    const int64_t p = ((int64_t)b * oh + oy) * ow + ox;
    const int label = labels[p];
    const float gv = g[p];
    if (!counted(label, ignore, c) || gv == 0.f) continue;

    const bilinear::Taps<T> t(logits, b, oy, ox, h, w, c, sh, sw, align_corners);
    float m, s, zt;
    logsumexp(t, c, label, &m, &s, &zt);
    const float g_over_s = gv / s;

    const int ly0 = t.y0 - base_y, lx0 = t.x0 - base_x;
    assert(ly0 + t.ystep < win_h && lx0 + t.xstep < win_w);  // backward_tile's bound
    float* s00 = win + ((int64_t)ly0 * win_w + lx0) * c;
    float* s01 = s00 + t.xstep * c;
    float* s10 = s00 + (int64_t)t.ystep * win_w * c;
    float* s11 = s10 + t.xstep * c;
    const float l00 = t.h0 * t.w0, l01 = t.h0 * t.w1, l10 = t.h1 * t.w0, l11 = t.h1 * t.w1;
    for (int k = 0; k < c; ++k) {
      float dz = expf(t.value(k) - m) * g_over_s;
      if (k == label) dz -= gv;
      atomicAdd(s00 + k, l00 * dz);
      atomicAdd(s01 + k, l01 * dz);
      atomicAdd(s10 + k, l10 * dz);
      atomicAdd(s11 + k, l11 * dz);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < win_size; i += blockDim.x) {
    const float v = win[i];
    if (v == 0.f) continue;
    const int k = i % c;
    const int cell = i / c;
    const int y = base_y + cell / win_w, x = base_x + cell % win_w;
    if (y < h && x < w) atomicAdd(dl + (((int64_t)b * h + y) * w + x) * c + k, v);
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

template <typename T>
int launch_bwd(const void* logits, const void* labels, const void* g, void* dl, int n, int h,
               int w, int c, int oh, int ow, int ignore, int align_corners, int tile_h,
               int tile_w, int win_h, int win_w, void* stream) {
  const int threads = 256;
  const int64_t blocks =
      (int64_t)n * ((oh + tile_h - 1) / tile_h) * ((ow + tile_w - 1) / tile_w);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)win_h * win_w * c * sizeof(float);
  ce_bwd_kernel<T><<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)logits, (const int32_t*)labels, (const float*)g, (float*)dl, n, h, w, c, oh, ow,
      ignore, align_corners != 0, tile_h, tile_w, win_h, win_w);
  return (int)cudaGetLastError();
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
                           int tile_h, int tile_w, int win_h, int win_w, void* stream) {
  return launch_bwd<__nv_bfloat16>(logits, labels, g, dl, n, h, w, c, oh, ow, ignore,
                                   align_corners, tile_h, tile_w, win_h, win_w, stream);
}

extern "C" int ce_bwd_f32(const void* logits, const void* labels, const void* g, void* dl, int n,
                          int h, int w, int c, int oh, int ow, int ignore, int align_corners,
                          int tile_h, int tile_w, int win_h, int win_w, void* stream) {
  return launch_bwd<float>(logits, labels, g, dl, n, h, w, c, oh, ow, ignore, align_corners,
                           tile_h, tile_w, win_h, win_w, stream);
}
