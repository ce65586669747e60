// Bilinear source taps shared by every kernel that reads upsampled logits
// (upsample_argmax.cu, ce_front.cu), so that the forward, the argmax and
// the backward all see the same z.
//
// Arithmetic of torch's upsample_bilinear2d (and of the JAX package's
// ops/resize.py::_interp_matrix), source index in float32:
//   align_corners:  src = dst * (in-1)/(out-1)   (0 when out == 1)
//   otherwise:      src = max(0, (dst+0.5) * in/out - 0.5)
// i0 = (int)src, i1 = i0 + (i0 < in-1), l1 = src - i0, l0 = 1 - l1. At the
// last row or column i1 == i0, so both lambdas land on one source pixel.
// The value is h0*(w0*v00 + w1*v01) + h1*(w0*v10 + w1*v11), in fp32 for
// bf16 and fp32 inputs alike.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bilinear {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float source_scale(int in, int out, bool align_corners) {
  if (align_corners) return out > 1 ? (float)(in - 1) / (float)(out - 1) : 0.f;
  return (float)in / (float)out;
}

// Source taps of output index `dst`: i0, the step to i1 (0 or 1), lambda1.
__device__ __forceinline__ void source_taps(int dst, float scale, int in, bool align_corners,
                                            int* i0, int* step, float* l1) {
  float src = align_corners ? scale * (float)dst
                            : fmaxf(scale * ((float)dst + 0.5f) - 0.5f, 0.f);
  int i = min((int)src, in - 1);
  *i0 = i;
  *step = i < in - 1 ? 1 : 0;
  *l1 = src - (float)i;
}

// The 2x2 taps of one output pixel of an NHWC (n,h,w,c) tensor: pointers to
// the class vectors of its top-left and bottom-left source pixels, the
// offset (0 or c) to their right neighbours, and the four lambdas.
template <typename T>
struct Taps {
  const T* r0;
  const T* r1;
  int dx;
  float h0, h1, w0, w1;
  int y0, ystep, x0, xstep;

  __device__ __forceinline__ Taps(const T* base, int b, int oy, int ox, int h, int w, int c,
                                  float sh, float sw, bool align_corners) {
    source_taps(oy, sh, h, align_corners, &y0, &ystep, &h1);
    source_taps(ox, sw, w, align_corners, &x0, &xstep, &w1);
    h0 = 1.f - h1;
    w0 = 1.f - w1;
    r0 = base + (((long long)b * h + y0) * w + x0) * c;
    r1 = r0 + (long long)ystep * w * c;
    dx = xstep * c;
  }

  // The upsampled value of class k.
  __device__ __forceinline__ float value(int k) const {
    const float top = w0 * to_float(r0[k]) + w1 * to_float(r0[k + dx]);
    const float bot = w0 * to_float(r1[k]) + w1 * to_float(r1[k + dx]);
    return h0 * top + h1 * bot;
  }
};

}  // namespace bilinear
