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
//
// Under H-sharding a kernel computes a window of output rows of a taller
// image from a slice of its source rows (the shard's, with halo rows from
// its neighbours): `Rows` takes each row's taps from the global sizes and
// turns the source row into the slice's own. A window of the whole image
// (offsets 0, global sizes the local ones) is the same arithmetic, bit for
// bit.

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

// The H taps of a window of output rows: `in` global source rows, of which
// the local source's row 0 is global row `in0` (negative where zero rows
// stand above the image), and `out` global output rows, of which the
// window's row 0 is global row `out0`.
struct Rows {
  int in, in0, out, out0;
  float scale;

  __device__ __forceinline__ Rows(int in_, int in0_, int out_, int out0_, bool align_corners)
      : in(in_), in0(in0_), out(out_), out0(out0_),
        scale(source_scale(in_, out_, align_corners)) {}

  // The taps of the window's row `y`: i0 as a local source row, the step
  // to i1, lambda1.
  __device__ __forceinline__ void taps(int y, bool align_corners, int* i0, int* step,
                                       float* l1) const {
    source_taps(out0 + y, scale, in, align_corners, i0, step, l1);
    *i0 -= in0;
  }
};

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

  // `oy` is a row of the window `rows` of an image whose local source has
  // h rows.
  __device__ __forceinline__ Taps(const T* base, int b, int oy, int ox, const Rows& rows, int h,
                                  int w, int c, float sw, bool align_corners) {
    rows.taps(oy, align_corners, &y0, &ystep, &h1);
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
