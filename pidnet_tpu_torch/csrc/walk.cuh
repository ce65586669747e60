// The parts of a column walk that K1 (upsample_argmax.cu) and K2/K3
// (ce_front.cu) share: the layout of a block's staged window of source
// pixels in shared memory, and the W-lerp of one staged row at a column's
// taps.
//
// Layout of a staged pixel: lpp slices of cb slots (cb a multiple of 4,
// class_slice), one slice for each of the lpp lanes that share an output
// pixel. Slot j of slice l holds class l + lpp j, so that every lane has at
// least cb - 4 real classes; the other slots hold 0 and the walk sets them
// to -inf. No load of a staged pixel depends on C: ptxas (CUDA 12.8, -O3)
// miscompiled shared loads guarded class by class inside a fully unrolled
// loop into kernels that stopped with an illegal instruction.

#pragma once

#include <stdint.h>

#include "bilinear.cuh"

namespace walk {

// A lane's slice of classes: ceil(C / lpp) rounded up to 4, at most 32.
__host__ __device__ inline int class_slice(int c, int lpp) {
  return ((c + lpp - 1) / lpp + 3) / 4 * 4;
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

// The W-lerp of one staged source row at this lane's taps and classes:
// out[k] = w0 L[x0][k] + w1 L[x1][k].
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

}  // namespace walk
