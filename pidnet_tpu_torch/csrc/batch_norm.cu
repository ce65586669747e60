// Train-mode BatchNorm over the NHWC view [M = N*H*W, C] of a channels_last
// activation (an N x C x 1 x 1 map qualifies): the batch statistics, the
// normalisation and the backward, each as two passes over device memory.
//
// Replaces no Pallas kernel: the JAX package's train-mode BN
// (pidnet_tpu/nn/functional.py::batch_norm_train) is XLA ops, which XLA
// fuses on the TPU. The port ran it as ~two dozen eager ops a BN and as
// many autograd ops backward, with an fp32 copy of every activation saved
// for the backward; on the H100 that was 125.5 ms of a 185.6 ms PIDNet-L
// step at 12 x 1024^2 (PERF.md, the span readings of the training step).
//
// Semantics (ops/batch_norm.py has the plain version of each kernel):
//   mean = E[x], mean_sq = E[x^2], var = max(mean_sq - mean^2, 0) (the JAX
//   package's formula), rstd = 1/sqrt(var + eps), scale = rstd*gamma,
//   shift = beta - mean*scale, y = x*scale + shift formed in fp32 and
//   rounded once to x's dtype; the running statistics blend with the
//   momentum, the variance unbiased by n/(n-1).
//   Backward, with xh = (x - mean)*rstd recomputed from x:
//   dgamma = sum(dy*xh), dbeta = sum(dy),
//   dx = scale*(dy - sum(dy)/M - xh*sum(dy*xh)/M), where the last term is
//   0 in a channel whose mean_sq - mean^2 < 0 (the clamp is active, and
//   the eager graph passes no gradient through the variance there).
//
// Bound: PIDNet-L's 90 train-mode BNs hold 1.946 G elements a step at 12 x
// 1024^2, 3.89 GB a bf16 pass. The forward reads x for the sums, then reads
// x and writes y (3 passes); the backward reads x and dy for the sums, then
// reads them again and writes dx (5 passes): 31.1 GB, 9.3 ms a step at
// 3.35 TB/s. The design holds each kernel to those bytes:
//   bn_reduce  one pass over x (and dy): a grid of row chunks x channel
//              tiles, one wave of 4 blocks an SM; a thread owns V channels
//              (a 16-byte load where C and the pointers allow) and walks
//              every rows-th row of its chunk, four loads in flight,
//              summing in fp32 registers; the block
//              reduces its rows in shared memory in a fixed order and
//              writes one partial row per chunk, [chunk][2][C]. No atomics,
//              so two launches give the same bits.
//   finalize   one small launch over the channels: sums the partials in a
//              fixed order (in double) and forms the per-channel numbers
//              (forward: mean, rstd, scale, shift, the new running
//              statistics and the clamp mask; backward: dgamma, dbeta and
//              the two coefficients of dx), in place of a dozen tiny
//              launches.
//   bn_apply   one pass reading x (and dy) and writing y (dx) with the
//              same blocks, the channel's numbers held in registers.
// The backward saves only x in its own dtype and the per-channel numbers.
// Each kernel's second read of a map finds it in the 50 MB L2 where the
// map is small (the late stages). Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;    // the most threads of a reduce/apply block
constexpr int kBlocksPerSM = 4;  // resident blocks an SM: at most 64 registers a thread
constexpr int kMaxVec = 8;       // 16 bytes of bf16
constexpr int kFinLanes = 32;    // channels of a finalize block
constexpr int kFinRows = 8;      // threads that split a finalize block's chunks

// the forward's per-channel rows of `ws` ([7][C] fp32)
enum { kMean, kRstd, kScale, kShift, kNewMean, kNewVar, kVarMask };
// the backward's per-channel rows of `g` ([4][C] fp32)
enum { kDgamma, kDbeta, kOffset, kCoef };

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

// Block (tile, chunk) of a grid (ctiles, chunks) with threads (lanes, rows):
// rows [chunk*rpc, min(M, (chunk+1)*rpc)) and channels [tile*lanes*V, ...),
// thread (tx, ty) channels tile*lanes*V + tx*V + [0, V) of rows ty, ty +
// rows, ... (ops/batch_norm.py::plan, which the CPU tests walk).
//
// bn_reduce: per channel of the block, (sum x, sum x^2) or, with GRAD,
// (sum dy, sum dy*(x - mean)), into part[chunk][2][C].
template <typename T, int V, bool GRAD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
bn_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ mean, float* __restrict__ part, long long m, int c,
                 long long rpc) {
  __shared__ float red[2 * kThreads * kMaxVec];
  const int lanes = blockDim.x, rows = blockDim.y, tw = lanes * V;
  const int c0 = blockIdx.x * tw;
  const int ch = c0 + threadIdx.x * V;
  const long long r0 = (long long)blockIdx.y * rpc;
  const long long r1 = min(m, r0 + rpc);
  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
  if (ch < c) {
    float mu[V];
#pragma unroll
    for (int k = 0; k < V; ++k) mu[k] = GRAD ? mean[ch + k] : 0.f;
    const long long step = (long long)rows * c;
    long long r = r0 + threadIdx.y;
    const long long off = r * c + ch;
    const T* px = x + off;
    const T* pg = GRAD ? dy + off : nullptr;
    for (; r + 3 * rows < r1; r += 4 * rows) {
      Pack<T, V> a[4], g[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = load<T, V>(px + u * step);
        if (GRAD) g[u] = load<T, V>(pg + u * step);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xv = to_f(a[u].v[k]);
          if (GRAD) {
            const float gv = to_f(g[u].v[k]);
            s[k] += gv;
            q[k] = fmaf(gv, xv - mu[k], q[k]);
          } else {
            s[k] += xv;
            q[k] = fmaf(xv, xv, q[k]);
          }
        }
      }
      px += 4 * step;
      if (GRAD) pg += 4 * step;
    }
    for (; r < r1; r += rows) {
      const Pack<T, V> a = load<T, V>(px);
      Pack<T, V> g;
      if (GRAD) g = load<T, V>(pg);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xv = to_f(a.v[k]);
        if (GRAD) {
          const float gv = to_f(g.v[k]);
          s[k] += gv;
          q[k] = fmaf(gv, xv - mu[k], q[k]);
        } else {
          s[k] += xv;
          q[k] = fmaf(xv, xv, q[k]);
        }
      }
      px += step;
      if (GRAD) pg += step;
    }
  }
  // the block's rows, summed in the order of threadIdx.y
  float* rs = red;              // [rows][tw]
  float* rq = red + rows * tw;  // [rows][tw]
#pragma unroll
  for (int k = 0; k < V; ++k) {
    rs[threadIdx.y * tw + threadIdx.x * V + k] = s[k];
    rq[threadIdx.y * tw + threadIdx.x * V + k] = q[k];
  }
  __syncthreads();
  const int tid = threadIdx.y * lanes + threadIdx.x;
  for (int j = tid; j < 2 * tw; j += lanes * rows) {
    const int which = j >= tw;
    const int cj = j - which * tw;
    if (c0 + cj >= c) continue;
    const float* src = which ? rq : rs;
    float acc = 0.f;
    for (int t = 0; t < rows; ++t) acc += src[t * tw + cj];
    part[((long long)blockIdx.y * 2 + which) * c + c0 + cj] = acc;
  }
}

// The partials' two sums of channel blockIdx.x*32 + threadIdx.x over every
// chunk, in a fixed order: each threadIdx.y every kFinRows-th chunk, then
// the kFinRows sums in order. Valid in threadIdx.y == 0.
__device__ __forceinline__ void sum_partials(const float* __restrict__ part, int chunks, int c,
                                             int ch, double* s_out, double* q_out) {
  __shared__ double red[2][kFinRows][kFinLanes];
  double s = 0.0, q = 0.0;
  if (ch < c) {
    for (int k = threadIdx.y; k < chunks; k += kFinRows) {
      s += part[(2LL * k) * c + ch];
      q += part[(2LL * k + 1) * c + ch];
    }
  }
  red[0][threadIdx.y][threadIdx.x] = s;
  red[1][threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  s = q = 0.0;
  for (int t = 0; t < kFinRows; ++t) {
    s += red[0][t][threadIdx.x];
    q += red[1][t][threadIdx.x];
  }
  *s_out = s;
  *q_out = q;
}

__global__ void __launch_bounds__(kFinLanes* kFinRows)
bn_stats_finalize_kernel(const float* __restrict__ part, int chunks, int c, long long n,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         const float* __restrict__ run_mean, const float* __restrict__ run_var,
                         float* __restrict__ ws, float eps, float keep, float momentum,
                         float unbias) {
  const int ch = blockIdx.x * kFinLanes + threadIdx.x;
  double s, q;
  sum_partials(part, chunks, c, ch, &s, &q);
  if (threadIdx.y != 0 || ch >= c) return;
  const float mean = (float)(s / (double)n);
  const float mean_sq = (float)(q / (double)n);
  const float var_raw = __fsub_rn(mean_sq, __fmul_rn(mean, mean));
  const float var = fmaxf(var_raw, 0.f);
  const float rstd = 1.f / sqrtf(var + eps);
  const float scale = rstd * gamma[ch];
  ws[kMean * c + ch] = mean;
  ws[kRstd * c + ch] = rstd;
  ws[kScale * c + ch] = scale;
  ws[kShift * c + ch] = beta[ch] - mean * scale;
  ws[kNewMean * c + ch] = keep * run_mean[ch] + momentum * mean;
  ws[kNewVar * c + ch] = keep * run_var[ch] + momentum * (var * unbias);
  ws[kVarMask * c + ch] = var_raw >= 0.f ? 1.f : 0.f;
}

__global__ void __launch_bounds__(kFinLanes* kFinRows)
bn_grad_finalize_kernel(const float* __restrict__ part, int chunks, int c, long long n,
                        const float* __restrict__ ws, float* __restrict__ g) {
  const int ch = blockIdx.x * kFinLanes + threadIdx.x;
  double s, q;
  sum_partials(part, chunks, c, ch, &s, &q);
  if (threadIdx.y != 0 || ch >= c) return;
  const float rstd = ws[kRstd * c + ch], scale = ws[kScale * c + ch];
  const float dbeta = (float)s;
  const float dgamma = (float)q * rstd;  // sum(dy * xh)
  const float inv_n = (float)(1.0 / (double)n);
  g[kDgamma * c + ch] = dgamma;
  g[kDbeta * c + ch] = dbeta;
  g[kOffset * c + ch] = -scale * (dbeta * inv_n);
  g[kCoef * c + ch] = ws[kVarMask * c + ch] * scale * rstd * (dgamma * inv_n);
}

// y = x*scale + shift or, with GRAD, dx = scale*dy + offset - coef*(x - mean),
// in fp32, rounded once to T.
template <typename T, int V, bool GRAD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ ws,
                const float* __restrict__ g, T* __restrict__ out, long long m, int c,
                long long rpc) {
  const int ch = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (ch >= c) return;
  const int rows = blockDim.y;
  const long long r0 = (long long)blockIdx.y * rpc;
  const long long r1 = min(m, r0 + rpc);
  float a[V], b[V], mu[V], coef[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    a[k] = ws[kScale * c + ch + k];
    b[k] = GRAD ? g[kOffset * c + ch + k] : ws[kShift * c + ch + k];
    mu[k] = GRAD ? ws[kMean * c + ch + k] : 0.f;
    coef[k] = GRAD ? g[kCoef * c + ch + k] : 0.f;
  }
  const long long step = (long long)rows * c;
  long long r = r0 + threadIdx.y;
  long long off = r * c + ch;
  auto one = [&](const Pack<T, V>& xa, const Pack<T, V>& ga) {
    Pack<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xv = to_f(xa.v[k]);
      o.v[k] = GRAD ? from_f<T>(fmaf(-coef[k], xv - mu[k], fmaf(a[k], to_f(ga.v[k]), b[k])))
                    : from_f<T>(fmaf(xv, a[k], b[k]));
    }
    return o;
  };
  for (; r + 3 * rows < r1; r += 4 * rows) {
    Pack<T, V> xa[4], ga[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      xa[u] = load<T, V>(x + off + u * step);
      if (GRAD) ga[u] = load<T, V>(dy + off + u * step);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<Pack<T, V>*>(out + off + u * step) = one(xa[u], ga[u]);
    off += 4 * step;
  }
  for (; r < r1; r += rows, off += step) {
    const Pack<T, V> xa = load<T, V>(x + off);
    Pack<T, V> ga;
    if (GRAD) ga = load<T, V>(dy + off);
    *reinterpret_cast<Pack<T, V>*>(out + off) = one(xa, ga);
  }
}

struct Plan {
  long long m, rpc;
  int c, vec, lanes, rows, ctiles, chunks;
  dim3 grid() const { return dim3(ctiles, chunks); }
  dim3 block() const { return dim3(lanes, rows); }
  dim3 fin_grid() const { return dim3((c + kFinLanes - 1) / kFinLanes); }
};

template <typename T, int V>
int forward_v(const Plan& p, const T* x, const float* gamma, const float* beta,
              const float* run_mean, const float* run_var, T* y, float* part, float* ws,
              float eps, float keep, float momentum, float unbias, cudaStream_t stream) {
  bn_reduce_kernel<T, V, false><<<p.grid(), p.block(), 0, stream>>>(x, nullptr, nullptr, part,
                                                                     p.m, p.c, p.rpc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_stats_finalize_kernel<<<p.fin_grid(), dim3(kFinLanes, kFinRows), 0, stream>>>(
      part, p.chunks, p.c, p.m, gamma, beta, run_mean, run_var, ws, eps, keep, momentum, unbias);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_apply_kernel<T, V, false><<<p.grid(), p.block(), 0, stream>>>(x, nullptr, ws, nullptr, y,
                                                                    p.m, p.c, p.rpc);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int backward_v(const Plan& p, const T* x, const T* dy, const float* ws, T* dx, float* part,
               float* g, cudaStream_t stream) {
  bn_reduce_kernel<T, V, true><<<p.grid(), p.block(), 0, stream>>>(x, dy, ws + kMean * p.c,
                                                                    part, p.m, p.c, p.rpc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_grad_finalize_kernel<<<p.fin_grid(), dim3(kFinLanes, kFinRows), 0, stream>>>(
      part, p.chunks, p.c, p.m, ws, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_apply_kernel<T, V, true><<<p.grid(), p.block(), 0, stream>>>(x, dy, ws, g, dx, p.m, p.c,
                                                                   p.rpc);
  return (int)cudaGetLastError();
}

bool plan_ok(const Plan& p, int itemsize) {
  const int vec_ok = p.vec == 1 || p.vec == 2 || p.vec == 4 || (p.vec == 8 && itemsize == 2);
  return vec_ok && p.m > 0 && p.c > 0 && p.c % p.vec == 0 && p.lanes > 0 && p.rows > 0 &&
         p.lanes * p.rows <= kThreads && p.rpc > 0 && p.chunks > 0 && p.chunks <= 65535 &&
         (long long)p.lanes * p.vec * p.ctiles >= p.c && p.rpc * p.chunks >= p.m;
}

template <typename T>
int forward(const Plan& p, const void* x, const void* gamma, const void* beta,
            const void* run_mean, const void* run_var, void* y, void* part, void* ws, float eps,
            float keep, float momentum, float unbias, void* stream) {
  if (!plan_ok(p, sizeof(T))) return (int)cudaErrorInvalidValue;
  const auto args = [&](auto vec) {
    constexpr int V = decltype(vec)::value;
    return forward_v<T, V>(p, (const T*)x, (const float*)gamma, (const float*)beta,
                           (const float*)run_mean, (const float*)run_var, (T*)y, (float*)part,
                           (float*)ws, eps, keep, momentum, unbias, (cudaStream_t)stream);
  };
  switch (p.vec) {
    case 1: return args(std::integral_constant<int, 1>());
    case 2: return args(std::integral_constant<int, 2>());
    case 4: return args(std::integral_constant<int, 4>());
    default:
      if constexpr (sizeof(T) == 2) return args(std::integral_constant<int, 8>());
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int backward(const Plan& p, const void* x, const void* dy, const void* ws, void* dx, void* part,
             void* g, void* stream) {
  if (!plan_ok(p, sizeof(T))) return (int)cudaErrorInvalidValue;
  const auto args = [&](auto vec) {
    constexpr int V = decltype(vec)::value;
    return backward_v<T, V>(p, (const T*)x, (const T*)dy, (const float*)ws, (T*)dx,
                            (float*)part, (float*)g, (cudaStream_t)stream);
  };
  switch (p.vec) {
    case 1: return args(std::integral_constant<int, 1>());
    case 2: return args(std::integral_constant<int, 2>());
    case 4: return args(std::integral_constant<int, 4>());
    default:
      if constexpr (sizeof(T) == 2) return args(std::integral_constant<int, 8>());
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The three launches of the forward: part [chunks][2][C] and ws [7][C] are
// fp32 scratch and output; y has x's dtype and layout.
#define BN_FWD(NAME, T)                                                                          \
  extern "C" int NAME(const void* x, const void* gamma, const void* beta, const void* run_mean, \
                      const void* run_var, void* y, void* part, void* ws, long long m, int c,   \
                      int vec, int lanes, int rows, int ctiles, int chunks, long long rpc,      \
                      float eps, float keep, float momentum, float unbias, void* stream) {      \
    const Plan p{m, rpc, c, vec, lanes, rows, ctiles, chunks};                                   \
    return forward<T>(p, x, gamma, beta, run_mean, run_var, y, part, ws, eps, keep, momentum,   \
                      unbias, stream);                                                           \
  }
BN_FWD(bn_fwd_bf16, __nv_bfloat16)
BN_FWD(bn_fwd_f32, float)

// The three launches of the backward: part [chunks][2][C] scratch, g [4][C]
// (dgamma, dbeta, and dx's two coefficients); dx has x's dtype and layout.
#define BN_BWD(NAME, T)                                                                        \
  extern "C" int NAME(const void* x, const void* dy, const void* ws, void* dx, void* part,    \
                      void* g, long long m, int c, int vec, int lanes, int rows, int ctiles,  \
                      int chunks, long long rpc, void* stream) {                               \
    const Plan p{m, rpc, c, vec, lanes, rows, ctiles, chunks};                                 \
    return backward<T>(p, x, dy, ws, dx, part, g, stream);                                     \
  }
BN_BWD(bn_bwd_bf16, __nv_bfloat16)
BN_BWD(bn_bwd_f32, float)
