// Fused 3x3 / stride 1 / SAME convolution, NHWC x HWIO, with an optional
// epilogue: y = conv(x, w) [+ b] [relu], and per-channel [sum y, sum y^2]
// of the fp32 post-epilogue values over N, H, W.
//
// Replaces pidnet_tpu/ops/conv3x3.py::_kernel (the Pallas TPU kernel). That
// kernel DMAs a halo block of TH+2 image rows per grid step into a VMEM
// scratch, runs 9 shifted (TH*W, Cin) x (Cin, Cout) MXU matmuls, and keeps
// the statistics in an output block that a sequential grid revisits. On
// Hopper none of that carries over: blocks run in parallel and share
// nothing, so this kernel is an implicit GEMM over
//
//     M = N*H*W output pixels,  N = Cout,  K = 9 taps x Cin
//
// A block owns BM = 128 consecutive output pixels (flattened over N, H, W,
// so any W fills its tiles, W = 24 included) and BN = 128 output channels.
// It walks K in steps of BK = 64 input channels of one tap: each step
// stages the tap-shifted input pixels (zero where the source pixel lies
// outside the image, by a zero-filling cp.async) and the (BK x BN) slice of
// w in shared memory, three steps in flight, and multiplies them on the
// tensor cores with nvcuda::wmma bf16 16x16x16 fragments accumulating in
// fp32. No im2col ever reaches device memory. The epilogue goes through
// shared memory: + bias (fp32), ReLU, round to the output type (nearest
// even for bf16), and one atomicAdd per channel per block for each of the
// two statistics, on the fp32 values before the cast; rows past the last
// pixel are masked out of the stores and the sums.
//
// Bound on an H100 SXM: operations. At (8,128,128,128) the conv is
// 2*N*H*W*9*Cin*Cout = 38.65 GFLOP, 39.1 us at 989 TFLOP/s bf16, while its
// bytes (x and y in bf16, w) are 67.4 MB, 20.1 us at 3.35 TB/s; at
// (8,32,32,256) and (8,16,16,512) it is 9.66 GFLOP (9.77 us) against 8.4
// and 9.1 MB. The design feeds the tensor cores from shared memory with
// 16-byte copies that overlap the math of the step before; it does not
// reach the bound: wmma (mma.sync) is not the full-rate path on Hopper,
// which wants wgmma fed by TMA, left for a later version.
//
// Contract (checked by the wrapper, ops/conv3x3.py): x (N,H,W,Cin) bf16,
// w (3,3,Cin,Cout) bf16, both contiguous and 16-byte aligned; Cin % 64 == 0,
// Cout % 128 == 0; b (Cout,) fp32 or null; stats (2,Cout) fp32 zeroed by
// the caller, or null.

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 128;               // output pixels per block
constexpr int BN = 128;               // output channels per block
constexpr int BK = 64;                // input channels per K step
constexpr int STAGES = 3;             // K steps in flight
constexpr int THREADS = 256;          // 8 warps: 2 along M x 4 along N
constexpr int WARP_M = 64;            // each warp: 64 pixels x 32 channels
constexpr int WARP_N = 32;
constexpr int FRAG_M = WARP_M / 16;   // 4
constexpr int FRAG_N = WARP_N / 16;   // 2
constexpr int LDA = BK + 8;           // padded rows of the staged tiles (bf16)
constexpr int LDB = BN + 8;
constexpr int LDT = BN + 4;           // padded rows of the fp32 epilogue tile
constexpr int A_ELEMS = BM * LDA;
constexpr int B_ELEMS = BK * LDB;
constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
constexpr int PIPE_BYTES = STAGES * STAGE_ELEMS * 2;
constexpr int TILE_BYTES = BM * LDT * 4;
constexpr int RED_BYTES = 2 * 2 * BN * 4;  // the two half-columns' partial sums
constexpr int SMEM_BYTES =
    PIPE_BYTES > TILE_BYTES + RED_BYTES ? PIPE_BYTES : TILE_BYTES + RED_BYTES;

// per-thread share of one stage's copies, in 16-byte (8 x bf16) vectors
constexpr int A_VECS = BM * BK / 8 / THREADS;  // 4
constexpr int B_VECS = BK * BN / 8 / THREADS;  // 4

static_assert(BM * BK / 8 % THREADS == 0 && BK * BN / 8 % THREADS == 0, "copy split");
static_assert((THREADS / (BK / 8)) * A_VECS == BM, "each thread copies whole pixel rows");
static_assert((LDA * 2) % 16 == 0 && (LDB * 2) % 16 == 0, "16-byte aligned staged rows");
static_assert((STAGE_ELEMS * 2) % 128 == 0 && (A_ELEMS * 2) % 128 == 0, "aligned stages");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void store_out(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_out(__nv_bfloat16* dst, const float* v) {
  uint4 u;
  __nv_bfloat162 p;
  p = __floats2bfloat162_rn(v[0], v[1]); u.x = *reinterpret_cast<unsigned*>(&p);
  p = __floats2bfloat162_rn(v[2], v[3]); u.y = *reinterpret_cast<unsigned*>(&p);
  p = __floats2bfloat162_rn(v[4], v[5]); u.z = *reinterpret_cast<unsigned*>(&p);
  p = __floats2bfloat162_rn(v[6], v[7]); u.w = *reinterpret_cast<unsigned*>(&p);
  *reinterpret_cast<uint4*>(dst) = u;
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias, OutT* __restrict__ y, float* __restrict__ stats,
               int n_img, int h, int wd, int cin, int cout, bool relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* pipe = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / (BN / WARP_N);  // 0..1
  const int warp_n = warp % (BN / WARP_N);  // 0..3
  const int64_t hw = (int64_t)h * wd;
  const int64_t total = (int64_t)n_img * hw;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int chunks = cin / BK;
  const int ksteps = 9 * chunks;

  // This thread copies 16-byte vector `a_vec` of the BK channels of pixel
  // rows a_row + i * (THREADS / 8): their image coordinates, once.
  const int a_vec = tid % (BK / 8);
  const int a_row = tid / (BK / 8);
  int pix_h[A_VECS], pix_w[A_VECS];
  int64_t pix_base[A_VECS];  // offset of pixel (n, 0, 0) in x, in elements
  bool pix_ok[A_VECS];
#pragma unroll
  for (int i = 0; i < A_VECS; ++i) {
    const int64_t p = m0 + a_row + i * (THREADS / (BK / 8));
    pix_ok[i] = p < total;
    const int64_t pp = pix_ok[i] ? p : 0;
    const int64_t img = pp / hw;
    const int64_t rem = pp - img * hw;
    pix_h[i] = (int)(rem / wd);
    pix_w[i] = (int)(rem - (int64_t)pix_h[i] * wd);
    pix_base[i] = img * hw * cin;
  }

  auto load_stage = [&](int stage, int step) {
    const int tap = step / chunks;
    const int c0 = (step - tap * chunks) * BK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    __nv_bfloat16* as = pipe + stage * STAGE_ELEMS;
    __nv_bfloat16* bs = as + A_ELEMS;
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int row = a_row + i * (THREADS / (BK / 8));
      const int hs = pix_h[i] + dy, ws = pix_w[i] + dx;
      const bool ok = pix_ok[i] && hs >= 0 && hs < h && ws >= 0 && ws < wd;
      const __nv_bfloat16* src =
          ok ? x + pix_base[i] + ((int64_t)hs * wd + ws) * cin + c0 + a_vec * 8 : x;
      cp_async16(as + row * LDA + a_vec * 8, src, ok);
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = tid + i * THREADS;
      const int k = v / (BN / 8), col = (v % (BN / 8)) * 8;
      const __nv_bfloat16* src = w + ((int64_t)tap * cin + c0 + k) * cout + n0 + col;
      cp_async16(bs + k * LDB + col, src, true);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FRAG_M][FRAG_N];
#pragma unroll
  for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
    for (int j = 0; j < FRAG_N; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ksteps) load_stage(s, s);
    cp_async_commit();
  }

  for (int step = 0; step < ksteps; ++step) {
    cp_async_wait<STAGES - 2>();  // this step's copies have landed
    __syncthreads();              // ... for every thread; the stage of step-1 is free
    const int next = step + STAGES - 1;
    if (next < ksteps) load_stage(next % STAGES, next);
    cp_async_commit();

    const __nv_bfloat16* as = pipe + (step % STAGES) * STAGE_ELEMS;
    const __nv_bfloat16* bs = as + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FRAG_M];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FRAG_N];
#pragma unroll
      for (int i = 0; i < FRAG_M; ++i)
        wmma::load_matrix_sync(fa[i], as + (warp_m * WARP_M + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FRAG_N; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * LDB + warp_n * WARP_N + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
        for (int j = 0; j < FRAG_N; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages: reuse them for the tile

  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < FRAG_M; ++i)
#pragma unroll
    for (int j = 0; j < FRAG_N; ++j)
      wmma::store_matrix_sync(tile + (warp_m * WARP_M + i * 16) * LDT + warp_n * WARP_N + j * 16,
                              acc[i][j], LDT, wmma::mem_row_major);
  __syncthreads();

  // stores: VEC consecutive channels of one pixel per thread and iteration
  constexpr int VEC = 16 / sizeof(OutT);
  for (int v = tid; v < BM * BN / VEC; v += THREADS) {
    const int r = v / (BN / VEC), c = (v % (BN / VEC)) * VEC;
    const int64_t p = m0 + r;
    if (p >= total) continue;
    float out[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float a = tile[r * LDT + c + e];
      if (bias) a += bias[n0 + c + e];
      if (relu) a = fmaxf(a, 0.f);
      out[e] = a;
    }
    store_out(y + p * cout + n0 + c, out);
  }

  if (stats) {
    // column sums: thread (half, col) sums rows [half*BM/2, (half+1)*BM/2)
    float* red = tile + BM * LDT;
    const int col = tid % BN, half = tid / BN;
    const float b = bias ? bias[n0 + col] : 0.f;
    float s = 0.f, s2 = 0.f;
    for (int r = half * (BM / 2); r < (half + 1) * (BM / 2); ++r) {
      if (m0 + r >= total) break;
      float a = tile[r * LDT + col] + b;
      if (relu) a = fmaxf(a, 0.f);
      s += a;
      s2 += a * a;
    }
    red[half * BN + col] = s;
    red[2 * BN + half * BN + col] = s2;
    __syncthreads();
    if (half == 0) {
      atomicAdd(stats + n0 + col, red[col] + red[BN + col]);
      atomicAdd(stats + cout + n0 + col, red[2 * BN + col] + red[3 * BN + col]);
    }
  }
}

template <typename OutT>
int launch(const void* x, const void* w, const void* bias, void* y, void* stats, int n, int h,
           int wd, int cin, int cout, int relu, void* stream) {
  // above 48 KB of dynamic shared memory needs the opt-in
  const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)n * h * wd;
  const dim3 grid((unsigned)((total + BM - 1) / BM), (unsigned)(cout / BN));
  conv3x3_kernel<OutT><<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)bias, (OutT*)y,
      (float*)stats, n, h, wd, cin, cout, relu != 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int conv3x3_bf16(const void* x, const void* w, const void* bias, void* y, void* stats,
                            int n, int h, int wd, int cin, int cout, int relu, void* stream) {
  return launch<__nv_bfloat16>(x, w, bias, y, stats, n, h, wd, cin, cout, relu, stream);
}

extern "C" int conv3x3_f32(const void* x, const void* w, const void* bias, void* y, void* stats,
                           int n, int h, int wd, int cin, int cout, int relu, void* stream) {
  return launch<float>(x, w, bias, y, stats, n, h, wd, cin, cout, relu, stream);
}
