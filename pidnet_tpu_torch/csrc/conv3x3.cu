// Fused 3x3 / stride 1 / SAME convolution, NHWC x HWIO, with an optional
// epilogue: y = conv(x, w) [+ b] [relu], and per-channel [sum y, sum y^2]
// of the fp32 post-epilogue values over N, H, W.
//
// Replaces pidnet_tpu/ops/conv3x3.py::_kernel (the Pallas TPU kernel). That
// kernel DMAs a halo block of TH+2 image rows per grid step into a VMEM
// scratch, runs 9 shifted (TH*W, Cin) x (Cin, Cout) MXU matmuls, and keeps
// the statistics in an output block that a sequential grid revisits. On
// Hopper blocks run in parallel and share nothing, so this kernel is an
// implicit GEMM over
//
//     M = output pixels,  N = Cout,  K = 9 taps x Cin,
//
// walked in K steps of BK = 64 input channels of one tap.
//
// Bound on an H100 SXM: operations. At (8,128,128,128) the conv is
// 2*N*H*W*9*Cin*Cout = 38.65 GFLOP, 39.1 us at 989 TFLOP/s bf16, while its
// bytes (x and y in bf16, w) are 67.4 MB, 20.1 us at 3.35 TB/s; at
// (8,32,32,256) and (8,16,16,512) it is 9.66 GFLOP (9.77 us) against 8.4
// and 9.1 MB. Only wgmma reaches the tensor cores' full rate on Hopper, and
// only if the operands arrive without taking the multiplying threads' issue
// slots, so the design is:
//
// - A block owns a TH x TW = 128 rectangle of output pixels of one image
//   (TW the smallest of 16, 32, 64, 128 that covers W, 128 above) and BN =
//   128 or 64 output channels; grid (pixel tiles, Cout / BN), not persistent.
// - Operand A of a K step is one 4-D TMA load of x, box (64 ch, TW, TH, 1),
//   at (c0, x0+dx-1, y0+dy-1, n): TMA zero-fills whatever lies outside the
//   image, so the SAME padding and the halo cost no code. The box lands as
//   128 rows of 128 bytes in the 128-byte swizzle, row = th*TW + tw: a
//   K-major 128 x 64 bf16 tile as wgmma reads it.
// - Operand B is w as it is, (9 x Cin, Cout) with Cout contiguous: per 64
//   output channels one 2-D TMA load, box (64 Cout, 64 k), lands as 64 rows
//   of 128 bytes in the 128-byte swizzle, an MN-major tile that wgmma reads
//   with its transpose-B bit. No copy of w is made.
// - 3 warpgroups. Warpgroup 0 is the producer: one thread keeps STAGES
//   stages of A and B in flight, each completing on a `full` mbarrier that
//   expects the two whole boxes' bytes (zero-filled bytes count). Warpgroups
//   1 and 2 each multiply 64 rows of the tile with 4 wgmma m64nBNk16 per
//   stage (bf16 in, fp32 accumulators in registers), and release a stage on
//   its `empty` mbarrier once wgmma.wait_group has retired the products that
//   read it. setmaxnreg moves registers from the producer to them.
// - The epilogue works on the accumulator registers: + bias (fp32), ReLU,
//   round to the output type (nearest even for bf16), staged in the freed
//   stages so that each pixel's BN channels leave as 16-byte stores of
//   neighbouring threads; the pixels of a ragged tile (h >= H or w >= W)
//   are masked. The statistics sum each thread's columns, reduce over the
//   lanes that share a column with shuffles and over the warps in shared
//   memory, and take one fp32 atomicAdd per channel per block and statistic.
//
// A barrier wait that outlasts 4 s traps instead of hanging the card.
//
// Contract (checked by the wrapper, ops/conv3x3.py, which also makes the
// tile plan): x (N,H,W,Cin) bf16, w (3,3,Cin,Cout) bf16, both contiguous and
// 16-byte aligned; Cin % 64 == 0, Cout % 128 == 0; b (Cout,) fp32 or null;
// stats (2,Cout) fp32 or null (zeroed here). The tensor maps are encoded on
// the host through cuTensorMapEncodeTiled, reached with
// cudaGetDriverEntryPoint so that the library needs no link to libcuda.

#include <cuda.h>  // CUtensorMap and the driver's enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BM = 128;                  // output pixels per block (TH x TW)
constexpr int BK = 64;                   // input channels per K step: one 128-byte row
constexpr int STAGES = 5;                // K steps in flight
constexpr int CONSUMERS = 2;             // warpgroups that multiply, 64 rows each
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int A_BYTES = BM * BK * 2;     // 16 KB
constexpr int B_BLOCK = BK * 64 * 2;     // 8 KB: 64 k rows of 64 output channels
constexpr uint32_t WAIT_LIMIT_NS = 4000000000u;

template <int BN>
__host__ __device__ constexpr int stage_bytes() { return A_BYTES + BN * BK * 2; }

// stages (1024-byte aligned for the swizzle), then the full and empty
// barriers, then the statistics' per-warp partial sums; 1024 bytes of slack
// to align the dynamic shared memory's base
template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + STAGES * stage_bytes<BN>() + 2 * STAGES * 8 + CONSUMERS * 4 * 2 * BN * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  for (uint32_t spin = 0;; ++spin) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) t0 = global_ns();
    if ((spin & 1023) == 1023 && global_ns() - t0 > WAIT_LIMIT_NS) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a tile of 128-byte rows in the 128-byte swizzle,
// 1024-byte aligned: start address >> 4 (bits 0-13), leading byte offset
// >> 4 (bits 16-29), stride byte offset >> 4 (bits 32-45), swizzle mode 1 =
// 128 B (bits 62-63).
//  - A, K-major (a row is 64 channels of one pixel): SBO = 1024 B between
//    8-row groups, LBO unused (16 B); a k16 slice starts 32 B further.
//  - B, MN-major (a row is 64 output channels of one k): blocks of 64 k rows
//    per 64 output channels, LBO = 8192 B between those blocks, SBO = 1024 B
//    between groups of 8 k rows; a k16 slice starts 16 rows (2048 B) further.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, fp32) += A (64 x 16, bf16, K-major) * B (16 x N, bf16, MN-major:
// the transpose-B bit), both in shared memory
__device__ __forceinline__ void wgmma_bn(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bn(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

template <int BN, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
               const float* __restrict__ bias, OutT* __restrict__ y, float* __restrict__ stats,
               int h, int wd, int cin, int cout, int tw_log2, int tiles_x, int tiles_y,
               int relu) {
  constexpr int STAGE = stage_bytes<BN>();
  constexpr int ACC = BN / 2;  // accumulator registers per thread: 64 rows x BN / 128
  // a staged output row: BN values and 8 of padding, so that the 8 rows a
  // warp writes at once fall on distinct shared-memory banks
  constexpr int OUT_ROW = (BN + 8) * (int)sizeof(OutT);
  static_assert(CONSUMERS * 64 * OUT_ROW <= STAGES * STAGE, "the output tile fits the stages");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full = base + STAGES * STAGE;  // full[s] at + 8 s, empty[s] at + 8 (STAGES + s)
  const uint32_t empty = full + 8 * STAGES;
  float* red = reinterpret_cast<float*>(smem_raw + (base - raw) + STAGES * STAGE + 16 * STAGES);

  int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  tile /= tiles_x;
  const int ty = tile % tiles_y;
  const int img = tile / tiles_y;
  const int x0 = tx << tw_log2, y0 = ty * (BM >> tw_log2);
  const int n0 = blockIdx.y * BN;
  const int ksteps = 9 * (cin / BK);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int s = 0, tap = 0, c0 = 0;
      uint32_t phase = 0;
      for (int step = 0; step < ksteps; ++step) {
        mbar_wait(empty + 8 * s, phase ^ 1);  // the first round passes at once
        const uint32_t bar = full + 8 * s, a = base + s * STAGE;
        mbar_expect_tx(bar, STAGE);
        tma_load_4d(a, &x_map, bar, c0, x0 + tap % 3 - 1, y0 + tap / 3 - 1, img);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(a + A_BYTES + j * B_BLOCK, &w_map, bar, n0 + 64 * j, tap * cin + c0);
        c0 += BK;
        if (c0 == cin) c0 = 0, ++tap;
        if (++s == STAGES) s = 0, phase ^= 1;
      }
    }
  } else {
    // consumers: warpgroup wg multiplies rows 64 (wg - 1) .. 64 wg - 1 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = threadIdx.x / 32 - 4;  // 0..7 over both consumers
    const int lane = threadIdx.x % 32;
    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int step = 0; step < ksteps; ++step) {
      mbar_wait(full + 8 * s, phase);
      const uint32_t a = base + s * STAGE;
      const uint64_t da = sw128_desc(a + (wg - 1) * 64 * 128, 16, 1024);
      const uint64_t db = sw128_desc(a + A_BYTES, B_BLOCK, 1024);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_bn(acc, da + 2 * kk, db + 128 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: free its stage
      fence_acc(acc);
      if (step > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == STAGES) s = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    // both consumers are done with the stages: they now stage the output
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");

    // accumulator layout (m64nNk16, fp32): register 4j + 2i + e holds row
    // 16 (warp % 4) + lane / 4 + 8 i and column 8 j + 2 (lane % 4) + e
    const int tw_mask = (1 << tw_log2) - 1;
    unsigned char* out_tile = smem_raw + (base - raw) + (wg - 1) * 64 * OUT_ROW;
    bool ok[2];
    OutT* staged[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rl = (warp % 4) * 16 + lane / 4 + 8 * i;  // row within this warpgroup's 64
      const int r = (wg - 1) * 64 + rl;
      ok[i] = y0 + (r >> tw_log2) < h && x0 + (r & tw_mask) < wd;
      staged[i] = reinterpret_cast<OutT*>(out_tile + rl * OUT_ROW) + 2 * (lane % 4);
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      float v[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float b = bias ? bias[n0 + col + e] : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float t = acc[4 * j + 2 * i + e] + b;
          if (relu) t = fmaxf(t, 0.f);
          v[i][e] = t;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) store2(staged[i] + 8 * j, v[i][0], v[i][1]);
      if (stats) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a0 = ok[0] ? v[0][e] : 0.f, a1 = ok[1] ? v[1][e] : 0.f;
          float s1 = a0 + a1, s2 = a0 * a0 + a1 * a1;
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, m);
            s2 += __shfl_xor_sync(0xffffffffu, s2, m);
          }
          if (lane < 4) {
            red[(warp * 2) * BN + col + e] = s1;
            red[(warp * 2 + 1) * BN + col + e] = s2;
          }
        }
      }
    }
    // this warpgroup's 64 staged rows to y: a row is BN channels of one
    // pixel, 16 bytes a thread, neighbouring threads on neighbouring bytes
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    constexpr int VECS = BN * (int)sizeof(OutT) / 16;  // 16-byte vectors per row
#pragma unroll
    for (int k = 0; k < 64 * VECS / 128; ++k) {
      const int idx = threadIdx.x % 128 + 128 * k;
      const int rl = idx / VECS, vec = idx % VECS;
      const int r = (wg - 1) * 64 + rl;
      const int yy = y0 + (r >> tw_log2), xx = x0 + (r & tw_mask);
      if (yy < h && xx < wd) {
        const uint4 val = *reinterpret_cast<const uint4*>(out_tile + rl * OUT_ROW + vec * 16);
        *(reinterpret_cast<uint4*>(y + (((int64_t)img * h + yy) * wd + xx) * cout + n0) + vec) =
            val;
      }
    }
    if (stats) {
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
      const int t = threadIdx.x - 128;
      if (t < 2 * BN) {
        const int stat = t / BN, col = t % BN;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < CONSUMERS * 4; ++w) sum += red[(w * 2 + stat) * BN + col];
        atomicAdd(stats + stat * cout + n0 + col, sum);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// bf16 tensor map with the 128-byte swizzle and zero fill out of bounds;
// dims and box innermost first, strides in bytes of dims 1..rank-1
CUresult encode(CUtensorMap* map, int rank, const void* ptr, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                        strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int ERR_ENCODE = 10000;  // + the CUresult of a failed tensor-map encode

template <int BN, typename OutT>
int launch(int dev, const void* x, const void* w, const void* bias, void* y, void* stats, int n,
           int h, int wd, int cin, int cout, int relu, int th, int tw, int grid_x, void* stream) {
  // above 48 KB of dynamic shared memory needs the opt-in: once per device
  static std::atomic<unsigned long long> opted{0};
  const unsigned long long bit = 1ull << (dev & 63);
  cudaError_t err;
  if (!(opted.load() & bit)) {
    err = cudaFuncSetAttribute(conv3x3_kernel<BN, OutT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<BN>());
    if (err != cudaSuccess) return (int)err;
    opted.fetch_or(bit);
  }
  if (!encode_tiled()) return (int)cudaErrorSymbolNotFound;

  CUtensorMap x_map, w_map;
  const cuuint64_t xd[4] = {(cuuint64_t)cin, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t xs[3] = {(cuuint64_t)cin * 2, (cuuint64_t)wd * cin * 2,
                            (cuuint64_t)h * wd * cin * 2};
  const cuuint32_t xb[4] = {BK, (cuuint32_t)tw, (cuuint32_t)th, 1};
  CUresult res = encode(&x_map, 4, x, xd, xs, xb);
  if (res != CUDA_SUCCESS) return ERR_ENCODE + (int)res;
  const cuuint64_t wdims[2] = {(cuuint64_t)cout, (cuuint64_t)9 * cin};
  const cuuint64_t wstr[1] = {(cuuint64_t)cout * 2};
  const cuuint32_t wbox[2] = {64, BK};
  res = encode(&w_map, 2, w, wdims, wstr, wbox);
  if (res != CUDA_SUCCESS) return ERR_ENCODE + (int)res;

  const cudaStream_t s = (cudaStream_t)stream;
  if (stats) {
    err = cudaMemsetAsync(stats, 0, sizeof(float) * 2 * cout, s);
    if (err != cudaSuccess) return (int)err;
  }
  int tw_log2 = 0;
  while ((1 << tw_log2) < tw) ++tw_log2;
  const int tiles_x = (wd + tw - 1) / tw, tiles_y = (h + th - 1) / th;
  conv3x3_kernel<BN, OutT><<<dim3((unsigned)grid_x, (unsigned)(cout / BN)), THREADS,
                             smem_bytes<BN>(), s>>>(
      x_map, w_map, (const float*)bias, (OutT*)y, (float*)stats, h, wd, cin, cout, tw_log2,
      tiles_x, tiles_y, relu);
  return (int)cudaGetLastError();
}

// the tile plan of ops/conv3x3.py::_plan, checked before anything launches
bool plan_ok(int n, int h, int wd, int cin, int cout, int th, int tw, int bn, int stages,
             int grid_x, int grid_y) {
  const bool tw_ok = tw == 16 || tw == 32 || tw == 64 || tw == 128;
  return n > 0 && h > 0 && wd > 0 && cin >= BK && cin % BK == 0 && cout % 128 == 0 && tw_ok &&
         th * tw == BM && (bn == 128 || bn == 64) && stages == STAGES &&
         (long long)grid_x == (long long)n * ((h + th - 1) / th) * ((wd + tw - 1) / tw) &&
         grid_y * bn == cout;
}

// launches on device `dev` (made current for the call if it is not)
template <typename OutT>
int dispatch(int dev, const void* x, const void* w, const void* bias, void* y, void* stats, int n,
             int h, int wd, int cin, int cout, int relu, int th, int tw, int bn, int stages,
             int grid_x, int grid_y, void* stream) {
  if (!plan_ok(n, h, wd, cin, cout, th, tw, bn, stages, grid_x, grid_y))
    return (int)cudaErrorInvalidValue;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != dev) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  const int ret =
      bn == 128 ? launch<128, OutT>(dev, x, w, bias, y, stats, n, h, wd, cin, cout, relu, th, tw,
                                    grid_x, stream)
                : launch<64, OutT>(dev, x, w, bias, y, stats, n, h, wd, cin, cout, relu, th, tw,
                                   grid_x, stream);
  if (cur != dev) cudaSetDevice(cur);
  return ret;
}

}  // namespace

extern "C" int conv3x3_bf16(int dev, const void* x, const void* w, const void* bias, void* y,
                            void* stats, int n, int h, int wd, int cin, int cout, int relu,
                            int th, int tw, int bn, int stages, int grid_x, int grid_y,
                            void* stream) {
  return dispatch<__nv_bfloat16>(dev, x, w, bias, y, stats, n, h, wd, cin, cout, relu, th, tw,
                                 bn, stages, grid_x, grid_y, stream);
}

extern "C" int conv3x3_f32(int dev, const void* x, const void* w, const void* bias, void* y,
                           void* stats, int n, int h, int wd, int cin, int cout, int relu, int th,
                           int tw, int bn, int stages, int grid_x, int grid_y, void* stream) {
  return dispatch<float>(dev, x, w, bias, y, stats, n, h, wd, cin, cout, relu, th, tw, bn,
                         stages, grid_x, grid_y, stream);
}

// dynamic shared memory of one block with BN output channels, in bytes
extern "C" int conv3x3_smem_bytes(int bn) {
  return bn == 128 ? smem_bytes<128>() : bn == 64 ? smem_bytes<64>() : -1;
}
