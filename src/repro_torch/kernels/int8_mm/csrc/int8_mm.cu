// int8 × int8 GEMM with exact int32 accumulation and the float32 dequant
// epilogue, for Hopper (sm_90a), on the int8 tensor cores.
//
// Replaces: the TPU kernel `int8_mm_kernel` in
//   src/repro/kernels/int8_mm/int8_mm.py:32 (launched by
//   `int8_mm_pallas_call`, same file :52; entries `ops.py:30`
//   `int8_mm_pallas` and `ops.py:46` `int8_matmul`).  Same function:
//   out[m, n] = float(Σ_k a[m,k]·w[k,n]) · (scale_a[m] · scale_w[n]),
//   the epilogue in that order of operations.
//
// Bound on this card: at the large shapes, operations — 2·M·N·K int8
// operations against the 1,979 TOP/s int8 tensor-core peak of an NVIDIA
// H100 (SXM, 700 W), with the operands read once (M·K + K·N bytes) and the
// float32 output written once; at 8 rows, the bytes of W.
//
// Design.  A CTA owns a 128×128 output tile and walks K in steps of 128.
// Both operands are K-major in shared memory, as int8 `wgmma` requires (it
// takes no transposed operand): A [M, K̂] as given, and Wᵀ [N, K̂], which the
// wrapper (int8_mm.py) has a small transpose kernel (below) write before
// the GEMM, K̂ = K rounded up to 16 with zero columns (TMA wants 16-byte
// row strides; zeros keep the int32 sums exact).  One producer thread
// keeps a 4-stage ring of [128, 128]-byte A and Wᵀ tiles in flight with
// TMA (`cp.async.bulk.tensor.2d`, 128-byte swizzle), each stage completing on its `full` mbarrier; TMA's
// out-of-bounds zero fill covers the ragged M, N and K edges.  Two consumer
// warpgroups each run `wgmma.mma_async.m64n128k32.s32.s8.s8` on their 64
// rows, four k32 steps a stage, with int32 accumulators in registers (64 a
// thread), and release the stage on its `empty` mbarrier.  The epilogue
// converts each int32 sum to float32 (round to nearest, as the plain
// version's `.to(float32)`) and multiplies by scale_a[m]·scale_w[n], with
// the store masked at the ragged edge, so the kernel equals its plain
// version bit for bit.  Tensor maps are encoded on the host per call with
// `cuTensorMapEncodeTiled` looked up through the CUDA runtime, so the build
// needs no -lcuda.  Shapes smaller than a tile (M = 8) run the same path
// with zero-filled rows.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 0.19 ms at
// 4096³, 36 % of the int8 peak, the transpose 0.03 ms of it.
//
// Left on the table: each consumer waits for its wgmma group before
// releasing the stage (no wgmma overlap across stages: keeping one group
// in flight gave wrong sums here, with ptxas serialising the wgmma around
// the accumulator fences); no persistent
// tile scheduler, cluster multicast or 128×256 tile; the epilogue stores
// straight from registers; at M = 8 the tile computes 120 zero rows and
// only N/128 CTAs stream W (a split over K would use more SMs); Wᵀ is
// written on every call (a deployment would store it once).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 128;  // kBK int8 values = 128 bytes
constexpr int kStages = 4;
constexpr int kConsumers = 2;                   // warpgroups running wgmma
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kTileA = kBM * kBK, kTileB = kBN * kBK;
constexpr int kStageBytes = kTileA + kTileB;
constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// spin until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO); LBO unused.
__device__ __forceinline__ uint64_t make_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) | (uint64_t{1024 >> 4} << 32) |
         (uint64_t{1} << 62);
}

__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64×128] (+)= A[64×32] · B[128×32]ᵀ, s8 inputs, s32 accumulators
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(kThreads, 1)
int8_mm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
               const float* __restrict__ scale_a, const float* __restrict__ scale_w,
               float* __restrict__ out, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles want 1024-byte alignment
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_tiles = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer warpgroup: one thread issues the copies
    if (threadIdx.x == kConsumers * 128) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
        unsigned char* a_s = smem + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load_2d(a_s, &map_a, &full[s], kt * kBK, m0);
        tma_load_2d(a_s + kTileA, &map_b, &full[s], kt * kBK, n0);
      }
    }
    return;
  }

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const unsigned char* a_s = smem + s * kStageBytes + wg * 64 * kBK;  // this warpgroup's rows
    const unsigned char* b_s = smem + s * kStageBytes + kTileA;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      wgmma_m64n128k32(acc, make_desc(a_s + kk * 32), make_desc(b_s + kk * 32));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[s]);
  }

  // accumulator fragment: register 4j + 2h + e holds row 16·warp + lane/4 +
  // 8h, column 8j + 2·(lane % 4) + e of the warpgroup's 64×128 tile
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
    if (row >= M) continue;
    const float sa = scale_a[row];
    float* orow = out + static_cast<size_t>(row) * N;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 8 * j + 2 * (lane % 4) + e;
        if (col < N) orow[col] = static_cast<float>(acc[4 * j + 2 * h + e]) * (sa * scale_w[col]);
      }
    }
  }
}

// wt[n, k] = w[k, n] for k < K, 0 for K <= k < K_pad: W [K, N] row-major
// written K-major for the GEMM.  A block transposes a 64×64-byte tile
// through shared memory, so that reads run along rows of W and writes
// along rows of wt.
constexpr int kT = 64;

__global__ void __launch_bounds__(256)
transpose_pad_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ wt, int K, int N,
                     int K_pad) {
  __shared__ int8_t tile[kT][kT + 4];
  const int n0 = blockIdx.x * kT, k0 = blockIdx.y * kT;
  for (int i = threadIdx.x; i < kT * kT; i += 256) {
    const int r = i / kT, c = i % kT;  // r along K, c along N
    const int k = k0 + r, n = n0 + c;
    tile[r][c] = (k < K && n < N) ? w[static_cast<size_t>(k) * N + n] : int8_t{0};
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kT * kT; i += 256) {
    const int r = i / kT, c = i % kT;  // r along N, c along K
    const int n = n0 + r, k = k0 + c;
    if (n < N && k < K_pad) wt[static_cast<size_t>(n) * K_pad + k] = tile[c][r];
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [rows, K] int8, row-major with a 16-byte multiple of K: boxes of
// [128 rows, 128 bytes], 128-byte swizzle, zero fill out of bounds
bool encode(CUtensorMap* map, const void* ptr, int rows, int K) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {kBK, 128};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// a int8 [M, K] and wt int8 [N, K] (W transposed), both row-major with K a
// multiple of 16 and 16-byte aligned; scales float32 [M] and [N]; out
// float32 [M, N].  Returns the launch's cudaError_t, or -1 when the tensor
// maps could not be encoded.
extern "C" int int8_mm_launch(const void* a, const void* wt, const void* scale_a,
                              const void* scale_w, void* out, int M, int N, int K,
                              void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  if (!encode(&map_a, a, M, K) || !encode(&map_b, wt, N, K)) return -1;
  cudaError_t err =
      cudaFuncSetAttribute(int8_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_mm_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<const float*>(scale_a), static_cast<const float*>(scale_w),
      static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// w int8 [K, N] row-major → wt int8 [N, K_pad], zero columns past K.
// Returns the launch's cudaError_t.
extern "C" int int8_transpose_pad_launch(const void* w, void* wt, int K, int N, int K_pad,
                                         void* stream) {
  if (K < 1 || N < 1 || K_pad < K) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + kT - 1) / kT, (K_pad + kT - 1) / kT);
  transpose_pad_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), static_cast<int8_t*>(wt), K, N, K_pad);
  return static_cast<int>(cudaGetLastError());
}
