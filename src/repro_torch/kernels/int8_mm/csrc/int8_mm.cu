// int8 × int8 GEMM with exact int32 accumulation and the float32 dequant
// epilogue, for Hopper (sm_90a).
//
// Replaces: the TPU kernel `int8_mm_kernel` in
//   src/repro/kernels/int8_mm/int8_mm.py:32 (launched by
//   `int8_mm_pallas_call`, same file :52; entries `ops.py:30`
//   `int8_mm_pallas` and `ops.py:46` `int8_matmul`).  Same function:
//   out[m, n] = float(Σ_k a[m,k]·w[k,n]) · (scale_a[m] · scale_w[n]),
//   the epilogue in that order of operations.
//
// Bound on this card: at the large shapes, operations — 2·M·N·K int8
// operations against the 1,979 TOP/s int8 tensor-core peak, with the
// operands read once (M·K + K·N bytes) and the float32 output written once.
//
// Design: the simple first kernel.  A block of 256 threads owns a 64×64
// output tile and walks K in steps of 32: it stages A's [64, 32] and W's
// [32, 64] int8 tiles in shared memory (W transposed, so that four
// consecutive k of one column form one 32-bit word), zero-filling the
// ragged edges; each thread then accumulates a 4×4 block of outputs with
// __dp4a (four int8 products and an int32 add per instruction) on the CUDA
// cores.  The int32 sums are exact in any order.
//
// Left on the table: the tensor cores.  An int8 `mma.sync`/`wgmma` kernel
// with TMA staging is the way to the int8 peak; dp4a on the CUDA cores
// (4 products an instruction, 64 INT32 lanes an SM) tops out near a
// fifteenth of it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 256;
constexpr int kWords = kBK / 4;  // 32-bit words per staged row

__global__ void __launch_bounds__(kThreads)
int8_mm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
               const float* __restrict__ scale_a, const float* __restrict__ scale_w,
               float* __restrict__ out, int M, int N, int K) {
  // +1 word a row against bank conflicts on the row-strided reads
  __shared__ int32_t a_s[kBM][kWords + 1];
  __shared__ int32_t w_s[kBN][kWords + 1];  // w_s[n][k/4]: W transposed
  int8_t* a_b = reinterpret_cast<int8_t*>(&a_s[0][0]);
  int8_t* w_b = reinterpret_cast<int8_t*>(&w_s[0][0]);
  constexpr int kRowBytes = (kWords + 1) * 4;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  int acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // stage A [64 rows][32 k] and W [32 k][64 cols] → w_s[col][k]
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, k = i % kBK;
      const int gm = m0 + r, gk = k0 + k;
      a_b[r * kRowBytes + k] =
          (gm < M && gk < K) ? a[static_cast<size_t>(gm) * K + gk] : static_cast<int8_t>(0);
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int k = i / kBN, c = i % kBN;
      const int gk = k0 + k, gn = n0 + c;
      w_b[c * kRowBytes + k] =
          (gk < K && gn < N) ? w[static_cast<size_t>(gk) * N + gn] : static_cast<int8_t>(0);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kWords; ++kw) {
      int av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = w_s[tx + 16 * j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      const float s = scale_a[gm] * scale_w[gn];
      out[static_cast<size_t>(gm) * N + gn] = static_cast<float>(acc[i][j]) * s;
    }
  }
}

}  // namespace

// a int8 [M, K], w int8 [K, N] row-major; scales float32 [M] and [N];
// out float32 [M, N].  Returns the launch's cudaError_t.
extern "C" int int8_mm_launch(const void* a, const void* w, const void* scale_a,
                              const void* scale_w, void* out, int M, int N, int K,
                              void* stream) {
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_mm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale_a), static_cast<const float*>(scale_w),
      static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
