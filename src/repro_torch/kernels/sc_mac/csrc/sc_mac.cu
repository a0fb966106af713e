// ODIN's stochastic MAC array for Hopper (sm_90a): B→S → AND → MUX tree →
// popcount, fused, one output popcount per (m, n).
//
// Replaces: the TPU kernel `sc_mac_kernel` in
//   src/repro/kernels/sc_mac/sc_mac.py:60 (launched by `sc_mac_pallas_call`,
//   same file :103; entry `ops.py:42` `sc_matmul_pallas`).  Same function:
//   out[m, n] = Σ_tiles popcount(MUXtree_bk(AND(lut_a[a[m,k]], lut_w[w[k,n]])))
//   with the tree's leaves k of one tile of bk = 2^depth, leaf pairs
//   (2j, 2j+1) muxed at level 0 as (sel0 & even) | (~sel0 & odd), and so on
//   up; leaves past K are zero streams.  One tile of K̂ is the full tree,
//   tiles of block_k the hybrid regime (int32 binary accumulate).
//
// Bound on this card: operations.  The function needs one B→S gather per
// operand element and stream word, one AND per leaf word, one mux node (a
// single LOP3) per tree node and one popcount per tile word; nothing has
// to leave the chip but the int32 popcounts, and the inputs are a few
// bytes per operand.  The count is against the INT32 issue rate (64 lanes
// per SM per clock).  This design issues two gathers per leaf word instead
// of one per operand (see "Left on the table").
//
// Design: a warp's lanes are split into groups of W = stream_len/32 lanes,
// one group per output and one lane per stream word, so each lane carries
// one 32-bit word through the whole tree.  Both LUTs (the paper's SRAM
// LUT, 8 KB each at 256×256) and the select words live in shared memory;
// B→S is a gather of row v (the TPU kernel's comparator form only avoided a
// dynamic gather on the VPU; the rows are bit-identical).  The K loop runs
// inside the thread instead of along a sequential grid axis.  The tree is
// reduced while the leaves stream in order: subtrees of G = min(bk, 32)
// leaves are fully unrolled so their partial words stay in registers, and
// the levels above them keep one pending word per level (a binary-counter
// stack).  The W lanes' popcounts are summed with shuffles at the end.
//
// Left on the table: every lane re-reads its operands a[m,k] and w[k,n]
// (L1 hits, shared by the W lanes of a group), and the w streams of a
// column are gathered again for every row; a tiled kernel with w's streams
// staged in shared memory once per column tile comes later.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 24;

__device__ __forceinline__ uint32_t mux(uint32_t sel, uint32_t even, uint32_t odd) {
  return (sel & even) | (~sel & odd);  // one LOP3
}

template <typename T>
struct Leaves {
  const T* a_row;           // a + m·K
  const T* w_col;           // w + n
  const uint32_t* lut_a;    // shared [L, W]
  const uint32_t* lut_w;
  int K, N, L, W, word;

  __device__ __forceinline__ uint32_t operator()(int k) const {
    if (k >= K) return 0u;  // zero padding up to the tile
    int va = static_cast<int>(a_row[k]);
    int vw = static_cast<int>(w_col[static_cast<size_t>(k) * N]);
    va = min(max(va, 0), L - 1);  // the JAX gather clamps, so does this one
    vw = min(max(vw, 0), L - 1);
    return lut_a[va * W + word] & lut_w[vw * W + word];
  }
};

// MUX subtree over the 2^LOG_G leaves k0 .. k0 + 2^LOG_G - 1.  Unrolled:
// j is a constant in each copy, so every stack index is static.
template <int LOG_G, typename T>
__device__ __forceinline__ uint32_t subtree(const Leaves<T>& leaf, int k0,
                                            const uint32_t (&sel)[5]) {
  uint32_t st[LOG_G];
  uint32_t root = 0u;
#pragma unroll
  for (int j = 0; j < (1 << LOG_G); ++j) {
    uint32_t x = leaf(k0 + j);
    bool stored = false;
#pragma unroll
    for (int l = 0; l < LOG_G; ++l) {
      if (!stored) {
        if ((j >> l) & 1) {
          x = mux(sel[l], st[l], x);
        } else {
          st[l] = x;
          stored = true;
        }
      }
    }
    if (!stored) root = x;  // the last leaf closes the subtree
  }
  return root;
}

template <typename T, int LOG_G>
__global__ void __launch_bounds__(kThreads)
sc_mac_kernel(const T* __restrict__ a, const T* __restrict__ w,
              const uint32_t* __restrict__ lut_a_g, const uint32_t* __restrict__ lut_w_g,
              const uint32_t* __restrict__ selects_g, int* __restrict__ out,
              int M, int N, int K, int L, int log_w, int bk_log, int n_tiles) {
  extern __shared__ uint32_t smem[];
  const int W = 1 << log_w;
  uint32_t* lut_a = smem;              // [L, W]
  uint32_t* lut_w = lut_a + L * W;     // [L, W]
  uint32_t* sel_s = lut_w + L * W;     // [bk_log, W]
  for (int i = threadIdx.x; i < L * W; i += blockDim.x) {
    lut_a[i] = lut_a_g[i];
    lut_w[i] = lut_w_g[i];
  }
  for (int i = threadIdx.x; i < bk_log * W; i += blockDim.x) sel_s[i] = selects_g[i];
  __syncthreads();

  const long long MN = static_cast<long long>(M) * N;
  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int word = static_cast<int>(gid & (W - 1));
  long long o = gid >> log_w;
  const bool valid = o < MN;
  if (!valid) o = MN - 1;  // idle lanes still take part in the shuffles
  const int m = static_cast<int>(o / N);
  const int n = static_cast<int>(o - static_cast<long long>(m) * N);
  const Leaves<T> leaf{a + static_cast<size_t>(m) * K, w + n, lut_a, lut_w, K, N, L, W, word};

  uint32_t sel[5];
#pragma unroll
  for (int l = 0; l < 5; ++l) sel[l] = l < bk_log ? sel_s[l * W + word] : 0u;

  const int groups = 1 << (bk_log - LOG_G);  // subtrees per tile
  int acc = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int k_tile = t << bk_log;
    uint32_t pending[kMaxLevels];  // one word waiting at each upper level
    uint32_t x = 0u;
    for (int g = 0; g < groups; ++g) {
      x = subtree<LOG_G>(leaf, k_tile + (g << LOG_G), sel);
      int lvl = LOG_G;
      for (int gg = g; gg & 1; gg >>= 1, ++lvl) x = mux(sel_s[lvl * W + word], pending[lvl], x);
      pending[lvl] = x;
    }
    acc += __popc(x);  // x is the tile's root after the last subtree
  }
  for (int off = W >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (valid && word == 0) out[o] = acc;
}

template <typename T>
int launch_t(const void* a, const void* w, const void* lut_a, const void* lut_w,
             const void* selects, void* out, int M, int N, int K, int L, int log_w,
             int bk_log, int n_tiles, cudaStream_t stream) {
  const int W = 1 << log_w;
  const size_t smem = static_cast<size_t>(2 * L * W + bk_log * W) * sizeof(uint32_t);
  const long long threads = static_cast<long long>(M) * N * W;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const int log_g = bk_log < 5 ? bk_log : 5;
  auto go = [&](auto kernel) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(w),
        static_cast<const uint32_t*>(lut_a), static_cast<const uint32_t*>(lut_w),
        static_cast<const uint32_t*>(selects), static_cast<int*>(out), M, N, K, L, log_w,
        bk_log, n_tiles);
    return static_cast<int>(cudaGetLastError());
  };
  switch (log_g) {
    case 1: return go(sc_mac_kernel<T, 1>);
    case 2: return go(sc_mac_kernel<T, 2>);
    case 3: return go(sc_mac_kernel<T, 3>);
    case 4: return go(sc_mac_kernel<T, 4>);
    case 5: return go(sc_mac_kernel<T, 5>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// a [M, K] and w [K, N] row-major (dtype 0: uint8, 1: int32); LUTs [L, W]
// and selects [≥bk_log, W] as 32-bit words; out int32 [M, N].  Tiles of
// 2^bk_log leaves, n_tiles of them (1 for the full tree).  Returns the
// launch's cudaError_t.
extern "C" int sc_mac_launch(const void* a, const void* w, const void* lut_a,
                             const void* lut_w, const void* selects, void* out, int M, int N,
                             int K, int L, int log_w, int bk_log, int n_tiles, int dtype,
                             void* stream) {
  if (log_w < 0 || log_w > 5 || bk_log < 1 || bk_log >= kMaxLevels || n_tiles < 1 ||
      M < 1 || N < 1 || K < 1 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_t<uint8_t>(a, w, lut_a, lut_w, selects, out, M, N, K, L, log_w, bk_log,
                               n_tiles, s);
    case 1:
      return launch_t<int32_t>(a, w, lut_a, lut_w, selects, out, M, N, K, L, log_w, bk_log,
                               n_tiles, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
