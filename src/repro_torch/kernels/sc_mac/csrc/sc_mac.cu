// ODIN's stochastic MAC array for Hopper (sm_90a): B→S → AND → MUX tree →
// popcount, as a masked AND-OR product split across CTAs along K.
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
// The identity the design rests on.  A MUX tree with fixed select streams
// takes each bit of its root from exactly one leaf: level l passes the even
// child where sel_l has a 1, so bit b of the root is bit b of the leaf p
// whose bit l is 1 - sel_l[b] at every level.  With the leaf masks
//   M_p = AND_l (bit_l(p) ? ~sel_l : sel_l),
// disjoint within a tree and covering every bit,
//   root = OR_p (M_p & a_p & w_p),  popcount(root) = Σ_p popcount(M_p & a_p & w_p),
// so out[m, n] = Σ_k popcount(M_{k mod bk} & lut_a[a[m,k]] & lut_w[w[k,n]]) in
// both regimes.  A leaf word costs one LOP3 (acc |= s & b); a popcount
// closes every group of G = min(bk, 32) leaves (summing popcounts of parts
// of one tree is exact, since the parts' masks are disjoint).  The sum may
// be cut anywhere along K, so K splits need no combine pass: their int32
// partial popcounts add in any order.
//
// Bound on this card: operations.  One AND-OR per leaf word, a popcount
// per tree word and one B→S gather per operand element and word, against
// the INT32 lane rate (64 lanes per SM per clock); the bytes (uint8
// operands, int32 popcounts) take less.  The MUX tree as drawn (an AND per
// leaf word and a mux per node) counts twice the operations.
//
// Design (the host plan `sc_plan` in sc_mac.py fixes every size from the
// shapes alone):
// * Roles.  The tile's rows come from the smaller operand ("S": a's rows,
//   or w's columns when M > N) and its columns from the larger ("B").  A CTA
//   owns MM rows × NT = 4·cs columns and a run of 32-leaf chunks of K (its
//   split); the grid is row blocks × column blocks × splits, row blocks
//   fastest so the CTAs that share a B tile run together.
// * Each stream is gathered once per CTA.  S's streams for a chunk are
//   gathered once, pre-masked with M_k, into shared memory.  A thread owns
//   one word pair and 4 columns: it gathers each B stream pair once per
//   leaf (one 8-byte load from B's LUT) and uses it for all MM rows, whose
//   pre-masked words it reads as broadcasts.  B's LUT is held in 32/W
//   copies a row, and the lanes of one half-warp read different copies, so
//   the random gathers meet no bank conflict.
// * B is staged coalesced.  Where B is uint8 w with 16-byte aligned rows,
//   each chunk's [32, NT] tile comes in as 16-byte loads, issued one chunk
//   ahead into registers while the current chunk computes, clamped four
//   bytes at a time and widened to 16-bit levels in a two-stage ring;
//   otherwise (int32 operands, or a's rows as columns) elements are loaded,
//   clamped and stored in pairs.
// * Splits.  When the plan cuts K, the launch zeroes out and every CTA adds
//   its popcounts with atomicAdd; integer addition makes the result exact
//   and independent of order.  Otherwise CTAs store.
//
// Left on the table: the b1 AND-popc tensor-core MMA applies to the masked
// form (out is an AND-popcount product over K·stream_len bits), but at the
// 2-row decode shapes the B→S gathers, not the MACs, take the time; the
// four rail products of a signed layer are four launches that gather the
// same w streams twice each (w⁺ and w⁻ against a⁺ and a⁻); a grid of a few
// CTAs (CNN1's 64×70×10 layer: 9) waits on each CTA's fixed chain of table
// fill, staging and one chunk.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;       // leaves a chunk: the K step and the unit of a split
constexpr int kNN = 4;           // columns a thread
constexpr int kMaxThreads = 256;
constexpr int kMaxLevels = 24;

struct Plan {
  const void* s;                 // S(r, k) = s[r·s_row + k·s_k]: the tile's rows
  long long s_row, s_k;
  const void* b;                 // B(k, c) = b[k·b_k + c·b_col]: its columns
  long long b_k, b_col;
  const uint32_t* lut_s;         // [L, W]
  const uint32_t* lut_b;         // [L, W]
  const uint32_t* selects;       // [depth, W]
  int* out;                      // out(r, c) = out[r·o_row + c·o_col]
  long long o_row, o_col;
  int rows, cols, K, L, W, log_w, depth, dtype;
  int row_blocks, col_blocks, chunks, chunks_per_split;
  int cs;                        // column slots a CTA: threads = cs·W/2, NT = 4·cs
  int rep;                       // copies of a row of B's LUT (32/W, or 1)
  int vec;                       // B tile by 16-byte loads
  int atomic;                    // add into a zeroed out (K is split)
};

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Byte offsets of the shared-memory regions; host and device agree, and
// sc_mac.py smem_bytes mirrors the total for the wrapper's check.
struct Layout {
  size_t lut_b, lut_s, masks, sel, btile, bstage, stile, sstage, total;
  __host__ __device__ Layout(int L, int W, int rep, int depth, int nt, int mm) {
    lut_b = 0;
    lut_s = align16(static_cast<size_t>(L) * rep * W * 4);
    masks = lut_s + align16(static_cast<size_t>(L) * W * 4);
    sel = masks + align16(static_cast<size_t>(kChunk) * W * 4);
    btile = sel + align16(static_cast<size_t>(depth) * W * 4);
    bstage = align16(static_cast<size_t>(kChunk) * nt * 2);
    stile = btile + 2 * bstage;
    sstage = align16(static_cast<size_t>(W / 2) * (kChunk * mm * 2 + 2) * 4);
    total = stile + 2 * sstage;
  }
};

__device__ __forceinline__ int load_level(const void* p, long long i, int dtype, int L) {
  const int v = dtype == 0 ? static_cast<int>(static_cast<const uint8_t*>(p)[i])
                           : static_cast<const int32_t*>(p)[i];
  return min(max(v, 0), L - 1);  // the JAX gather clamps, so does this one
}

// Level of S(r0 + e/32, k0 + e%32) for staging thread e < MM·32, or -1 (a
// zero stream: a row past the tile or a leaf past K).
template <int MM>
__device__ __forceinline__ int fetch_s(const Plan& p, int r0, int k0) {
  const int e = threadIdx.x;
  if (e >= MM * kChunk) return -1;
  const int r = r0 + (e >> 5), k = k0 + (e & 31);
  if (r >= p.rows || k >= p.K) return -1;
  return load_level(p.s, r * p.s_row + k * p.s_k, p.dtype, p.L);
}

// S's streams of one chunk, masked with M_k: word 2·wp + h of (row m, leaf
// k) at stile[wp·(64·MM + 2) + (k·MM + m)·2 + h].  The 2 words of padding a
// word pair put the pairs in different banks for the broadcast reads.
template <int MM>
__device__ __forceinline__ void stage_s(const Plan& p, int level, int k0, uint32_t* stile,
                                        const uint32_t* lut_s, const uint32_t* masks,
                                        const uint32_t* sel) {
  const int e = threadIdx.x;
  if (e >= MM * kChunk) return;
  const int m = e >> 5, k = e & 31, W = p.W;
  // bits ≥ 5 of the chunk's leaf position in its tree (trees longer than a chunk)
  const int hi = (k0 & ((1 << p.depth) - 1)) >> 5;
  for (int wp = 0; wp < W / 2; ++wp) {
    uint2 x = make_uint2(0u, 0u);
    if (level >= 0) {
      x = *reinterpret_cast<const uint2*>(lut_s + level * W + 2 * wp);
      const uint2 mk = *reinterpret_cast<const uint2*>(masks + k * W + 2 * wp);
      x.x &= mk.x;
      x.y &= mk.y;
      for (int l = 5; l < p.depth; ++l) {
        const uint2 s = *reinterpret_cast<const uint2*>(sel + l * W + 2 * wp);
        const bool odd = (hi >> (l - 5)) & 1;
        x.x &= odd ? ~s.x : s.x;
        x.y &= odd ? ~s.y : s.y;
      }
    }
    *reinterpret_cast<uint2*>(stile + wp * (kChunk * MM * 2 + 2) + (k * MM + m) * 2) = x;
  }
}

// 16 consecutive uint8 columns of one leaf row: unit u of the chunk at k0
// (zero past K or the last column).
__device__ __forceinline__ uint4 fetch_b16(const Plan& p, int u, int c0, int k0, int nt) {
  const int per_row = nt >> 4;
  const int k = k0 + u / per_row, c = c0 + (u % per_row) * 16;
  if (k >= p.K || c >= p.cols) return make_uint4(0u, 0u, 0u, 0u);
  return __ldg(reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(p.b) +
                                              static_cast<long long>(k) * p.b_k + c));
}

// Clamp 16 levels to L-1 four bytes at a time and widen them to 16 bits.
__device__ __forceinline__ void store_b16(const uint4 x, int u, int nt, uint16_t* tile,
                                          uint32_t clampv) {
  const int per_row = nt >> 4;
  const int k = u / per_row, c = (u % per_row) * 16;
  const uint32_t in[4] = {x.x, x.y, x.z, x.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t v = __vminu4(in[i], clampv);
    o[2 * i] = __byte_perm(v, 0u, 0x4140);      // bytes 0, 1 → two 16-bit levels
    o[2 * i + 1] = __byte_perm(v, 0u, 0x4342);  // bytes 2, 3
  }
  uint4* dst = reinterpret_cast<uint4*>(tile + k * nt + c);
  dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
  dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// The [32, NT] tile of B's levels for the chunk at k0, two columns a store,
// eight pairs a thread in flight.
__device__ __forceinline__ void stage_b_pairs(const Plan& p, int c0, int k0, int nt,
                                              uint16_t* tile) {
  constexpr int kBatch = 8;
  const int half_nt = nt >> 1, n = kChunk * half_nt, step = blockDim.x;
  for (int base = threadIdx.x; base < n; base += kBatch * step) {
    uint32_t lo[kBatch], hi[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * step;
      const int kk = k0 + i / half_nt, cc = c0 + (i % half_nt) * 2;
      lo[j] = hi[j] = 0u;
      if (i < n && kk < p.K) {
        const long long row = static_cast<long long>(kk) * p.b_k;
        if (cc < p.cols) lo[j] = load_level(p.b, row + cc * p.b_col, p.dtype, p.L);
        if (cc + 1 < p.cols) hi[j] = load_level(p.b, row + (cc + 1) * p.b_col, p.dtype, p.L);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * step;
      if (i < n) reinterpret_cast<uint32_t*>(tile)[i] = lo[j] | (hi[j] << 16);  // (k, c/2)
    }
  }
}

// A table of `words` 32-bit words bound for shared memory: word f (row
// f/W, word f%W) goes to dst[(f/W)·row_words + r·W + f%W] for each copy
// r < rep.
struct Table {
  uint32_t* dst;
  const uint32_t* src;
  int words, row_words, rep;
};

__device__ __forceinline__ void put_words(const Table& t, int f, const uint32_t* v, int n,
                                          int log_w) {
  const int W = 1 << log_w;
  for (int i = 0; i < n; ++i)
    for (int r = 0; r < t.rep; ++r)
      t.dst[((f + i) >> log_w) * t.row_words + r * W + ((f + i) & (W - 1))] = v[i];
}

// Copy the tables with 16-byte loads (word by word from an unaligned
// source): the first four 16-byte pieces a thread of every table are all in
// flight before the first store.
template <int NT_>
__device__ __forceinline__ void copy_tables(const Table (&t)[NT_], int log_w) {
  constexpr int kIn = 4;
  const int W = 1 << log_w, step = blockDim.x, tid = threadIdx.x;
  int n4[NT_];
  uint4 x[NT_][kIn];
#pragma unroll
  for (int i = 0; i < NT_; ++i) {
    n4[i] = (reinterpret_cast<uintptr_t>(t[i].src) & 15) ? 0 : t[i].words >> 2;
#pragma unroll
    for (int j = 0; j < kIn; ++j)
      if (tid + j * step < n4[i])
        x[i][j] = __ldg(reinterpret_cast<const uint4*>(t[i].src) + tid + j * step);
  }
#pragma unroll
  for (int i = 0; i < NT_; ++i) {
    auto put = [&](const uint4 y, int q) {
      const int f = 4 * q;
      if (W >= 4) {  // the 4 words lie in one row: one 16-byte store a copy
        for (int r = 0; r < t[i].rep; ++r)
          *reinterpret_cast<uint4*>(t[i].dst + (f >> log_w) * t[i].row_words + r * W +
                                    (f & (W - 1))) = y;
      } else {
        const uint32_t v[4] = {y.x, y.y, y.z, y.w};
        put_words(t[i], f, v, 4, log_w);
      }
    };
#pragma unroll
    for (int j = 0; j < kIn; ++j)
      if (tid + j * step < n4[i]) put(x[i][j], tid + j * step);
    for (int q = tid + kIn * step; q < n4[i]; q += step)
      put(__ldg(reinterpret_cast<const uint4*>(t[i].src) + q), q);
    for (int f = 4 * n4[i] + tid; f < t[i].words; f += step) {
      const uint32_t v = __ldg(t[i].src + f);
      put_words(t[i], f, &v, 1, log_w);
    }
  }
}

// One chunk: for each leaf, gather the 4 columns' stream pairs from B's
// LUT once and AND-OR them with every row's masked S pair; a popcount
// closes each group of G leaves.
template <int MM, int G>
__device__ __forceinline__ void mac_chunk(const uint16_t* __restrict__ bt, int nt,
                                          const uint32_t* __restrict__ st,
                                          const unsigned char* __restrict__ lut, int row_bytes,
                                          uint32_t (&orw)[MM][kNN][2], int (&acc)[MM][kNN]) {
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const uint2 lv = *reinterpret_cast<const uint2*>(bt + k * nt);
    const uint32_t v[kNN] = {lv.x & 0xffffu, lv.x >> 16, lv.y & 0xffffu, lv.y >> 16};
    uint2 bw[kNN];
#pragma unroll
    for (int n = 0; n < kNN; ++n)
      bw[n] = *reinterpret_cast<const uint2*>(lut + v[n] * row_bytes);
#pragma unroll
    for (int m = 0; m < MM; ++m) {
      const uint2 s = *reinterpret_cast<const uint2*>(st + (k * MM + m) * 2);
#pragma unroll
      for (int n = 0; n < kNN; ++n) {
        orw[m][n][0] |= s.x & bw[n].x;
        orw[m][n][1] |= s.y & bw[n].y;
      }
    }
    if ((k + 1) % G == 0) {
#pragma unroll
      for (int m = 0; m < MM; ++m)
#pragma unroll
        for (int n = 0; n < kNN; ++n) {
          acc[m][n] += __popc(orw[m][n][0]) + __popc(orw[m][n][1]);
          orw[m][n][0] = orw[m][n][1] = 0u;
        }
    }
  }
}

template <int MM, int G>
__global__ void __launch_bounds__(kMaxThreads, 2) sc_mac_kernel(const Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = p.W, half = W >> 1, nt = p.cs * kNN, tid = threadIdx.x;
  const Layout lay(p.L, W, p.rep, p.depth, nt, MM);
  uint32_t* lut_b = reinterpret_cast<uint32_t*>(smem + lay.lut_b);
  uint32_t* lut_s = reinterpret_cast<uint32_t*>(smem + lay.lut_s);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + lay.masks);
  uint32_t* sel = reinterpret_cast<uint32_t*>(smem + lay.sel);
  uint16_t* btile = reinterpret_cast<uint16_t*>(smem + lay.btile);
  uint32_t* stile = reinterpret_cast<uint32_t*>(smem + lay.stile);
  const int bstage = static_cast<int>(lay.bstage / 2), sstage = static_cast<int>(lay.sstage / 4);

  int bid = blockIdx.x;
  const int rb = bid % p.row_blocks;
  bid /= p.row_blocks;
  const int cb = bid % p.col_blocks, split = bid / p.col_blocks;
  const int r0 = rb * MM, c0 = cb * nt;
  const int c_begin = split * p.chunks_per_split;
  const int c_end = min(c_begin + p.chunks_per_split, p.chunks);

  // Tables: B's LUT with `rep` copies of each row, S's LUT, the select rows;
  // the first chunk's loads; then the masks of the low five levels for a
  // chunk's 32 leaf positions; then S's first chunk, which needs them.
  const int row_words = p.rep * W, k0 = c_begin * kChunk;
  const uint32_t clampv = p.L >= 256 ? 0xffffffffu : static_cast<uint32_t>(p.L - 1) * 0x01010101u;
  const int units = 2 * nt;  // 16-byte units of a B tile; at most 2 a thread (vec: W ≥ 8)
  const int step = blockDim.x;
  const int s_first = fetch_s<MM>(p, r0, k0);
  uint4 x0 = make_uint4(0u, 0u, 0u, 0u), x1 = x0;
  if (p.vec) {
    if (tid < units) x0 = fetch_b16(p, tid, c0, k0, nt);
    if (tid + step < units) x1 = fetch_b16(p, tid + step, c0, k0, nt);
  }
  const Table tables[3] = {{lut_b, p.lut_b, p.L * W, row_words, p.rep},
                           {lut_s, p.lut_s, p.L * W, W, 1},
                           {sel, p.selects, p.depth * W, W, 1}};
  copy_tables(tables, p.log_w);
  if (p.vec) {
    if (tid < units) store_b16(x0, tid, nt, btile, clampv);
    if (tid + step < units) store_b16(x1, tid + step, nt, btile, clampv);
  } else {
    stage_b_pairs(p, c0, k0, nt, btile);
  }
  __syncthreads();
  const int low = min(p.depth, 5);
  for (int i = tid; i < kChunk * W; i += step) {
    const int j = i >> p.log_w, w = i & (W - 1);
    uint32_t m = ~0u;
    for (int l = 0; l < low; ++l) m &= ((j >> l) & 1) ? ~sel[l * W + w] : sel[l * W + w];
    masks[i] = m;
  }
  __syncthreads();
  stage_s<MM>(p, s_first, k0, stile, lut_s, masks, sel);
  __syncthreads();

  const int wg = tid & (half - 1), slot = tid / half;
  const int row_bytes = row_words * 4;
  const unsigned char* lut = reinterpret_cast<const unsigned char*>(lut_b) +
                             ((slot & (p.rep - 1)) * W + wg * 2) * 4;
  uint32_t orw[MM][kNN][2];
  int acc[MM][kNN];
#pragma unroll
  for (int m = 0; m < MM; ++m)
#pragma unroll
    for (int n = 0; n < kNN; ++n) {
      orw[m][n][0] = orw[m][n][1] = 0u;
      acc[m][n] = 0;
    }

  for (int c = c_begin; c < c_end; ++c) {
    const int cur = (c - c_begin) & 1, nxt = cur ^ 1;
    const bool more = c + 1 < c_end;
    const int k1 = (c + 1) * kChunk;
    uint4 pre0 = make_uint4(0u, 0u, 0u, 0u), pre1 = pre0;
    int pre_s = -1;
    if (more) {  // the next chunk's loads fly while this one computes
      if (p.vec) {
        if (tid < units) pre0 = fetch_b16(p, tid, c0, k1, nt);
        if (tid + step < units) pre1 = fetch_b16(p, tid + step, c0, k1, nt);
      }
      pre_s = fetch_s<MM>(p, r0, k1);
    }
    mac_chunk<MM, G>(btile + cur * bstage + slot * kNN, nt,
                     stile + cur * sstage + wg * (kChunk * MM * 2 + 2), lut, row_bytes, orw,
                     acc);
    if (more) {
      uint16_t* bn = btile + nxt * bstage;
      if (p.vec) {
        if (tid < units) store_b16(pre0, tid, nt, bn, clampv);
        if (tid + step < units) store_b16(pre1, tid + step, nt, bn, clampv);
      } else {
        stage_b_pairs(p, c0, k1, nt, bn);
      }
      stage_s<MM>(p, pre_s, k1, stile + nxt * sstage, lut_s, masks, sel);
    }
    __syncthreads();
  }

  // An output's W/2 word pairs sit in consecutive lanes of one warp.
#pragma unroll
  for (int m = 0; m < MM; ++m)
#pragma unroll
    for (int n = 0; n < kNN; ++n)
      for (int off = half >> 1; off > 0; off >>= 1)
        acc[m][n] += __shfl_xor_sync(0xffffffffu, acc[m][n], off);
  if (wg != 0) return;
#pragma unroll
  for (int m = 0; m < MM; ++m)
#pragma unroll
    for (int n = 0; n < kNN; ++n) {
      const int r = r0 + m, cc = c0 + slot * kNN + n;
      if (r < p.rows && cc < p.cols) {
        int* o = p.out + r * p.o_row + cc * p.o_col;
        if (p.atomic)
          atomicAdd(o, acc[m][n]);
        else
          *o = acc[m][n];
      }
    }
}

template <int MM, int G>
int go(const Plan& p, int threads, unsigned blocks, size_t smem, cudaStream_t stream) {
  static size_t smem_set = 48 * 1024;  // dynamic shared memory the kernel may take
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        sc_mac_kernel<MM, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  sc_mac_kernel<MM, G><<<blocks, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a [M, K] and w [K, N] row-major (dtype 0: uint8, 1: int32); LUTs [L, W]
// and selects [≥bk_log, W] as 32-bit words, W = 2^log_w ≥ 2; out int32
// [M, N].  Trees of 2^bk_log leaves.  The plan (sc_mac.py sc_plan): swap
// (tile rows from w's columns), mm rows and 4·cs columns a CTA, K cut into
// n_splits runs of chunks_per_split chunks of 32 leaves, popcounts every
// `group` leaves, `rep` copies of a row of B's LUT.  Returns the launch's
// cudaError_t.
extern "C" int sc_mac_launch(const void* a, const void* w, const void* lut_a,
                             const void* lut_w, const void* selects, void* out, int M, int N,
                             int K, int L, int log_w, int bk_log, int dtype, int swap, int mm,
                             int cs, int chunks_per_split, int n_splits, int rep, int group,
                             void* stream) {
  const int W = 1 << log_w;
  const int threads = cs * (W / 2);
  if (log_w < 1 || log_w > 5 || bk_log < 1 || bk_log >= kMaxLevels || M < 1 || N < 1 ||
      K < 1 || L < 1 || (dtype != 0 && dtype != 1) || (mm != 2 && mm != 4) || cs < 1 ||
      (cs & (cs - 1)) || threads < 32 || threads > kMaxThreads || (threads & 31) ||
      (rep != 1 && rep != 32 / W) || chunks_per_split < 1 || n_splits < 1 ||
      (group != 2 && group != 8 && group != 32) || group > (1 << bk_log))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p{};
  if (!swap) {
    p.s = a; p.s_row = K; p.s_k = 1; p.lut_s = static_cast<const uint32_t*>(lut_a);
    p.b = w; p.b_k = N; p.b_col = 1; p.lut_b = static_cast<const uint32_t*>(lut_w);
    p.rows = M; p.cols = N; p.o_row = N; p.o_col = 1;
  } else {
    p.s = w; p.s_row = 1; p.s_k = N; p.lut_s = static_cast<const uint32_t*>(lut_w);
    p.b = a; p.b_k = 1; p.b_col = K; p.lut_b = static_cast<const uint32_t*>(lut_a);
    p.rows = N; p.cols = M; p.o_row = 1; p.o_col = N;
  }
  p.selects = static_cast<const uint32_t*>(selects);
  p.out = static_cast<int*>(out);
  p.K = K; p.L = L; p.W = W; p.log_w = log_w; p.depth = bk_log; p.dtype = dtype;
  const int nt = cs * kNN;
  p.row_blocks = (p.rows + mm - 1) / mm;
  p.col_blocks = (p.cols + nt - 1) / nt;
  p.chunks = (K + kChunk - 1) / kChunk;
  p.chunks_per_split = chunks_per_split;
  if (static_cast<long long>(n_splits) * chunks_per_split < p.chunks ||
      static_cast<long long>(n_splits - 1) * chunks_per_split >= p.chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  p.cs = cs; p.rep = rep;
  p.vec = !swap && dtype == 0 && N % 16 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0 &&
          W >= 8;
  p.atomic = n_splits > 1;
  const long long blocks = static_cast<long long>(p.row_blocks) * p.col_blocks * n_splits;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Layout(L, W, rep, bk_log, nt, mm).total;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.atomic) {
    const cudaError_t e =
        cudaMemsetAsync(out, 0, static_cast<size_t>(M) * N * sizeof(int), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned nb = static_cast<unsigned>(blocks);
  switch (mm * 100 + group) {
    case 202: return go<2, 2>(p, threads, nb, smem, s);
    case 208: return go<2, 8>(p, threads, nb, smem, s);
    case 232: return go<2, 32>(p, threads, nb, smem, s);
    case 402: return go<4, 2>(p, threads, nb, smem, s);
    case 408: return go<4, 8>(p, threads, nb, smem, s);
    case 432: return go<4, 32>(p, threads, nb, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
