// Chunked-prefill attention over the paged KV block pool, for Hopper
// (sm_90a): flash attention on the tensor cores (wgmma), reading each
// slot's live K/V rows in place through its block table.
//
// Replaces: no Pallas kernel.  The JAX package runs this core in jnp
// (src/repro/nn/attention.py `_paged_gqa_core`, inline: gather every page
// of each slot's table, mask, dense float32 attention); the port ran the
// same gather + float32 `sdpa` (`_gather_attend`) on the card until this
// kernel.  Same
// function: for slot b and KV head h, the S-row query tile q[b, :, h·G:(h+1)·G]
// (G query heads a KV head), of which the last q_lens[b] rows are real (all
// S without q_lens); row i sits at absolute position lengths[b] − S + i and
// attends causally, with an optional sliding window, to the slot's keys
// 0 … min(lengths[b], P·bs) − 1, read through tables[b].  int8 pools are
// dequantised by kv_mul = 1/kv_scale.  Pad rows, and real rows with no
// visible key, give exactly 0.
//
// Bound on this card: operations for the rows of a long chunk (a 512-row
// chunk at positions 1,024–1,536 does ≈ 4·512·G·1,280·D·Hkv flops against
// ≈ 2·1,536·Hkv·D·2 bytes of live K/V, far above the 295 flops a byte where
// an H100 stops being bound by its 3.35 TB/s), bytes for a tile that is
// mostly pad rows (its output is written whole, zeros included); the
// latency of one item's chain of key blocks when few items are real.
//
// Design.  Work items (row tile, slot, KV head) from the shapes alone: an
// item is kM = 64 packed query rows (row i·G + g is query i, head h·G + g,
// so the G heads of a KV head share every K/V tile), one warpgroup of four
// warps, 16 rows a warp.  Persistent CTAs, two an SM (the wrapper's plan),
// walk the items gridDim.x apart, in order of decreasing work (every slot's
// last tile first, its rows see the most keys), twice: first computing the
// items with real rows and skipping the others, then storing the zeros of
// the items of pad rows; so the real items start at once.  (With one slot
// of real rows, as in a mixed tile of one prompt chunk, the walk gives no
// CTA two of its items.)  A CTA reads lengths[b] and q_lens[b] itself; a
// live item walks only the key blocks of kN = 64 keys (aligned to absolute
// key 0) from the first its window keeps to the last its last real row can
// see.
//   * K/V: a two-stage ring in shared memory (one block computed while the
//     next lands), filled by TMA: a lane of warp 0 a page copies its bs rows
//     of the head (two boxes of 64 bf16 values, or one of D int8 values)
//     into the stage, completing on the stage's mbarrier; the lanes read the
//     pages' block ids from the table one block ahead of the copies that use
//     them.  A key block is 64 / bs whole pages (bs divides 64); rows past
//     the slot's visible length are loaded and masked (the pool holds finite
//     values).  Every bf16 tile is in wgmma's 128-byte-swizzled canonical
//     layout (64-value panels of 128-byte rows, 16-byte chunks XOR-ed with
//     row % 8), which TMA's 128-byte swizzle writes.  An int8 stage is
//     converted once into bf16 tiles (exact: an int8 value times 1/16 fits
//     bf16's 8 bits).  The query rows come in by 16-byte cp.async copies.
//   * S = Q·Kᵀ: wgmma m64n64k16, Q and K (both K-major) from shared memory,
//     float32 accumulators: the product of two bf16 values is exact in
//     float32, so the scores lose nothing but the order of the sum against
//     the float32 einsum.
//   * Online softmax in float32 registers, in base 2 (exp2(s·scale·log2(e)
//     − m) by one FFMA and one MUFU ex2), per row; a masked score adds
//     exactly 0 and a block with nothing visible leaves (m, l, acc)
//     untouched, so a row's result does not depend on its tile, on S or on
//     the other slots.  A block that every real row of a warp sees whole
//     skips the mask.
//   * O += P·V: wgmma m64n{D}k16, P from registers, V (MN-major) from shared
//     memory.  P keeps float32-like precision: it is split into hi = bf16(P)
//     and lo = bf16(P − hi), two products into one float32 accumulator (P =
//     hi + lo to 2^-16 relative).
// Left on the table (PERF.md §6 has the times): a warpgroup waits for each
// product before the softmax that needs it (no second warpgroup to
// ping-pong with; issuing the next block's QKᵀ under this block's softmax
// was slower here, ptxas serialising the products), so a 64 x 64 block
// takes ≈ 2 µs alone and an SM reaches about a quarter of the tensor cores'
// rate; the P split doubles the PV products; each row tile of a KV head
// reads the keys it needs again (from L2); one item's key blocks run in
// order on one CTA, so the last tile of a long slot sets the time when few
// items are real (a key split across CTAs would need a combine).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // one warpgroup
constexpr int kM = 64;         // packed query rows an item (16 a warp)
constexpr int kN = 64;         // keys a block
constexpr int kStages = 2;     // K/V blocks in shared memory (one computed, one loading)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy; src_bytes == 0 zero-fills the destination and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
// a TMA box of the pool (values c0 … of pool row c1 …) into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma: a 128-byte-swizzled operand in shared memory, offsets in 16 bytes
__device__ __forceinline__ uint64_t wg_desc(const void* p, int lbo, int sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo & 0x3FFF) << 16) |
         (static_cast<uint64_t>(sbo & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d += a · B over 16 of K (the PV product at D = 64), a 64 x 16 bf16 from
// registers (warp w's rows 16w … 16w + 15, mma.sync's A layout), B (N = 64,
// MN-major) from shared memory; d [8][4] is mma.sync's C layout for each 8
// columns.  (The registers of a and d belong to the product until
// wgmma.wait_group.)
__device__ __forceinline__ void wgmma_n64_mn(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (+)= A · B over 16 of K, N = 64, both K-major from shared memory (the
// QKᵀ product: A the query rows, B the keys)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// the same with N = 128, B MN-major (the PV product at D = 128)
__device__ __forceinline__ void wgmma_n128_mn(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]),
        "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]),
        "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]),
        "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]),
        "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 8][4], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (D == 128) {
    wgmma_n128_mn(o, a, b);
  } else {
    wgmma_n64_mn(o, a, b);
  }
}

// 2^x in one MUFU op (relative error about 2^-22; 0 for x far below -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte offset of 16-byte chunk c (8 values) of row r in a bf16 tile of 64
// rows (query rows, K or V): wgmma's 128-byte swizzle, panels of 64 values
// (64 rows of 128 bytes)
__device__ __forceinline__ int kv_off(int r, int c) {
  return (c >> 3) * (kN * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ bool visible(int key, int pos, int window, int kv_len) {
  return key < kv_len && key <= pos && (window == 0 || key > pos - window);
}

template <typename TKV, int D>
__global__ void __launch_bounds__(kThreads, 2)
chunk_attn_kernel(const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const __nv_bfloat16* __restrict__ q,
                  const int* __restrict__ tables,
                  const int* __restrict__ lengths, const int* __restrict__ q_lens,
                  __nv_bfloat16* __restrict__ out, int B, int S, int H,
                  int Hkv, int G, int bs, int P, int n_blocks, int window, float scale2,
                  float kv_mul) {
  constexpr bool kInt8 = sizeof(TKV) == 1;
  constexpr int kRowBytes = D * static_cast<int>(sizeof(TKV));  // a pool row of one head
  constexpr int kStage = kN * kRowBytes;                          // K (or V) of one stage
  // TMA boxes: a page's rows of 64 bf16 values (one 128-byte swizzle panel)
  // or of the whole int8 head row (unswizzled), kBoxes a page
  constexpr int kBox = kInt8 ? D : 64;
  constexpr int kBoxes = D / kBox;
  constexpr int kTile = kN * D * 2;                               // a bf16 K (or V) tile
  constexpr int kKS = D / 16;                                     // k-steps of QKᵀ

  // tiles 1024-byte aligned for the swizzle
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = smem;                      // [kM][D] bf16, the query rows
  unsigned char* k_st = q_s + kTile;              // [kStages] K blocks, pool type
  unsigned char* v_st = k_st + kStages * kStage;  // [kStages] V blocks, pool type
  unsigned char* k_cv = v_st + kStages * kStage;  // int8 only: a block's bf16 K and V
  unsigned char* v_cv = k_cv + kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(kInt8 ? v_cv + kTile : k_cv);  // [kStages]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int SG = S * G;
  const int T = (SG + kM - 1) / kM;  // row tiles a (slot, KV head)
  const int n_items = T * B * Hkv;
  const int n_pages = kN / bs;  // pages a key block (bs divides 64)
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int seq = 0;  // key blocks this CTA has loaded: block n uses stage n % 2 at parity n / 2

  for (int phase = 0; phase < 2; ++phase) {  // 0: live items, 1: the zeros of the others
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int tile = T - 1 - item / (B * Hkv);
      const int bh = item % (B * Hkv);
      const int b = bh / Hkv, h = bh - b * Hkv;
      const int r0 = tile * kM;
      const int r_end = min(r0 + kM, SG);  // rows of this tile: r0 … r_end − 1
      const int len = lengths[b];
      const int ql = q_lens ? min(max(q_lens[b], 0), S) : S;
      const int first_real = (S - ql) * G;  // packed rows before it are pad rows
      const int kv_len = min(len, P * bs);
      const int row_lo = max(r0, first_real);
      const int pos0 = len - S;  // position of query row 0
      int blk_lo = 0, n_blk = 0;
      if (row_lo < r_end) {
        const int key_hi = min(pos0 + (r_end - 1) / G, kv_len - 1);
        const int key_lo = window ? max(0, pos0 + row_lo / G - window + 1) : 0;
        if (key_hi >= key_lo) {
          blk_lo = key_lo / kN;
          n_blk = key_hi / kN - blk_lo + 1;
        }
      }

      auto out_row = [&](int pr) {  // packed row → its output row
        const int i = pr / G, g = pr - i * G;
        return out + ((static_cast<size_t>(b) * S + i) * H + h * G + g) * D;
      };

      if ((n_blk == 0) != (phase == 1)) continue;  // not this phase's
      if (n_blk == 0) {  // nothing real, or nothing visible: zeros, D / 8 lanes a row
        constexpr int kLanesRow = D / 8;
        for (int r = tid / kLanesRow; r < r_end - r0; r += kThreads / kLanesRow)
          *reinterpret_cast<uint4*>(out_row(r0 + r) + (tid % kLanesRow) * 8) =
              make_uint4(0, 0, 0, 0);
        continue;
      }

      // query rows (pad rows and rows past the tile zero-filled)
      for (int t = tid; t < kM * (D / 8); t += kThreads) {
        const int r = t / (D / 8), c = t - r * (D / 8);
        const int pr = r0 + r;
        const bool ok = pr >= row_lo && pr < r_end;
        const int i = ok ? pr / G : 0, g = ok ? pr - i * G : 0;
        const __nv_bfloat16* src =
            q + ((static_cast<size_t>(b) * S + i) * H + h * G + g) * D + c * 8;
        cp_async16(q_s + kv_off(r, c), src, ok ? 16 : 0);
      }

      cp_async_commit();  // the query rows

      // warp 0 loads the key blocks: lane l takes pages l and l + 32 of a
      // block, reading their block ids from the table one block ahead of
      // the TMA copies that use them (pages past the table read its last
      // entry: their keys are masked, the pool holds finite values)
      int bid[2];
      auto load_bids = [&](int j) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int page = min((blk_lo + j) * n_pages + lane + 32 * x, P - 1);
          bid[x] = min(max(tables[static_cast<size_t>(b) * P + page], 0), n_blocks - 1);
        }
      };
      auto issue = [&](int j) {  // key block blk_lo + j, K and V, into its stage
        const int st = (seq + j) % kStages;
        if (lane == 0) mbar_expect_tx(&full[st], 2 * kStage);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int pg = lane + 32 * x;  // page of the block
          if (pg >= n_pages) continue;
#pragma unroll
          for (int w = 0; w < 2; ++w)
#pragma unroll
            for (int bx = 0; bx < kBoxes; ++bx)
              tma_load_2d((w ? v_st : k_st) + st * kStage +
                              (kInt8 ? pg * bs * kRowBytes : bx * (kN * 128) + pg * bs * 128),
                          w ? &map_v : &map_k, &full[st], h * D + bx * kBox, bid[x] * bs);
        }
      };
      if (warp == 0) {
        load_bids(0);
        issue(0);
        if (1 < n_blk) load_bids(1);
      }

      // this thread's two rows (g and g + 8 of its warp's 16) and their positions
      const int wr0 = warp * 16;
      int pos_r[2];
      bool real_r[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pr = r0 + wr0 + lane / 4 + e * 8;
        real_r[e] = pr >= row_lo && pr < r_end;
        pos_r[e] = real_r[e] ? pos0 + pr / G : -(1 << 30);  // pad: sees nothing
      }
      // the warp's real rows, for leaving the mask out of blocks they see whole
      const int w_lo = max(r0 + wr0, row_lo), w_hi = min(r0 + wr0 + 16, r_end) - 1;
      const bool w_live = w_lo <= w_hi;
      const int w_pos_lo = pos0 + w_lo / G, w_pos_hi = pos0 + w_hi / G;

      float o[D / 8][4];
      float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

      for (int j = 0; j < n_blk; ++j) {
        const int st = (seq + j) % kStages;
        mbar_wait(&full[st], ((seq + j) / kStages) & 1);  // block j landed
        if (j == 0) {  // the query rows too, before the tensor cores read them
          cp_async_wait<0>();
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        __syncthreads();
        if (warp == 0 && j + 1 < n_blk) {  // into the stage block j − 1 used
          issue(j + 1);
          if (j + 2 < n_blk) load_bids(j + 2);
        }
        const unsigned char* kt = k_st + st * kStage;
        const unsigned char* vt = v_st + st * kStage;
        if constexpr (kInt8) {  // dequantise the stage into bf16 tiles
          for (int t = tid; t < kN * (D / 8); t += kThreads) {
            const int r = t / (D / 8), c = t - r * (D / 8);
#pragma unroll
            for (int w = 0; w < 2; ++w) {
              const unsigned char* src = (w ? vt : kt) + r * kRowBytes + c * 8;
              const uint2 u = *reinterpret_cast<const uint2*>(src);
              const int8_t* e8 = reinterpret_cast<const int8_t*>(&u);
              uint4 o4;
              uint32_t* ow = reinterpret_cast<uint32_t*>(&o4);
#pragma unroll
              for (int x = 0; x < 4; ++x)
                ow[x] = pack_bf16(static_cast<float>(e8[2 * x]) * kv_mul,
                                  static_cast<float>(e8[2 * x + 1]) * kv_mul);
              *reinterpret_cast<uint4*>((w ? v_cv : k_cv) + kv_off(r, c)) = o4;
            }
          }
          kt = k_cv;
          vt = v_cv;
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncthreads();
        }

        // S = Q·Kᵀ, 64 rows × 64 keys: k-step ks reads 16 values of D, in
        // panel ks / 4 at byte 32·(ks % 4) of each 128-byte row
        float s[kN / 8][4];
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
          const int off = (ks >> 2) * (kN * 128) + (ks & 3) * 32;
          wgmma_ss_n64(s, wg_desc(q_s + off, 1, 64), wg_desc(kt + off, 1, 64), ks > 0);
        }
        wg_commit();
        wg_wait();

        // mask unless every real row of the warp sees the whole block (then
        // the mask keeps every score; pad rows are zeroed at the end)
        const int kb0 = (blk_lo + j) * kN;
        const bool whole = w_live && kb0 + kN - 1 <= w_pos_lo && kb0 + kN <= kv_len &&
                           (window == 0 || kb0 > w_pos_hi - window);
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int n = 0; n < kN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kb0 + n * 8 + (lane & 3) * 2 + (e & 1);
            if (!whole && !visible(key, pos_r[e >> 1], window, kv_len)) s[n][e] = kNegInf;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
          }
        // online softmax in base 2 on scaled scores s·scale2, per row; the
        // state m_r is scaled, the scores stay raw until exp2(s·scale2 − m)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
          mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
          mx[x] = mx[x] == kNegInf ? kNegInf : mx[x] * scale2;
          if (mx[x] > m_r[x]) {
            const float corr = ex2(m_r[x] - mx[x]);
            l_r[x] *= corr;
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
              o[n][2 * x] *= corr;
              o[n][2 * x + 1] *= corr;
            }
            m_r[x] = mx[x];
          }
        }
        // P = hi + lo in the A layout: for keys 16kk … 16kk + 15, a0/a1 hold
        // keys 16kk + 2t (rows g, g + 8), a2/a3 keys 16kk + 8 + 2t
        uint32_t ph[kN / 16][4], pl[kN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int n = 2 * kk + (x >> 1), e = (x & 1) * 2;
            const float m = m_r[x & 1];
            const float p0 = m == kNegInf ? 0.f : ex2(fmaf(s[n][e], scale2, -m));  // masked: 0
            const float p1 = m == kNegInf ? 0.f : ex2(fmaf(s[n][e + 1], scale2, -m));
            l_r[x & 1] += p0 + p1;
            const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
            ph[kk][x] = *reinterpret_cast<const uint32_t*>(&hi);
            pl[kk][x] = pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
          }
        // O += P·V: k-step kk reads keys 16kk … 16kk + 15 (two 8-row groups,
        // 1024 bytes apart; the 64-value panels of D 8192 bytes apart)
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) {
          const uint64_t dv = wg_desc(vt + kk * 16 * 128, kN * 128 / 16, 64);
          wgmma_pv<D>(o, ph[kk], dv);
          wgmma_pv<D>(o, pl[kk], dv);
        }
        wg_commit();
        wg_wait();  // the next block's barrier then frees this stage for its copies
      }
      seq += n_blk;

      // row sums over the quad, then the output in bf16 (0 for pad rows and
      // where nothing was visible)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        l_r[x] += __shfl_xor_sync(0xffffffffu, l_r[x], 1);
        l_r[x] += __shfl_xor_sync(0xffffffffu, l_r[x], 2);
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int pr = r0 + wr0 + lane / 4 + x * 8;
        if (pr >= r_end) continue;
        const bool live = real_r[x] && l_r[x] > 0.f;
        const float inv = live ? 1.f / l_r[x] : 0.f;
        __nv_bfloat16* orow = out_row(pr);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const float a = live ? o[n][2 * x] * inv : 0.f;
          const float c = live ? o[n][2 * x + 1] * inv : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + (lane & 3) * 2) =
              __floats2bfloat162_rn(a, c);
        }
      }
      __syncthreads();  // the next item's copies overwrite this one's tiles
    }
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

// a pool [n_blocks, bs, Hkv, D] as rows of Hkv·D values: boxes of bs rows
// by 64 bf16 values with the 128-byte swizzle, or by D int8 values unswizzled
template <typename TKV, int D>
bool encode(CUtensorMap* map, const void* pool, int n_blocks, int bs, int Hkv) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  constexpr bool kInt8 = sizeof(TKV) == 1;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Hkv) * D,
                              static_cast<cuuint64_t>(n_blocks) * bs};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Hkv) * D * sizeof(TKV)};
  const cuuint32_t box[2] = {kInt8 ? D : 64, static_cast<cuuint32_t>(bs)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(pool), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            kInt8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TKV, int D>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
           const void* lengths, const void* q_lens, void* out, int B, int S, int H,
           int Hkv, int bs, int P, int n_blocks, int window, float scale2, float kv_mul, int smem,
           int n_ctas, cudaStream_t stream) {
  if (kN % bs) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_k, map_v;
  if (!encode<TKV, D>(&map_k, k_pool, n_blocks, bs, Hkv) ||
      !encode<TKV, D>(&map_v, v_pool, n_blocks, bs, Hkv))
    return -1;
  auto kernel = chunk_attn_kernel<TKV, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_ctas, kThreads, smem, stream>>>(
      map_k, map_v, static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<const int*>(q_lens),
      static_cast<__nv_bfloat16*>(out), B, S, H, Hkv, H / Hkv, bs, P,
      n_blocks, window, scale2, kv_mul);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q and out bf16 [B, S, H, D]; pools [n_blocks, bs, Hkv, D], bf16
// (kv_dtype 1) or int8 (kv_dtype 2); tables [B, P], lengths [B] and q_lens
// [B] (or null: every row real) int32.  `smem` and `n_ctas` (persistent
// CTAs) come from the wrapper's launch_plan.  Returns the cudaError_t of the launch.
extern "C" int chunk_attn_launch(const void* q, const void* k_pool, const void* v_pool,
                                 const void* tables, const void* lengths, const void* q_lens,
                                 void* out, int B, int S, int H, int Hkv, int D,
                                 int bs, int P, int n_blocks, int window, float scale2,
                                 float kv_mul, int kv_dtype, int smem, int n_ctas, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv || n_ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define CHUNK_ATTN_CASE(T, DD)                                                                  \
  return launch<T, DD>(q, k_pool, v_pool, tables, lengths, q_lens, out, B, S, H, Hkv, bs,       \
                       P, n_blocks, window, scale2, kv_mul, smem, n_ctas, st)
  if (kv_dtype == 1 && D == 128) CHUNK_ATTN_CASE(__nv_bfloat16, 128);
  if (kv_dtype == 1 && D == 64) CHUNK_ATTN_CASE(__nv_bfloat16, 64);
  if (kv_dtype == 2 && D == 128) CHUNK_ATTN_CASE(int8_t, 128);
  if (kv_dtype == 2 && D == 64) CHUNK_ATTN_CASE(int8_t, 64);
#undef CHUNK_ATTN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
