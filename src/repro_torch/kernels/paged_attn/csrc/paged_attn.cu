// Paged GQA attention over a physical KV block pool, for Hopper (sm_90a):
// flash-decoding, with the page axis split across CTAs and a combine pass.
//
// Replaces: the TPU kernel `paged_attn_kernel` in
//   src/repro/kernels/paged_attn/paged_attn.py:53 (launched by
//   `paged_attn_pallas_call`, same file :119).  Same function: online-softmax
//   GQA of a [Q·G, D] query tile per (slot b, kv-head h) over the slot's
//   pages, read through its block table; query row q·G+g sits at absolute
//   position length-Q+q with a causal mask per row; optional sliding window;
//   int8 pools dequantised by kv_mul = 1/kv_scale; a row with no visible key
//   and a zero-length slot give exactly 0.
//
// Bound on this card: bytes.  The function reads each visible K/V row of a
// head once ([D] values per key, 2 bytes a value in bf16) and does
// 4·Q·G·D flops per key, far below the 295 flops a byte where an H100
// (NVIDIA H100 80GB HBM3, 700 W) stops being bound by its 3.35 TB/s.
//
// Design.  The TPU walks the page axis in order in one grid row; here the
// wrapper (ops.py) splits a slot's pages into `n_splits` ranges of
// `pages_per_split` pages, chosen from the shapes alone, and the grid is
// (n_splits, B·Hkv, chunks of RT ≤ 4 query rows).  A CTA of four warps
//   * issues its first stage's copies, then loads its RT query rows into
//     registers as float32, each lane owning 16 values of D, so that D/16
//     lanes (8 at D = 128) read one key row and a warp reads 4 keys at once;
//   * streams its live pages (past `length` and wholly below the window are
//     skipped) through a two-stage ring in shared memory, up to 32 KB of K
//     and V a stage, with 16-byte cp.async.cg copies; the next stage's
//     block ids are read from the table and its copies issued while the
//     current stage is computed;
//   * reads each K row once with 16-byte loads, dots it with all RT query
//     rows and reduces over the key's lanes with warp shuffles; a lane group
//     scores 4 keys before one online-softmax rescale, keeps (m, l, acc) in
//     registers in base 2 (scores times scale·log2(e), exp2), and updates
//     it only for visible keys, so masked keys never touch it and an empty
//     row keeps l == 0, acc == 0;
//   * merges the groups' states once through shared memory (reusing the
//     ring): one weight exp2(m_g − M) a group and row, then a weighted sum
//     per output value; writes either the output (n_splits == 1) or a
//     float32 partial (m, l, acc[D]) to the workspace.  A CTA with no live
//     page writes the empty partial (NEG_INF, 0, 0) directly.
// The combine kernel takes one output row [b, h, r] a block:
// out = Σ exp(m_i − M)·acc_i / max(Σ exp(m_i − M)·l_i, 1e-30), M = max m_i
// (in base 2), with the partials' maxima and sums staged in shared memory;
// an empty partial adds exactly 0 (m_i is a finite NEG_INF), so an empty
// row stays exactly 0 with no NaN.  The arithmetic stays float32 on the
// CUDA cores: at Q·G = 3 rows the tensor cores do not pay.
//
// Left on the table (measured on an NVIDIA H100 80GB HBM3 at 700 W: about
// 0.019 ms at phi4's decode against a 0.005 ms bound, PERF.md): a CTA's
// time is a chain of latencies (lengths, then the table, then its copies,
// then its keys, then the merge) with about three CTAs of four warps on an
// SM to hide them, and the 8 lanes of a key repeat its softmax work; the
// combine is a second launch; a verify tile of more than 4 rows re-reads
// K/V once per row chunk; the split plan does not see `lengths` (by
// design: reading them would sync the host), so short slots leave their
// later splits empty.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEl = 16;  // values of D a lane owns (D / kEl lanes read one key row)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ bool visible(int pos, int q_pos, int window) {
  return pos <= q_pos && (window == 0 || pos > q_pos - window);
}

// 16 bytes of TKV → 16 / sizeof(TKV) floats; an int8 pool is dequantised
// by kv_mul here (the plain version multiplies each value), float32 and
// bfloat16 pools pass as they are
template <typename TKV>
__device__ __forceinline__ void unpack16(const uint4& u, float kv_mul, float* f) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(TKV));
  const TKV* e = reinterpret_cast<const TKV*>(&u);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if constexpr (sizeof(TKV) == 1) {
      f[i] = to_f32(e[i]) * kv_mul;
    } else {
      f[i] = to_f32(e[i]);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename TQ, typename TKV, int RT>
__global__ void __launch_bounds__(kThreads)
paged_attn_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                        const TKV* __restrict__ v_pool, const int* __restrict__ tables,
                        const int* __restrict__ lengths, TQ* __restrict__ out,
                        float* __restrict__ ws_ml, float* __restrict__ ws_acc, int Hkv, int QG,
                        int D, int bs, int P, int n_blocks, int q_len, int window, float scale,
                        float kv_mul, int pages_per_split, int n_splits, int pages_per_stage) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(TKV));  // values in 16 bytes
  constexpr int kLoads = kEl / kVec;   // 16-byte loads a lane makes of a key row
  constexpr int kJ = 4;                // keys a lane group scores before one rescale
  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int r0 = blockIdx.z * RT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lpk = D / kEl;             // lanes per key row (8 at D = 128)
  const int kpw = 32 / lpk;            // keys a warp reads at once
  const int n_groups = kWarps * kpw;   // lane groups of the CTA
  const int grp = warp * kpw + lane / lpk;
  const int sub = lane % lpk;          // this lane's 16-byte pieces: sub, sub + lpk, ...
  const int G = QG / q_len;
  const int length = lengths[b];
  const int first_q = length - q_len;  // absolute position of query token 0
  // scores, maxima and partials are kept in base 2: s·scale·log2(e)
  const float scale2 = scale * 1.4426950408889634f;

  // live pages of the slot (the union of the rows' visible ranges), cut to
  // this CTA's split
  int lo = 0;
  const int hi = length > 0 ? min(P, (length + bs - 1) / bs) : 0;
  if (window) {
    const int t = length - q_len - window + 1;  // a live page ends past t
    lo = t > 0 ? t / bs : 0;
  }
  const int p0 = max(lo, split * pages_per_split);
  const int p1 = min(hi, (split + 1) * pages_per_split);
  const int n_pages = max(0, p1 - p0);

  if (n_pages == 0) {  // nothing visible here: the empty partial
    for (int i = tid; i < RT * D; i += kThreads) {
      const int r = i / D, d = i - r * D, row = r0 + r;
      if (row >= QG) continue;
      const size_t orow = static_cast<size_t>(bh) * QG + row;
      if (n_splits == 1) {
        store(out + orow * D + d, 0.f);
      } else {
        const size_t pi = (static_cast<size_t>(bh) * n_splits + split) * QG + row;
        ws_acc[pi * D + d] = 0.f;
        if (d == 0) {
          ws_ml[2 * pi] = kNegInf;
          ws_ml[2 * pi + 1] = 0.f;
        }
      }
    }
    return;
  }

  // ring of two stages of `pages_per_stage` consecutive pages each; a stage
  // holds its pages' K rows, then their V rows, row by row
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_bytes = D * static_cast<int>(sizeof(TKV));
  const int page_bytes = bs * row_bytes;
  const int stage_bytes = 2 * pages_per_stage * page_bytes;
  const int chunks_per_row = row_bytes / 16;
  const int chunk_shift = __ffs(chunks_per_row) - 1;
  const int chunks_per_page = bs * chunks_per_row;
  const size_t pool_row = static_cast<size_t>(Hkv) * D;  // elements between key rows
  const int n_steps = (n_pages + pages_per_stage - 1) / pages_per_stage;

  auto issue = [&](int step) {
    const int first = p0 + step * pages_per_stage;
    const int np = min(pages_per_stage, p1 - first);
    unsigned char* ks = smem + (step & 1) * stage_bytes;
    unsigned char* vs = ks + pages_per_stage * page_bytes;
    for (int i = tid; i < np * chunks_per_page; i += kThreads) {
      const int j = i / chunks_per_page, w = i - j * chunks_per_page;
      const int r = w >> chunk_shift, c = w & (chunks_per_row - 1);
      int bid = tables[static_cast<size_t>(b) * P + first + j];
      bid = min(max(bid, 0), n_blocks - 1);
      const size_t g = ((static_cast<size_t>(bid) * bs + r) * pool_row + static_cast<size_t>(h) * D) *
                           sizeof(TKV) + c * 16;
      const int sm = (j * bs + r) * row_bytes + c * 16;
      cp_async16(ks + sm, reinterpret_cast<const unsigned char*>(k_pool) + g);
      cp_async16(vs + sm, reinterpret_cast<const unsigned char*>(v_pool) + g);
    }
  };

  issue(0);  // the first stage's copies fly while the query tile loads
  cp_async_commit();

  // element t of piece j of this lane is d = (j·lpk + sub)·kVec + t
  float qr[RT][kEl], acc[RT][kEl], m[RT], l[RT];
  int q_pos[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = r0 + r;
    const bool ok = row < QG;
    const TQ* qrow = q + (static_cast<size_t>(bh) * QG + (ok ? row : 0)) * D;
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        qr[r][j * kVec + t] = ok ? to_f32(qrow[(j * lpk + sub) * kVec + t]) : 0.f;
        acc[r][j * kVec + t] = 0.f;
      }
    m[r] = kNegInf;
    l[r] = 0.f;
    q_pos[r] = ok ? first_q + row / G : -(1 << 30);  // padding rows see nothing
  }

  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) issue(step + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* ks = smem + (step & 1) * stage_bytes;
    const unsigned char* vs = ks + pages_per_stage * page_bytes;
    const int first_key = (p0 + step * pages_per_stage) * bs;
    const int keys = min(pages_per_stage, p1 - (p0 + step * pages_per_stage)) * bs;
    for (int c0 = 0; c0 < keys; c0 += n_groups * kJ) {  // uniform across the CTA
      // scores of this group's kJ keys against every row, reduced over the
      // key's lanes (independent chains, one shuffle tree each)
      float s[kJ][RT];
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int c = c0 + j * n_groups + grp;
#pragma unroll
        for (int r = 0; r < RT; ++r) s[j][r] = 0.f;
#pragma unroll
        for (int pc = 0; pc < kLoads; ++pc) {
          uint4 u = make_uint4(0, 0, 0, 0);
          if (c < keys)
            u = *reinterpret_cast<const uint4*>(ks + c * row_bytes + (pc * lpk + sub) * 16);
          float kf[kVec];
          unpack16<TKV>(u, kv_mul, kf);
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int t = 0; t < kVec; ++t) s[j][r] = fmaf(qr[r][pc * kVec + t], kf[t], s[j][r]);
        }
      }
      for (int o = lpk / 2; o; o >>= 1) {
#pragma unroll
        for (int j = 0; j < kJ; ++j)
#pragma unroll
          for (int r = 0; r < RT; ++r) s[j][r] += __shfl_xor_sync(kFull, s[j][r], o);
      }
      // one online-softmax rescale per row for the batch; masked keys get
      // s = NEG_INF here and p = 0 below, and never touch the state
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float m_new = m[r];
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int c = c0 + j * n_groups + grp;
          const bool vis = c < keys && visible(first_key + c, q_pos[r], window);
          s[j][r] = vis ? s[j][r] * scale2 : kNegInf;
          m_new = fmaxf(m_new, s[j][r]);
        }
        if (m_new > m[r]) {
          const float corr = exp2f(m[r] - m_new);
          l[r] *= corr;
#pragma unroll
          for (int e = 0; e < kEl; ++e) acc[r][e] *= corr;
          m[r] = m_new;
        }
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int c = c0 + j * n_groups + grp;
        if (c >= keys) continue;
        float p[RT];
        bool any = false;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          p[r] = s[j][r] == kNegInf ? 0.f : exp2f(s[j][r] - m[r]);  // masked: p = 0
          l[r] += p[r];
          any = any || s[j][r] != kNegInf;
        }
        if (!any) continue;
#pragma unroll
        for (int pc = 0; pc < kLoads; ++pc) {
          const uint4 vu =
              *reinterpret_cast<const uint4*>(vs + c * row_bytes + (pc * lpk + sub) * 16);
          float vf[kVec];
          unpack16<TKV>(vu, kv_mul, vf);
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int t = 0; t < kVec; ++t)
              acc[r][pc * kVec + t] = fmaf(p[r], vf[t], acc[r][pc * kVec + t]);
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next step's copies
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the lane groups' states through shared memory (the ring's bytes)
  float* acc_s = reinterpret_cast<float*>(smem);  // [n_groups][RT][D]
  float* m_s = acc_s + static_cast<size_t>(n_groups) * RT * D;
  float* l_s = m_s + n_groups * RT;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
#pragma unroll
      for (int t = 0; t < kVec; ++t)
        acc_s[(grp * RT + r) * D + (j * lpk + sub) * kVec + t] = acc[r][j * kVec + t];
    if (sub == 0) {
      m_s[grp * RT + r] = m[r];
      l_s[grp * RT + r] = l[r];
    }
  }
  __syncthreads();
  if (tid < RT) {  // each row's maximum, then each group's weight exp2(m_g − M)
    float M = kNegInf;
    for (int g = 0; g < n_groups; ++g) M = fmaxf(M, m_s[g * RT + tid]);
    float L = 0.f;
    for (int g = 0; g < n_groups; ++g) {
      const float e = exp2f(m_s[g * RT + tid] - M);  // an empty group adds e·0
      m_s[g * RT + tid] = e;
      L = fmaf(e, l_s[g * RT + tid], L);
    }
    l_s[tid] = L;          // groups' sums are read; row r's total lands in l_s[r]
    l_s[RT + tid] = M;     // and its maximum in l_s[RT + r]
  }
  __syncthreads();
  for (int i = tid; i < RT * D; i += kThreads) {
    const int r = i / D, d = i - r * D, row = r0 + r;
    if (row >= QG) continue;
    float A = 0.f;
    for (int g = 0; g < n_groups; ++g) A = fmaf(m_s[g * RT + r], acc_s[(g * RT + r) * D + d], A);
    const float L = l_s[r], M = l_s[RT + r];
    const size_t orow = static_cast<size_t>(bh) * QG + row;
    if (n_splits == 1) {
      store(out + orow * D + d, A / fmaxf(L, 1e-30f));
    } else {
      const size_t pi = (static_cast<size_t>(bh) * n_splits + split) * QG + row;
      ws_acc[pi * D + d] = A;
      if (d == 0) {
        ws_ml[2 * pi] = M;
        ws_ml[2 * pi + 1] = L;
      }
    }
  }
}

// One block of D threads per output row [b, h, r]: merge the n_splits
// partials of the row.  The partials' maxima and sums are staged in shared
// memory first, so that the loop over splits waits on one load a split.
constexpr int kMaxSplits = 1024;

template <typename TQ>
__global__ void paged_attn_combine_kernel(const float* __restrict__ ws_ml,
                                          const float* __restrict__ ws_acc,
                                          TQ* __restrict__ out, int QG, int D, int n_splits) {
  __shared__ float w_s[kMaxSplits];  // exp(m_i - M)
  __shared__ float l_s[kMaxSplits];
  __shared__ float red[32];
  const int orow = blockIdx.x;
  const int bh = orow / QG, row = orow - bh * QG;
  const int d = threadIdx.x;
  const size_t first = static_cast<size_t>(bh) * n_splits * QG + row;  // partial of split 0
  float mx = kNegInf;
  for (int s = d; s < n_splits; s += blockDim.x) {
    const size_t pi = first + static_cast<size_t>(s) * QG;
    w_s[s] = ws_ml[2 * pi];
    l_s[s] = ws_ml[2 * pi + 1];
    mx = fmaxf(mx, w_s[s]);
  }
  for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  if (d % 32 == 0) red[d / 32] = mx;
  __syncthreads();
  float M = kNegInf;
  for (int i = 0; i < static_cast<int>(blockDim.x) / 32; ++i) M = fmaxf(M, red[i]);
  for (int s = d; s < n_splits; s += blockDim.x) w_s[s] = exp2f(w_s[s] - M);  // empty: e·0
  __syncthreads();
  float L = 0.f, A = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) {
    L = fmaf(w_s[s], l_s[s], L);
    A = fmaf(w_s[s], ws_acc[(first + static_cast<size_t>(s) * QG) * D + d], A);
  }
  store(out + static_cast<size_t>(orow) * D + d, A / fmaxf(L, 1e-30f));
}

struct Args {
  const void *q, *k_pool, *v_pool, *tables, *lengths;
  void* out;
  float* ws;
  int B, Hkv, QG, D, bs, P, n_blocks, q_len, window;
  float scale, kv_mul;
  int pages_per_split, n_splits, pages_per_stage, smem;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int RT>
int launch(const Args& a) {
  auto kernel = paged_attn_split_kernel<TQ, TKV, RT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_chunks = (a.QG + RT - 1) / RT;
  const size_t rows = static_cast<size_t>(a.B) * a.Hkv * a.n_splits * a.QG;
  float* ws_ml = a.ws;
  float* ws_acc = a.ws + 2 * rows;
  dim3 grid(a.n_splits, a.B * a.Hkv, row_chunks);
  kernel<<<grid, kThreads, a.smem, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pool),
      static_cast<const TKV*>(a.v_pool), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.lengths), static_cast<TQ*>(a.out), ws_ml, ws_acc, a.Hkv, a.QG,
      a.D, a.bs, a.P, a.n_blocks, a.q_len, a.window, a.scale, a.kv_mul, a.pages_per_split,
      a.n_splits, a.pages_per_stage);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return static_cast<int>(err);
  paged_attn_combine_kernel<TQ><<<a.B * a.Hkv * a.QG, a.D, 0, a.stream>>>(
      ws_ml, ws_acc, static_cast<TQ*>(a.out), a.QG, a.D, a.n_splits);
  return static_cast<int>(cudaGetLastError());
}

// A CTA holds 1 to 4 query rows in registers (16 values of D a lane each
// for the query tile and as many for the accumulator)
template <typename TQ, typename TKV>
int launch_rt(const Args& a, int rt) {
  switch (rt) {
    case 1: return launch<TQ, TKV, 1>(a);
    case 2: return launch<TQ, TKV, 2>(a);
    case 3: return launch<TQ, TKV, 3>(a);
    case 4: return launch<TQ, TKV, 4>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ>
int launch_kv(const Args& a, int kv_dtype, int rt) {
  switch (kv_dtype) {
    case 0: return launch_rt<TQ, float>(a, rt);
    case 1: return launch_rt<TQ, __nv_bfloat16>(a, rt);
    case 2: return launch_rt<TQ, int8_t>(a, rt);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Element types: 0 = float32, 1 = bfloat16, 2 = int8.  q and out share
// q_dtype (float32 or bfloat16); both pools share kv_dtype.  The plan
// (pages_per_split, n_splits, rows a CTA, pages a ring stage, dynamic
// shared memory) comes from the wrapper; `ws` holds B·Hkv·n_splits·QG·(D + 2) floats when
// n_splits > 1.  Returns the cudaError_t of the launches (0 on success).
extern "C" int paged_attn_launch(const void* q, const void* k_pool, const void* v_pool,
                                 const void* tables, const void* lengths, void* out, void* ws,
                                 int B, int Hkv, int QG, int D, int bs, int P, int n_blocks,
                                 int q_len, int window, float scale, float kv_mul, int q_dtype,
                                 int kv_dtype, int pages_per_split, int n_splits, int rt,
                                 int pages_per_stage, int smem, void* stream) {
  if (B < 1 || n_splits < 1 || (D != 64 && D != 128)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k_pool, v_pool, tables, lengths, out, static_cast<float*>(ws), B, Hkv, QG, D, bs,
         P, n_blocks, q_len, window, scale, kv_mul, pages_per_split, n_splits,
         pages_per_stage, smem, static_cast<cudaStream_t>(stream)};
  switch (q_dtype) {
    case 0: return launch_kv<float>(a, kv_dtype, rt);
    case 1: return launch_kv<__nv_bfloat16>(a, kv_dtype, rt);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
