// Paged GQA attention over a physical KV block pool, for Hopper (sm_90a).
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
// Bound on this card: memory.  Each CTA reads the live K/V rows of its head
// once ([bs, D] per page, 2 bytes a value in bf16); the arithmetic is
// 4·Q·G·D flops per key, far below the 295 flops/byte where an H100 stops
// being memory-bound.
//
// Design: one CTA of 128 threads per (b, h), a sequential loop over the
// table's pages in place of the TPU's carried page grid axis.  Each live
// page's K and V tiles are staged in shared memory (K rows padded by one
// float against bank conflicts), scores are taken in float32, and the
// online-softmax state (m, l, acc) stays in shared memory for the CTA's
// lifetime.  Pages past `length`, and pages wholly below the window, are
// skipped; p is masked as well as s, so a fully masked row keeps l == 0.
//
// Left on the table: B×Hkv CTAs (64 at the phi4 decode shape) underfill the
// 132 SMs, so a split over the page axis with a combine pass comes later,
// together with cp.async/TMA staging that overlaps the next page's loads
// with this page's math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ bool visible(int pos, int q_pos, int window) {
  return pos <= q_pos && (window == 0 || pos > q_pos - window);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                  const TKV* __restrict__ v_pool, const int* __restrict__ tables,
                  const int* __restrict__ lengths, TQ* __restrict__ out,
                  int Hkv, int QG, int D, int bs, int P, int n_blocks,
                  int q_len, int window, float scale, float kv_mul) {
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x - b * Hkv;
  const int tid = threadIdx.x;
  const int G = QG / q_len;
  const int length = lengths[b];
  const int first_q = length - q_len;  // absolute position of query token 0
  const int ks = D + 1;                // padded K row stride

  extern __shared__ float smem[];
  float* q_s = smem;                // [QG, D]
  float* acc = q_s + QG * D;        // [QG, D]
  float* k_s = acc + QG * D;        // [bs, D+1]
  float* v_s = k_s + bs * ks;       // [bs, D]
  float* p_s = v_s + bs * D;        // [QG, bs] scores, then probabilities
  float* m_s = p_s + QG * bs;       // [QG] running max
  float* l_s = m_s + QG;            // [QG] running denominator
  float* c_s = l_s + QG;            // [QG] this page's correction factor

  const size_t q_off = (static_cast<size_t>(b) * Hkv + h) * QG * D;
  for (int i = tid; i < QG * D; i += kThreads) {
    q_s[i] = to_f32(q[q_off + i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < QG; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int page = 0; page < P; ++page) {
    const int base = page * bs;
    // does the page overlap the union of the rows' visible ranges?
    bool live = base < length;
    if (window) live = live && (base + bs > length - q_len - window + 1);
    if (!live) continue;  // uniform across the CTA
    int bid = tables[static_cast<size_t>(b) * P + page];
    bid = min(max(bid, 0), n_blocks - 1);

    for (int i = tid; i < bs * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const size_t g = ((static_cast<size_t>(bid) * bs + r) * Hkv + h) * D + d;
      k_s[r * ks + d] = to_f32(k_pool[g]) * kv_mul;
      v_s[i] = to_f32(v_pool[g]) * kv_mul;
    }
    __syncthreads();

    for (int i = tid; i < QG * bs; i += kThreads) {
      const int row = i / bs, c = i - row * bs;
      const float* qr = q_s + row * D;
      const float* kr = k_s + c * ks;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      p_s[i] = visible(base + c, first_q + row / G, window) ? s * scale : kNegInf;
    }
    __syncthreads();

    for (int row = warp; row < QG; row += kThreads / 32) {
      float* pr = p_s + row * bs;
      const int q_pos = first_q + row / G;
      float mx = kNegInf;
      for (int c = lane; c < bs; c += 32) mx = fmaxf(mx, pr[c]);
      for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < bs; c += 32) {
        const float p = visible(base + c, q_pos, window) ? expf(pr[c] - m_new) : 0.f;
        pr[c] = p;
        sum += p;
      }
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[row] = l_s[row] * corr + sum;
        m_s[row] = m_new;
        c_s[row] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < QG * D; i += kThreads) {
      const int row = i / D, d = i - row * D;
      const float* pr = p_s + row * bs;
      float a = acc[i] * c_s[row];
      for (int c = 0; c < bs; ++c) a = fmaf(pr[c], v_s[c * D + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < QG * D; i += kThreads) {
    store(out + q_off + i, acc[i] / fmaxf(l_s[i / D], 1e-30f));
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
           const void* lengths, void* out, int B, int Hkv, int QG, int D, int bs, int P,
           int n_blocks, int q_len, int window, float scale, float kv_mul,
           cudaStream_t stream) {
  const size_t floats = 2 * static_cast<size_t>(QG) * D + static_cast<size_t>(bs) * (D + 1) +
                        static_cast<size_t>(bs) * D + static_cast<size_t>(QG) * bs + 3 * QG;
  const size_t smem = floats * sizeof(float);
  auto kernel = paged_attn_kernel<TQ, TKV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<TQ*>(out), Hkv, QG, D, bs, P, n_blocks,
      q_len, window, scale, kv_mul);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int launch_kv(int kv_dtype, const void* q, const void* k_pool, const void* v_pool,
              const void* tables, const void* lengths, void* out, int B, int Hkv, int QG,
              int D, int bs, int P, int n_blocks, int q_len, int window, float scale,
              float kv_mul, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch<TQ, float>(q, k_pool, v_pool, tables, lengths, out, B, Hkv, QG, D, bs, P,
                               n_blocks, q_len, window, scale, kv_mul, stream);
    case 1:
      return launch<TQ, __nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out, B, Hkv, QG, D,
                                       bs, P, n_blocks, q_len, window, scale, kv_mul, stream);
    case 2:
      return launch<TQ, int8_t>(q, k_pool, v_pool, tables, lengths, out, B, Hkv, QG, D, bs, P,
                                n_blocks, q_len, window, scale, kv_mul, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Element types: 0 = float32, 1 = bfloat16, 2 = int8.  q and out share
// q_dtype (float32 or bfloat16); both pools share kv_dtype.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int paged_attn_launch(const void* q, const void* k_pool, const void* v_pool,
                                 const void* tables, const void* lengths, void* out, int B,
                                 int Hkv, int QG, int D, int bs, int P, int n_blocks,
                                 int q_len, int window, float scale, float kv_mul,
                                 int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return launch_kv<float>(kv_dtype, q, k_pool, v_pool, tables, lengths, out, B, Hkv, QG, D,
                              bs, P, n_blocks, q_len, window, scale, kv_mul, s);
    case 1:
      return launch_kv<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, tables, lengths, out, B,
                                      Hkv, QG, D, bs, P, n_blocks, q_len, window, scale,
                                      kv_mul, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
