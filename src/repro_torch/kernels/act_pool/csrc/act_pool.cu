// ODIN's binary-domain add-on block for Hopper (sm_90a): an 8-bit activation
// (saturating ReLU or the 8-bit tanh) fused with p×p, stride-p max or
// average pooling over an int32 NHWC popcount-domain map.
//
// Replaces: the TPU kernel `act_pool_kernel` in
//   src/repro/kernels/act_pool/act_pool.py:36 (launched by
//   `act_pool_pallas_call`, same file :52; entry `ops.py:15` `act_pool`).
//   Same function, bit for bit:
//     r = relu: clip(x, 0, 255)  |  tanh: clip(rint(255·tanh(x/64)), 0, 255)
//     out[b,i,j,c] = max over the window of r, or rint(Σ r / p²)
//   with rint half to even (`jnp.round`).
//
// Bound on this card: bytes.  The function reads each int32 input once and
// writes each int32 output once, 4·B·H·W·C·(1 + 1/p²) bytes, and does a
// few operations per input; at 3.35 TB/s the reads set the time.  Each
// choice below serves moving those bytes at the memory's rate:
//
// * A flat grid over output items.  An item is four consecutive channels
//   of one output pixel when C % 4 == 0 and both pointers are 16-byte
//   aligned (the launcher decides, `plan` below; `launch_plan` in
//   act_pool.py mirrors it): each window element is one 16-byte load and
//   the result one 16-byte store.  Otherwise an item
//   is one channel and the same loop runs on 4-byte words (C = 1, 3, 10, or
//   a tensor with an odd storage offset), in this kernel, never elsewhere.
//   Consecutive threads take consecutive items, so a warp's loads of one
//   window position cover contiguous channels.
// * Grid stride, two items a thread in flight.  The grid is
//   min(items / (256·2), 4 CTAs an SM), all resident at once; a thread
//   takes items e and e + stride, issues every load of both windows before
//   it reduces (p is a template argument for p <= 4, so the loops unroll),
//   then moves on by 2·stride.  Small maps (CNN1's 64×28×28×4) get as many
//   CTAs as their items need and every thread of those works, where the
//   first kernel's grid of a CTA per output row left 78 % of them idle; the
//   65,535 row-block limit is gone with the rows.  (One item a thread on
//   twice the CTAs was no faster on CNN1's map and slower on CNN2's.)
// * Max before the activation.  Both activations are monotone
//   non-decreasing over int32, so act(max(window)) == max(act(window)) bit
//   for bit; the max kinds activate once per output, p² times fewer, the
//   tanh by `tanhf` (no table to fill).
// * The 8-bit tanh as its table, for the avg kind, which activates every
//   input.  It is 0 for x <= 0 and 255 for x >= 222, and takes 117 other
//   values on 1..221: the 256-entry LUT of a CMOS tanh block.  Each CTA
//   fills a 222-byte table in shared memory with the exact expression (one
//   `tanhf` a thread), then reads it per input: 56 words over 32 banks, so
//   at most a 2-way bank conflict.  No integer x puts 255·tanh(x/64) within
//   1.7e-3 of a half-integer (nearest: x = ±170), far above tanhf's error,
//   so `rintf` of tanhf is the exact value and the table is the function.
//   On the VGG-scale map the table was 6 % faster than `tanhf` per input.
// * Streaming loads.  Every input is read once, so its loads are
//   `ld.global.cs` (evict first): on the VGG-scale map, twice the L2, that
//   took 3–4 % off the time.  The stores keep the default policy: the pooled
//   map is what the next layer reads, and evict-first stores were slower on
//   CNN2's map.
// * No fast math.  `rintf` rounds half to even; the average is an IEEE
//   division of the exact float sum (at most p²·255) by p².
//
// Indices are 32-bit: the launcher and the wrapper refuse 2^31 elements or
// more.  TMA or shared-memory staging would bring nothing to a single
// streaming pass that reuses no byte.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// THREADS, UNROLL and CTAS_PER_SM of act_pool.py; TANH_TABLE_LEN of ref.py
constexpr int kThreads = 256;
constexpr int kUnroll = 2;
constexpr int kCtasPerSm = 4;
constexpr int kTableLen = 222;

enum Act { kRelu = 0, kTanh = 1 };

__device__ __forceinline__ int tanh8(int v) {
  const float y = rintf(255.0f * tanhf(static_cast<float>(v) / 64.0f));
  return static_cast<int>(fminf(fmaxf(y, 0.0f), 255.0f));
}

// the 8-bit activation: the avg tanh reads its table, the max tanh (once an
// output) computes it
template <int ACT, bool AVG>
__device__ __forceinline__ int act8(int v, const uint8_t* table) {
  if (ACT == kRelu) return min(max(v, 0), 255);  // saturating 8-bit ReLU
  if (AVG) return v >= kTableLen ? 255 : table[max(v, 0)];
  return tanh8(v);
}

// lane-wise operations on one channel (int) or four (int4)
__device__ __forceinline__ int lane_max(int a, int b) { return max(a, b); }
__device__ __forceinline__ int4 lane_max(int4 a, int4 b) {
  return make_int4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z), max(a.w, b.w));
}
__device__ __forceinline__ int lane_add(int a, int b) { return a + b; }
__device__ __forceinline__ int4 lane_add(int4 a, int4 b) {
  return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
template <class F>
__device__ __forceinline__ int each(int a, F f) { return f(a); }
template <class F>
__device__ __forceinline__ int4 each(int4 a, F f) {
  return make_int4(f(a.x), f(a.y), f(a.z), f(a.w));
}

// The p×p window whose top-left item is `w`: window rows `row` items
// apart, columns `col` apart.  Every load is issued before the reduction
// uses it when P is known.
template <int P, int ACT, bool AVG, class V>
__device__ __forceinline__ V window(const V* __restrict__ w, int row, int col, int p,
                                    const uint8_t* table) {
  const int n = P ? P : p;
  const auto act = [table](int v) { return act8<ACT, AVG>(v, table); };
  if (!AVG) {  // max of the raw int32 window, then one activation
    V m = __ldcs(w);
#pragma unroll
    for (int di = 0; di < n; ++di)
#pragma unroll
      for (int dj = 0; dj < n; ++dj)
        if (di | dj) m = lane_max(m, __ldcs(w + di * row + dj * col));
    return each(m, act);
  }
  V s = each(__ldcs(w), act);
#pragma unroll
  for (int di = 0; di < n; ++di)
#pragma unroll
    for (int dj = 0; dj < n; ++dj)
      if (di | dj) s = lane_add(s, each(__ldcs(w + di * row + dj * col), act));
  const float area = static_cast<float>(n * n);
  return each(s, [area](int v) { return static_cast<int>(rintf(static_cast<float>(v) / area)); });
}

// Items e = (pixel, c): pixel = r·Wo + j with r = b·Ho + i, c one of Cv
// channel items.  Its window starts at input item ((r·p)·W + j·p)·Cv + c.
template <int P, int ACT, bool AVG, class V>
__device__ __forceinline__ void pool_items(const V* __restrict__ x, V* __restrict__ out, int W,
                                           int Wo, int Cv, int p, unsigned n,
                                           const uint8_t* table) {
  const int pn = P ? P : p;
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned e0 = blockIdx.x * kThreads + threadIdx.x; e0 < n; e0 += kUnroll * stride) {
    V r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // past the end, recompute the last item: every load stays in bounds
      // and only the store is masked
      const unsigned e = min(e0 + u * stride, n - 1);
      const unsigned pix = e / Cv, c = e - pix * Cv;
      const unsigned rw = pix / Wo, j = pix - rw * Wo;
      r[u] = window<P, ACT, AVG>(x + ((rw * pn) * W + j * pn) * Cv + c, W * Cv, Cv, pn, table);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (e0 + u * stride < n) out[e0 + u * stride] = r[u];
  }
}

template <int P, int ACT, bool AVG>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
act_pool_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, int W, int Wo, int C,
                int p, unsigned n, int vec) {
  constexpr bool kTable = ACT == kTanh && AVG;
  __shared__ uint8_t table[kTable ? kTableLen : 1];
  if (kTable) {
    for (int v = threadIdx.x; v < kTableLen; v += kThreads) table[v] = tanh8(v);
    __syncthreads();
  }
  if (vec)
    pool_items<P, ACT, AVG>(reinterpret_cast<const int4*>(x), reinterpret_cast<int4*>(out), W,
                            Wo, C / 4, p, n, table);
  else
    pool_items<P, ACT, AVG>(x, out, W, Wo, C, p, n, table);
}

using Kernel = void (*)(const int32_t*, int32_t*, int, int, int, int, unsigned, int);

template <int P>
Kernel pick(int act, int avg) {
  static const Kernel k[2][2] = {
      {act_pool_kernel<P, kRelu, false>, act_pool_kernel<P, kRelu, true>},
      {act_pool_kernel<P, kTanh, false>, act_pool_kernel<P, kTanh, true>}};
  return k[act][avg];
}

struct Plan {
  int vec;             // 1: items of four channels, 0: of one
  unsigned items;      // output items
  int grid;            // CTAs of kThreads threads
  int passes;          // of the grid-stride loop
};

Plan plan(int B, int H, int W, int C, int p, int aligned, int n_sm) {
  Plan q;
  q.vec = C % 4 == 0 && aligned;
  q.items = static_cast<unsigned>(B * (H / p) * (W / p) * (q.vec ? C / 4 : C));
  const long long per_cta = kThreads * kUnroll;
  const long long ctas = (q.items + per_cta - 1) / per_cta;
  q.grid = static_cast<int>(ctas < 1 ? 1 : ctas < n_sm * kCtasPerSm ? ctas : n_sm * kCtasPerSm);
  q.passes = static_cast<int>((q.items + q.grid * per_cta - 1) / (q.grid * per_cta));
  return q;
}

bool valid(int B, int H, int W, int C, int p) {
  return B >= 1 && C >= 1 && p >= 1 && H >= p && W >= p && H % p == 0 && W % p == 0 &&
         static_cast<long long>(B) * H * W * C < (1LL << 31);
}

}  // namespace

// The launch plan for an int32 [B, H, W, C] input pooled by p, with x and
// out 16-byte `aligned` or not, on n_sm SMs: out[4] = {vec, items, grid,
// passes}.  Returns cudaErrorInvalidValue for a shape the kernel refuses.
extern "C" int act_pool_plan(int B, int H, int W, int C, int p, int aligned, int n_sm,
                             long long* out) {
  if (!valid(B, H, W, C, p) || n_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan q = plan(B, H, W, C, p, aligned, n_sm);
  out[0] = q.vec, out[1] = q.items, out[2] = q.grid, out[3] = q.passes;
  return 0;
}

// x int32 [B, H, W, C] row-major, H and W multiples of p, fewer than 2^31
// elements; out int32 [B, H/p, W/p, C].  act 0: relu, 1: tanh; pool_kind
// 0: max, 1: avg.  Four channels an item when C % 4 == 0 and x and out are
// 16-byte aligned; the grid from the items and the current device's SM
// count (`plan`).  Returns the launch's cudaError_t.
extern "C" int act_pool_launch(const void* x, void* out, int B, int H, int W, int C, int p,
                               int act, int pool_kind, void* stream) {
  if (!valid(B, H, W, C, p) || act < 0 || act > 1 || pool_kind < 0 || pool_kind > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const Plan q = plan(B, H, W, C, p, aligned, n_sm);
  Kernel k;
  switch (p) {
    case 1: k = pick<1>(act, pool_kind); break;
    case 2: k = pick<2>(act, pool_kind); break;
    case 3: k = pick<3>(act, pool_kind); break;
    case 4: k = pick<4>(act, pool_kind); break;
    default: k = pick<0>(act, pool_kind);
  }
  k<<<q.grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), W, W / p, C, p, q.items, q.vec);
  return static_cast<int>(cudaGetLastError());
}
