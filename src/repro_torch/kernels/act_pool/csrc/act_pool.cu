// ODIN's binary-domain add-on block for Hopper (sm_90a): an 8-bit activation
// (saturating ReLU or the 8-bit tanh) fused with p×p, stride-p max or
// average pooling over an int32 NHWC popcount-domain map.
//
// Replaces: the TPU kernel `act_pool_kernel` in
//   src/repro/kernels/act_pool/act_pool.py:36 (launched by
//   `act_pool_pallas_call`, same file :52; entry `ops.py:15` `act_pool`).
//   Same function:
//     r = relu: clip(x, 0, 255)  |  tanh: clip(round(255·tanh(x/64)), 0, 255)
//     out[b,i,j,c] = max over the window of r, or round(Σ r / p²)
//   with round half to even (`jnp.round`), applied to every input before
//   the window reduction (so the int32 sum of at most p²·255 cannot
//   overflow).
//
// Bound on this card: bytes.  The function reads each int32 input once and
// writes each int32 output once (4·B·H·W·C·(1 + 1/p²) bytes) and does a few
// operations per input; at 3.35 TB/s the reads set the time.
//
// Design: the simple first kernel.  One thread per output element
// (b, i, j, c): a block row of the grid per output row (b, i), its threads
// over (j, c) with c innermost, so the 32 lanes of a warp read 32
// consecutive channels of one window row: each of the p² loads of a window
// is coalesced.  Indices are 32-bit and take one division a thread (a first
// version took three 64-bit divisions and ran 2.9x its bound).  The TPU
// kernel's whole-plane VMEM blocks over (b, c) have no counterpart: a window
// is read once, by the thread that needs it.
// Rounding follows the reference exactly: `rintf` (half to even, not
// `roundf`), the average an IEEE float division of the exact float sum by
// p², and `tanhf` without fast math (no 255·tanh(x/64) of an integer x
// lies within 1.7e-3 of a half-integer, far above tanhf's error).
//
// Left on the table: 16-byte vectorised loads of four channels a thread;
// the kernel can reach its bytes bound only when the map is large enough to
// fill the card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int activate(int v, int act) {
  if (act == 1) {  // tanh, the 256-entry LUT of a CMOS tanh block in closed form
    const float y = rintf(255.0f * tanhf(static_cast<float>(v) / 64.0f));
    return static_cast<int>(fminf(fmaxf(y, 0.0f), 255.0f));
  }
  return min(max(v, 0), 255);  // saturating 8-bit ReLU
}

__global__ void __launch_bounds__(kThreads)
act_pool_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, int H, int W,
                int C, int p, int act, int avg) {
  // blockIdx.x: one output row (b, i); threads: its (j, c), c innermost.
  // Every index is below 2^31 (checked by the launcher), so 32-bit
  // arithmetic suffices.
  const int Wo = W / p, Ho = H / p, row_len = Wo * C;
  const int t = blockIdx.y * kThreads + threadIdx.x;
  if (t >= row_len) return;
  const int row = blockIdx.x;
  const int b = row / Ho, i = row - b * Ho;
  const int j = t / C, c = t - j * C;
  const int32_t* win = x + ((b * H + i * p) * W + j * p) * C + c;
  int acc = 0;  // activated values lie in 0..255: 0 is the max's identity too
  for (int di = 0; di < p; ++di) {
    const int32_t* r = win + di * W * C;
    for (int dj = 0; dj < p; ++dj) {
      const int v = activate(r[dj * C], act);
      acc = avg ? acc + v : max(acc, v);
    }
  }
  if (avg) acc = static_cast<int>(rintf(static_cast<float>(acc) / static_cast<float>(p * p)));
  out[row * row_len + t] = acc;
}

}  // namespace

// x int32 [B, H, W, C] row-major, H and W multiples of p, fewer than 2^31
// elements; out int32 [B, H/p, W/p, C].  act 0: relu, 1: tanh; pool_kind
// 0: max, 1: avg.  Returns the launch's cudaError_t.
extern "C" int act_pool_launch(const void* x, void* out, int B, int H, int W, int C,
                               int p, int act, int pool_kind, void* stream) {
  if (B < 1 || C < 1 || p < 1 || H < p || W < p || H % p || W % p || act < 0 ||
      act > 1 || pool_kind < 0 || pool_kind > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * (H / p);
  const long long row_blocks = (static_cast<long long>(W / p) * C + kThreads - 1) / kThreads;
  if (static_cast<long long>(B) * H * W * C >= (1LL << 31) || row_blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(row_blocks));
  act_pool_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), H, W, C, p, act, pool_kind);
  return static_cast<int>(cudaGetLastError());
}
