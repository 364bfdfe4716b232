// One fused LSTM step for Hopper (sm_90a): both gate products, the bias
// and the cell epilogue in one launch.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/lstm_cell/lstm_cell.py::lstm_cell_pallas
//   (body _lstm_kernel)
// and computes the same function:
//   gates = x @ Wx + h @ Wh + b            (float32 sums)
//   c2 = sigmoid(f) * c + sigmoid(i) * tanh(g),  h2 = sigmoid(o) * tanh(c2)
// with gates i, f, g, o the column blocks of Wx (F,4H), Wh (H,4H) and
// b (4H), and (h2, c2) stored in the input type (float32 or bfloat16).
// It is the step of the policy's step-by-step recurrence, which the
// training path runs: T = max_rq + 1 launches per recurrence.
//
// What bounds it on an H100.  One call does 2*B*(F+H)*4H operations and
// must read the weights once: (F+H)*4H*4 bytes, 1.11 MB at F = 16,
// H = 256 in float32.  At the rollout shape (B = 8) that is 4.5 MFLOP
// against ~1.15 MB: 0.07 us at 67 TFLOP/s and 0.34 us at 3.35 TB/s, so
// bytes bound it; at the update shape (B = 32, F = 23) 18.3 MFLOP,
// 0.27 us, still under the 0.34 us of the weights.  Both bounds are far
// under the few microseconds a launch costs, so in practice the launch
// bounds it.
//
// What the design does about it.  The TPU kernel keeps an (F, 4, bh)
// slab of the weights in VMEM per grid step.  Here one block owns a tile
// of ROWS batch rows and UNITS hidden units (one warp per row, one lane
// per unit, so each thread owns one (row, unit) pair and its four gate
// sums), and walks the K = F + H input rows of [Wx; Wh] in tiles of KT:
// each tile stages the four gate columns of its units (KT x 4 x UNITS
// float32, 16 KB) and the block's KT inputs of [x, h] (ROWS x KT) in
// shared memory, then every thread runs its four dot products out of
// shared memory.  Because K is tiled, the shared memory is fixed at
// 17 KB whatever F and H are: no shape needs more than a block has, and
// any B, F, H >= 1 runs (ragged unit and row tiles are masked).  At
// B <= 8 only H / 32 blocks run, so each must stream its 139 KB of
// weights with many loads in flight: every thread starts its 16 weight
// loads (and one input load) of a tile together into registers, and
// starts the next tile's while the current one is summed.  The weights
// are read once per row tile from L2/device memory; at B <= 8 that is
// once.  Fusing the T steps of a recurrence (as lstm_seq does) or
// capturing the step loop in a CUDA graph is the way past the launch
// cost.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int UNITS = 32;  // hidden units per block (one per lane)
constexpr int ROWS = 8;    // batch rows per block (one warp each)
constexpr int KT = 32;     // input rows of [Wx; Wh] staged per tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

constexpr int NT = UNITS * ROWS;             // threads per block
constexpr int W_PER_T = KT * 4 * UNITS / NT;  // weights each thread stages
static_assert(ROWS * KT == NT, "one input element per thread per tile");

// Load tile k0 of the block's weight columns and inputs into registers:
// all W_PER_T + 1 loads start before any is used, so a thread has
// them in flight together (the loop is unrolled; nothing in it waits).
template <typename T>
__device__ __forceinline__ void load_tile(
    const T* __restrict__ x, const T* __restrict__ h,
    const T* __restrict__ wx, const T* __restrict__ wh, int k0, int unit0,
    int row0, int B, int F, int H, float (&w)[W_PER_T], float& in) {
  const int K = F + H;
  const size_t H4 = 4 * static_cast<size_t>(H);
#pragma unroll
  for (int i = 0; i < W_PER_T; ++i) {
    // consecutive threads read consecutive columns of one gate
    const int idx = threadIdx.x + i * NT;
    const int col = unit0 + idx % UNITS;
    const int g = (idx / UNITS) % 4;
    const int k = k0 + idx / (4 * UNITS);
    w[i] = 0.0f;
    if (k < K && col < H) {
      const T* src = k < F ? wx + static_cast<size_t>(k) * H4
                           : wh + static_cast<size_t>(k - F) * H4;
      w[i] = to_f(src[static_cast<size_t>(g) * H + col]);
    }
  }
  const int k = k0 + threadIdx.x % KT;
  const int b = row0 + threadIdx.x / KT;
  in = 0.0f;
  if (k < K && b < B) {
    in = k < F ? to_f(x[static_cast<size_t>(b) * F + k])
               : to_f(h[static_cast<size_t>(b) * H + (k - F)]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
lstm_cell_kernel(const T* __restrict__ x, const T* __restrict__ h,
                 const T* __restrict__ c, const T* __restrict__ wx,
                 const T* __restrict__ wh, const T* __restrict__ bias,
                 T* __restrict__ h2, T* __restrict__ c2, int B, int F,
                 int H) {
  __shared__ float w_s[KT * 4 * UNITS];   // [KT][4][UNITS]
  __shared__ float in_s[ROWS * KT];       // [ROWS][KT]
  const int u = threadIdx.x % UNITS;
  const int r = threadIdx.x / UNITS;
  const int unit0 = blockIdx.x * UNITS;
  const int row0 = blockIdx.y * ROWS;
  const int K = F + H;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
  float w[W_PER_T], in;
  load_tile(x, h, wx, wh, 0, unit0, row0, B, F, H, w, in);

  for (int k0 = 0; k0 < K; k0 += KT) {
#pragma unroll
    for (int i = 0; i < W_PER_T; ++i) w_s[threadIdx.x + i * NT] = w[i];
    in_s[threadIdx.x] = in;
    __syncthreads();
    // the next tile's loads fly while this tile is summed
    if (k0 + KT < K) load_tile(x, h, wx, wh, k0 + KT, unit0, row0, B, F, H,
                               w, in);
#pragma unroll 8
    for (int kk = 0; kk < KT; ++kk) {
      const float v = in_s[r * KT + kk];  // one address per warp: broadcast
      const float* wk = w_s + kk * 4 * UNITS + u;
      acc0 = fmaf(v, wk[0], acc0);
      acc1 = fmaf(v, wk[UNITS], acc1);
      acc2 = fmaf(v, wk[2 * UNITS], acc2);
      acc3 = fmaf(v, wk[3 * UNITS], acc3);
    }
    __syncthreads();
  }

  const int b = row0 + r;
  const int unit = unit0 + u;
  if (b < B && unit < H) {
    const float ig = sigmoid_f(acc0 + to_f(bias[unit]));
    const float fg = sigmoid_f(acc1 + to_f(bias[H + unit]));
    const float gg = tanhf(acc2 + to_f(bias[2 * H + unit]));
    const float og = sigmoid_f(acc3 + to_f(bias[3 * H + unit]));
    const size_t at = static_cast<size_t>(b) * H + unit;
    const float cn = fg * to_f(c[at]) + ig * gg;
    store(c2 + at, cn);
    store(h2 + at, og * tanhf(cn));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* h, const void* c,
                   const void* wx, const void* wh, const void* b, void* h2,
                   void* c2, int B, int F, int H, cudaStream_t stream) {
  const dim3 grid((H + UNITS - 1) / UNITS, (B + ROWS - 1) / ROWS, 1);
  lstm_cell_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const T*>(c), static_cast<const T*>(wx),
      static_cast<const T*>(wh), static_cast<const T*>(b),
      static_cast<T*>(h2), static_cast<T*>(c2), B, F, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* lstm_cell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B,F), h (B,H), c (B,H), wx (F,4H), wh (H,4H), b (4H), outputs
// h2, c2 (B,H); all contiguous on the current device and of one type:
// dtype 0 = float32, 1 = bfloat16.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError() (or cudaErrorInvalidValue for
// an unknown dtype).
int lstm_cell_launch(const void* x, const void* h, const void* c,
                     const void* wx, const void* wh, const void* b, void* h2,
                     void* c2, int B, int F, int H, int dtype,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(
        launch<float>(x, h, c, wx, wh, b, h2, c2, B, F, H, s));
  if (dtype == 1)
    return static_cast<int>(
        launch<__nv_bfloat16>(x, h, c, wx, wh, b, h2, c2, B, F, H, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
