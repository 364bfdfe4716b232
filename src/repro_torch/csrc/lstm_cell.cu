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
// under a launch, so what a call costs is the launch plus the memory
// round trips it waits for one after the other.
//
// What the design does about it.  The TPU kernel keeps an (F, 4, bh)
// slab of the weights in VMEM per grid step.  Here the weight read is
// spread over many SMs and paid as one round trip:
//   * a block owns U hidden units, 16 bytes of one gate's columns (4 in
//     float32, 8 in bfloat16), and a tile of 16 batch rows: at H = 256
//     that is 64 blocks in float32 (32 in bfloat16), each with a weight
//     slab of (F+H) x 4 gates x 16 bytes, 17 KB at F = 16; more row
//     tiles when B is larger (two at the update's B = 32, which halve
//     each block's sums against one 32-row tile: 7.3 -> 5.6 us on an
//     H100);
//   * the whole slab and the block's rows of [x, h] go to shared memory
//     with 16-byte cp.async, every copy issued before the one wait; the
//     bias and c of the epilogue are loaded into registers before it, so
//     nothing else waits on memory;
//   * each thread owns one of the 4U (gate, unit) columns and a slice of
//     K = F + H for every row of the tile, sums out of shared memory,
//     and the slices and the four gates of a (row, unit) meet in shared
//     memory for the fused epilogue;
//   * ragged edges: a scalar path (4-byte cp.async in float32, plain
//     loads in bfloat16) stages the units of a block that H does not
//     fill and rows of x or h that do not start on 16 bytes (F = 23);
//     a K too long for the shared memory budget is staged in chunks, one
//     round trip each, so any B, F, H >= 1 runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int NT = 256;                    // threads per block
constexpr int R = 16;                      // batch rows per block
constexpr int SMEM_BUDGET = 96 * 1024;     // dynamic shared memory cap

template <typename T>
struct Cfg {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));  // per 16 B
  static constexpr int U = V;              // hidden units per block
  static constexpr int C = 4 * U;          // weight columns per block
  static constexpr int NP = NT / C;        // slices of K per column
};

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

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src)
               : "memory");
}
// one element: cp.async in float32, a plain copy in bfloat16 (cp.async
// moves 4 bytes at least)
__device__ __forceinline__ void cp1(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp1(__nv_bfloat16* dst,
                                    const __nv_bfloat16* src) {
  *dst = *src;
}

__device__ __forceinline__ bool aligned16(const void* p, size_t elems,
                                          size_t esz) {
  return ((reinterpret_cast<uintptr_t>(p) | (elems * esz)) & 15) == 0;
}

// Copy n elements of `rows` rows (row r at src + r * ld) to dst + r * ldd,
// 16 bytes at a time when every row start and n allow it, else one
// element at a time.  All threads of the block share the work.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ldd, const T* src,
                                           size_t ld, int rows, int n) {
  constexpr int V = Cfg<T>::V;
  if (n <= 0 || rows <= 0) return;
  if (aligned16(src, ld, sizeof(T)) && n % V == 0) {
    const int per = n / V;
    for (int i = threadIdx.x; i < rows * per; i += NT) {
      const int r = i / per, j = i % per;
      cp16(dst + r * ldd + j * V, src + r * ld + j * V);
    }
  } else {
    for (int i = threadIdx.x; i < rows * n; i += NT) {
      const int r = i / n, j = i % n;
      cp1(dst + r * ldd + j, src + r * ld + j);
    }
  }
}

// Shared memory of one chunk of kc input rows: the weight slab
// [kc][4][U] and the inputs [R][ld_in], x's part padded to 16 bytes.
template <typename T>
__host__ __device__ constexpr size_t stage_bytes(int kc) {
  return (static_cast<size_t>(kc) * Cfg<T>::C +
          static_cast<size_t>(R) * (kc + 2 * Cfg<T>::V)) * sizeof(T);
}
__host__ __device__ constexpr size_t reduce_bytes() {
  return static_cast<size_t>(NT) * R * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(NT)
lstm_cell_kernel(const T* __restrict__ x, const T* __restrict__ h,
                 const T* __restrict__ c, const T* __restrict__ wx,
                 const T* __restrict__ wh, const T* __restrict__ bias,
                 T* __restrict__ h2, T* __restrict__ c2, int B, int F, int H,
                 int KC) {
  using CF = Cfg<T>;
  constexpr int U = CF::U, C = CF::C, V = CF::V, NP = CF::NP;
  extern __shared__ __align__(16) unsigned char smem[];
  T* w_s = reinterpret_cast<T*>(smem);            // [kc][4][U]
  T* in_s = w_s + static_cast<size_t>(KC) * C;    // [R][ld_in]
  float* red = reinterpret_cast<float*>(smem);    // [NP][R][C], after use

  const int unit0 = blockIdx.x * U;
  const int row0 = blockIdx.y * R;
  const int rows = min(R, B - row0);
  const int K = F + H;
  const size_t H4 = 4 * static_cast<size_t>(H);

  // the epilogue's bias and c, in flight while the slab is staged
  const int er = threadIdx.x / U, eu = threadIdx.x % U;
  const int eb = row0 + er, eunit = unit0 + eu;
  const bool owner = threadIdx.x < R * U && eb < B && eunit < H;
  float bg[4] = {0.f, 0.f, 0.f, 0.f}, cv = 0.f;
  if (owner) {
#pragma unroll
    for (int g = 0; g < 4; ++g) bg[g] = to_f(bias[g * H + eunit]);
    cv = to_f(c[static_cast<size_t>(eb) * H + eunit]);
  }

  const int col = threadIdx.x % C, part = threadIdx.x / C;
  const bool full_units = unit0 + U <= H;
  const bool w_vec = full_units && aligned16(wx, H, sizeof(T)) &&
                     aligned16(wh, H, sizeof(T));
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  for (int c0 = 0; c0 < K; c0 += KC) {
    const int kc = min(KC, K - c0);
    const int nx = max(0, min(F - c0, kc));          // rows of Wx, x
    const int kh0 = max(c0, F) - F, nh = kc - nx;    // rows of Wh, h
    const int xp = (nx + V - 1) / V * V;             // x's padded part
    const int ld_in = xp + (nh + V - 1) / V * V;

    // the weight slab: 4 gates x 16 bytes per input row
    if (w_vec) {
      for (int i = threadIdx.x; i < kc * 4; i += NT) {
        const int kk = i / 4, g = i % 4, k = c0 + kk;
        const T* src = (k < F ? wx + k * H4 : wh + (k - F) * H4) +
                       static_cast<size_t>(g) * H + unit0;
        cp16(w_s + kk * C + g * U, src);
      }
    } else {
      for (int i = threadIdx.x; i < kc * C; i += NT) {
        const int kk = i / C, g = (i % C) / U, u = i % U, k = c0 + kk;
        T* dst = w_s + i;
        if (unit0 + u < H) {
          const T* src = (k < F ? wx + k * H4 : wh + (k - F) * H4) +
                         static_cast<size_t>(g) * H + unit0 + u;
          cp1(dst, src);
        } else {
          *dst = T(0.0f);
        }
      }
    }
    // the block's rows of [x, h]
    stage_rows(in_s, ld_in, x + static_cast<size_t>(row0) * F + c0, F, rows,
               nx);
    stage_rows(in_s + xp, ld_in, h + static_cast<size_t>(row0) * H + kh0, H,
               rows, nh);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
                 ::: "memory");
    __syncthreads();

    // this thread's column over its slice of the chunk, every row
    const int per = (kc + NP - 1) / NP;
    const int k_lo = part * per, k_hi = min(kc, k_lo + per);
    for (int kk = k_lo; kk < k_hi; ++kk) {
      const float w = to_f(w_s[kk * C + col]);
      const T* in = in_s + (kk < nx ? kk : xp + kk - nx);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(to_f(in[r * ld_in]), w, acc[r]);
    }
    __syncthreads();                    // the chunk's buffers are free
  }

#pragma unroll
  for (int r = 0; r < R; ++r) red[(part * R + r) * C + col] = acc[r];
  __syncthreads();

  if (owner) {
    float gs[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float s = bg[g];
#pragma unroll
      for (int p = 0; p < NP; ++p) s += red[(p * R + er) * C + g * U + eu];
      gs[g] = s;
    }
    const float ig = sigmoid_f(gs[0]);
    const float fg = sigmoid_f(gs[1]);
    const float gg = tanhf(gs[2]);
    const float og = sigmoid_f(gs[3]);
    const size_t at = static_cast<size_t>(eb) * H + eunit;
    const float cn = fg * cv + ig * gg;
    store(c2 + at, cn);
    store(h2 + at, og * tanhf(cn));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* h, const void* c,
                   const void* wx, const void* wh, const void* b, void* h2,
                   void* c2, int B, int F, int H, cudaStream_t stream) {
  constexpr int V = Cfg<T>::V, C = Cfg<T>::C;
  auto kern = lstm_cell_kernel<T>;
  // the attribute belongs to the current device: set it once on each
  constexpr int MAX_DEVICES = 64;
  static std::atomic<bool> budget_set[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !budget_set[dev].load()) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BUDGET);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) budget_set[dev].store(true);
  }
  // the longest chunk of K that fits the budget (one chunk at the
  // training shapes); several chunks start on multiples of 8 rows
  const int K = F + H;
  int KC = K;
  if (stage_bytes<T>(K) > SMEM_BUDGET) {
    const size_t fixed = static_cast<size_t>(R) * 2 * V * sizeof(T);
    const size_t per_k = static_cast<size_t>(C + R) * sizeof(T);
    KC = static_cast<int>((SMEM_BUDGET - fixed) / per_k) / 8 * 8;
  }
  size_t smem = stage_bytes<T>(KC);
  if (smem < reduce_bytes()) smem = reduce_bytes();
  const dim3 grid((H + Cfg<T>::U - 1) / Cfg<T>::U, (B + R - 1) / R, 1);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const T*>(c), static_cast<const T*>(wx),
      static_cast<const T*>(wh), static_cast<const T*>(b),
      static_cast<T*>(h2), static_cast<T*>(c2), B, F, H, KC);
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
