// Blocked prefill attention for Hopper (sm_90a): causal or sliding-window
// masks, grouped-query heads, an online softmax over key tiles.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
//   (body _flash_kernel)
// and computes the same function: q (B,Hq,S,D), k/v (B,Hkv,S,D) ->
// o (B,Hq,S,D) in q's dtype; query head h reads KV head h / (Hq/Hkv);
// query i sees key j when (not causal or i >= j) and (window <= 0 or
// i - j < window); float32 running (m, l, acc) per query row and a final
// acc / max(l, 1e-30).
//
// What bounds it on an H100.  A causal call does 2*2*B*Hq*S*S/2*D
// operations on B*S*D*(2*Hq + 2*Hkv) elements: at the internlm2-1.8b
// prefill (B=4, Hq=16, Hkv=8, S=2048, D=128, bf16) that is 68.7 GFLOP
// against 0.1 GB, 69 us at the 989 TFLOP/s bf16 tensor-core peak and
// 30 us at 3.35 TB/s: operations bound it.
//
// What the design does about it.  The TPU kernel walks a sequential grid
// (B, Hq, S/bq, S/bk) and keeps (m, l, acc) in VMEM scratch across the
// key tiles.  On Hopper the blocks run in parallel and in no order, so
// the key-tile axis becomes a loop inside one block:
//   * one block (256 threads) per (64-row query tile, query head, batch
//     row); the query tile sits in shared memory as float32 for the
//     whole loop, and each 64-row K and V tile is staged through shared
//     memory once per block, converted to float32 on the way;
//   * each thread owns a 4x4 patch of the 64x64 score tile and 4 rows x
//     D/16 columns of the output accumulator in registers; a row's 16
//     owners are 16 lanes of one warp, so the row max and row sum are
//     warp shuffles; P goes through shared memory for the P.V product;
//   * whole tiles that are in the future of every query of the block
//     (causal) or out of the window of every query are never visited,
//     as the TPU kernel skips them with pl.when; blocks are issued from
//     the last query tile down, so the longest causal rows start first;
//   * any S: the ragged last tile is masked by bounds predicates, with no
//     padding on the host.
// This first kernel computes with float32 FMA, not tensor cores, so it
// stays well above the operations bound; mma/wgmma tiles, a pipelined
// TMA ring and bf16 operands are later work.
// D must be 64 or 128; the wrapper raises otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // key rows per tile
constexpr int NT = 256;   // threads per block: 16 row groups x 16 lanes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// 16-byte vector of T: 4 floats or 8 bf16.
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};

// Stage rows [row0, row0 + rows) of a (S, D) matrix into shared memory
// as float32 with leading dimension ld; rows >= S become zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const T* __restrict__ src, int row0,
                                      int rows, int S) {
  constexpr int V = Vec16<T>::N;
  constexpr int CPR = D / V;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * CPR; idx += NT) {
    const int r = idx / CPR, c = idx % CPR;
    const int row = row0 + r;
    float* out = dst + r * ld + c * V;
    if (row < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row) * D + c * V);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = to_f(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = 0.f;
    }
  }
}

constexpr size_t smem_floats(int D) {
  // Q (BQ x D+1), K (BK x D+1), V (BK x D), P (BQ x BK+1); the +1 pads
  // keep the column reads of Q, K and P free of bank conflicts.
  return static_cast<size_t>(BQ) * (D + 1) + static_cast<size_t>(BK) * (D + 1) +
         static_cast<size_t>(BK) * D + static_cast<size_t>(BQ) * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq,
                       int Hkv, int S, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * (D + 1);
  float* Vs = Ks + BK * (D + 1);
  float* Ps = Vs + BK * D;
  constexpr int NC = D / 16;  // output columns per thread

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  const T* qb = q + (static_cast<size_t>(b) * Hq + h) * S * D;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * S * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * S * D;
  T* ob = o + (static_cast<size_t>(b) * Hq + h) * S * D;

  stage<T, D>(Qs, D + 1, qb, q0, BQ, S);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // key tiles that hold a visible key for some query row of the block
  int kt_end = (S + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage<T, D>(Ks, D + 1, kb, k0, BK, S);
    stage<T, D>(Vs, D, vb, k0, BK, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < S && (!causal || qpos >= kpos) &&
                (window <= 0 || qpos - kpos < window);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int jd = 0; jd < NC; ++jd) {
        const float vv = Vs[c * D + tx + 16 * jd];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jd] = fmaf(pa[i], vv, acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float lsafe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < NC; ++jd)
      ob[static_cast<size_t>(row) * D + tx + 16 * jd] =
          from_f<T>(acc[i][jd] / lsafe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int causal, int window,
           cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, D>;
  const size_t smem = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, S, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory one block needs at head dim D.
size_t flash_attention_smem_bytes(int D) {
  return smem_floats(D) * sizeof(float);
}

// q (B,Hq,S,D), k/v (B,Hkv,S,D), o (B,Hq,S,D), all contiguous on the
// current device, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// D in {64, 128}; Hq a multiple of Hkv.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError() (cudaErrorInvalidValue for a
// D it does not take).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Hq, int Hkv, int S, int D,
                           int is_bf16, int causal, int window,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64)
      return launch<__nv_bfloat16, 64>(q, k, v, o, B, Hq, Hkv, S, causal,
                                       window, st);
    if (D == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, o, B, Hq, Hkv, S, causal,
                                        window, st);
  } else {
    if (D == 64)
      return launch<float, 64>(q, k, v, o, B, Hq, Hkv, S, causal, window,
                               st);
    if (D == 128)
      return launch<float, 128>(q, k, v, o, B, Hq, Hkv, S, causal, window,
                                st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
