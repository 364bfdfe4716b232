// One-token grouped-query decode attention for Hopper (sm_90a): one
// query token per sequence against its KV cache, with a per-sequence
// length mask.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_gqa/decode_gqa.py::decode_attention_pallas
//   (body _decode_kernel)
// and computes the same function: q (B,Hq,1,D), k/v (B,Hkv,S,D), length
// (B,) int32 -> o (B,Hq,1,D) in q's dtype; query head h reads KV head
// h / (Hq/Hkv); positions >= length[b] are masked; float32 running
// (m, l, acc) and a final acc / max(l, 1e-30).  At length 0 it returns
// zeros, as the TPU kernel does (the plain version returns the mean of
// V there; the model path never asks for length 0).
//
// What bounds it on an H100.  Decode reads every cached K and V row up
// to length once and does 4*D operations per row and query head, so it
// is bound by bytes: 2*length*Hkv*D*sizeof(T) per sequence at 3.35 TB/s.
//
// What the design does about it.  The TPU grid (B, Hq, S/bk) reads each
// K/V row once per query head.  Here one block (8 warps) per (KV head,
// batch row) computes all Hq/Hkv query heads of the group, so each K/V
// row leaves device memory once, as in the grouped plain version:
//   * the key axis is split over the 8 warps in chunks of 8 rows; a lane
//     holds D/32 contiguous elements of a row, so a warp reads a row as
//     one coalesced line, and the 8 rows of a chunk are loaded before
//     any is used, 64 K/V rows in flight per block;
//   * each warp keeps its own float32 online softmax (m, l) and D/32
//     accumulator elements per lane for every query head of the group;
//     q.k is a warp all-reduce;
//   * at the end the 8 warps' partial states are merged through shared
//     memory, one query head at a time.
// Only positions < length[b] are read, so the work follows this call's
// lengths.  The grid is Hkv*B blocks, 32 at B=4 on 132 SMs: too few to
// reach the bandwidth bound without a split over S, which is later work.
// D must be 64 or 128 and Hq/Hkv one of 1, 2, 4, 8, 16; the wrapper
// raises otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int NW = 8;       // warps per block
constexpr int NT = NW * 32;
constexpr int U = 8;        // K/V rows per warp per chunk
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
  return __float2bfloat16(x);
}

// Load N contiguous elements of T as float32 (N * sizeof(T) is 4, 8 or
// 16 bytes, and the address is aligned to it).
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* __restrict__ p,
                                       float (&out)[N]) {
  constexpr int BYTES = N * sizeof(T);
  if constexpr (BYTES == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
  } else if constexpr (BYTES == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
  } else {
    static_assert(BYTES == 4, "4, 8 or 16 bytes per lane");
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
  }
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(NT)
decode_gqa_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ length,
                  T* __restrict__ o, int Hq, int Hkv, int S, float scale) {
  constexpr int DPL = D / 32;  // elements of a row per lane
  __shared__ float sm_acc[NW][D];
  __shared__ float sm_m[NW], sm_l[NW];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = min(max(length[b], 0), S);
  const size_t kv0 = (static_cast<size_t>(b) * Hkv + hk) * S * D + lane * DPL;
  const T* kp = k + kv0;
  const T* vp = v + kv0;
  const size_t q0 = (static_cast<size_t>(b) * Hq + hk * G) * D;

  float qf[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) load_f<T, DPL>(q + q0 + g * D + lane * DPL, qf[g]);

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
  }

  for (int base = warp * U; base < L; base += NW * U) {
    float kf[U][DPL], vf[U][DPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u < L) {
        load_f<T, DPL>(kp + static_cast<size_t>(base + u) * D, kf[u]);
        load_f<T, DPL>(vp + static_cast<size_t>(base + u) * D, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < DPL; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) part = fmaf(qf[g][e], kf[u][e], part);
        s[u] = part;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      float mc = NEG_INF;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = base + u < L ? s[u] * scale : NEG_INF;
        mc = fmaxf(mc, s[u]);
      }
      const float m_new = fmaxf(m[g], mc);
      const float corr = expf(m[g] - m_new);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = base + u < L ? expf(s[u] - m_new) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(p, vf[u][e], acc[g][e]);
      }
      m[g] = m_new;
    }
  }

  // merge the warps' partial states, one query head at a time
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < DPL; ++e) sm_acc[warp][lane * DPL + e] = acc[g][e];
    if (lane == 0) {
      sm_m[warp] = m[g];
      sm_l[warp] = l[g];
    }
    __syncthreads();
    if (threadIdx.x < D) {
      const int d = threadIdx.x;
      float mx = NEG_INF;
#pragma unroll
      for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w]);
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float f = expf(sm_m[w] - mx);
        num = fmaf(sm_acc[w][d], f, num);
        den = fmaf(sm_l[w], f, den);
      }
      o[q0 + g * D + d] = from_f<T>(num / fmaxf(den, 1e-30f));
    }
    __syncthreads();
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const int* length,
           void* o, int B, int Hq, int Hkv, int S, cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  decode_gqa_kernel<T, D, G><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, static_cast<T*>(o), Hq, Hkv, S,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_g(const void* q, const void* k, const void* v, const int* length,
             void* o, int B, int Hq, int Hkv, int S, cudaStream_t st) {
  switch (Hq / Hkv) {
    case 1: return launch<T, D, 1>(q, k, v, length, o, B, Hq, Hkv, S, st);
    case 2: return launch<T, D, 2>(q, k, v, length, o, B, Hq, Hkv, S, st);
    case 4: return launch<T, D, 4>(q, k, v, length, o, B, Hq, Hkv, S, st);
    case 8: return launch<T, D, 8>(q, k, v, length, o, B, Hq, Hkv, S, st);
    case 16: return launch<T, D, 16>(q, k, v, length, o, B, Hq, Hkv, S, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* decode_gqa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B,Hq,1,D), k/v (B,Hkv,S,D), o (B,Hq,1,D) contiguous, float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1); length (B,) int32; all on the
// current device.  D in {64, 128}, Hq/Hkv in {1, 2, 4, 8, 16}.  Launches
// on `stream`, does not synchronise, returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
int decode_gqa_launch(const void* q, const void* k, const void* v,
                      const int* length, void* o, int B, int Hq, int Hkv,
                      int S, int D, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    if (D == 64)
      return launch_g<__nv_bfloat16, 64>(q, k, v, length, o, B, Hq, Hkv, S,
                                         st);
    if (D == 128)
      return launch_g<__nv_bfloat16, 128>(q, k, v, length, o, B, Hq, Hkv, S,
                                          st);
  } else {
    if (D == 64)
      return launch_g<float, 64>(q, k, v, length, o, B, Hq, Hkv, S, st);
    if (D == 128)
      return launch_g<float, 128>(q, k, v, length, o, B, Hq, Hkv, S, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
