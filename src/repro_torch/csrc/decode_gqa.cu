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
// is bound by bytes: 2*length*Hkv*D*sizeof(T) per sequence at 3.35 TB/s
// (34.6 MB, 0.0103 ms, at the internlm2-1.8b decode shape (4, 16, 8,
// 2176, 128) with lengths 2112).  Reaching it takes many bytes in flight
// on every SM: by Little's law about 3.4 MB over the card at ~1 us of
// memory latency.
//
// What the design does about it.  The cache is split over the card, then
// merged:
//   * decode_gqa_split, grid (n_split, Hkv, B): a block of 4 warps
//     owns `rows` cache positions of one (KV head, batch row) and computes all
//     Hq/Hkv query heads of the group, so each K/V row leaves device
//     memory once.  n_split and rows come from the wrapper's planner
//     (ops.split_plan), a function of the static shapes and the SM count
//     only: the launch never reads `length` on the host, so it can be
//     captured in a CUDA graph.  A block whose run starts at or past
//     length[b] exits at once.
//   * a row is read by a group of lanes, 16 bytes a lane (8 bytes in
//     bf16 at group 16, to keep the accumulators in registers); each lane
//     loads U = 4 rows of K and V before it uses any, 16 KB in flight per
//     block at the main shape (at most 128 registers: four blocks and
//     64 KB per SM), and keeps its own float32 online softmax (m, l) and
//     accumulator slice for every query head of the group; q.k is a
//     shuffle reduction over the row's lanes;
//   * the lanes' states, then the 4 warps', are merged in the block;
//     with one split the block writes o, else its partial (m, l, acc[D])
//     goes to a float32 scratch the wrapper allocates;
//   * decode_gqa_merge, grid (Hq, B), D threads: the log-sum-exp
//     rescale of the partials of the splits that length[b] reaches.
// Scores are kept in the log2 domain (the scale carries log2(e)).  D
// must be 64 or 128 and Hq/Hkv one of 1, 2, 4, 8, 16; the wrapper raises
// otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int NW = 4;       // warps per split block
constexpr int NT = NW * 32;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VB bytes of a row held by one lane: EPL elements of T.
template <int VB>
struct Vec;
template <>
struct Vec<16> { uint4 r; };
template <>
struct Vec<8> { uint2 r; };

template <int VB>
__device__ __forceinline__ Vec<VB> load_vec(const void* p) {
  Vec<VB> v;
  if constexpr (VB == 16)
    v.r = __ldg(reinterpret_cast<const uint4*>(p));
  else
    v.r = __ldg(reinterpret_cast<const uint2*>(p));
  return v;
}

template <int VB>
__device__ __forceinline__ void zero_vec(Vec<VB>& v) {
  if constexpr (VB == 16)
    v.r = make_uint4(0u, 0u, 0u, 0u);
  else
    v.r = make_uint2(0u, 0u);
}

// element e of a vector as float32
template <typename T, int VB>
__device__ __forceinline__ float elem(const Vec<VB>& v, int e) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&v.r);
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[e]);
  } else {  // bf16: element 2i in the low half of word i
    const uint32_t x = w[e >> 1];
    return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
  }
}

template <typename T, int G>
struct Shape {
  static constexpr int EPL16 = 16 / static_cast<int>(sizeof(T));
  // elements a lane holds: 16 bytes, or 8 in bf16 at G = 16
  static constexpr int EPL = (G * EPL16 <= 64) ? EPL16 : EPL16 / 2;
  static constexpr int VB = EPL * static_cast<int>(sizeof(T));
  // rows per lane in flight, and blocks per SM the registers allow
  static constexpr int U = G * EPL <= 32 ? 4 : 2;
  static constexpr int MINB = G * EPL <= 16 ? 4 : 2;
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(NT, (Shape<T, G>::MINB))
decode_gqa_split(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ length,
                 float* __restrict__ part_acc, float* __restrict__ part_ml,
                 T* __restrict__ o, int Hq, int Hkv, int S, int rows,
                 int n_split, float scale_log2) {
  using Sh = Shape<T, G>;
  constexpr int EPL = Sh::EPL, VB = Sh::VB, U = Sh::U;
  constexpr int LPR = D / EPL;   // lanes per row
  constexpr int RPW = 32 / LPR;  // rows a warp reads at once
  constexpr int STEP = RPW * U;  // rows a warp covers per iteration
  static_assert(LPR * EPL == D && RPW * LPR == 32, "row does not split");
  __shared__ float sm_acc[NW][G * D];
  __shared__ float sm_m[NW][G], sm_l[NW][G];

  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int L = min(max(length[b], 0), S);
  const int s0 = sp * rows;
  if (n_split > 1 && s0 >= L) return;  // the merge reads only used splits
  const int s1 = min(L, s0 + rows);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = lane / LPR, c = lane % LPR;
  const size_t kv0 = (static_cast<size_t>(b) * Hkv + hk) * S * D + c * EPL;
  const T* kp = k + kv0;
  const T* vp = v + kv0;
  const size_t q0 = (static_cast<size_t>(b) * Hq + hk * G) * D;

  float qf[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const Vec<VB> qv = load_vec<VB>(q + q0 + g * D + c * EPL);
#pragma unroll
    for (int e = 0; e < EPL; ++e) qf[g][e] = elem<T, VB>(qv, e) * scale_log2;
  }
  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int base = s0 + warp * STEP; base < s1; base += NW * STEP) {
    Vec<VB> kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = base + u * RPW + r;
      if (row < s1) {
        kr[u] = load_vec<VB>(kp + static_cast<size_t>(row) * D);
        vr[u] = load_vec<VB>(vp + static_cast<size_t>(row) * D);
      } else {
        zero_vec(kr[u]);
        zero_vec(vr[u]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          part = fmaf(qf[g][e], elem<T, VB>(kr[u], e), part);
        s[u] = part;
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      float mc = NEG_INF;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (base + u * RPW + r >= s1) s[u] = NEG_INF;
        mc = fmaxf(mc, s[u]);
      }
      const float m_new = fmaxf(m[g], mc);
      const float corr = exp2f(m[g] - m_new);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p =
            base + u * RPW + r < s1 ? exp2f(s[u] - m_new) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[g][e] = fmaf(p, elem<T, VB>(vr[u], e), acc[g][e]);
      }
      m[g] = m_new;
    }
  }

  // merge the row groups of the warp (lanes of equal c)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float f = exp2f(m[g] - mn), fo = exp2f(mo - mn);
      l[g] = l[g] * f + lo * fo;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * f + ao * fo;
      }
      m[g] = mn;
    }
  }
  if (r == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        sm_acc[warp][g * D + c * EPL + e] = acc[g][e];
      if (c == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps; write o (one split) or this split's partial
  for (int t = threadIdx.x; t < G * D; t += NT) {
    const int g = t / D, d = t % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = exp2f(sm_m[w][g] - mx);
      num = fmaf(sm_acc[w][t], f, num);
      den = fmaf(sm_l[w][g], f, den);
    }
    const size_t bh = static_cast<size_t>(b) * Hq + hk * G + g;
    if (n_split == 1) {
      o[bh * D + d] = from_f<T>(num / fmaxf(den, 1e-30f));
    } else {
      const size_t pidx = bh * n_split + sp;
      part_acc[pidx * D + d] = num;
      if (d == 0) {
        part_ml[2 * pidx] = mx;
        part_ml[2 * pidx + 1] = den;
      }
    }
  }
}

// One block of D threads per (query head, batch row): the log-sum-exp
// merge of the splits that hold positions below length[b].
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_gqa_merge(const float* __restrict__ part_acc,
                 const float* __restrict__ part_ml,
                 const int* __restrict__ length, T* __restrict__ o, int Hq,
                 int S, int rows, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int L = min(max(length[b], 0), S);
  const int used = min(n_split, (L + rows - 1) / rows);
  const size_t bh = static_cast<size_t>(b) * Hq + h;
  const float* ml = part_ml + 2 * bh * n_split;
  const float* pa = part_acc + bh * n_split * D + d;
  float mx = NEG_INF;
  for (int s = 0; s < used; ++s) mx = fmaxf(mx, ml[2 * s]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < used; ++s) {
    const float f = exp2f(ml[2 * s] - mx);
    num = fmaf(pa[static_cast<size_t>(s) * D], f, num);
    den = fmaf(ml[2 * s + 1], f, den);
  }
  o[bh * D + d] = from_f<T>(num / fmaxf(den, 1e-30f));
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const int* length,
           void* o, float* part, int B, int Hq, int Hkv, int S, int rows,
           int n_split, cudaStream_t stream) {
  const float scale_log2 = LOG2E / sqrtf(static_cast<float>(D));
  float* part_acc = part;  // then (m, l) of every partial
  float* part_ml = n_split > 1
                       ? part + static_cast<size_t>(B) * Hq * n_split * D
                       : nullptr;
  decode_gqa_split<T, D, G><<<dim3(n_split, Hkv, B), NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, part_acc, part_ml,
      static_cast<T*>(o), Hq, Hkv, S, rows, n_split, scale_log2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return static_cast<int>(e);
  decode_gqa_merge<T, D><<<dim3(Hq, B), D, 0, stream>>>(
      part_acc, part_ml, length, static_cast<T*>(o), Hq, S, rows, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_g(const void* q, const void* k, const void* v, const int* length,
             void* o, float* part, int B, int Hq, int Hkv, int S, int rows,
             int n_split, cudaStream_t st) {
#define DGQA_CASE(G)                                                     \
  case G:                                                                \
    return launch<T, D, G>(q, k, v, length, o, part, B, Hq, Hkv, S, rows, \
                           n_split, st);
  switch (Hq / Hkv) {
    DGQA_CASE(1)
    DGQA_CASE(2)
    DGQA_CASE(4)
    DGQA_CASE(8)
    DGQA_CASE(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DGQA_CASE
}

}  // namespace

extern "C" {

const char* decode_gqa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B,Hq,1,D), k/v (B,Hkv,S,D), o (B,Hq,1,D) contiguous, float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1); length (B,) int32; all on the
// current device.  D in {64, 128}, Hq/Hkv in {1, 2, 4, 8, 16}.  The cache
// is cut into n_split runs of `rows` positions (n_split * rows >= S);
// with n_split > 1, `part` is float32 scratch of B*Hq*n_split*(D+2)
// elements.  Launches on `stream` (two kernels when n_split > 1), does
// not synchronise, returns cudaGetLastError() (cudaErrorInvalidValue for
// a shape or plan it does not take).
int decode_gqa_launch(const void* q, const void* k, const void* v,
                      const int* length, void* o, void* part, int B, int Hq,
                      int Hkv, int S, int D, int is_bf16, int rows,
                      int n_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv || rows <= 0 || n_split <= 0 ||
      static_cast<long long>(rows) * n_split < S ||
      (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(part);
  if (is_bf16) {
    if (D == 64)
      return launch_g<__nv_bfloat16, 64>(q, k, v, length, o, p, B, Hq, Hkv,
                                         S, rows, n_split, st);
    if (D == 128)
      return launch_g<__nv_bfloat16, 128>(q, k, v, length, o, p, B, Hq, Hkv,
                                          S, rows, n_split, st);
  } else {
    if (D == 64)
      return launch_g<float, 64>(q, k, v, length, o, p, B, Hq, Hkv, S, rows,
                                 n_split, st);
    if (D == 128)
      return launch_g<float, 128>(q, k, v, length, o, p, B, Hq, Hkv, S, rows,
                                  n_split, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
