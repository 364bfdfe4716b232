// Blocked prefill attention for Hopper (sm_90a): causal or sliding-window
// masks, or none (an encoder, or cross-attention with Sk keys for Sq
// queries), grouped-query heads, an online softmax over key tiles.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
//   (body _flash_kernel)
// and computes the same function: q (B,Hq,Sq,D), k/v (B,Hkv,Sk,D) ->
// o (B,Hq,Sq,D) in q's dtype; query head h reads KV head h / (Hq/Hkv);
// query i sees key j < Sk when (not causal or i >= j) and (window <= 0
// or i - j < window); masked scores are -1e30 and their weights 0;
// float32 running (m, l, acc) per query row and a final
// acc / max(l, 1e-30).  Sq and Sk differ only without the causal mask
// (the wrapper refuses the rest): query tiles and the output run over
// Sq rows, key tiles and the key mask over Sk.
//
// What bounds it on an H100.  A causal call does 2*2*B*Hq*S*S/2*D
// operations on B*S*D*(2*Hq + 2*Hkv) elements: at the internlm2-1.8b
// prefill (B=4, Hq=16, Hkv=8, S=2048, D=128, bf16) that is 68.7 GFLOP
// against 0.1 GB, 69 us at the 989 TFLOP/s bf16 tensor-core peak and
// 30 us at 3.35 TB/s: operations bound it, and only the tensor cores
// (wgmma) come near that rate.  A call without the mask does
// 4*B*Hq*Sq*Sk*D: at whisper-tiny's encoder (B=8, Hq=Hkv=6,
// Sq=Sk=1500, D=64) 27.6 GFLOP, 28 us.
//
// bfloat16: a warp-specialised tensor-core kernel.  The TPU kernel walks
// a sequential grid (B, Hq, S/bq, S/bk) and keeps (m, l, acc) in VMEM
// scratch across the key tiles; here blocks run in parallel and in no
// order, so the key-tile axis is a loop inside one block:
//   * one block per 128-row query tile of one (batch, query head): two
//     consumer warpgroups of 64 query rows each (wgmma's M) and a
//     producer warpgroup, one thread of which issues every TMA load (the
//     other three warps only hand their registers to the consumers with
//     setmaxnreg); the Q tile is loaded once;
//   * K and V tiles of 128 rows stream through a 3-stage ring in shared
//     memory with 128-byte swizzle (at D = 128: Q 32 KB + 3 x 64 KB,
//     225 KB of the 227 KB a block may use), loaded by TMA from 3-D
//     tensor maps (D, Sq or Sk, B*H): rows past the end are zero-filled
//     and never read from the next head; each stage has a K-full, a V-full and an empty
//     mbarrier, so S = Q.K^T starts before V has landed;
//   * S = Q.K^T is wgmma m64n128k16 with both operands K-major in shared
//     memory (a 128-wide head is two 64-column swizzle boxes), float32
//     sums; the scale 1/sqrt(D) (times log2 e, for exp2) is applied to
//     the float32 scores; masks are applied only on tiles that cross the
//     diagonal, the window's edge or Sk; row max and row sum are quad
//     shuffles over the accumulator layout;
//   * O += P.V is wgmma with A = P in registers (the float32 scores
//     rounded to bf16 pairs in place) and B = the V tile, MN-major, read
//     through wgmma's transpose bit; (m, l, O) stay float32;
//   * within a warpgroup, tile j's S = Q.K^T is issued before tile j-1's
//     O += P.V, so tile j's softmax runs on the CUDA cores while the
//     tensor cores do the P.V; the P of two tiles alternate between two
//     register arrays (a copy between them would serialise the wgmma),
//     and setmaxnreg moves the producer warpgroup's registers to the
//     consumers so none of it spills;
//   * whole tiles in the future of every row of the block (causal) or
//     out of the window of every row are never loaded, as the TPU kernel
//     skips them with pl.when; the query-tile index is the grid's slow
//     axis, issued from the last tile down, so the longest causal rows
//     start first.
// Rounding P to bf16 before P.V differs from the plain version (float32
// P) by at most 2^-9 relative per weight, inside the tolerance
// (kernels/attn_tolerance.py).
//
// float32: the first (FMA) kernel, kept as it was: one block of 256
// threads per 64-row query tile, K/V staged through shared memory as
// float32, each thread a 4x4 patch of the scores; TF32 tensor cores
// would not meet float32's 1e-4 tolerance.  No model path calls it.
// D must be 64 or 128; the wrapper raises otherwise.

#include <cuda.h>  // CUtensorMap and its enums (no link against libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {


constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // key rows per tile
constexpr int NT = 256;   // threads per block: 16 row groups x 16 lanes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

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
                       int Hkv, int Sq, int Sk, int causal, int window,
                       float scale) {
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
  const T* qb = q + (static_cast<size_t>(b) * Hq + h) * Sq * D;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  T* ob = o + (static_cast<size_t>(b) * Hq + h) * Sq * D;

  stage<T, D>(Qs, D + 1, qb, q0, BQ, Sq);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // key tiles that hold a visible key for some query row of the block
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage<T, D>(Ks, D + 1, kb, k0, BK, Sk);
    stage<T, D>(Vs, D, vb, k0, BK, Sk);
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
        ok[j] = kpos < Sk && (!causal || qpos >= kpos) &&
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
    if (row >= Sq) continue;
    const float lsafe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < NC; ++jd)
      ob[static_cast<size_t>(row) * D + tx + 16 * jd] =
          from_f<T>(acc[i][jd] / lsafe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, int causal, int window,
           cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, D>;
  const size_t smem = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Sk, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// bfloat16: TMA + wgmma
// ---------------------------------------------------------------------
namespace tc {

constexpr int BQ = 128;       // query rows per block: 2 warpgroups x 64
constexpr int BKV = 128;      // key rows per K / V tile
constexpr int STAGES = 3;     // K/V ring depth
constexpr int NT = 384;       // 2 consumer warpgroups + 1 producer
constexpr int ROW = 128;      // bytes of one swizzled row: 64 bf16
constexpr int BOX = 64;       // bf16 columns of one TMA box

template <int D>
struct Layout {
  static constexpr int NH = D / BOX;                  // boxes per row
  static constexpr uint32_t Q_BYTES = NH * BQ * ROW;
  static constexpr uint32_t KV_BYTES = NH * BKV * ROW;  // one K or V tile
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, then k_full, v_full and empty for each stage
  static constexpr uint32_t BYTES = BAR_OFF + 8 * (1 + 3 * STAGES)
                                    + 1024;  // slack to align to 1024
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// arrive once and expect `bytes` of TMA traffic on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; lbo / sbo in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from touching accumulators across the async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// D (64 x 128, float32) (+)= A (64 x 16, bf16, shared memory, K-major)
//   x B (16 x 128, bf16, shared memory, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, float32) += A (64 x 16, bf16 pairs in registers)
//   x B (16 x 128, bf16, shared memory, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "n"(1));
}

// D (64 x 64, float32) += A (64 x 16, bf16 pairs in registers)
//   x B (16 x 64, bf16, shared memory, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "n"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x BKV) = Q (64 x D) K^T for one warpgroup: both K-major; a k16
// slice is 32 bytes into a 128-byte row, a 64-column box boundary a jump
// to the next box.  Issues D / 16 wgmma, does not commit.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[BKV / 2], uint32_t q,
                                         uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n128(sc, sw128_desc(q + (kk / 4) * BQ * ROW + off, 16, 1024),
                  sw128_desc(k + (kk / 4) * BKV * ROW + off, 16, 1024),
                  kk > 0);
  }
}

// O (64 x D) += P (64 x BKV, registers) V (BKV x D): V is MN-major (D
// contiguous); a k16 slice is 16 key rows (2048 bytes), the two 64-column
// boxes of D = 128 lie BKV * 128 bytes apart (the leading byte offset).
// Issues BKV / 16 wgmma after a fence, does not commit.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&p)[BKV / 4],
                                         uint32_t v) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    wgmma_pv<D>(acc, a, sw128_desc(v + kk * 16 * ROW, BKV * ROW, 1024));
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one score tile.  Masks (MASK: the tile crosses
// the diagonal, the window's edge or Sk) set a score to -1e30; the rows'
// running max m is kept scaled to the log2 domain, so a weight is one
// FMA and one ex2 of the float32 score: 2^(s * scale_log2 - m).  Updates
// m and this thread's part of the row sums l, writes P as bf16 pairs
// laid out as wgmma's register A fragments (k16 slice kk is
// p[4 kk .. 4 kk + 3]); corr is the factor by which the output
// accumulated so far must shrink.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BKV / 2],
                                             uint32_t (&p)[BKV / 4],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int r0, int t,
                                             int k0, int Sk, int causal,
                                             int window, float scale_log2) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < BKV / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (MASK) {
        const int row = r0 + 8 * (j >> 1);
        const int col = k0 + 8 * i + 2 * t + (j & 1);
        const bool ok = col < Sk && (!causal || row >= col) &&
                        (window <= 0 || row - col < window);
        if (!ok) sc[4 * i + j] = NEG_INF;
      }
      mx[j >> 1] = fmaxf(mx[j >> 1], sc[4 * i + j]);
    }
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < BKV / 8; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float s0 = sc[4 * i + 2 * r], s1 = sc[4 * i + 2 * r + 1];
      // a masked score's weight is 0, also when its whole row is masked
      const float p0 = MASK && s0 == NEG_INF
                           ? 0.f : ex2(fmaf(s0, scale_log2, neg_m[r]));
      const float p1 = MASK && s1 == NEG_INF
                           ? 0.f : ex2(fmaf(s1, scale_log2, neg_m[r]));
      l[r] += p0 + p1;
      p[2 * i + r] = pack_bf16(p0, p1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int Sq,
                   int Sk, int causal, int window, float scale_log2) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::K_OFF, v_s = base + L::V_OFF;
  const uint32_t q_full = base + L::BAR_OFF;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * STAGES + s); };

  const int bh = blockIdx.x;                   // b * Hq + h
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);    // b * Hkv + hk
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last tile first

  // key tiles that hold a visible key for some query row of the block
  int kt_end = (Sk + BKV - 1) / BKV;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BKV + 1);
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BKV : 0;
  const int n_tiles = kt_end - kt_begin;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);                  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Registers are handed out per warpgroup: every thread starts with
  // 168; the producer warpgroup gives back all but 24 and the consumers
  // take 240, which their two accumulators, P and the next tile's P need
  // without spilling.
  if (warp >= 8) {                             // producer: one thread
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int j = 0; j < L::NH; ++j)
        tma_load(q_s + j * BQ * ROW, &qmap, q_full, j * BOX, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(s), ((it / STAGES) - 1) & 1);
        const int k0 = (kt_begin + it) * BKV;
        const uint32_t ks = k_s + s * L::KV_BYTES, vs = v_s + s * L::KV_BYTES;
        mbar_expect_tx(k_full(s), L::KV_BYTES);
        for (int j = 0; j < L::NH; ++j)
          tma_load(ks + j * BKV * ROW, &kmap, k_full(s), j * BOX, k0, kvh);
        mbar_expect_tx(v_full(s), L::KV_BYTES);
        for (int j = 0; j < L::NH; ++j)
          tma_load(vs + j * BKV * ROW, &vmap, v_full(s), j * BOX, k0, kvh);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; in the
  // accumulator layout a thread holds rows r0 and r0 + 8, and of each
  // 8-column group the columns 2t and 2t + 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp / 4;
  const int t = lane % 4;
  const int row_lo = q0 + 64 * wg;
  const int r0 = row_lo + 16 * (warp % 4) + lane / 4;
  const uint32_t q_wg = q_s + wg * 64 * ROW;
  // a tile needs masks where it crosses the diagonal, the window's edge
  // or Sk, for some row of this warpgroup
  auto masked = [&](int k0) {
    return k0 + BKV > Sk || (causal && k0 + BKV - 1 > row_lo) ||
           (window > 0 && row_lo + 63 - k0 >= window);
  };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
  float sc[BKV / 2];
  uint32_t pa[BKV / 4], pb[BKV / 4];     // P of two tiles, in turns

  auto softmax = [&](int k0, uint32_t (&p)[BKV / 4]) {
    if (masked(k0))
      softmax_tile<true>(sc, p, m, l, corr, r0, t, k0, Sk, causal, window,
                         scale_log2);
    else
      softmax_tile<false>(sc, p, m, l, corr, r0, t, k0, Sk, causal, window,
                          scale_log2);
  };
  // Tile it: its S = Q K^T is issued before tile it-1's O += P V, so its
  // softmax runs on the CUDA cores while P V runs on the tensor cores;
  // p holds tile it-1's P, pn receives tile it's.
  auto step = [&](int it, uint32_t (&p)[BKV / 4], uint32_t (&pn)[BKV / 4]) {
    const int s = it % STAGES, sp = (it - 1) % STAGES;
    fence_regs(acc);
    fence_regs(p);
    mbar_wait(k_full(s), (it / STAGES) & 1);
    wgmma_fence();
    issue_qk<D>(sc, q_wg, k_s + s * L::KV_BYTES);
    wgmma_commit();
    mbar_wait(v_full(sp), ((it - 1) / STAGES) & 1);
    issue_pv<D>(acc, p, v_s + sp * L::KV_BYTES);
    wgmma_commit();
    wgmma_wait<1>();                           // S of tile it is in
    fence_regs(sc);
    softmax((kt_begin + it) * BKV, pn);
    wgmma_wait<0>();                           // P V of tile it-1 is in
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty(sp));     // this warp is done with sp
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[4 * i] *= corr[0];
      acc[4 * i + 1] *= corr[0];
      acc[4 * i + 2] *= corr[1];
      acc[4 * i + 3] *= corr[1];
    }
  };
  // the last tile's O += P V
  auto finish = [&](uint32_t (&p)[BKV / 4]) {
    const int sp = (n_tiles - 1) % STAGES;
    fence_regs(acc);
    fence_regs(p);
    mbar_wait(v_full(sp), ((n_tiles - 1) / STAGES) & 1);
    issue_pv<D>(acc, p, v_s + sp * L::KV_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty(sp));
  };

  mbar_wait(q_full, 0);
  mbar_wait(k_full(0), 0);
  wgmma_fence();
  issue_qk<D>(sc, q_wg, k_s);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(kt_begin * BKV, pa);
  int it = 1;
  for (; it + 1 < n_tiles; it += 2) {          // two tiles: no copy of P
    step(it, pa, pb);
    step(it + 1, pb, pa);
  }
  if (it < n_tiles) {
    step(it, pa, pb);
    finish(pb);
  } else {
    finish(pa);
  }

  __nv_bfloat16* ob = o + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    const float lsafe = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = ob + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) = __floats2bfloat162_rn(
          acc[4 * i + 2 * r] / lsafe, acc[4 * i + 2 * r + 1] / lsafe);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map (D, S, BH) of a contiguous (BH, S, D) bf16 tensor, boxes of
// 64 columns x `rows` rows x 1 head, 128-byte swizzle, zero fill out of
// bounds.
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int BH,
              int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {BOX, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, int causal, int window,
           cudaStream_t stream) {
  auto kern = flash_attention_tc<D>;
  const int smem = static_cast<int>(Layout<D>::BYTES);
  // once on each device (the attribute belongs to the current device),
  // not on every call: the call is not stream-ordered
  constexpr int MAX_DEVICES = 64;
  static std::atomic<bool> smem_set[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES || !smem_set[dev].load()) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) smem_set[dev].store(true);
  }
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, D, Sq, B * Hq, BQ) ||
      !make_map(&km, k, D, Sk, B * Hkv, BKV) ||
      !make_map(&vm, v, D, Sk, B * Hkv, BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  kern<<<grid, NT, smem, stream>>>(qm, km, vm, static_cast<__nv_bfloat16*>(o),
                                   Hq, Hkv, Sq, Sk, causal, window,
                                   scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory one block needs at head dim D: the larger of the
// bfloat16 (tensor-core) and float32 kernels' needs.
size_t flash_attention_smem_bytes(int D) {
  const size_t fma = smem_floats(D) * sizeof(float);
  const size_t tcb = D == 64 ? tc::Layout<64>::BYTES : tc::Layout<128>::BYTES;
  return fma > tcb ? fma : tcb;
}

// q (B,Hq,Sq,D), k/v (B,Hkv,Sk,D), o (B,Hq,Sq,D), all contiguous on the
// current device, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// D in {64, 128}; Hq a multiple of Hkv; Sk >= 1, and Sk == Sq when
// causal.  bfloat16 runs the tensor-core
// kernel, float32 the FMA kernel.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError() (cudaErrorInvalidValue for a
// D it does not take or a tensor map the driver refuses).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Hq, int Hkv, int Sq, int Sk,
                           int D, int is_bf16, int causal, int window,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64)
      return tc::launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                            st);
    if (D == 128)
      return tc::launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                             st);
  } else {
    if (D == 64)
      return launch<float, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal,
                               window, st);
    if (D == 128)
      return launch<float, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal,
                                window, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
