// Mamba-2 SSD intra-chunk term for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_chunk/ssd_chunk.py::ssd_intra_pallas (line 45,
//   body _ssd_kernel)
// and computes the same function, in float32 in and out: for every
// (batch*chunk bc, head h)
//   S = cm[bc] . bm[bc]^T                               (C, C)
//   L = tril(exp(clip(cum[bc,h,i] - cum[bc,h,j], -60, 0)))
//   y[bc,h] = (S o L) . xdt[bc,h]                       (C, P)
// with cm/bm (BC,C,N) shared by all heads (G = 1), xdt (BC,H,C,P) and
// cum (BC,H,C), all contiguous.
//
// What bounds it on an H100.  At the mamba2-2.7b prefill shape (BC = 64,
// H = 80, C = N = 128, P = 64) the call must read cm, bm, xdt and cum and
// write y: 346.6 MB, 0.103 ms at 3.35 TB/s.  Its 5.6 GFLOP (S once per
// chunk, lower triangles only) would take 0.083 ms at the 67 TFLOP/s
// float32 rate outside the tensor cores, so only the tensor cores leave
// the byte bound room.  Single-pass TF32 (10-bit mantissas) misses the
// float32 contract (1e-4 of each block's RMS) by ~60x; 3xTF32 (each
// operand split as hi + lo, both TF32, and a.b taken as
// hi.hi + hi.lo + lo.hi summed in float32) meets it, at ~17 GFLOP of
// tensor-core work, still well inside their rate.
//
// What the design does about it.  One block of 8 warps per (chunk bc,
// group of HG heads), two blocks per SM (102,912 B of shared memory at
// C = 128, P = 64); the wrapper picks HG (8 or more) so that the grid
// fills the SMs about twice (4 groups of 20 heads at the mamba2 shape,
// 256 blocks, one wave):
//   * S = cm . bm^T is computed once per block, over the 16x16 tiles of
//     its lower triangle only, with mma.sync.m16n8k8 TF32 in 3xTF32;
//     cm and bm arrive by cp.async in slices of 32 columns of N
//     (zero-filled past N) through a ring of three shared-memory slots,
//     three slices in flight; S is kept in shared memory in float32 in
//     the order of the next product's A fragments (one 16-byte load per
//     lane and k-step);
//   * per head, W = S o L is formed in registers as the A fragment is
//     loaded (the clipped exp on the special-function unit, the causal
//     mask on the diagonal tile only), split into hi + lo, and
//     y = W . xdt runs on the tensor cores in 3xTF32; each warp owns two
//     16-row strips i and C/16-1-i (equal work over the triangle) and
//     half of the 8-column tiles of P, and runs the k-steps its two
//     strips share together (one B load for both, two independent
//     accumulator chains);
//   * xdt is split into hi + lo once, as it goes to shared memory, in
//     the order of the B fragments, so the inner loop loads a tile's
//     four B registers with one 16-byte load; the next head's xdt and
//     cum are loaded into registers while this head computes (half as
//     it starts, half after the k-steps the warp's strips share); y is
//     stored once, from the accumulator fragments;
//   * a split is three integer and float operations (hi rounded to
//     TF32 on the bit pattern, lo the exact remainder, of which the
//     tensor cores read 10 bits), the clip is one saturating multiply,
//     and heads past H in the last group are neither loaded nor stored.
// C must be 16, 32, 64 or 128, P 16, 32 or 64, and N a multiple of 4 up
// to 128; the wrapper raises otherwise.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int NW = 8;        // warps per block
constexpr int NT = NW * 32;
constexpr int KS = 32;       // columns of N per staged slice
constexpr int NSLOT = 3;     // slices in flight
constexpr float CLIP = 60.0f;
constexpr float LOG2E = 1.4426950408889634f;

template <int C, int P>
struct Geo {
  static constexpr int NS = C / 16;                  // 16-row strips
  static constexpr int NTILE = NS * (NS + 1) / 2;    // lower 16x16 tiles
  static constexpr int MAXT = (NTILE + NW - 1) / NW; // S tiles per warp
  static constexpr int NPAIR = (NS + 1) / 2;         // strip pairs
  static constexpr int NG = NW / NPAIR;              // column groups
  static constexpr int NT8 = P / 8;                  // 8-column tiles
  static constexpr int NTW = (NT8 + NG - 1) / NG;    // per warp
  static constexpr int Q = P / 4;                    // float4s of a row
  static constexpr int X8 = C * P / 8;               // float4 pairs of a head
  static constexpr int XPT = (X8 + NT - 1) / NT;     // per thread
  // shared memory in floats: S fragments, one head's cum and its xdt in
  // the order of the B fragments; while S is computed, the same bytes
  // hold a ring of NSLOT slices of cm and bm
  static constexpr int S_F = NTILE * 256;
  static constexpr int CUM_F = C;
  static constexpr int X_F = 2 * C * P;
  static constexpr int SLOT_F = 2 * C * KS;
  static constexpr int MAIN_F = S_F + CUM_F + X_F;
  static constexpr int STAGE_F = NSLOT * SLOT_F;
  static constexpr size_t BYTES =
      sizeof(float) *
      static_cast<size_t>(MAIN_F > STAGE_F ? MAIN_F : STAGE_F);
  static_assert(NG * NPAIR == NW, "warps do not split");
};

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero,
// as cvt.rna.tf32.f32, by integer operations on the bit pattern); lo =
// x - hi is exact in float32, and the tensor cores read its top 19 bits
// (lo to 10 bits: x to about 2^-21 of itself)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b in 3xTF32: the small products first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

// 16 bytes from global to shared memory, zero-filled when !valid
__device__ __forceinline__ void cp16(float* smem, const float* gmem,
                                     bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// exp(clip(d, -60, 0)) on the special-function unit, the clip as
// -60 * saturate(-d / 60)
__device__ __forceinline__ float decay(float d) {
  const float c = __saturatef(d * (-1.0f / CLIP));
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(c * (-CLIP * LOG2E)));
  return r;
}

template <int C, int P>
__global__ void __launch_bounds__(NT, 2)
    ssd_chunk_kernel(const float* __restrict__ cm,
                     const float* __restrict__ bm,
                     const float* __restrict__ xdt,
                     const float* __restrict__ cum, float* __restrict__ y,
                     int N, int H, int HG) {
  using Gm = Geo<C, P>;
  constexpr int Q = Gm::Q;
  extern __shared__ float4 smem4[];
  float* s_frag = reinterpret_cast<float*>(smem4);  // [NTILE][2][32][4]
  float* cum_s = s_frag + Gm::S_F;                   // [C]
  // xdt as [C/8][P][4 (tig)][hi j, hi j+4, lo j, lo j+4] for j = 8kk + tig:
  // a lane's B fragment of one 8x8 tile is one 16-byte load
  float* xs = cum_s + Gm::CUM_F;

  const size_t bc = blockIdx.x;
  const int h0 = blockIdx.y * HG;
  const int nh = min(HG, H - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  // the next head's xdt and cum wait in registers while a head computes:
  // rows j and j + 4 (j = 8kk + tig) of one float4 column; fetched in two
  // halves, [t0, t1) of the thread's pairs, so that loads stay in flight
  // through the head's compute
  float4 xr[Gm::XPT][2];
  float4 cr = make_float4(0.f, 0.f, 0.f, 0.f);
  auto fetch = [&](int hh, int t0, int t1) {
    const size_t bh = bc * H + h0 + hh;
    const float4* xg = reinterpret_cast<const float4*>(xdt + bh * C * P);
#pragma unroll
    for (int t = 0; t < Gm::XPT; ++t) {
      if (t < t0 || t >= t1) continue;
      const int e = tid + t * NT;  // (kk, c4, tig), tig fastest
      if (e < Gm::X8) {
        const int kk = e / (4 * Q), c4 = (e / 4) % Q, tg = e % 4;
        xr[t][0] = __ldg(xg + (8 * kk + tg) * Q + c4);
        xr[t][1] = __ldg(xg + (8 * kk + tg + 4) * Q + c4);
      }
    }
    if (t0 == 0 && tid < C / 4)
      cr = __ldg(reinterpret_cast<const float4*>(cum + bh * C) + tid);
  };
  // ... then go to shared memory, split into (hi, lo)
  auto put = [&]() {
#pragma unroll
    for (int t = 0; t < Gm::XPT; ++t) {
      const int e = tid + t * NT;
      if (e < Gm::X8) {
        const int kk = e / (4 * Q), c4 = (e / 4) % Q, tg = e % 4;
        const float a[4] = {xr[t][0].x, xr[t][0].y, xr[t][0].z, xr[t][0].w};
        const float b[4] = {xr[t][1].x, xr[t][1].y, xr[t][1].z, xr[t][1].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t ha, la, hb, lb;
          split(a[i], ha, la);
          split(b[i], hb, lb);
          *reinterpret_cast<uint4*>(
              xs + ((kk * P + 4 * c4 + i) * 4 + tg) * 4) =
              make_uint4(ha, hb, la, lb);
        }
      }
    }
    if (tid < C / 4) reinterpret_cast<float4*>(cum_s)[tid] = cr;
  };
  fetch(0, 0, Gm::XPT);

  // ---- S = cm . bm^T over the lower 16x16 tiles, 3xTF32 ----
  {
    const float* cmg = cm + bc * C * N;
    const float* bmg = bm + bc * C * N;
    float* ring = reinterpret_cast<float*>(smem4);
    // slice i (columns 32i .. 32i+31 of cm, then of bm) into slot i % NSLOT,
    // rows of 32 floats with the 16-byte chunks swizzled by row % 8 (the
    // fragment loads are then free of bank conflicts); one cp.async
    // group, empty past N
    const int nsl = (N + KS - 1) / KS;
    auto stage_slice = [&](int i) {
      if (i < nsl) {
        float* slot = ring + (i % NSLOT) * Gm::SLOT_F;
        for (int e = tid; e < 2 * C * (KS / 4); e += NT) {
          const int row = e / (KS / 4), c = e % (KS / 4);  // row < 2C
          const int col = i * KS + 4 * c;
          const float* src = (row < C ? cmg + row * N : bmg + (row - C) * N);
          cp16(slot + row * KS + 4 * (c ^ (row & 7)),
               col < N ? src + col : src, col < N);
        }
      }
      cp_commit();
    };
    float sacc[Gm::MAXT][2][4];
#pragma unroll
    for (int t = 0; t < Gm::MAXT; ++t)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sacc[t][nt][i] = 0.0f;
#pragma unroll
    for (int i = 0; i < NSLOT; ++i) stage_slice(i);
    for (int i = 0; i < nsl; ++i) {
      cp_wait<NSLOT - 1>();
      __syncthreads();  // slice i has landed
      const float* cm_s = ring + (i % NSLOT) * Gm::SLOT_F;
      const float* bm_s = cm_s + C * KS;
#pragma unroll
      for (int t = 0; t < Gm::MAXT; ++t) {
        const int tile = warp + NW * t;
        if (tile >= Gm::NTILE) break;
        int ti = 0;
        while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
        const int tj = tile - ti * (ti + 1) / 2;
        // rows ti*16 + gid (+8) of cm: row % 8 == gid
        const float* ar = cm_s + (ti * 16 + gid) * KS + tig;
#pragma unroll
        for (int q = 0; q < KS / 8; ++q) {  // k-step: chunks 2q, 2q + 1
          const int c0 = 4 * ((2 * q) ^ gid), c1 = 4 * ((2 * q + 1) ^ gid);
          uint32_t ah[4], al[4];
          split(ar[c0], ah[0], al[0]);
          split(ar[8 * KS + c0], ah[1], al[1]);
          split(ar[c1], ah[2], al[2]);
          split(ar[8 * KS + c1], ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const float* br = bm_s + (tj * 16 + nt * 8 + gid) * KS + tig;
            uint32_t bh[2], bl[2];
            split(br[c0], bh[0], bl[0]);
            split(br[c1], bh[1], bl[1]);
            mma3(sacc[t][nt], ah, al, bh, bl);
          }
        }
      }
      __syncthreads();  // slot i % NSLOT is free
      stage_slice(i + NSLOT);
    }
    cp_wait<0>();
    // accumulator (row, col) of a tile -> the A fragment of k-step
    // col / 8: lane (row % 8) * 4 + col % 4, register row / 8 + 2 *
    // ((col % 8) / 4)
#pragma unroll
    for (int t = 0; t < Gm::MAXT; ++t) {
      const int tile = warp + NW * t;
      if (tile >= Gm::NTILE) break;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int cc = 2 * tig + (i & 1);
          s_frag[((tile * 2 + nt) * 32 + gid * 4 + (cc & 3)) * 4 + (i >> 1) +
                 2 * (cc >> 2)] = sacc[t][nt][i];
        }
    }
    __syncthreads();  // S is whole; the staging region is free
  }

  // ---- per head: y = (S o L) . xdt, 3xTF32 ----
  // Warp w owns the strip pair (sa, sb) = (p, C/16-1-p), p = w % NPAIR,
  // and the column group w / NPAIR.  The k-steps the two strips share
  // (kk < 2sa + 2) run together: each B fragment is loaded once for
  // both strips, and the two strips' accumulators are independent
  // chains; sb's remaining k-steps run alone.
  const int pair = warp % Gm::NPAIR, ng = warp / Gm::NPAIR;
  const int sa = pair, sb = Gm::NS - 1 - pair;
  const bool two = sa != sb;  // one strip at C = 16
  const float* xp = xs + ((ng * Gm::NTW * 8 + gid) * 4 + tig) * 4;
  for (int hh = 0; hh < nh; ++hh) {
    put();
    __syncthreads();  // head hh's xdt and cum are in shared memory
    if (hh + 1 < nh) fetch(hh + 1, 0, Gm::XPT / 2);
    float* yh = y + (bc * H + h0 + hh) * C * P;
    if (ng * Gm::NTW < Gm::NT8) {
      float acc_a[Gm::NTW][4], acc_b[Gm::NTW][4];
#pragma unroll
      for (int t = 0; t < Gm::NTW; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_a[t][i] = acc_b[t][i] = 0.0f;
      const float ca_lo = cum_s[sa * 16 + gid];
      const float ca_hi = cum_s[sa * 16 + gid + 8];
      const float cb_lo = cum_s[sb * 16 + gid];
      const float cb_hi = cum_s[sb * 16 + gid + 8];
      // A fragments of W = S o L for strip s at k-step kk (columns
      // kk*8 .. kk*8+7), split into hi + lo; the strip's last two
      // k-steps hold the diagonal tile, where the causal mask applies
      auto wfrag = [&](int s, float ci_lo, float ci_hi, int kk,
                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
        const float4 sf = *reinterpret_cast<const float4*>(
            s_frag + ((s * (s + 1) + kk) * 32 + lane) * 4);
        const int j_lo = kk * 8 + tig, j_hi = j_lo + 4;
        const float cj_lo = cum_s[j_lo], cj_hi = cum_s[j_hi];
        // a0 (i_lo, j_lo), a1 (i_hi, j_lo), a2 (i_lo, j_hi), a3 (i_hi, j_hi)
        float w0 = sf.x * decay(ci_lo - cj_lo);
        float w1 = sf.y * decay(ci_hi - cj_lo);
        float w2 = sf.z * decay(ci_lo - cj_hi);
        float w3 = sf.w * decay(ci_hi - cj_hi);
        if ((kk >> 1) == s) {
          const int i_lo = s * 16 + gid, i_hi = i_lo + 8;
          if (j_lo > i_lo) w0 = 0.f;
          if (j_lo > i_hi) w1 = 0.f;
          if (j_hi > i_lo) w2 = 0.f;
          if (j_hi > i_hi) w3 = 0.f;
        }
        split(w0, ah[0], al[0]);
        split(w1, ah[1], al[1]);
        split(w2, ah[2], al[2]);
        split(w3, ah[3], al[3]);
      };
      const int na = two ? 2 * sa + 2 : 0;
#pragma unroll 1
      for (int kk = 0; kk < na; ++kk) {
        uint32_t aah[4], aal[4], abh[4], abl[4];
        wfrag(sa, ca_lo, ca_hi, kk, aah, aal);
        wfrag(sb, cb_lo, cb_hi, kk, abh, abl);
        const float* xr0 = xp + kk * P * 16;
#pragma unroll
        for (int t = 0; t < Gm::NTW; ++t) {
          if (ng * Gm::NTW + t < Gm::NT8) {
            const uint4 b = *reinterpret_cast<const uint4*>(xr0 + 128 * t);
            const uint32_t bh[2] = {b.x, b.y}, bl[2] = {b.z, b.w};
            mma3(acc_a[t], aah, aal, bh, bl);
            mma3(acc_b[t], abh, abl, bh, bl);
          }
        }
      }
      if (hh + 1 < nh) fetch(hh + 1, Gm::XPT / 2, Gm::XPT);
#pragma unroll 4
      for (int kk = na; kk < 2 * sb + 2; ++kk) {
        uint32_t abh[4], abl[4];
        wfrag(sb, cb_lo, cb_hi, kk, abh, abl);
        const float* xr0 = xp + kk * P * 16;
#pragma unroll
        for (int t = 0; t < Gm::NTW; ++t) {
          if (ng * Gm::NTW + t < Gm::NT8) {
            const uint4 b = *reinterpret_cast<const uint4*>(xr0 + 128 * t);
            const uint32_t bh[2] = {b.x, b.y}, bl[2] = {b.z, b.w};
            mma3(acc_b[t], abh, abl, bh, bl);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < Gm::NTW; ++t) {
        const int n = ng * Gm::NTW + t;
        if (n < Gm::NT8) {
          const int col = n * 8 + 2 * tig;
          float* ya = yh + (sa * 16 + gid) * P + col;
          float* yb = yh + (sb * 16 + gid) * P + col;
          if (two) {
            *reinterpret_cast<float2*>(ya) =
                make_float2(acc_a[t][0], acc_a[t][1]);
            *reinterpret_cast<float2*>(ya + 8 * P) =
                make_float2(acc_a[t][2], acc_a[t][3]);
          }
          *reinterpret_cast<float2*>(yb) =
              make_float2(acc_b[t][0], acc_b[t][1]);
          *reinterpret_cast<float2*>(yb + 8 * P) =
              make_float2(acc_b[t][2], acc_b[t][3]);
        }
      }
    } else if (hh + 1 < nh) {
      fetch(hh + 1, Gm::XPT / 2, Gm::XPT);  // warps without columns
    }
    __syncthreads();  // the shared xdt and cum are free for head hh + 1
  }
}

template <int C, int P>
int launch(const float* cm, const float* bm, const float* xdt,
           const float* cum, float* y, int BC, int N, int H, int HG,
           cudaStream_t st) {
  const size_t smem = Geo<C, P>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_kernel<C, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(BC, (H + HG - 1) / HG);
  ssd_chunk_kernel<C, P><<<grid, NT, smem, st>>>(cm, bm, xdt, cum, y, N, H,
                                                 HG);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_p(const float* cm, const float* bm, const float* xdt,
             const float* cum, float* y, int BC, int N, int H, int P, int HG,
             cudaStream_t st) {
  switch (P) {
    case 16: return launch<C, 16>(cm, bm, xdt, cum, y, BC, N, H, HG, st);
    case 32: return launch<C, 32>(cm, bm, xdt, cum, y, BC, N, H, HG, st);
    case 64: return launch<C, 64>(cm, bm, xdt, cum, y, BC, N, H, HG, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// cm/bm (BC,C,N), xdt/y (BC,H,C,P), cum (BC,H,C): contiguous float32 on
// the current device, 16-byte aligned.  C in {16, 32, 64, 128}, P in
// {16, 32, 64}, N a multiple of 4 up to 128; HG heads per block, with
// ceil(H / HG) <= 65535.  Launches on `stream`, does not synchronise,
// returns cudaGetLastError() (cudaErrorInvalidValue for a shape it does
// not take).
int ssd_chunk_launch(const void* cm, const void* bm, const void* xdt,
                     const void* cum, void* y, int BC, int C, int N, int H,
                     int P, int HG, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BC <= 0 || H <= 0 || HG <= 0 || (H + HG - 1) / HG > 65535 ||
      N <= 0 || N > 128 || N % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* c = static_cast<const float*>(cm);
  const float* b = static_cast<const float*>(bm);
  const float* x = static_cast<const float*>(xdt);
  const float* u = static_cast<const float*>(cum);
  float* o = static_cast<float*>(y);
  switch (C) {
    case 16: return launch_p<16>(c, b, x, u, o, BC, N, H, P, HG, st);
    case 32: return launch_p<32>(c, b, x, u, o, BC, N, H, P, HG, st);
    case 64: return launch_p<64>(c, b, x, u, o, BC, N, H, P, HG, st);
    case 128: return launch_p<128>(c, b, x, u, o, BC, N, H, P, HG, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
