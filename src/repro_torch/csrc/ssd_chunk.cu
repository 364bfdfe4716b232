// Mamba-2 SSD intra-chunk term for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_chunk/ssd_chunk.py::ssd_intra_pallas (line 45,
//   body _ssd_kernel)
// and computes the same function, in float32 throughout: for every
// (batch*chunk bc, head h)
//   S = cm[bc] . bm[bc]^T                               (C, C)
//   L = tril(exp(clip(cum[bc,h,i] - cum[bc,h,j], -60, 0)))
//   y[bc,h] = (S o L) . xdt[bc,h]                       (C, P)
// with cm/bm (BC,C,N) shared by all heads (G = 1), xdt (BC,H,C,P) and
// cum (BC,H,C), all contiguous.
//
// What bounds it on an H100.  At the mamba2-2.7b prefill shape (BC = 64,
// H = 80, C = N = 128, P = 64) the call must read cm, bm, xdt and cum and
// write y: 346.6 MB, 0.103 ms at 3.35 TB/s.  The operations it needs,
// with S computed once per chunk and only the lower triangle, are about
// 5.6 GFLOP, 0.083 ms at the 67 TFLOP/s float32 rate outside the tensor
// cores.  So it is bound by bytes, just.
//
// What the design does about it.  The TPU grid (BC, H) recomputes S for
// every head and the whole (C, C) square.  Here one block of 256
// threads owns one row tile of T = 32 rows (16 at C = 16) of one chunk
// for a group of HG = 4 heads:
//   * its cm rows stay in shared memory; it walks the column tiles
//     j0 <= i0 only (the upper triangle is never computed), staging each
//     bm tile and the HG heads' xdt tiles in shared memory;
//   * every S entry of a tile is computed once (a float4 dot over N) and
//     serves all HG heads: each head's decay-weighted W = S o L goes to
//     shared memory, then y += W . xdt with each thread keeping P/8
//     columns of one row for every head in registers;
//   * heads past H in the last group are zero-filled and not stored.
// It uses float32 FMAs, no tensor cores; sharing S over more heads and
// tensor cores are later work.  C must be 16, 32, 64 or 128, P 16, 32
// or 64, and N a multiple of 4 up to 128; the wrapper raises otherwise.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int NT = 256;     // threads per block
constexpr int HG = 4;       // heads per block
constexpr float CLIP = 60.0f;

template <int T, int P>
__global__ void __launch_bounds__(NT)
    ssd_chunk_kernel(const float* __restrict__ cm,
                     const float* __restrict__ bm,
                     const float* __restrict__ xdt,
                     const float* __restrict__ cum, float* __restrict__ y,
                     int C, int N, int H) {
  constexpr int TPR = NT / T;  // threads per row of a tile: 8 or 16
  constexpr int E = T / TPR;   // S entries per thread: 4 or 1
  constexpr int PC = P / TPR;  // y columns per thread and head
  static_assert(E * TPR == T && PC * TPR == P, "tile does not split");

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int NS = N + 4;                   // padded row stride, float4-aligned
  float* cm_s = smem;                     // [T][NS]  rows i0..i0+T
  float* bm_s = cm_s + T * NS;            // [T][NS]  rows j0..j0+T
  float* x_s = bm_s + T * NS;             // [HG][T][P]
  float* w_s = x_s + HG * T * P;          // [HG][T][T+1]
  float* cum_s = w_s + HG * T * (T + 1);  // [HG][C]

  const size_t bc = blockIdx.x;
  const int h0 = blockIdx.y * HG;
  const int i0 = blockIdx.z * T;
  const int nh = min(HG, H - h0);
  const int tid = threadIdx.x;
  const int r = tid / TPR;  // row of the tile this thread computes
  const int q = tid % TPR;  // its lane within the row
  const int i = i0 + r;
  const int N4 = N / 4;
  const int rows = i0 + T;  // cum entries the block needs

  const float* cm_b = cm + bc * C * N;
  const float* bm_b = bm + bc * C * N;
  for (int e = tid; e < T * N4; e += NT) {
    const int rr = e / N4, c4 = e % N4;
    *reinterpret_cast<float4*>(cm_s + rr * NS + 4 * c4) =
        reinterpret_cast<const float4*>(cm_b + (size_t)(i0 + rr) * N)[c4];
  }
  for (int e = tid; e < HG * rows; e += NT) {
    const int hh = e / rows, c = e % rows;
    cum_s[hh * C + c] =
        hh < nh ? cum[(bc * H + h0 + hh) * C + c] : 0.0f;
  }

  float acc[HG][PC];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh)
#pragma unroll
    for (int m = 0; m < PC; ++m) acc[hh][m] = 0.0f;

  for (int j0 = 0; j0 <= i0; j0 += T) {
    __syncthreads();  // the last tile's readers are done
    for (int e = tid; e < T * N4; e += NT) {
      const int rr = e / N4, c4 = e % N4;
      *reinterpret_cast<float4*>(bm_s + rr * NS + 4 * c4) =
          reinterpret_cast<const float4*>(bm_b + (size_t)(j0 + rr) * N)[c4];
    }
    constexpr int TP4 = T * P / 4;
    for (int e = tid; e < HG * TP4; e += NT) {
      const int hh = e / TP4, o = e % TP4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (hh < nh)
        v = reinterpret_cast<const float4*>(
            xdt + ((bc * H + h0 + hh) * C + j0) * P)[o];
      reinterpret_cast<float4*>(x_s + hh * T * P)[o] = v;
    }
    __syncthreads();

    // S entries (i, j0 + q + TPR*k), computed once for all heads
    float s[E];
#pragma unroll
    for (int k = 0; k < E; ++k) s[k] = 0.0f;
    const float* crow = cm_s + r * NS;
    for (int n = 0; n < N; n += 4) {
      const float4 c4 = *reinterpret_cast<const float4*>(crow + n);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(bm_s + (q + TPR * k) * NS + n);
        s[k] = fmaf(c4.x, b4.x, s[k]);
        s[k] = fmaf(c4.y, b4.y, s[k]);
        s[k] = fmaf(c4.z, b4.z, s[k]);
        s[k] = fmaf(c4.w, b4.w, s[k]);
      }
    }
    // W = S o L for each head of the group
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      const float ci = cum_s[hh * C + i];
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int jl = q + TPR * k;
        float wv = 0.0f;
        if (j0 + jl <= i) {
          const float d =
              fminf(fmaxf(ci - cum_s[hh * C + j0 + jl], -CLIP), 0.0f);
          wv = s[k] * expf(d);
        }
        w_s[(hh * T + r) * (T + 1) + jl] = wv;
      }
    }
    __syncthreads();

    // y[i, q + TPR*m] += sum_j W[i, j] xdt[j, q + TPR*m]
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      const float* wrow = w_s + (hh * T + r) * (T + 1);
      const float* xh = x_s + hh * T * P;
#pragma unroll 8
      for (int jj = 0; jj < T; ++jj) {
        const float wv = wrow[jj];
        const float* xr = xh + jj * P + q;
#pragma unroll
        for (int m = 0; m < PC; ++m)
          acc[hh][m] = fmaf(wv, xr[TPR * m], acc[hh][m]);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    if (hh >= nh) break;
    float* yr = y + ((bc * H + h0 + hh) * C + i) * P + q;
#pragma unroll
    for (int m = 0; m < PC; ++m) yr[TPR * m] = acc[hh][m];
  }
}

size_t smem_bytes(int T, int C, int N, int P) {
  return sizeof(float) * (static_cast<size_t>(2) * T * (N + 4) +
                          HG * T * P + HG * T * (T + 1) + HG * C);
}

template <int T, int P>
int launch(const float* cm, const float* bm, const float* xdt,
           const float* cum, float* y, int BC, int C, int N, int H,
           cudaStream_t st) {
  const size_t smem = smem_bytes(T, C, N, P);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(BC, (H + HG - 1) / HG, C / T);
  ssd_chunk_kernel<T, P><<<grid, NT, smem, st>>>(cm, bm, xdt, cum, y, C, N,
                                                 H);
  return static_cast<int>(cudaGetLastError());
}

template <int T>
int launch_p(const float* cm, const float* bm, const float* xdt,
             const float* cum, float* y, int BC, int C, int N, int H, int P,
             cudaStream_t st) {
  switch (P) {
    case 16: return launch<T, 16>(cm, bm, xdt, cum, y, BC, C, N, H, st);
    case 32: return launch<T, 32>(cm, bm, xdt, cum, y, BC, C, N, H, st);
    case 64: return launch<T, 64>(cm, bm, xdt, cum, y, BC, C, N, H, st);
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
// {16, 32, 64}, N a multiple of 4 up to 128, 0 < H <= 4 * 65535.
// Launches on `stream`, does not synchronise, returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
int ssd_chunk_launch(const void* cm, const void* bm, const void* xdt,
                     const void* cum, void* y, int BC, int C, int N, int H,
                     int P, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BC <= 0 || H <= 0 || (H + HG - 1) / HG > 65535 || N <= 0 ||
      N > 128 || N % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* c = static_cast<const float*>(cm);
  const float* b = static_cast<const float*>(bm);
  const float* x = static_cast<const float*>(xdt);
  const float* u = static_cast<const float*>(cum);
  float* o = static_cast<float*>(y);
  switch (C) {
    case 16: return launch_p<16>(c, b, x, u, o, BC, C, N, H, P, st);
    case 32:
    case 64:
    case 128: return launch_p<32>(c, b, x, u, o, BC, C, N, H, P, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
