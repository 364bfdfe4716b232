// Masked full-sequence LSTM for Hopper (sm_90a): the whole T-step
// recurrence in ONE launch, the recurrent weights held in registers
// across all steps.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/lstm_seq/lstm_seq.py::lstm_seq_pallas
//   (body _lstm_seq_kernel)
// and computes the same function: zero initial carry, gates i, f, g, o
// (column blocks of Wx (F,4H) / Wh (H,4H) / b (4H)), and a masked step
// keeps (h, c) and emits the held h.
//
// What bounds it on an H100.  One call does 2*(live row-steps)*(F+H)*4H
// float32 operations and moves xs, mask, the weights and hs once.  At
// the serving shape (T=97, B=32, F=16, H=256, full mask) that is
// 1.73 GFLOP against ~4.5 MB: 26 us at the 67 TFLOP/s float32
// (non-tensor-core) peak and 1.3 us at 3.35 TB/s, so operations bound
// it.  The recurrence is sequential in T: every step needs all of
// h_{t-1} before any gate of step t, so what a step costs is its
// product spread over the card plus one exchange of h across it.
//
// What the design does about it.
//   * A cluster of C = H/U CTAs shares a tile of R batch rows; CTA j
//     owns hidden units [jU, jU+U), i.e. their 4U gate columns
//     (U = 16: up to 16 CTAs, a non-portable cluster size; U = 32: up
//     to 8).  The wrapper picks (U, R) and the number of clusters with
//     cudaOccupancyMaxActiveClusters so that every cluster is resident
//     at once; a cluster walks over the batch tiles
//     blockIdx.y, blockIdx.y + gridDim.y, ...  At the serving shape an
//     H100 holds 7 clusters of 16, so 32 rows go in tiles of 5 on 112
//     SMs.
//   * The CTA's 16U threads cut K = H of the recurrent product into 16
//     slices: thread (slice s, unit u) holds Wh[s + 16j][gates of u]
//     for j < H/16 in registers (at most 64 floats), read from device
//     memory once per call.  Each step it reads the R rows of h at each
//     of its k as float4s (a shared-memory broadcast; rows padded to
//     RS, a multiple of 4) and does 4R FMAs with each, with no branch
//     in the loop (k >= H reads a row of zeros), so the loads issue
//     early.
//   * The 16 slices meet in shared memory; R*U threads each sum one
//     (row, unit), add the bias, run the cell (sigmoid and tanh from
//     the fast exp), and keep (h, c) in registers for the whole
//     sequence.
//   * The exchange is pushed, not pulled: the CTA's U x RS slice of h_t
//     goes to shared memory, and all threads store it as float4s
//     straight into every peer's buffer with st.async, double-buffered
//     by exchange parity; each store completes bytes on the peer's
//     mbarrier.  A CTA waits on its own mbarrier for all H x RS
//     values: one one-way latency per step, no cluster barrier.
//   * The input side x_{t+1} @ Wx does not depend on h: x is staged
//     with cp.async two steps ahead, and its product (Wx from shared
//     memory) runs while the exchange of h_t is in flight.
//   * The tile's mask is scanned once at the start for its last live
//     step; after it, no gate work and no exchange: the held h is
//     written to hs.  A masked-out step inside the live range keeps
//     (h, c) per row, so any mask gives the same outputs.
// Where a step's time goes at the serving shape (about 1.5 us; edited
// builds timed by scripts/lstm_seq_variants.py, PERF.md): the product
// ~0.45 us, the exchange ~0.26 us, the 16-slice sum and the cell
// ~0.2 us, the rest the two barriers and the step's fixed work.
// H must be a multiple of 32 with H/32 <= 8; the wrapper raises
// otherwise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int SLICES = 16;   // slices of the recurrent K = H
constexpr int MAX_KS = 16;   // H / SLICES for H <= 256

// sigmoid and tanh from the fast exp: ~1e-7 from the exact functions,
// and a few instructions on a step's critical path in place of tens
__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_f(float x) {
  return 2.0f * sigmoid_f(2.0f * x) - 1.0f;
}

// floats between consecutive k of h (and x) in shared memory: R padded
// to 4 so a thread reads a k's rows as float4s
__host__ __device__ constexpr int row_stride(int R) {
  return R <= 2 ? R : (R + 3) & ~3;
}

// floats between the two exchange buffers: H + 1 rows (the last one
// zeros), padded to 16 bytes for the 16-byte stores into them
__host__ __device__ constexpr int hbuf_stride(int H, int RS) {
  return ((H + 1) * RS + 3) & ~3;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of `addr` (a shared::cta address) in CTA
// `rank` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// store 16 bytes into a peer's shared memory; completes 16 bytes of
// transaction count on the peer's mbarrier `bar`
__device__ __forceinline__ void st_async(uint32_t addr, float4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// arrive once and expect `bytes` of st.async traffic on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
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

// 4-byte async copy from device to shared memory; zero-filled when
// `valid` is false (the source is then not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the most recent group of copies have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// R consecutive floats of shared memory (16-byte aligned when R % 4 == 0,
// 8-byte when R % 2 == 0)
template <int R>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else if constexpr (R % 2 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + i);
      v[i] = q.x; v[i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = p[i];
  }
}

__device__ __forceinline__ void fma4(float4& a, float v, const float4& w) {
  a.x = fmaf(v, w.x, a.x);
  a.y = fmaf(v, w.y, a.y);
  a.z = fmaf(v, w.z, a.z);
  a.w = fmaf(v, w.w, a.w);
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// Byte offsets of the dynamic shared memory, each 16-byte aligned
// (RS = row_stride(R)):
//   wx4  F x U float4       this CTA's gate columns of Wx
//   red  16 x R x U float4  the slices' partial gate sums
//   hbuf 2 x hbuf_stride    h of the whole tile ((H+1) x RS floats),
//                           by exchange parity; row H is zeros
//   hloc U x RS float       this CTA's slice of h_t, as peers store it
//   xbuf 4 x F x RS float   x_t of the tile, a ring over t
//   bars 2 mbarriers, then the tile's last live step (int)
__host__ __device__ inline size_t up(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

struct Layout {
  size_t wx4, red, hbuf, hloc, xbuf, bars, total;
  __host__ __device__ Layout(int U, int R, int F, int H) {
    wx4 = 0;
    red = up(wx4 + static_cast<size_t>(F) * U * 16);
    hbuf = up(red + static_cast<size_t>(SLICES) * R * U * 16);
    const size_t RS = row_stride(R);
    hloc = up(hbuf + 2 * static_cast<size_t>(hbuf_stride(H, RS)) * 4);
    xbuf = up(hloc + static_cast<size_t>(U) * RS * 4);
    bars = up(xbuf + 4 * static_cast<size_t>(F) * RS * 4);
    total = bars + 2 * 8 + 16;
  }
};

template <int U, int R>
__global__ void __launch_bounds__(SLICES * U, 1)
lstm_seq_kernel(const float* __restrict__ xs,
                const unsigned char* __restrict__ mask,
                const float* __restrict__ wx, const float* __restrict__ wh,
                const float* __restrict__ bias, float* __restrict__ hs,
                int T, int B, int F, int H) {
  constexpr int NT = SLICES * U;
  constexpr int RS = row_stride(R);
  constexpr int NV = U * RS / 4;         // float4s of h_t sent to a peer
  const int HB = hbuf_stride(H, RS);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());   // H / U
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int ks = H / SLICES;
  const int pu = tid % U;                // unit within the CTA
  const int ps = tid / U;                // slice of K (product role)
  const int pr = tid / U;                // row (cell role, tid < R * U)
  const bool cell = tid < R * U;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(U, R, F, H);
  float4* wx4 = reinterpret_cast<float4*>(smem + L.wx4);
  float4* red = reinterpret_cast<float4*>(smem + L.red);
  float* hbuf = reinterpret_cast<float*>(smem + L.hbuf);
  float* hloc = reinterpret_cast<float*>(smem + L.hloc);
  float* xbuf = reinterpret_cast<float*>(smem + L.xbuf);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  int* tl = reinterpret_cast<int*>(bars + 2);

  // this thread's recurrent weights: rows s + 16j of Wh, unit u's gates
  const int unit = rank * U + pu;
  float4 w[MAX_KS];
#pragma unroll
  for (int j = 0; j < MAX_KS; ++j) {
    w[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < ks) {
      const float* row = wh + static_cast<size_t>(ps + SLICES * j) * 4 * H;
      w[j] = make_float4(row[unit], row[H + unit], row[2 * H + unit],
                         row[3 * H + unit]);
    }
  }
  for (int i = tid; i < F * U; i += NT) {
    const float* row = wx + static_cast<size_t>(i / U) * 4 * H + rank * U +
                       i % U;
    wx4[i] = make_float4(row[0], row[H], row[2 * H], row[3 * H]);
  }
  float4 b4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (cell)
    b4 = make_float4(bias[unit], bias[H + unit], bias[2 * H + unit],
                     bias[3 * H + unit]);
  for (int i = tid; i < RS; i += NT) {   // the zero rows: peers never
    hbuf[H * RS + i] = 0.f;               // store there
    hbuf[HB + H * RS + i] = 0.f;
  }
  if (tid == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    mbar_init(smem_u32(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every peer's barriers are initialised before a store

  // x_t of the tile into ring slot t & 3 (rows past B read as zeros)
  auto stage_x = [&](int b0, int t) {
    float* dst = xbuf + (t & 3) * F * RS;
    for (int i = tid; i < F * R; i += NT) {
      const int k = i / R, r = i % R, b = b0 + r;
      const bool ok = b < B;
      cp_async4(smem_u32(dst + k * RS + r),
                ok ? xs + (static_cast<size_t>(t) * B + b) * F + k : xs, ok);
    }
  };
  // acc = x_t @ Wx over this thread's slice, for every row of the tile
  float4 acc[R];
  auto x_part = [&](int t) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* xb = xbuf + (t & 3) * F * RS;
    for (int k = ps; k < F; k += SLICES) {
      float v[RS];
      load_rows<RS>(xb + k * RS, v);
      const float4 wk = wx4[k * U + pu];
#pragma unroll
      for (int r = 0; r < R; ++r) fma4(acc[r], v[r], wk);
    }
  };

  const int ntiles = (B + R - 1) / R;
  uint32_t ex = 0;   // exchanges so far: buffer ex & 1, barrier use ex >> 1
  for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const int b0 = tile * R;
    // the tile's last live step: the largest t with any row unmasked
    if (tid == 0) *tl = -1;
    stage_x(b0, 0);
    cp_async_commit();
    if (T > 1) stage_x(b0, 1);
    cp_async_commit();
    __syncthreads();
    int last = -1;
    for (int i = tid; i < T * R; i += NT) {
      const int b = b0 + i % R;
      if (b < B && mask[static_cast<size_t>(i / R) * B + b]) last = i / R;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1)
      last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
    if ((tid & 31) == 0 && last >= 0) atomicMax(tl, last);
    cp_async_wait_prior();   // x_0 has landed
    __syncthreads();
    const int tlast = *tl;

    const int rb = b0 + pr;
    const bool row_ok = cell && rb < B;
    float h = 0.f, c = 0.f;
    bool m_next = row_ok && tlast >= 0 && mask[rb];
    x_part(0);
    for (int t = 0; t <= tlast; ++t) {
      const bool m = m_next;
      if (t + 2 <= tlast) stage_x(b0, t + 2);   // two steps ahead
      cp_async_commit();
      if (t < tlast)
        m_next = row_ok && mask[static_cast<size_t>(t + 1) * B + rb];
      if (t > 0) {       // acc += h_{t-1} @ Wh over this thread's slice
        // no branch in the loop, so every load can be issued early:
        // k >= H reads the zero row (and w[j] is 0 there)
        const float* hp = hbuf + ((ex - 1) & 1) * HB;
#pragma unroll
        for (int j = 0; j < MAX_KS; ++j) {
          float v[RS];
          load_rows<RS>(hp + min(ps + SLICES * j, H) * RS, v);
#pragma unroll
          for (int r = 0; r < R; ++r) fma4(acc[r], v[r], w[j]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) red[(ps * R + r) * U + pu] = acc[r];
      __syncthreads();   // the partial sums are in shared memory
      if (cell) {
        float4 g = b4;
#pragma unroll
        for (int s = 0; s < SLICES; ++s) add4(g, red[(s * R + pr) * U + pu]);
        const float ig = sigmoid_f(g.x);
        const float fg = sigmoid_f(g.y);
        const float gg = tanh_f(g.z);
        const float og = sigmoid_f(g.w);
        const float c2 = fg * c + ig * gg;
        const float h2 = og * tanh_f(c2);
        if (m) {  // a masked-out step keeps (h, c), emits the held h
          h = h2;
          c = c2;
        }
        if (row_ok) hs[(static_cast<size_t>(t) * B + rb) * H + unit] = h;
        hloc[pu * RS + pr] = h;
      }
      if (t == tlast) break;   // nobody reads h after the last live step
      cp_async_wait_prior();   // x_{t+1} has landed
      __syncthreads();   // hloc holds this CTA's slice of h_t
      // push it into every CTA's buffer ex & 1, as float4s
      const uint32_t buf = ex & 1;
      const uint32_t bar = smem_u32(&bars[buf]);
      const uint32_t dst = smem_u32(hbuf + buf * HB + rank * U * RS);
      for (int i = tid; i < C * NV; i += NT) {
        const int peer = i / NV, v = i % NV;
        st_async(mapa(dst + 16 * v, peer),
                 reinterpret_cast<const float4*>(hloc)[v], mapa(bar, peer));
      }
      if (tid == 0) mbar_expect_tx(bar, H * RS * 4);
      x_part(t + 1);     // the input side runs while h_t is in flight
      mbar_wait(bar, (ex >> 1) & 1);
      ++ex;
    }
    // after the last live step every row holds its h
    if (row_ok)
      for (int t = tlast + 1; t < T; ++t)
        hs[(static_cast<size_t>(t) * B + rb) * H + unit] = h;
    cp_async_wait_all();
    __syncthreads();   // the next tile reuses shared memory
  }
  cluster.sync();  // no CTA leaves while a peer may still store into it
}

template <int U, int R>
cudaError_t set_attributes(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      lstm_seq_kernel<U, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(lstm_seq_kernel<U, R>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

cudaLaunchConfig_t config(int U, int C, int clusters, size_t smem,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, clusters, 1);
  cfg.blockDim = dim3(SLICES * U, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int U, int R>
int launch(const float* xs, const unsigned char* mask, const float* wx,
           const float* wh, const float* b, float* hs, int T, int B, int F,
           int H, int clusters, cudaStream_t stream) {
  const size_t smem = Layout(U, R, F, H).total;
  cudaError_t err = set_attributes<U, R>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(U, H / U, clusters, smem, stream, attr);
  err = cudaLaunchKernelEx(&cfg, lstm_seq_kernel<U, R>, xs, mask, wx, wh, b,
                           hs, T, B, F, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int U, int R>
int max_active(int F, int H) {
  const size_t smem = Layout(U, R, F, H).total;
  cudaError_t err = set_attributes<U, R>(smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(U, H / U, 1, smem, nullptr, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, lstm_seq_kernel<U, R>, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return n;
}

#define LSTM_SEQ_CASES(X) \
  X(16, 1) X(16, 2) X(16, 3) X(16, 4) X(16, 5) X(16, 6) X(16, 7) X(16, 8) \
  X(32, 1) X(32, 2) X(32, 3) X(32, 4)

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs for (U, R, F, H).
size_t lstm_seq_smem_bytes(int U, int R, int F, int H) {
  return Layout(U, R, F, H).total;
}

const char* lstm_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Clusters of H/U CTAs of the (U, R) kernel that the current device can
// hold at once; a negative value is minus a cudaError_t, and
// cudaErrorInvalidValue (U, R) is not a built case.
int lstm_seq_max_active_clusters(int U, int R, int F, int H) {
#define X(u, r) \
  if (U == u && R == r) return max_active<u, r>(F, H);
  LSTM_SEQ_CASES(X)
#undef X
  return -static_cast<int>(cudaErrorInvalidValue);
}

// xs (T,B,F) f32, mask (T,B) bool as bytes, wx (F,4H), wh (H,4H), b (4H)
// f32, hs (T,B,H) f32; all contiguous on the current device.  U hidden
// units per CTA (cluster size H/U), R batch rows per tile, `clusters`
// clusters walking over the ceil(B/R) tiles.  Launches on `stream`,
// does not synchronise, returns cudaGetLastError().
int lstm_seq_launch(const float* xs, const unsigned char* mask,
                    const float* wx, const float* wh, const float* b,
                    float* hs, int T, int B, int F, int H, int U, int R,
                    int clusters, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define X(u, r)                                                        \
  if (U == u && R == r)                                                \
    return launch<u, r>(xs, mask, wx, wh, b, hs, T, B, F, H, clusters, s);
  LSTM_SEQ_CASES(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
