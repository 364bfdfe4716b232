// Masked full-sequence LSTM for Hopper (sm_90a): the whole T-step
// recurrence in ONE launch, the weights held in shared memory across all
// steps.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/lstm_seq/lstm_seq.py::lstm_seq_pallas
//   (body _lstm_seq_kernel)
// and computes the same function: zero initial carry, gates i, f, g, o
// (column blocks of Wx (F,4H) / Wh (H,4H) / b (4H)), and a masked step
// keeps (h, c) and emits the held h.
//
// What bounds it on an H100.  One call does 2*B*T*(F+H)*4H float32
// operations and moves xs, mask, the weights and hs once.  At the
// serving shape (T=97, B=32, F=16, H=256) that is 1.73 GFLOP against
// ~4.5 MB: 26 us at the 67 TFLOP/s float32 (non-tensor-core) peak and
// 1.3 us at 3.35 TB/s, so operations bound it.  The recurrence is
// sequential in T, so the real limit is the latency of one step: every
// step needs all of h_{t-1} before any gate of step t.
//
// What the design does about it.  On the TPU the weights sat in VMEM
// (~1.6 MB).  Here a block has at most 227 KB of shared memory, and Wh
// alone is 16*H^2 bytes = 1 MB at H=256, so the hidden units are split
// across a thread-block cluster:
//   * CTA j of a cluster of H/32 CTAs owns hidden units [32j, 32j+32),
//     i.e. their 128 gate columns.  It stages its [Wx; Wh] column slice
//     as float4 (i, f, g, o) per (input row, unit) in dynamic shared
//     memory once, (F+H)*32*16 bytes = 136 KB at H=256, F=16, and keeps
//     it for all T steps: the weights are read from device memory once
//     per cluster, not once per step.
//   * A cluster handles ROWS batch rows, one warp per row, one lane per
//     unit, so each thread owns one (row, unit) pair for the whole
//     sequence and keeps that pair's c (and h) in registers.
//   * After each step a CTA writes its 32-unit slice of h_t to its own
//     shared memory (double-buffered by step parity), the cluster
//     synchronises once, and every CTA gathers the full h_t from its
//     peers through distributed shared memory.  One cluster barrier
//     per step; h never goes back through device memory.
//   * Batch tiles are independent clusters (grid.y), so B=32 occupies
//     8 clusters x 8 CTAs at H=256.
// H must be a multiple of 32 with H/32 <= 8 (the portable cluster
// size); the wrapper raises otherwise.  This is a first, simple kernel:
// each thread runs an (F+H)-long dot product per step out of shared
// memory.  Making it fast (register tiling over rows, tensor cores) is
// later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int UNITS = 32;  // hidden units per CTA (one per lane)
constexpr int ROWS = 4;    // batch rows per cluster (one warp each)

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(UNITS * ROWS)
lstm_seq_kernel(const float* __restrict__ xs,
                const unsigned char* __restrict__ mask,
                const float* __restrict__ wx, const float* __restrict__ wh,
                const float* __restrict__ bias, float* __restrict__ hs,
                int T, int B, int F, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nc = static_cast<int>(cluster.num_blocks());  // == H / UNITS
  const int u = threadIdx.x & (UNITS - 1);
  const int r = threadIdx.x / UNITS;
  const int b = blockIdx.y * ROWS + r;
  const bool row_ok = b < B;
  const int K = F + H;
  const int unit = rank * UNITS + u;

  extern __shared__ float4 smem4[];
  float4* w4 = smem4;                                   // K x UNITS
  float* in_s = reinterpret_cast<float*>(w4 + K * UNITS);  // ROWS x K
  float* hbuf = in_s + ROWS * K;                        // 2 x ROWS x UNITS

  // stage this CTA's gate columns: rows [0,F) from Wx, [F,F+H) from Wh
  for (int idx = threadIdx.x; idx < K * UNITS; idx += blockDim.x) {
    const int k = idx / UNITS;
    const int col = rank * UNITS + idx % UNITS;
    const float* src = k < F ? wx + static_cast<size_t>(k) * 4 * H
                             : wh + static_cast<size_t>(k - F) * 4 * H;
    w4[idx] = make_float4(src[col], src[H + col], src[2 * H + col],
                          src[3 * H + col]);
  }
  for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x)
    in_s[(idx / H) * K + F + idx % H] = 0.0f;           // h_{-1} = 0
  const float4 b4 = make_float4(bias[unit], bias[H + unit],
                                bias[2 * H + unit], bias[3 * H + unit]);
  float h = 0.0f, c = 0.0f;
  float* my_in = in_s + r * K;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t tb = static_cast<size_t>(t) * B + b;
    if (row_ok) {
      for (int k = u; k < F; k += UNITS) my_in[k] = xs[tb * F + k];
    }
    __syncwarp();  // row r's x_t is written and read by warp r only
    if (row_ok) {
      float4 acc = b4;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float v = my_in[k];
        const float4 w = w4[k * UNITS + u];
        acc.x = fmaf(v, w.x, acc.x);
        acc.y = fmaf(v, w.y, acc.y);
        acc.z = fmaf(v, w.z, acc.z);
        acc.w = fmaf(v, w.w, acc.w);
      }
      const float ig = sigmoid_f(acc.x);
      const float fg = sigmoid_f(acc.y);
      const float gg = tanhf(acc.z);
      const float og = sigmoid_f(acc.w);
      const float c2 = fg * c + ig * gg;
      const float h2 = og * tanhf(c2);
      if (mask[tb]) {  // a masked-out step keeps (h, c), emits the held h
        h = h2;
        c = c2;
      }
      hs[tb * H + unit] = h;
    }
    float* buf = hbuf + (t & 1) * ROWS * UNITS;
    buf[r * UNITS + u] = h;
    cluster.sync();  // every CTA's slice of h_t is in its shared memory
    for (int idx = threadIdx.x; idx < nc * ROWS * UNITS; idx += blockDim.x) {
      const int peer = idx / (ROWS * UNITS);
      const int rem = idx % (ROWS * UNITS);
      const float* pbuf = cluster.map_shared_rank(buf, peer);
      in_s[(rem / UNITS) * K + F + peer * UNITS + rem % UNITS] = pbuf[rem];
    }
    __syncthreads();
  }
  cluster.sync();  // no CTA leaves while a peer may still read its buffer
}

size_t smem_bytes(int F, int H) {
  const size_t K = static_cast<size_t>(F) + H;
  return K * UNITS * sizeof(float4) + ROWS * K * sizeof(float) +
         2 * ROWS * UNITS * sizeof(float);
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs at (F, H); the wrapper checks it
// against the card's limit before launching.
size_t lstm_seq_smem_bytes(int F, int H) { return smem_bytes(F, H); }

const char* lstm_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// xs (T,B,F) f32, mask (T,B) bool as bytes, wx (F,4H), wh (H,4H), b (4H)
// f32, hs (T,B,H) f32; all contiguous on the current device.  Launches
// on `stream`, does not synchronise, returns cudaGetLastError().
int lstm_seq_launch(const float* xs, const unsigned char* mask,
                    const float* wx, const float* wh, const float* b,
                    float* hs, int T, int B, int F, int H, void* stream) {
  const int nc = H / UNITS;
  const size_t smem = smem_bytes(F, H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc, (B + ROWS - 1) / ROWS, 1);
  cfg.blockDim = dim3(UNITS * ROWS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lstm_seq_kernel, xs, mask, wx, wh, b, hs, T,
                           B, F, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
