// The contention engine's event loop for Hopper (sm_90a): the whole loop
// of src/repro_torch/sim/engine.py::_loop in one launch, one warp a
// stream.
//
// Replaces no TPU kernel.  The JAX package runs this loop as
// lax.while_loop vmapped over streams (src/repro/sim/engine.py::
// simulate_jax), which XLA compiles into one device loop.  The port ran
// it in eager PyTorch over the whole (S, n) batch: about 50 launches an
// iteration, (S, n, M) one-hot tensors for the per-SA reductions, frozen
// streams recomputed and masked out, and a host check of the condition
// every 16 iterations.  This kernel is that loop on the card; _loop stays
// its plain twin (the CPU route and the route of shapes beyond the
// kernel's limits).
//
// It computes, per stream s and for its n slots and M SAs, what _loop
// computes: from t = 0, each iteration admits on every idle SA its best
// ready candidate (priority tie-broken by slot at 1e-6, ties within 1e-9
// to the lowest slot), shares the bandwidth B among the active sub-jobs
// (rho = B / D when their demand D exceeds B), advances to the next
// finish or enabling time, and finishes the sub-jobs whose progress
// reached their cost less tol = 1e-5 + 4e-6 t.  A stream loops while it
// has an unfinished valid sub-job and fewer than 3n + M + 16 iterations,
// and, with stop_start_after, while its clock is short of the horizon or
// an early starter is still owed a finish.
//
// What bounds it on an H100.  Bytes: each slot's inputs read once (valid
// 1 B, assign and dep 8 B each, prio, cost, bw, ready 4 B each: 33 B) and
// start and finish written once (8 B), 41 B a slot: 64.5 MB at
// (S, n) = (16384, 96), 0.019 ms at 3.35 TB/s.  Latency: a stream's
// iterations run one after another (48-69 a serving period at that
// shape, up to 3n + M + 16 = 310), each a chain of a few warp reductions.
//
// What the design does about it:
//   * one warp a stream, lane l holding slots l, l + 32, ... in registers
//     (NS = ceil(n / 32) of them: SA, tie-broken priority, cost,
//     bandwidth, dependency, ready and enabling times, progress, start,
//     finish); nothing is stored until the stream is done;
//   * valid, started and finished are warp-wide bit masks
//     (__ballot_sync), so the dependency test finished[dep] is a bit test;
//   * the per-SA reductions are bit masks over SAs (busy SAs, SAs with a
//     candidate; __reduce_or_sync), each SA's best score a max-reduce of
//     an order-preserving key (__reduce_max_sync) and its lowest tied
//     slot a ballot: no (S, n, M) tensor;
//   * D, the least remaining time and the least enabling time are warp
//     reductions; the float sum is a butterfly, so every lane holds the
//     same bits and every decision is uniform across the warp;
//   * each warp loops on its own stream's condition and exits: no host
//     check, and no work on a stream that is done;
//   * float32 as _loop: every product, sum and quotient that _loop takes
//     as a separate operation is rounded by itself (__fmul_rn,
//     __fadd_rn, __fsub_rn, __fdiv_rn: nvcc contracts nothing into an
//     FMA), with _loop's tolerances.  Only the order of D's sum differs
//     from torch.sum's.
//
// Inputs as the engine's callers pass them: valid bool, assign and dep
// int64, prio, cost, bw, ready (S, n) and sa_free (S, M) float32, all
// contiguous; B a float or an (S,) float32 tensor.  An SA index outside
// [0, M) is clamped (_loop would fault on it); a dependency at or past
// 32 * NS never counts as finished.  NaN inputs are not handled as
// torch's NaN-propagating min and max would.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 4;                   // streams (warps) a block
constexpr int MAX_N = 256;                 // slots a stream: 8 a lane
constexpr int MAX_M = 32;                  // SAs: one bit each
constexpr unsigned FULL = 0xffffffffu;
constexpr float INF = 1e30f;               // engine.INF in float32
constexpr float HALF_INF = 5e29f;          // INF / 2
constexpr float EPS = 1e-5f;               // engine._EPS

// An unsigned key with the order of the floats (NaN aside).
__device__ __forceinline__ unsigned okey(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unkey(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}
__device__ __forceinline__ float warp_max(float x) {
  return unkey(__reduce_max_sync(FULL, okey(x)));
}
__device__ __forceinline__ float warp_min(float x) {
  return unkey(__reduce_min_sync(FULL, okey(x)));
}
// Butterfly: lane l adds x_l and x_{l^o} in either order, so every lane
// ends with the same bits.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ bool lane_bit(unsigned word, int lane) {
  return (word >> lane) & 1u;
}
// Bit j of the warp-wide mask w (words of 32 slots); 0 past its end.
template <int NS>
__device__ __forceinline__ bool slot_bit(const unsigned (&w)[NS], int j) {
  unsigned word = 0u;
#pragma unroll
  for (int k = 0; k < NS; ++k)
    if ((j >> 5) == k) word = w[k];
  return (word >> (j & 31)) & 1u;
}

template <int NS>
__global__ void __launch_bounds__(32 * WARPS)
event_loop_kernel(const bool* __restrict__ valid,
                  const int64_t* __restrict__ assign,
                  const float* __restrict__ prio,
                  const float* __restrict__ cost,
                  const float* __restrict__ bw,
                  const int64_t* __restrict__ dep,
                  const float* __restrict__ ready,
                  const float* __restrict__ sa_free,
                  const float* __restrict__ b_stream, float b_all, int S,
                  int n, int M, float stop, float* __restrict__ start_out,
                  float* __restrict__ finish_out, int* __restrict__ iters_out) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (s >= S) return;                      // the whole warp leaves
  const int64_t row = static_cast<int64_t>(s) * n;
  const int max_iters = 3 * n + M + 16;
  const float B = b_stream != nullptr ? b_stream[s] : b_all;
  const float free_m =
      lane < M ? sa_free[static_cast<int64_t>(s) * M + lane] : INF;

  int sa[NS], dp[NS];
  float score[NS], c[NS], w[NS], rdy[NS], en[NS], prog[NS], st[NS], fin[NS];
  unsigned V[NS], ST[NS], FN[NS];          // valid, started, finished
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int j = 32 * k + lane;
    const bool in = j < n;
    int64_t a = in ? assign[row + j] : 0;
    a = a < 0 ? 0 : (a >= M ? M - 1 : a);
    const int64_t d = in ? dep[row + j] : -1;
    sa[k] = static_cast<int>(a);
    dp[k] = d < 0 ? -1 : (d >= MAX_N ? MAX_N : static_cast<int>(d));
    score[k] = __fsub_rn(in ? prio[row + j] : 0.f,
                         __fmul_rn(static_cast<float>(j), 1e-6f));
    c[k] = in ? cost[row + j] : 0.f;
    w[k] = in ? bw[row + j] : 0.f;
    rdy[k] = in ? ready[row + j] : 0.f;
    en[k] = fmaxf(__shfl_sync(FULL, free_m, sa[k]), rdy[k]);
    prog[k] = 0.f;
    st[k] = INF;
    fin[k] = INF;
    V[k] = __ballot_sync(FULL, in && valid[row + j]);
    ST[k] = 0u;
    FN[k] = 0u;
  }

  float t = 0.f;
  int it = 0;
  for (; it < max_iters; ++it) {
    // ---- the stream's loop condition
    bool live = false;
    unsigned early = 0u;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const unsigned open = V[k] & ~FN[k];
      live |= open != 0u;
      early |= __ballot_sync(FULL,
                             lane_bit(open & ST[k], lane) && st[k] < stop);
    }
    if (!live || !(t < stop || early != 0u)) break;
    const float tc = t;
    const float tce = __fadd_rn(tc, EPS);

    // ---- start phase: each idle SA admits its best ready candidate
    unsigned ACT[NS];
    bool dd[NS];
    unsigned busy = 0u;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      ACT[k] = ST[k] & ~FN[k] & V[k];
      dd[k] = dp[k] < 0 || slot_bit(FN, dp[k]);
      if (lane_bit(ACT[k], lane)) busy |= 1u << sa[k];
    }
    busy = __reduce_or_sync(FULL, busy);
    const unsigned sa_open = __ballot_sync(
        FULL, lane < M && !lane_bit(busy, lane) && free_m <= tce);
    bool cand[NS];
    unsigned cand_sa = 0u;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      cand[k] = lane_bit(V[k] & ~ST[k], lane) && dd[k] && rdy[k] <= tce &&
                lane_bit(sa_open, sa[k]);
      if (cand[k]) cand_sa |= 1u << sa[k];
    }
    cand_sa = __reduce_or_sync(FULL, cand_sa);
    unsigned SN[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) SN[k] = 0u;
    while (cand_sa != 0u) {                // uniform over the warp
      const int m = __ffs(cand_sa) - 1;
      cand_sa &= cand_sa - 1u;
      float best = -INF;
#pragma unroll
      for (int k = 0; k < NS; ++k)
        if (cand[k] && sa[k] == m) best = fmaxf(best, score[k]);
      best = warp_max(best);
      const float thr = __fsub_rn(best, 1e-9f);
      bool found = false;
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const unsigned tie = __ballot_sync(
            FULL, cand[k] && sa[k] == m && score[k] >= thr &&
                      score[k] > -HALF_INF);
        if (!found && tie != 0u) {         // the lowest tied slot
          SN[k] |= tie & (~tie + 1u);
          found = true;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      if (lane_bit(SN[k], lane)) st[k] = tc;
      ST[k] |= SN[k];
      ACT[k] |= SN[k];
    }

    // ---- next event
    const float tol = __fadd_rn(EPS, __fmul_rn(4e-6f, tc));
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < NS; ++k)
      if (lane_bit(ACT[k], lane)) part = __fadd_rn(part, w[k]);
    const float D = warp_sum(part);
    const float rho = D > B ? __fdiv_rn(B, fmaxf(D, 1e-9f)) : 1.f;
    const float rho_c = fmaxf(rho, 1e-12f);
    float rem = INF, enab = INF;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      if (lane_bit(ACT[k], lane))
        rem = fminf(rem, __fdiv_rn(fmaxf(__fsub_rn(c[k], prog[k]), 0.f),
                                   rho_c));
      if (lane_bit(V[k] & ~ST[k], lane) && dd[k] && en[k] > tce)
        enab = fminf(enab, en[k]);
    }
    const float t_fin = __fadd_rn(tc, fmaxf(warp_min(rem), tol));
    float next_t = fminf(t_fin, warp_min(enab));
    if (!(isfinite(next_t) && next_t < HALF_INF)) next_t = tc;

    // ---- progress: finish what reached its cost
    const float step = __fmul_rn(__fsub_rn(next_t, tc), rho);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      bool done = false;
      if (lane_bit(ACT[k], lane)) {
        prog[k] = __fadd_rn(prog[k], step);
        if (prog[k] >= __fsub_rn(c[k], tol)) {
          fin[k] = next_t;
          done = true;
        }
      }
      FN[k] |= __ballot_sync(FULL, done);
    }
    t = next_t;
  }

#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int j = 32 * k + lane;
    if (j < n) {
      start_out[row + j] = st[k];
      finish_out[row + j] = fin[k];
    }
  }
  if (lane == 0) iters_out[s] = it;
}

template <int NS>
cudaError_t launch(const void* valid, const void* assign, const void* prio,
                   const void* cost, const void* bw, const void* dep,
                   const void* ready, const void* sa_free,
                   const void* b_stream, float b_all, int S, int n, int M,
                   float stop, void* start, void* finish, void* iters,
                   cudaStream_t stream) {
  const dim3 grid((S + WARPS - 1) / WARPS);
  event_loop_kernel<NS><<<grid, 32 * WARPS, 0, stream>>>(
      static_cast<const bool*>(valid), static_cast<const int64_t*>(assign),
      static_cast<const float*>(prio), static_cast<const float*>(cost),
      static_cast<const float*>(bw), static_cast<const int64_t*>(dep),
      static_cast<const float*>(ready), static_cast<const float*>(sa_free),
      static_cast<const float*>(b_stream), b_all, S, n, M, stop,
      static_cast<float*>(start), static_cast<float*>(finish),
      static_cast<int*>(iters));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* event_loop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// valid (S,n) bool, assign and dep (S,n) int64, prio, cost, bw, ready
// (S,n) and sa_free (S,M) float32, b_stream (S,) float32 or null (then
// every stream's bandwidth is b_all), stop the early exit's horizon (INF
// for none); outputs start, finish (S,n) float32 and iters (S,) int32,
// each stream's iterations.  All contiguous on the current device.
// Launches on `stream`, does not synchronise, returns cudaGetLastError()
// (or cudaErrorInvalidValue outside 1 <= S, 1 <= n <= 256, 1 <= M <= 32).
int event_loop_launch(const void* valid, const void* assign,
                      const void* prio, const void* cost, const void* bw,
                      const void* dep, const void* ready,
                      const void* sa_free, const void* b_stream, float b_all,
                      int S, int n, int M, float stop, void* start,
                      void* finish, void* iters, void* stream) {
  if (S < 1 || n < 1 || n > MAX_N || M < 1 || M > MAX_M)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EVENT_LOOP_CASE(NS)                                               \
  case NS:                                                                \
    return static_cast<int>(launch<NS>(valid, assign, prio, cost, bw, dep, \
                                       ready, sa_free, b_stream, b_all, S,  \
                                       n, M, stop, start, finish, iters,    \
                                       st));
  switch ((n + 31) / 32) {
    EVENT_LOOP_CASE(1)
    EVENT_LOOP_CASE(2)
    EVENT_LOOP_CASE(3)
    EVENT_LOOP_CASE(4)
    EVENT_LOOP_CASE(5)
    EVENT_LOOP_CASE(6)
    EVENT_LOOP_CASE(7)
    EVENT_LOOP_CASE(8)
  }
#undef EVENT_LOOP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
