// Fused Dynamic filter+score over the node-by-metric load matrix.
//
// Replaces the TPU kernel in crane_scheduler_tpu/scorer/pallas_kernel.py
// (PallasScorer._run, body built by _make_kernel). It computes exactly
// BatchedScorer(float32)._score_impl (crane_scheduler_tpu/scorer/batched.py):
//
//   over   = OR over predicates with active > 0 and threshold != 0 of
//            (now < ts + active) & !(u < 0) & (u > threshold)
//   base   = Go int32 trunc of (ordered sum of fl(fl((1 - u) * w) * 100)
//            over fresh, non-negative priority entries) / weight_sum
//   penalty= Go int32 trunc of hot * 10 when now < hot_ts + 300 and hot >= 0
//   score  = clip(base - penalty, 0, 100), 0 where the row is invalid
//   sched  = !over & valid
//
// Layout:
// - Policy by value. The column indices, windows, thresholds and weights
//   come in one ScorePolicy struct in the kernel's parameter space (at most
//   kMaxEntries predicates and as many priorities; the wrapper raises above
//   that), so they are uniform constant-bank operands and no node waits on
//   a dependent global load of a policy constant before it can read its row.
// - Rows read directly. A thread scores one node at a time, reading the
//   entries of its own [M]-float rows of values and timestamps that the
//   policy names; a warp's loads of one column touch 32 consecutive rows,
//   whose lines the warp's other columns then hit in L1. The policy loops
//   stay rolled, which keeps the code small (28 registers): the main path
//   launches this kernel once per burst, between other kernels, so it
//   starts with cold instruction caches.
// - One wave. The grid is min(ceil(N / 256), SMs x resident blocks per SM),
//   from the device's SM count and this kernel's occupancy; blocks take
//   further nodes in a grid-stride loop.
// This kernel's first design on the H100 staged 256-node tiles of both
// matrices in shared memory with 16-byte loads and unrolled the policy
// loops; it ran slower than the row-per-thread layout, warm and cold, and
// was dropped. The TPU kernel's transposed [M_pad, N] layout and 8-sublane
// output broadcast served the TPU's (8, 128) tiling and have no
// counterpart here.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. At 51,200 nodes x 6 metrics the
// kernel reads 2 x 51,200 x 6 x 4 B (values, ts) + 51,200 x 9 B (hot,
// hot_ts, valid) and writes 51,200 x 5 B, about 3.17 MB, or about 0.95 us;
// the ~80 float ops per node are ~0.06 us at 67 TFLOP/s.
//
// Bit parity with the f32 reference: every float op is an explicitly
// rounded intrinsic (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn; the build
// also passes -fmad=false), priority entries add in policy order, Go's int()
// maps NaN/Inf/out-of-range to INT32_MIN (CUDA's conversion would saturate
// and send NaN to 0), and the subtraction base - penalty wraps in two's
// complement through uint32.

#include <cuda_runtime.h>
#include <atomic>
#include <climits>
#include <cstdint>

constexpr int kMaxEntries = 16;

// At namespace scope: a C entry point whose parameter type had internal
// linkage would get internal linkage itself.
struct ScorePolicy {
  int n_pred;
  int n_prio;
  int pred_col[kMaxEntries];
  float pred_thr[kMaxEntries];
  float pred_active[kMaxEntries];
  int prio_col[kMaxEntries];
  float prio_w[kMaxEntries];
  float prio_active[kMaxEntries];
  float weight_sum;
  float hot_active;
};

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ int go_trunc_i32(float q) {
  // NaN fails both comparisons; +-Inf and |q| >= 2^31 fail one.
  if (!(q > -2147483648.0f && q < 2147483648.0f)) return INT_MIN;
  return __float2int_rz(q);
}

__global__ void __launch_bounds__(kBlock) score_nodes_kernel(
    const float* __restrict__ values, const float* __restrict__ ts,
    const float* __restrict__ hot, const float* __restrict__ hot_ts,
    const uint8_t* __restrict__ valid, int n, int m, float now,
    const ScorePolicy pol, uint8_t* __restrict__ sched_out,
    int* __restrict__ score_out) {
  for (int i = blockIdx.x * kBlock + threadIdx.x; i < n; i += gridDim.x * kBlock) {
    const float* u_row = values + static_cast<size_t>(i) * m;
    const float* t_row = ts + static_cast<size_t>(i) * m;

    bool over = false;
#pragma unroll 1
    for (int p = 0; p < pol.n_pred; ++p) {
      const float active = pol.pred_active[p];
      const float thr = pol.pred_thr[p];
      if (!(active > 0.0f) || thr == 0.0f) continue;  // entry disabled
      const int c = pol.pred_col[p];
      const float u = u_row[c];
      const bool fresh = now < __fadd_rn(t_row[c], active);
      over = over || (fresh && !(u < 0.0f) && u > thr);
    }

    int base = 0;  // no priorities: score 0
    if (pol.n_prio > 0) {
      float acc = 0.0f;
#pragma unroll 1
      for (int k = 0; k < pol.n_prio; ++k) {
        const float active = pol.prio_active[k];
        const int c = pol.prio_col[k];
        const float u = u_row[c];
        const bool ok =
            active > 0.0f && now < __fadd_rn(t_row[c], active) && !(u < 0.0f);
        // Go rounds twice: fl(fl((1 - u) * w) * 100); entries add in order.
        const float contrib =
            __fmul_rn(__fmul_rn(__fsub_rn(1.0f, u), pol.prio_w[k]), 100.0f);
        const float entry = ok ? contrib : 0.0f;
        acc = (k == 0) ? entry : __fadd_rn(acc, entry);
      }
      // weight_sum == 0 gives NaN or +-Inf, which truncate to INT32_MIN
      // exactly as the reference's explicit NaN/Inf quotient does.
      base = go_trunc_i32(__fdiv_rn(acc, pol.weight_sum));
    }

    const float h = hot[i];
    const bool hot_ok = now < __fadd_rn(hot_ts[i], pol.hot_active) && !(h < 0.0f);
    const int penalty = go_trunc_i32(__fmul_rn(hot_ok ? h : 0.0f, 10.0f));
    int score = static_cast<int>(static_cast<uint32_t>(base) -
                                 static_cast<uint32_t>(penalty));
    score = min(max(score, 0), 100);
    const bool v = valid[i] != 0;
    score_out[i] = v ? score : 0;
    sched_out[i] = (v && !over) ? 1 : 0;
  }
}

std::atomic<int> g_wave[64];  // per device: blocks in one wave, 0 until asked

// Blocks of score_nodes_kernel resident on the whole current device (SMs x
// blocks per SM): one wave. Cached per device, so a launch costs no
// occupancy query.
cudaError_t one_wave(int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cache = dev >= 0 && dev < 64;
  if (cache && (*blocks = g_wave[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, score_nodes_kernel,
                                                        kBlock, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (cache) g_wave[dev].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

// sizeof(ScorePolicy), which the wrapper holds against its own copy of the
// layout before it passes one.
extern "C" int crane_score_nodes_policy_bytes() {
  return static_cast<int>(sizeof(ScorePolicy));
}

// The caller checks the policy's entry counts against kMaxEntries.
extern "C" int crane_score_nodes(
    const void* values, const void* ts, const void* hot, const void* hot_ts,
    const void* valid, int n, int m, float now, const ScorePolicy* policy,
    void* sched_out, void* score_out, void* stream) {
  if (n <= 0 || m < 0 || policy->n_pred < 0 || policy->n_pred > kMaxEntries ||
      policy->n_prio < 0 || policy->n_prio > kMaxEntries)
    return static_cast<int>(cudaErrorInvalidValue);
  int wave = 0;
  const cudaError_t err = one_wave(&wave);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int needed = (n + kBlock - 1) / kBlock;
  const int grid = needed < wave ? needed : wave;
  score_nodes_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const float*>(ts),
      static_cast<const float*>(hot), static_cast<const float*>(hot_ts),
      static_cast<const uint8_t*>(valid), n, m, now, *policy,
      static_cast<uint8_t*>(sched_out), static_cast<int*>(score_out));
  return static_cast<int>(cudaGetLastError());
}
