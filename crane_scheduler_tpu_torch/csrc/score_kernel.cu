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
// Layout: one thread per node, reading its own row of the node-major
// [N, M] f32 matrices as the scheduling step holds them; policy constants
// are small device arrays walked in policy order. The TPU kernel's
// transposed [M_pad, N] layout and 8-sublane output broadcast served the
// TPU's (8, 128) tiling and have no counterpart here.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. At 51,200 padded nodes x 6
// metrics the kernel reads 2 x 51,200 x 6 x 4 B (values, ts) + 51,200 x
// 9 B (hot, hot_ts, valid) and writes 51,200 x 5 B, about 3.2 MB, or
// about 0.95 us; the ~80 float ops per node are ~0.06 us at 67 TFLOP/s.
// At this size a launch costs more than either, so the kernel is
// launch-bound; its design keeps it to one pass with no intermediate
// device-memory traffic.
//
// Bit parity with the f32 reference: every float op is an explicitly
// rounded intrinsic (and the build passes -fmad=false), the division is
// correctly rounded, Go's int() maps NaN/Inf/out-of-range to INT32_MIN
// (CUDA's conversion would saturate and send NaN to 0), and the
// subtraction base - penalty wraps in two's complement through uint32.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

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
    const int* __restrict__ pred_idx, const float* __restrict__ pred_thr,
    const float* __restrict__ pred_active, int n_pred,
    const int* __restrict__ prio_idx, const float* __restrict__ prio_w,
    const float* __restrict__ prio_active, int n_prio, float weight_sum,
    float hot_active, uint8_t* __restrict__ sched_out,
    int* __restrict__ score_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* u_row = values + static_cast<size_t>(i) * m;
  const float* t_row = ts + static_cast<size_t>(i) * m;

  bool over = false;
  for (int p = 0; p < n_pred; ++p) {
    const float active = pred_active[p];
    const float thr = pred_thr[p];
    if (!(active > 0.0f) || thr == 0.0f) continue;  // entry disabled
    const int c = pred_idx[p];
    const float u = u_row[c];
    const bool fresh = now < __fadd_rn(t_row[c], active);
    over = over || (fresh && !(u < 0.0f) && u > thr);
  }

  int base = 0;  // no priorities: score 0
  if (n_prio > 0) {
    float acc = 0.0f;
    for (int k = 0; k < n_prio; ++k) {
      const float active = prio_active[k];
      const int c = prio_idx[k];
      const float u = u_row[c];
      const bool ok =
          active > 0.0f && now < __fadd_rn(t_row[c], active) && !(u < 0.0f);
      // Go rounds twice: fl(fl((1 - u) * w) * 100); entries add in order.
      const float contrib =
          __fmul_rn(__fmul_rn(__fsub_rn(1.0f, u), prio_w[k]), 100.0f);
      const float entry = ok ? contrib : 0.0f;
      acc = (k == 0) ? entry : __fadd_rn(acc, entry);
    }
    // weight_sum == 0 gives NaN or +-Inf, which truncate to INT32_MIN
    // exactly as the reference's explicit NaN/Inf quotient does.
    base = go_trunc_i32(__fdiv_rn(acc, weight_sum));
  }

  const float h = hot[i];
  const bool hot_ok = now < __fadd_rn(hot_ts[i], hot_active) && !(h < 0.0f);
  const int penalty = go_trunc_i32(__fmul_rn(hot_ok ? h : 0.0f, 10.0f));
  int score = static_cast<int>(static_cast<uint32_t>(base) -
                               static_cast<uint32_t>(penalty));
  score = min(max(score, 0), 100);
  const bool v = valid[i] != 0;
  score_out[i] = v ? score : 0;
  sched_out[i] = (v && !over) ? 1 : 0;
}

}  // namespace

extern "C" int crane_score_nodes(
    const void* values, const void* ts, const void* hot, const void* hot_ts,
    const void* valid, int n, int m, float now, const void* pred_idx,
    const void* pred_thr, const void* pred_active, int n_pred,
    const void* prio_idx, const void* prio_w, const void* prio_active,
    int n_prio, float weight_sum, float hot_active, void* sched_out,
    void* score_out, void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  score_nodes_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const float*>(ts),
      static_cast<const float*>(hot), static_cast<const float*>(hot_ts),
      static_cast<const uint8_t*>(valid), n, m, now,
      static_cast<const int*>(pred_idx), static_cast<const float*>(pred_thr),
      static_cast<const float*>(pred_active), n_pred,
      static_cast<const int*>(prio_idx), static_cast<const float*>(prio_w),
      static_cast<const float*>(prio_active), n_prio, weight_sum, hot_active,
      static_cast<uint8_t*>(sched_out), static_cast<int*>(score_out));
  return static_cast<int>(cudaGetLastError());
}
