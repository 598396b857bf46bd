// Level-table totals of the water-filling gang solve.
//
// Replaces the TPU kernel in crane_scheduler_tpu/scorer/pallas_gang.py
// (PallasGangScheduler._totals, body built by _make_kernel). It computes
// exactly GangScheduler._totals (crane_scheduler_tpu/scorer/topk.py):
//
//   totals[L] = sum over nodes n of A_n(L), L in [0, n_levels), where
//   qnum = L - off_n;  q = ceil(qnum / w)
//   A_n(L) = cap_n                                   when qnum <= 0, else
//          = min(cap_n, max(g[min((s_n - q) / 10, 10)] - pri_n, 0))
//                                                    when q <= 100 and s_n >= q,
//          = 0                                       otherwise.
//
// All in int32. The division operands are non-negative wherever the
// result is used (qnum > 0 on that branch, s_n >= q), so C's truncating
// "/" equals the reference's floor division; the caller clips every
// node's cap to (2^31 - 1) / N, so every total fits in int32.
//
// Layout: one thread per node, a block per 256 nodes. For each level a
// thread computes its A_n(L), __reduce_add_sync sums the warp, and lane 0
// adds the warp's sum into the block's shared per-level array; the block
// then atomically adds that array into the zeroed global totals. An int32
// sum is exact in any order, so the result does not depend on block
// order. Levels go in chunks of 4,096 (16 KB of shared memory), so any
// level count works; the plain grid has 102 levels, combined-score modes
// a few hundred. The TPU kernel carried the sum across its sequential
// grid in one resident output block; CUDA blocks run in no order, hence
// the atomics.
//
// Bound on an H100 SXM: integer operations. At 102 levels x 51,200
// padded nodes and about 25 int32 operations per (level, node) cell that
// is about 1.3e8 operations; the kernel reads only 4 x 51,200 x 4 B and
// writes 102 x 4 B (about 0.8 MB, 0.25 us at 3.35 TB/s).

#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kLevelChunk = 4096;
constexpr int kMaxScore = 100;

__global__ void __launch_bounds__(kBlock) gang_totals_kernel(
    const int* __restrict__ s, const int* __restrict__ offs,
    const int* __restrict__ cap, const int* __restrict__ pri, int n,
    const int* __restrict__ g, int w, int n_levels, int* __restrict__ totals) {
  extern __shared__ int part[];  // this block's partial totals, one chunk
  __shared__ int g_s[11];
  if (threadIdx.x < 11) g_s[threadIdx.x] = g[threadIdx.x];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  // lanes past the last node hold zero capacity: they add no tokens but
  // still take part in every warp reduction
  const int s_i = live ? s[i] : 0;
  const int off_i = live ? offs[i] : 0;
  const int cap_i = live ? cap[i] : 0;
  const int pri_i = live ? pri[i] : 0;
  const int lane = threadIdx.x & 31;

  for (int base = 0; base < n_levels; base += kLevelChunk) {
    const int len = min(kLevelChunk, n_levels - base);
    for (int j = threadIdx.x; j < len; j += blockDim.x) part[j] = 0;
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      const int qnum = base + j - off_i;
      int a = cap_i;  // every token of a node is valued >= its offset
      if (qnum > 0) {
        const int q = (w == 1) ? qnum : (qnum + w - 1) / w;
        int unlocked = 0;
        if (q <= kMaxScore && s_i >= q) unlocked = g_s[min((s_i - q) / 10, 10)];
        a = min(cap_i, max(unlocked - pri_i, 0));
      }
      const int warp_sum = __reduce_add_sync(0xffffffffu, a);
      if (lane == 0 && warp_sum != 0) atomicAdd(&part[j], warp_sum);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      if (part[j] != 0) atomicAdd(&totals[base + j], part[j]);
    }
    __syncthreads();  // the next chunk re-zeroes part
  }
}

}  // namespace

extern "C" int crane_gang_totals(const void* s, const void* offs,
                                 const void* cap, const void* pri, int n,
                                 const void* g, int w, int n_levels,
                                 void* totals, void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  const size_t shmem = sizeof(int) * static_cast<size_t>(
      std::min(n_levels, kLevelChunk));
  gang_totals_kernel<<<grid, kBlock, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(s), static_cast<const int*>(offs),
      static_cast<const int*>(cap), static_cast<const int*>(pri), n,
      static_cast<const int*>(g), w, n_levels, static_cast<int*>(totals));
  return static_cast<int>(cudaGetLastError());
}
