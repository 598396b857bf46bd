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
//          = min(cap_n, max(0 - pri_n, 0))           otherwise.
//
// Design: a breakpoint histogram plus a prefix scan. For fixed n, A_n is a
// step function of L with at most 13 steps: cap_n up to off_n; then, for q
// in 1..min(s_n, 100), a value that depends on q only through the staircase
// index x = min((s_n - q) / 10, 10), which falls by one every 10 steps of q
// (at most 11 runs, x_first down to x_last); then the tail value. Step q
// covers levels [off + (q-1)·w + 1, off + q·w], so run x starts at level
// off + (q_lo(x) - 1)·w + 1 with q_lo = 1 for the first run and s - 10x - 9
// for the others, and the tail at off + min(s, 100)·w + 1. A thread computes
// each run's start and its change A after - A before in closed form, all 12
// independent of one another (unrolled, no loop-carried walk), and adds each
// nonzero change into its block's shared-memory difference histogram of
// n_levels bins with a shared atomic; a change at a level <= 0 lands in bin
// 0, one at or past n_levels is dropped. The level-0 value (cap_n) goes
// through a block reduction instead, since every node has it. The block then
// prefix-scans its own histogram and adds each nonzero scanned bin into the
// zeroed totals with a global atomic: a prefix scan is linear, so the sum of
// the blocks' scans is the scan of their sum, and no block waits for
// another. The work is O(N x 13) and reads 16 B per node, whatever the level
// count.
//
// This kernel's first design on the H100 merged equal bins within a warp
// with __match_any_sync before each shared atomic, and scanned the summed
// histogram in the last block to finish (an atomic ticket). The merge cost
// more than the bin contention it removed (on the main path every node
// changes at level 1), and the ticket put a serial tail behind the grid; so
// equal bins go to the shared atomic unmerged, and each block scans its own.
//
// Exactness: every add is in uint32, and two's-complement addition is
// associative modulo 2^32, so the histogram, the scans and the cross-block
// atomics give the plain totals bit for bit in any order. The caller clips
// every node's cap to (2^31 - 1) / N, so every total fits in int32. Division
// operands are non-negative (s_n >= q on the runs), so C's "/" equals the
// reference's floor division; g[x] - pri wraps through uint32 as the int32
// reference does; levels are computed in 64 bits. Lanes past N hold no node.
//
// Grid: one wave, min(ceil(N / 256), SMs x resident blocks per SM) blocks of
// 256 threads; a block walks node tiles in a grid-stride loop. Shared
// memory is n_levels x 4 B, so the level count is bounded by the device's
// opt-in shared memory per block (about 58,000 levels on an H100);
// crane_gang_totals_max_levels() reports it and the wrapper raises above it.
//
// Bound on an H100 SXM: bytes. The kernel reads 4 x 4 B per node and writes
// 4 B per level (about 0.82 MB at 51,200 nodes and 102 levels, 0.25 us at
// 3.35 TB/s); each of at most 13 steps per node is about 10 int32
// operations (under 7e6 operations, about 0.2 us at 33.5 TOP/s).

#include <cuda_runtime.h>
#include <atomic>
#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxScore = 100;
constexpr unsigned kFull = 0xffffffffu;

// A_n on a run whose staircase entry is `unlocked`: min(cap, max(u - pri, 0))
// with the subtraction wrapping as in the int32 reference.
__device__ __forceinline__ int run_value(int unlocked, int cap, int pri) {
  const int left = static_cast<int>(static_cast<unsigned>(unlocked) - static_cast<unsigned>(pri));
  return min(cap, max(left, 0));
}

__device__ __forceinline__ void add_change(unsigned* hist, long long level, int n_levels,
                                           int before, int after) {
  if (after != before && level < n_levels)
    atomicAdd(&hist[level > 0 ? static_cast<int>(level) : 0],
              static_cast<unsigned>(after) - static_cast<unsigned>(before));
}

__global__ void __launch_bounds__(kBlock) gang_totals_kernel(
    const int* __restrict__ s, const int* __restrict__ offs,
    const int* __restrict__ cap, const int* __restrict__ pri, int n,
    const int* __restrict__ g, int w, int n_levels, unsigned* __restrict__ totals) {
  extern __shared__ unsigned hist[];  // this block's difference histogram
  __shared__ int g_s[11];
  __shared__ unsigned warp_sums[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int j = tid; j < n_levels; j += kBlock) hist[j] = 0u;
  if (tid < 11) g_s[tid] = g[tid];
  __syncthreads();

  unsigned level0 = 0u;  // this thread's share of bin 0
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock + tid; i < n;
       i += static_cast<long long>(gridDim.x) * kBlock) {
    const int s_i = s[i], off_i = offs[i], cap_i = cap[i], pri_i = pri[i];
    level0 += static_cast<unsigned>(cap_i);
    const int qmax = s_i > 0 ? min(s_i, kMaxScore) : 0;
    const int x_first = s_i > 0 ? min((s_i - 1) / 10, 10) : -1;  // at q = 1
    const int x_last = s_i > 0 ? min((s_i - qmax) / 10, 10) : 0;  // at q = qmax
    const long long level1 = static_cast<long long>(off_i) + 1;   // step q = 1
    int v_above = cap_i;  // value of run x + 1
#pragma unroll
    for (int x = 10; x >= 0; --x) {
      const int v = run_value(g_s[x], cap_i, pri_i);
      if (x <= x_first && x >= x_last) {
        const int q_lo = x == x_first ? 1 : s_i - 10 * x - 9;
        add_change(hist, level1 + static_cast<long long>(q_lo - 1) * w, n_levels,
                   x == x_first ? cap_i : v_above, v);
      }
      v_above = v;
    }
    // past the unlocked steps: the tail value
    add_change(hist, level1 + static_cast<long long>(qmax) * w, n_levels,
               x_first >= 0 ? run_value(g_s[x_last], cap_i, pri_i) : cap_i,
               run_value(0, cap_i, pri_i));
  }
  level0 = __reduce_add_sync(kFull, level0);
  if (lane == 0) warp_sums[tid >> 5] = level0;
  __syncthreads();
  if (tid == 0) {
    unsigned b0 = 0u;
    for (int k = 0; k < kWarps; ++k) b0 += warp_sums[k];
    hist[0] += b0;
  }
  __syncthreads();

  // Inclusive scan of this block's histogram: each thread a contiguous
  // chunk, then an exclusive scan of the chunk sums across the block.
  const int per = (n_levels + kBlock - 1) / kBlock;
  const int lo = min(tid * per, n_levels);
  const int hi = min(lo + per, n_levels);
  unsigned run = 0u;
  for (int j = lo; j < hi; ++j) {
    run += hist[j];
    hist[j] = run;
  }
  unsigned incl = run;
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sums[tid >> 5] = incl;
  __syncthreads();
  unsigned carry = incl - run;
  for (int k = 0; k < (tid >> 5); ++k) carry += warp_sums[k];
  for (int j = lo; j < hi; ++j) hist[j] += carry;
  __syncthreads();

  for (int j = tid; j < n_levels; j += kBlock) {
    const unsigned v = hist[j];
    if (v != 0u) atomicAdd(&totals[j], v);
  }
}

int g_max_levels[64];  // per device, 0 until first asked
std::atomic<unsigned long long> g_wave[64];  // per device: shmem << 32 | blocks

// Blocks of gang_totals_kernel resident on the whole current device at `shmem` bytes
// of dynamic shared memory (SMs x blocks per SM): one wave. Cached per
// device for the last size asked, so a launch costs no occupancy query.
cudaError_t one_wave(size_t shmem, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cache = dev >= 0 && dev < 64;
  if (cache) {
    const unsigned long long hit = g_wave[dev].load(std::memory_order_relaxed);
    if (hit != 0 && (hit >> 32) == shmem) {
      *blocks = static_cast<int>(hit & 0xffffffffu);
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gang_totals_kernel, kBlock, shmem);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (cache)
    g_wave[dev].store((static_cast<unsigned long long>(shmem) << 32) |
                          static_cast<unsigned>(*blocks),
                      std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

// The largest n_levels one launch takes on the current device (its opt-in
// shared memory per block, less the kernel's static shared memory, in 4 B
// bins), after raising the kernel's dynamic shared-memory limit to match; a
// negative value is a CUDA error code, negated.
extern "C" int crane_gang_totals_max_levels() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (dev >= 0 && dev < 64 && g_max_levels[dev] > 0) return g_max_levels[dev];
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, gang_totals_kernel);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int dyn = optin - static_cast<int>(attr.sharedSizeBytes);
  err = cudaFuncSetAttribute(gang_totals_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int levels = dyn / static_cast<int>(sizeof(unsigned));
  if (dev >= 0 && dev < 64) g_max_levels[dev] = levels;
  return levels;
}

// totals must hold n_levels zeroed 32-bit words. The caller checks n_levels
// against crane_gang_totals_max_levels() first.
extern "C" int crane_gang_totals(const void* s, const void* offs,
                                 const void* cap, const void* pri, int n,
                                 const void* g, int w, int n_levels,
                                 void* totals, void* stream) {
  if (n <= 0 || n_levels <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = sizeof(unsigned) * static_cast<size_t>(n_levels);
  int wave = 0;
  const cudaError_t err = one_wave(shmem, &wave);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (static_cast<long long>(n) + kBlock - 1) / kBlock;
  const int grid = static_cast<int>(tiles < wave ? tiles : wave);
  gang_totals_kernel<<<grid, kBlock, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(s), static_cast<const int*>(offs),
      static_cast<const int*>(cap), static_cast<const int*>(pri), n,
      static_cast<const int*>(g), w, n_levels, static_cast<unsigned*>(totals));
  return static_cast<int>(cudaGetLastError());
}
