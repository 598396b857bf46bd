// One step of the drip window: one pod's Filter, Score, argmax and fold
// over every node, in one launch.
//
// Replaces no TPU kernel: the reference's window is a jitted lax.scan
// (crane_scheduler_tpu/scorer/drip_batch.py, _drip_batch), which the port
// first ran as PyTorch ops (scorer/drip_batch.py, _drip_batch and, with
// NodeResourceTopologyMatch, _drip_batch_numa): 16 (plain) or 68 (NRT)
// dependent kernels a pod step, each a few microseconds over a 65,000-row
// column that L2 holds many times over. This kernel computes the same step
// bit for bit, so a window is K launches, ordered by the stream (and, on the
// main path, replayed from one captured CUDA graph).
//
// Step k over nodes i (int64 throughout, wrapping like PyTorch's int64):
//
//   fit_fail = bounded[i] & any_j(vec[j] > 0 & free[i, j] < vec[j])
//   mask     = schedulable[i] & !fit_fail
//   score    = weighted[i]
//   with zone columns (z > 0), NodeResourceTopologyMatch beside them:
//     on       = req > 0;  act_on = zactive[i] & on
//     need_fit = aw_none ? act_naw[i] : act_on & aw_true
//     fits     = any_j(zkey[i, j] - used[i, j] >= req)
//     mask    &= need_fit ? fits : (has[i] | !on)
//     pack     = zones by free CPU (zkey - used) descending, first among
//                equals first; take_s = min(rem, zcap - used) (the first
//                zone always, later ones while rem > 0), rem -= take_s
//     idx      = need_fit ? 1 : act_on ? #(take_s > 0) : z + 1
//     score   += table[idx];  bad counts mask & idx == 0
//   best     = the first maximum of (mask ? score : INT64_MIN)
//   ties     = #(mask & score == that maximum)
//   fold     free[best] -= vec where some row is feasible and the pod is
//            active; with zones, used[best] += the winner's takes by CR
//            zone (the whole request in the first zone for an aware pack,
//            the non-negative greedy takes otherwise) where NRT acts there
//   outs[k]  = (best or -1, feasible, ties or 1, [bad, takes[z]])
//
// Design: single pass, "last block finishes". Each block takes a slice of
// nodes (one node a thread at 65,000 nodes) and reduces it to (maximum,
// lowest index holding it, masked rows equal to it), the feasible count and
// the empty-pack count; the pair order (value descending, index ascending)
// makes every merge associative, so the result is np.argmax's whatever
// order blocks finish in. Each block writes its partial row to scratch,
// fences, and takes a ticket (atomicInc, which wraps the ticket back to 0
// for the next launch and the next replay). The block that takes the last
// ticket merges the partials, folds the winner's row and writes outs[k].
// No block waits for another: no cooperative launch, no grid barrier, no
// assumption that blocks are co-resident. Launches of one window are
// ordered by their stream, so step k + 1 sees step k's fold.
//
// The pack walks zones without storage: the next zone is the largest
// (free, -index) below the last one visited, an O(z^2) scan of the row, so
// any zone count runs (ZoneColumns' z is the largest CR's zone count). The
// reference marks visited zones with INT64_MIN; the orders agree while a
// zone's free CPU lies above INT64_MIN, which milli-CPU quantities do (the
// sentinel past a node's zones is -2^62).
//
// Bound on an H100 SXM: operations and latency. At 65,000 nodes a step
// reads 2.7 MB (plain; the NRT columns add 3.4 MB at z = 2), which L2 holds
// across steps, and does about 20 int32-equivalent operations a node
// (plain), 0.04 us at 33.5 TOP/s; the step's time is set by one dependent
// chain of global loads, a block reduction, the fence and ticket, the last
// block's merge and the winner's fold: 6.8 us a step plain and 8.6 us with
// two zones on an H100 SXM at 700 W (PERF.md, kernel table).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

// At namespace scope, and laid out as the wrapper's ctypes structure
// (scorer/drip_step.py, DripArgs): every pointer, then every int.
struct DripArgs {
  const unsigned char* sched;    // bool [n]
  const long long* weighted;     // [n]
  const unsigned char* bounded;  // bool [n]
  long long* free;               // [n, 4], folded in place
  const long long* vecs;         // [K, 4]
  const unsigned char* active;   // bool [K]
  long long* outs;               // [K, 3], or [K, 4 + z] with zones
  long long* scratch;            // kMaxBlocks x kSlots partial rows
  unsigned* ticket;              // 0 between launches
  const long long* zkey;         // [n, z] zone allocatable milli-CPU; null: no zones
  const long long* zcap;         // [n, z] floored to whole cores
  const unsigned char* has;      // bool [n]: a CR exists
  const unsigned char* zactive;  // bool [n]: Static CPU manager
  const unsigned char* act_naw;  // bool [n]: Static and single-NUMA
  long long* used;               // [n, z], folded in place
  const long long* pods;         // [K, 5 + z]: req, aware absent, aware true, table[z + 2]
  int n;
  int z;
  int want_ties;
};

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxBlocks = 1024;
constexpr int kSlots = 5;  // value, index, ties, feasible, bad
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kMin = LLONG_MIN;

__device__ __forceinline__ long long wadd(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

__device__ __forceinline__ long long wsub(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) -
                                static_cast<unsigned long long>(b));
}

// (maximum, lowest index holding it, masked rows equal to it)
struct Best {
  long long v, i, ties;
};

__device__ __forceinline__ Best merge(Best x, Best y) {
  if (x.v > y.v) return x;
  if (y.v > x.v) return y;
  return {x.v, x.i < y.i ? x.i : y.i, x.ties + y.ties};
}

__device__ __forceinline__ Best shfl_down(Best b, int d) {
  return {__shfl_down_sync(kFull, b.v, d), __shfl_down_sync(kFull, b.i, d),
          __shfl_down_sync(kFull, b.ties, d)};
}

// Block-wide merge; thread 0 ends with the block's result.
__device__ __forceinline__ void block_reduce(Best& b, long long& feas, long long& bad) {
  __shared__ Best s_best[kWarps];
  __shared__ long long s_feas[kWarps], s_bad[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    b = merge(b, shfl_down(b, d));
    feas += __shfl_down_sync(kFull, feas, d);
    bad += __shfl_down_sync(kFull, bad, d);
  }
  if (lane == 0) {
    s_best[warp] = b;
    s_feas[warp] = feas;
    s_bad[warp] = bad;
  }
  __syncthreads();
  if (warp == 0) {
    b = lane < kWarps ? s_best[lane] : Best{kMin, LLONG_MAX, 0};
    feas = lane < kWarps ? s_feas[lane] : 0;
    bad = lane < kWarps ? s_bad[lane] : 0;
#pragma unroll
    for (int d = kWarps / 2; d > 0; d >>= 1) {
      b = merge(b, shfl_down(b, d));
      feas += __shfl_down_sync(kFull, feas, d);
      bad += __shfl_down_sync(kFull, bad, d);
    }
  }
}

// The greedy pack of `req` over one node's z zones (rows of zkey, zcap,
// used): returns the number of zones that take a positive part; with
// `row`, writes max(take, 0) at each zone's CR index.
__device__ int pack(const long long* zk, const long long* zc, const long long* u, int z,
                    long long req, long long* row) {
  long long rem = req, last_key = 0;
  int last = -1, count = 0;
  for (int s = 0; s < z; ++s) {
    int o = -1;
    long long key = 0;
    for (int j = 0; j < z; ++j) {
      const long long kj = wsub(zk[j], u[j]);
      const bool unvisited = last < 0 || kj < last_key || (kj == last_key && j > last);
      if (unvisited && (o < 0 || kj > key)) {
        o = j;
        key = kj;
      }
    }
    const long long c = wsub(zc[o], u[o]);
    const long long take = (s == 0 || rem > 0) ? (rem < c ? rem : c) : 0;
    if (s + 1 < z) rem = wsub(rem, take);
    count += take > 0;
    if (row != nullptr) row[o] = take > 0 ? take : 0;
    last = o;
    last_key = key;
  }
  return count;
}

// The first zone of the pack order: the freest, first among equals.
__device__ int freest_zone(const long long* zk, const long long* u, int z) {
  int o = 0;
  long long key = wsub(zk[0], u[0]);
  for (int j = 1; j < z; ++j) {
    const long long kj = wsub(zk[j], u[j]);
    if (kj > key) {
      o = j;
      key = kj;
    }
  }
  return o;
}

template <bool kZones>
__global__ void __launch_bounds__(kBlock) drip_step(const DripArgs a, const int k) {
  const long long* vec = a.vecs + 4LL * k;
  const long long v0 = vec[0], v1 = vec[1], v2 = vec[2], v3 = vec[3];
  const int z = kZones ? a.z : 0;
  const long long* pod = kZones ? a.pods + static_cast<long long>(k) * (5 + z) : nullptr;
  const long long req = kZones ? pod[0] : 0;
  const bool on = req > 0;
  const bool aw_none = kZones && pod[1] > 0;
  const bool aw_true = kZones && pod[2] > 0;

  Best b{kMin, LLONG_MAX, 0};
  long long feas = 0, bad = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x; i < a.n;
       i += static_cast<long long>(gridDim.x) * kBlock) {
    bool m = a.sched[i] != 0;
    if (m && a.bounded[i]) {
      const long long* f = a.free + 4 * i;
      m = !((v0 > 0 && f[0] < v0) || (v1 > 0 && f[1] < v1) || (v2 > 0 && f[2] < v2) ||
            (v3 > 0 && f[3] < v3));
    }
    long long score = a.weighted[i];
    if (kZones) {
      const long long* zk = a.zkey + i * z;
      const long long* zc = a.zcap + i * z;
      const long long* u = a.used + i * z;
      const bool act_on = a.zactive[i] && on;
      const bool need_fit = aw_none ? a.act_naw[i] != 0 : act_on && aw_true;
      if (need_fit) {
        bool fits = false;
        for (int j = 0; j < z; ++j) fits |= wsub(zk[j], u[j]) >= req;
        m = m && fits;
      } else {
        m = m && (a.has[i] || !on);
      }
      const int idx = need_fit ? 1 : act_on ? pack(zk, zc, u, z, req, nullptr) : z + 1;
      score = wadd(score, pod[3 + idx]);
      bad += m && idx == 0;
    }
    b = merge(b, Best{m ? score : kMin, i, m});
    feas += m;
  }

  block_reduce(b, feas, bad);
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    long long* row = a.scratch + static_cast<long long>(blockIdx.x) * kSlots;
    row[0] = b.v;
    row[1] = b.i;
    row[2] = b.ties;
    row[3] = feas;
    row[4] = bad;
    __threadfence();
    s_last = atomicInc(a.ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: merge every block's partial row
  __threadfence();
  b = Best{kMin, LLONG_MAX, 0};
  feas = bad = 0;
  for (int g = threadIdx.x; g < static_cast<int>(gridDim.x); g += kBlock) {
    const volatile long long* row = a.scratch + static_cast<long long>(g) * kSlots;
    b = merge(b, Best{row[0], row[1], row[2]});
    feas += row[3];
    bad += row[4];
  }
  block_reduce(b, feas, bad);
  if (threadIdx.x != 0) return;

  const bool some = feas > 0;
  const long long best = b.i;
  long long* out = a.outs + static_cast<long long>(k) * (kZones ? 4 + z : 3);
  out[0] = some ? best : -1;
  out[1] = feas;
  out[2] = a.want_ties ? b.ties : 1;
  if (some && a.active[k]) {
    long long* f = a.free + 4 * best;
    f[0] = wsub(f[0], v0);
    f[1] = wsub(f[1], v1);
    f[2] = wsub(f[2], v2);
    f[3] = wsub(f[3], v3);
  }
  if (kZones) {
    out[3] = bad;
    long long* row = out + 4;
    for (int j = 0; j < z; ++j) row[j] = 0;
    if (some && a.zactive[best] && on) {
      const long long* zk = a.zkey + best * z;
      const long long* u = a.used + best * z;
      const bool need_fit = aw_none ? a.act_naw[best] != 0 : aw_true;
      if (need_fit)
        row[freest_zone(zk, u, z)] = req;
      else
        pack(zk, a.zcap + best * z, u, z, req, row);
      long long* ub = a.used + best * z;
      for (int j = 0; j < z; ++j) ub[j] = wadd(ub[j], row[j]);
    }
  }
}

}  // namespace

// Words of int64 scratch a window's launches need: one partial row per block.
extern "C" int crane_drip_scratch_words() { return kMaxBlocks * kSlots; }

// Launches steps 0..k-1 of one window on `stream`, in order. `a->zkey`
// null runs the plain window, else the window with z >= 1 zone columns.
// Returns the first launch error, or 0.
extern "C" int crane_drip_window(const DripArgs* a, int k, void* stream) {
  if (a->n <= 0 || k < 0 || (a->zkey != nullptr && a->z <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (static_cast<long long>(a->n) + kBlock - 1) / kBlock;
  const int grid = static_cast<int>(tiles < kMaxBlocks ? tiles : kMaxBlocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int step = 0; step < k; ++step) {
    if (a->zkey != nullptr)
      drip_step<true><<<grid, kBlock, 0, s>>>(*a, step);
    else
      drip_step<false><<<grid, kBlock, 0, s>>>(*a, step);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
