// block_topk: the stable smallest-k of each row with its ids, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/block_topk.py::block_topk_kernel
// (_topk_kernel), a Pallas kernel on the TPU: a grid over (row blocks,
// column blocks) whose column axis ran in order on one core, a running top-k
// per row carried in VMEM scratch from one column block to the next, merged
// with each new block by k rounds of (row minimum, first column attaining
// it, mask it out).  In the port it merges the per-shard search results of
// ``launch.ann_steps.make_distributed_search`` (the paper's cross-machine
// "aggregate results" step).
//
// Computes, for each row q of dists [Q, N]: the k smallest values in
// ascending order, the lowest column first among equal values (a stable
// sort on the value; -0.0 and +0.0 are equal), and out_i = ids[column] for
// a finite pick, -1 for a non-finite one (+inf or -inf).  k > N pads with
// (+inf, -1).  A row holding a NaN gives (NaN, -1) in every column, as the
// Pallas kernel does: its row minimum is NaN and no column compares equal
// to it.
//
// Bound: device-memory bytes -- Q*N*4 of values read once, N*4 of ids and
// Q*k*8 written, with about one comparison per value.  At the
// freshdiskann-1b merge (Q 1024 x N 2,560: 512 shards x k 5) that is
// 10.5 MB, 0.003 ms at 3.35 TB/s; at a few shards the launch dominates.
// A warp a row (1,024 warps, ~8 an SM) leaves little to hide latency, so
// the design keeps loads in flight and a lane's serial work short:
//  * lane l meets its columns in increasing order, in batches of kBatch
//    values loaded into registers before any is compared, the next batch's
//    loads issued before this batch's values are inserted: float4s
//    b0 + l + 32 u (columns 4i..4i+3) where N % 4 == 0, the rows are
//    16-byte aligned and fill every lane's first batch, else single values
//    b0 + l + 32 t;
//  * a bound from the first batch: the k-th least of the 32 lanes'
//    minima.  Then a value is a candidate only below the lane's k-th best
//    and at or below the bound (equal values may still win on their
//    column): one mask over the batch in registers, so most values cost a
//    compare; the batch is staged in the warp's shared slice and each lane
//    inserts only its candidates, found by their bits;
//  * each lane keeps its own k best as (value, column) pairs in ascending
//    order, for k <= 8 in registers (LaneBest: every index known at compile
//    time, a 0-byte stack frame); since a lane meets its columns in
//    increasing order, the strict comparisons keep the lowest column first
//    among ties;
//  * then k rounds of two warp reductions (redux.sync) over the lanes'
//    heads: the least value, -0.0 equal to +0.0, then the lowest column
//    among the heads of that value; the winning lane writes the pick and
//    pops it;
//  * a row of at most 32 values (a few shards' merge: N 15, N 20) skips
//    batches and lists: lane l holds column l and goes straight to the k
//    rounds.
// k 9-128, off every timed path, keeps its list in local memory.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kBatch = 16;          // values of a row a lane loads at once
constexpr int kRegMax = 8;          // lists up to this long stay in registers
constexpr unsigned kFull = 0xffffffffu;

// An order-preserving key of a value that is not a NaN, -0.0 and +0.0
// alike: a < b exactly when key(a) < key(b).  0xffffffff stands for an
// empty list.
__device__ __forceinline__ unsigned key(float x) {
  const unsigned u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}

__device__ __forceinline__ float unkey(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

// A lane's best (value, column) pairs in ascending order, at most k of
// them.  Up to kRegMax entries the list lives in registers, every index
// known at compile time: the k best sit at the END of the KMAX entries,
// behind KMAX - k entries of -inf that no value displaces, so the k-th best
// is always d[KMAX - 1], and an insertion is a predicated shift of the
// whole list; drain() then moves the k best to the front.  Longer lists
// (k 9-128) live in local memory and use runtime indices.  Empty entries
// hold (+inf, INT_MAX).
template <int KMAX>
struct LaneBest {
  static constexpr bool kRegs = KMAX <= kRegMax;
  float d[KMAX];
  int c[KMAX];
  int n = 0;                // entries held (local list)
  int head = 0;             // entries popped (local list)

  __device__ __forceinline__ explicit LaneBest(int k) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      d[j] = kRegs && j < KMAX - k ? -INFINITY : INFINITY;
      c[j] = INT_MAX;
    }
  }

  // The k-th best: a value enters only below it.
  __device__ __forceinline__ float kth(int k) const {
    if constexpr (kRegs) return d[KMAX - 1];
    else return d[k - 1];
  }

  // Value x < kth(k) of column col; a lane inserts its columns in
  // increasing order, so the strict comparisons keep the lowest column
  // first among equal values.
  __device__ __forceinline__ void insert(float x, int col, int k) {
    if constexpr (kRegs) {
#pragma unroll
      for (int j = KMAX - 1; j >= 0; --j) {
        if (j > 0 && x < d[j - 1]) {
          d[j] = d[j - 1];
          c[j] = c[j - 1];
        } else if (x < d[j]) {
          d[j] = x;
          c[j] = col;
        }
      }
    } else {
      int j = n < k ? n++ : k - 1;
      for (; j > 0 && x < d[j - 1]; --j) {
        d[j] = d[j - 1];
        c[j] = c[j - 1];
      }
      d[j] = x;
      c[j] = col;
    }
  }

  __device__ __forceinline__ float head_d() const {
    if constexpr (kRegs) return d[0];
    else return head < KMAX ? d[head] : INFINITY;
  }
  __device__ __forceinline__ int head_c() const {
    if constexpr (kRegs) return c[0];
    else return head < KMAX ? c[head] : INT_MAX;
  }

  __device__ __forceinline__ void pop() {
    if constexpr (kRegs) {
#pragma unroll
      for (int j = 0; j + 1 < KMAX; ++j) {
        d[j] = d[j + 1];
        c[j] = c[j + 1];
      }
      d[KMAX - 1] = INFINITY;
      c[KMAX - 1] = INT_MAX;
    } else {
      ++head;
    }
  }

  // Drop the -inf entries in front of the k best (a register list).
  __device__ __forceinline__ void drain(int k) {
    if constexpr (kRegs) {
#pragma unroll
      for (int s = 0; s < KMAX - 1; ++s)
        if (s < KMAX - k) pop();
    }
  }
};

// A lane's batch of a row in registers: value t (t < kBatch) of the batch
// from unit i0 (= the batch's first unit + lane) is column
// column(i0, t).  kVec: float4 units, the batch's kUnits float4s i0 + 32 u
// hold columns 4 (i0 + 32 u) + 0..3; else single values i0 + 32 t.  Either
// way a lane meets its columns in increasing order.
template <bool kVec>
struct Batch {
  static constexpr int kUnits = kVec ? kBatch / 4 : kBatch;
  static constexpr int kPer = kVec ? 4 : 1;     // values a unit
  float v[kBatch];

  __device__ __forceinline__ void load(const float* d, int units, int i0) {
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int i = i0 + 32 * u;
      if constexpr (kVec) {
        const float4 x = i < units
                             ? __ldg(reinterpret_cast<const float4*>(d) + i)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        v[4 * u] = x.x;
        v[4 * u + 1] = x.y;
        v[4 * u + 2] = x.z;
        v[4 * u + 3] = x.w;
      } else {
        v[u] = i < units ? __ldg(d + i) : 0.f;
      }
    }
  }

  // Stage the batch in the warp's shared slice: value t of lane l at
  // buf[t][l] (a candidate is read back by its runtime index t).
  __device__ __forceinline__ void stage(float (*buf)[32], int lane) const {
#pragma unroll
    for (int t = 0; t < kBatch; ++t) buf[t][lane] = v[t];
  }

  // Bit t set for each of the nv values below kth and at most bound (a
  // value equal to the bound may still win on its column); a NaN sets
  // *nan.
  __device__ __forceinline__ unsigned candidates(float kth, float bound,
                                                 int nv, bool* nan) const {
    unsigned m = 0;
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      if (t < nv) {
        if (v[t] < kth && v[t] <= bound) m |= 1u << t;
        if (v[t] != v[t]) *nan = true;
      }
    }
    return m;
  }

  // Values of the batch from unit i0 (units in the row), and their columns.
  __device__ __forceinline__ static int values(int units, int i0) {
    return kPer * max(0, min(kUnits, (units - i0 + 31) / 32));
  }
  __device__ __forceinline__ static int column(int i0, int t) {
    return kPer * (i0 + 32 * (t / kPer)) + t % kPer;
  }
};

// A bound on the row's k-th best from a lane's first batch: the k-th least
// of the 32 lanes' minima (+inf while fewer than k lanes hold a value).  k
// distinct columns hold values at or below it, so no value above it is
// among the row's k best.  k <= 8: k rounds of a warp min that retire one
// lane each.
template <class B>
__device__ __forceinline__ float kth_lane_min(const B& batch, int nv, int k) {
  float m = INFINITY;
#pragma unroll
  for (int t = 0; t < kBatch; ++t)
    if (t < nv) m = fminf(m, batch.v[t]);  // a NaN is flagged elsewhere
  unsigned mk = key(m), kk = 0xffffffffu;
  for (int r = 0; r < k; ++r) {
    kk = __reduce_min_sync(kFull, mk);
    const unsigned who = __ballot_sync(kFull, mk == kk);
    if ((threadIdx.x & 31) == __ffs(who) - 1) mk = 0xffffffffu;
  }
  return kk == 0xffffffffu ? INFINITY : unkey(kk);
}

// A lane's single value of a row of at most 32 (lane l holds column l):
// the list of LaneBest without the list.
struct OneBest {
  float d;
  int c;
  __device__ __forceinline__ float head_d() const { return d; }
  __device__ __forceinline__ int head_c() const { return c; }
  __device__ __forceinline__ void pop() {
    d = INFINITY;
    c = INT_MAX;
  }
};

// Write the row's k picks from the lanes' ascending lists: k rounds of the
// least head key over the lanes, then the lowest column among the heads of
// that value; its lane writes the pick (its own value, sign of a zero kept)
// and pops it.  Every lane calls it.
template <class L>
__device__ __forceinline__ void write_picks(L& best, const int32_t* ids,
                                            float* od, int32_t* oi, int k) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < k; ++r) {
    const int hc = best.head_c();
    const unsigned hk = hc == INT_MAX ? 0xffffffffu : key(best.head_d());
    const unsigned wk = __reduce_min_sync(kFull, hk);
    const unsigned wc =
        __reduce_min_sync(kFull, hk == wk ? (unsigned)hc : 0xffffffffu);
    if (wk == 0xffffffffu) {               // every list is empty
      if (lane == 0) {
        od[r] = INFINITY;
        oi[r] = -1;
      }
    } else if ((unsigned)hc == wc) {       // columns are unique to a lane
      const float hd = best.head_d();
      od[r] = hd;
      oi[r] = isfinite(hd) ? __ldg(ids + hc) : -1;
      best.pop();
    }
  }
}

// (NaN, -1) in every column of the row.
__device__ __forceinline__ void write_nan(float* od, int32_t* oi, int k) {
  for (int r = threadIdx.x & 31; r < k; r += 32) {
    od[r] = __int_as_float(0x7fc00000);    // quiet NaN
    oi[r] = -1;
  }
}

template <int KMAX, bool kVec>
__global__ void block_topk_kernel(const float* __restrict__ dists,
                                  const int32_t* __restrict__ ids,
                                  float* __restrict__ out_d,
                                  int32_t* __restrict__ out_i, int Q, int N,
                                  int k) {
  __shared__ float stage[kWarpsPerBlock][kBatch][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= Q) return;                    // warp-uniform
  const float* d = dists + (long long)row * N;
  float* od = out_d + (long long)row * k;
  int32_t* oi = out_i + (long long)row * k;
  float (*buf)[32] = stage[warp];

  if constexpr (!kVec) {
    if (N <= 32) {                         // a value a lane at most
      const float x = lane < N ? __ldg(d + lane) : INFINITY;
      if (__any_sync(kFull, x != x)) {
        write_nan(od, oi, k);
        return;
      }
      OneBest one{x, x < INFINITY ? lane : INT_MAX};
      write_picks(one, ids, od, oi, k);
      return;
    }
  }

  using B = Batch<kVec>;
  LaneBest<KMAX> best(k);
  bool nan = false;
  float bound = INFINITY;
  B batch;
  const int units = kVec ? N >> 2 : N;     // float4s or values of the row
  batch.load(d, units, lane);
  for (int b0 = 0; b0 < units; b0 += 32 * B::kUnits) {
    const int i0 = b0 + lane;
    const int nv = B::values(units, i0);
    if (LaneBest<KMAX>::kRegs && b0 == 0 && units > 32)
      bound = kth_lane_min(batch, nv, k);
    // The batch's candidates, then the next batch's loads, in flight while
    // the candidates are inserted.
    unsigned cand = batch.candidates(best.kth(k), bound, nv, &nan);
    batch.stage(buf, lane);
    __syncwarp();
    if (b0 + 32 * B::kUnits < units)
      batch.load(d, units, i0 + 32 * B::kUnits);
    while (cand) {
      const int t = __ffs(cand) - 1;
      cand &= cand - 1;
      const float x = buf[t][lane];
      if (x < best.kth(k)) best.insert(x, B::column(i0, t), k);
    }
    __syncwarp();
  }

  if (__any_sync(kFull, nan)) {
    write_nan(od, oi, k);
    return;
  }
  best.drain(k);
  write_picks(best, ids, od, oi, k);
}

template <int KMAX, bool kVec>
void run(const void* dists, const void* ids, void* out_d, void* out_i, int Q,
         int N, int k, cudaStream_t s) {
  const int blocks = (Q + kWarpsPerBlock - 1) / kWarpsPerBlock;
  block_topk_kernel<KMAX, kVec><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      (const float*)dists, (const int32_t*)ids, (float*)out_d,
      (int32_t*)out_i, Q, N, k);
}

template <int KMAX>
void launch(const void* dists, const void* ids, void* out_d, void* out_i,
            int Q, int N, int k, cudaStream_t s) {
  // float4 loads where every row starts 16-byte aligned and fills every
  // lane's first batch; a shorter row spreads its values over more lanes
  // one by one.
  if ((N & 3) == 0 && (reinterpret_cast<uintptr_t>(dists) & 15) == 0 &&
      N >= 32 * kBatch)
    run<KMAX, true>(dists, ids, out_d, out_i, Q, N, k, s);
  else
    run<KMAX, false>(dists, ids, out_d, out_i, Q, N, k, s);
}

}  // namespace

extern "C" int block_topk(const void* dists, const void* ids, void* out_d,
                          void* out_i, int Q, int N, int k, void* stream) {
  if (Q == 0) return 0;
  if (k < 1 || k > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (k <= kRegMax)
    launch<kRegMax>(dists, ids, out_d, out_i, Q, N, k, s);
  else
    launch<128>(dists, ids, out_d, out_i, Q, N, k, s);
  return (int)cudaGetLastError();
}
