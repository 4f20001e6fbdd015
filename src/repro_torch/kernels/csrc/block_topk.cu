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
// sort on the value), and out_i = ids[column] for a finite pick, -1 for a
// non-finite one (+inf or -inf).  k > N pads with (+inf, -1).  A row holding
// a NaN gives (NaN, -1) in every column, as the Pallas kernel does: its row
// minimum is NaN and no column compares equal to it.
//
// Bound: device-memory bytes -- Q*N*4 of values read once, N*4 of ids and
// Q*k*8 written, with about one comparison per value.  At the
// freshdiskann-1b merge (Q 1024 x N 2,560: 512 shards x k 5) that is
// 10.5 MB, 0.003 ms at 3.35 TB/s; at a few shards the launch dominates.
// Design: a warp per row.  Lane l scans columns l, l+32, ... (coalesced
// loads) and keeps its own k best as (value, column) pairs in ascending
// order; since a lane meets its columns in increasing order, a strict
// comparison on the value alone keeps the lowest column first among ties.
// Then k rounds of a warp-shuffle argmin over the lanes' heads, compared
// as (value, column) pairs; the winning lane advances its head, lane 0
// writes the pick and reads its id.  The lists live in thread-local arrays
// sized by a template bound on k (8, 32 or 128).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool before(float da, int ca, float db, int cb) {
  return da < db || (da == db && ca < cb);
}

template <int KMAX>
__global__ void block_topk_kernel(const float* __restrict__ dists,
                                  const int32_t* __restrict__ ids,
                                  float* __restrict__ out_d,
                                  int32_t* __restrict__ out_i, int Q, int N,
                                  int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= Q) return;                    // warp-uniform
  const float* d = dists + (long long)row * N;
  float* od = out_d + (long long)row * k;
  int32_t* oi = out_i + (long long)row * k;

  float bd[KMAX];
  int bc[KMAX];
  int cnt = 0;
  bool nan = false;
  for (int c = lane; c < N; c += 32) {
    const float x = __ldg(d + c);
    if (x != x) {
      nan = true;
      continue;
    }
    int j;
    if (cnt < k) {
      j = cnt++;
    } else if (x < bd[k - 1]) {
      j = k - 1;
    } else {
      continue;
    }
    while (j > 0 && bd[j - 1] > x) {
      bd[j] = bd[j - 1];
      bc[j] = bc[j - 1];
      --j;
    }
    bd[j] = x;
    bc[j] = c;
  }

  if (__any_sync(kFull, nan)) {
    for (int r = lane; r < k; r += 32) {
      od[r] = __int_as_float(0x7fc00000);  // quiet NaN
      oi[r] = -1;
    }
    return;
  }

  int head = 0;
  for (int r = 0; r < k; ++r) {
    const float hd = head < cnt ? bd[head] : INFINITY;
    const int hc = head < cnt ? bc[head] : INT_MAX;
    float wd = hd;
    int wc = hc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float xd = __shfl_xor_sync(kFull, wd, off);
      const int xc = __shfl_xor_sync(kFull, wc, off);
      if (before(xd, xc, wd, wc)) {
        wd = xd;
        wc = xc;
      }
    }
    if (head < cnt && wc == hc) ++head;    // columns are unique to a lane
    if (lane == 0) {
      od[r] = wd;                          // +inf once every list is empty
      oi[r] = (wc != INT_MAX && isfinite(wd)) ? __ldg(ids + wc) : -1;
    }
  }
}

template <int KMAX>
void launch(const void* dists, const void* ids, void* out_d, void* out_i,
            int Q, int N, int k, cudaStream_t s) {
  const int blocks = (Q + kWarpsPerBlock - 1) / kWarpsPerBlock;
  block_topk_kernel<KMAX><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      (const float*)dists, (const int32_t*)ids, (float*)out_d,
      (int32_t*)out_i, Q, N, k);
}

}  // namespace

extern "C" int block_topk(const void* dists, const void* ids, void* out_d,
                          void* out_i, int Q, int N, int k, void* stream) {
  if (Q == 0) return 0;
  if (k < 1 || k > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (k <= 8) {
    launch<8>(dists, ids, out_d, out_i, Q, N, k, s);
  } else if (k <= 32) {
    launch<32>(dists, ids, out_d, out_i, Q, N, k, s);
  } else {
    launch<128>(dists, ids, out_d, out_i, Q, N, k, s);
  }
  return (int)cudaGetLastError();
}
