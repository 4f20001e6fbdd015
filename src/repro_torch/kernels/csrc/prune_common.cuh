// Device helpers shared by the prune and delete-repair kernels: `better`,
// the (value, column) order of every prune round (robust_prune_fp.cu and
// delete_repair_fp.cu through prune_rounds_fp.cuh, robust_prune_sdc.cu and
// delete_repair_sdc.cu through prune_rounds_sdc.cuh), and Algorithm 4's
// row load and candidate compaction (delete_repair_fp.cu,
// delete_repair_sdc.cu), which all threads of a block of kThreads threads
// call.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace prune {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// a before b: the lesser value, the lower column among equal values.
__device__ __forceinline__ bool better(float va, int ca, float vb, int cb) {
  return va < vb || (va == vb && ca < cb);
}

// Scratch for load_row and compact (static shared memory).
struct Scratch {
  int w_cnt[kWarps];
  int ok;
};

// Algorithm 4's first step for node p: load its row into row_s[R], and
// list in par_s the columns of its deleted neighbours in column order, at
// most `cap` of them.  Returns whether the node is repaired at all (live,
// with at least one deleted neighbour, whatever the cap); the count of
// listed parents lands in *n_par.
__device__ __forceinline__ bool load_row(
    const int32_t* __restrict__ adj, const bool* __restrict__ deleted,
    const bool* __restrict__ usable, int N, int R, int p, int cap,
    int* row_s, int* par_s, uint8_t* del_s, int* n_par, Scratch& s) {
  const int tid = threadIdx.x;
  for (int r = tid; r < R; r += blockDim.x) {
    const int v = adj[(long long)p * R + r];
    row_s[r] = v;
    del_s[r] = (v >= 0 && v < N && deleted[v]) ? 1 : 0;
  }
  __syncthreads();
  if (tid == 0) {
    int np = 0;
    for (int r = 0; r < R; ++r)
      if (del_s[r] && np < cap) par_s[np++] = r;
    s.w_cnt[0] = np;
    s.ok = (np > 0 && usable[p]) ? 1 : 0;
  }
  __syncthreads();
  *n_par = s.w_cnt[0];
  const bool changed = s.ok != 0;
  __syncthreads();
  return changed;
}

// The candidate list of Algorithm 4 compacted in column order: the lanes
// are the kept edges (row entries that exist and are not deleted), then
// the rows of the listed deleted neighbours; a lane survives when its id is
// usable and not p.  Writes the ids to cid and returns their count.
// Keeping column order keeps the lowest-column tie-break of the rounds.
__device__ __forceinline__ int compact(const int32_t* __restrict__ adj,
                                       const bool* __restrict__ deleted,
                                       const bool* __restrict__ usable,
                                       int N, int R, int p, const int* row_s,
                                       const int* par_s, int n_par, int* cid,
                                       Scratch& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = R * (1 + n_par);
  int n = 0;
  for (int t0 = 0; t0 < T; t0 += blockDim.x) {
    const int t = t0 + tid;
    bool keep = false;
    int id = -1;
    if (t < T) {
      const int seg = t / R, k = t - seg * R;
      if (seg == 0) {
        id = row_s[k];
        keep = id >= 0 && id < N && !deleted[id];
      } else {
        id = adj[(long long)row_s[par_s[seg - 1]] * R + k];
        keep = id >= 0 && id < N;
      }
      keep = keep && usable[id] && id != p;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s.w_cnt[warp] = __popc(bal);
    __syncthreads();
    int off = n, total = n;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) off += s.w_cnt[w];
      total += s.w_cnt[w];
    }
    if (keep) cid[off + __popc(bal & ((1u << lane) - 1u))] = id;
    __syncthreads();
    n = total;
  }
  return n;
}

}  // namespace prune
