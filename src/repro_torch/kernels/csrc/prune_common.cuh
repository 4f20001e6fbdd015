// Device helpers shared by the SDC prune and the delete-repair kernels
// (robust_prune_sdc.cu, delete_repair_fp.cu, delete_repair_sdc.cu).  Every
// helper is called by all threads of a block of kThreads threads.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace prune {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float va, int ca, float vb, int cb) {
  return va < vb || (va == vb && ca < cb);
}

// Scratch for block_argmin and compact (static shared memory).
struct Scratch {
  float w_val[kWarps];
  int w_col[kWarps];
  int w_cnt[kWarps];
  int star;
  int ok;
};

// The alive column with the least dp (lowest column on ties) among
// [0, n), or -1 when no alive column has a finite dp.  A warp-shuffle
// reduction on (distance, column), then one thread over the warps.
__device__ __forceinline__ int block_argmin(const float* dp,
                                            const uint8_t* alive, int n,
                                            Scratch& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float bv = CUDART_INF_F;
  int bc = n;
  for (int c = tid; c < n; c += blockDim.x) {
    const float v = alive[c] ? dp[c] : CUDART_INF_F;
    if (better(v, c, bv, bc)) {
      bv = v;
      bc = c;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
    if (better(ov, oc, bv, bc)) {
      bv = ov;
      bc = oc;
    }
  }
  if (lane == 0) {
    s.w_val[warp] = bv;
    s.w_col[warp] = bc;
  }
  __syncthreads();
  if (tid == 0) {
    float v = s.w_val[0];
    int c = s.w_col[0];
    for (int w = 1; w < kWarps; ++w)
      if (better(s.w_val[w], s.w_col[w], v, c)) {
        v = s.w_val[w];
        c = s.w_col[w];
      }
    s.star = isfinite(v) ? c : -1;
  }
  __syncthreads();
  return s.star;
}

// Stage the SDC LUT slice T[j, a_j, :] (j < m) of tables [m, ksub, ksub]
// into lut[j * ksub + k], with 16-byte loads where the layout allows.
__device__ __forceinline__ void stage_lut(const float* __restrict__ tables,
                                          const uint8_t* a, int m, int ksub,
                                          float* lut) {
  if ((ksub & 3) == 0 && (reinterpret_cast<uintptr_t>(tables) & 15) == 0) {
    const int q = ksub >> 2;
    for (int i = threadIdx.x; i < m * q; i += blockDim.x) {
      const int j = i / q, k4 = i - j * q;
      const float4* src = reinterpret_cast<const float4*>(
          tables + ((long long)j * ksub + a[j]) * ksub);
      reinterpret_cast<float4*>(lut + j * ksub)[k4] = src[k4];
    }
  } else {
    for (int i = threadIdx.x; i < m * ksub; i += blockDim.x) {
      const int j = i / ksub, k = i - j * ksub;
      lut[i] = tables[((long long)j * ksub + a[j]) * ksub + k];
    }
  }
}

// SDC distance of a code row to the staged slice: sum_j lut[j, row[j]],
// summed in j order.
__device__ __forceinline__ float sdc_sum(const float* lut,
                                         const uint8_t* row, int m,
                                         int ksub) {
  float acc = 0.f;
  for (int j = 0; j < m; ++j) acc += lut[j * ksub + row[j]];
  return acc;
}

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
