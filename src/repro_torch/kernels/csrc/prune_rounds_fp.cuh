// The staged RobustPrune rounds, full precision, shared by robust_prune_fp.cu
// and delete_repair_fp.cu.  Every helper is called by all threads of a
// block of kThreads threads.
//
// The caller lays out, in shared memory: the candidates' ids sid[C] and
// keys key[C] (the anchor distance while the candidate is alive, +inf once
// it is not), and the rows of the first n_res candidates, ceil(d/4)
// float4s each (stage_rows).  Candidates past n_res are read from device
// memory (L2) whenever they are scored: the tiled path.  Each candidate c
// belongs to the 8-lane group c % kGroups for the whole kernel, so only
// that group writes key[c]; it scores the candidate with the winner's
// slice held in registers (d <= 128) and keeps the least surviving
// (key, column) while it retires what the winner covers, so the next
// round's argmin is folded into the cover pass: one barrier a round.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "prune_common.cuh"

namespace fpr {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;                     // lanes per candidate
constexpr int kGroups = kThreads / kLanes;    // candidates in flight
constexpr unsigned kFull = 0xffffffffu;

using prune::better;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Floats 4k..4k+3 of a row in device memory (zero past d).
__device__ __forceinline__ float4 global_chunk(const float* row, int k, int d,
                                               bool vec4) {
  if (vec4) return __ldg(reinterpret_cast<const float4*>(row) + k);
  const int j = 4 * k;
  return make_float4(j < d ? __ldg(row + j) : 0.f,
                     j + 1 < d ? __ldg(row + j + 1) : 0.f,
                     j + 2 < d ? __ldg(row + j + 2) : 0.f,
                     j + 3 < d ? __ldg(row + j + 3) : 0.f);
}

struct Rows {
  const float4* smem;       // [n_res][s4] resident rows
  const int* sid;           // [C] candidate ids
  const float* table;       // [N, d]
  int n_res, s4, d;
  bool vec4;

  __device__ __forceinline__ float4 chunk(int c, int k) const {
    if (c < n_res) return smem[c * s4 + k];
    return global_chunk(table + (long long)max(sid[c], 0) * d, k, d, vec4);
  }
};

__device__ __forceinline__ float sq(float4 a, float4 b, float acc) {
  const float x = a.x - b.x, y = a.y - b.y, z = a.z - b.z, w = a.w - b.w;
  return acc + x * x + y * y + z * z + w * w;
}

// Stage the rows of candidates [0, n_res) once, with 16-byte cp.async
// copies where the table allows (rows packed at s4 float4s, zeros past d);
// kAlive: only the rows of candidates whose key is finite.  The caller
// places a barrier before any thread reads another's rows.
template <bool kAlive>
__device__ __forceinline__ void stage_rows(float4* rows, const int* sid,
                                           const float* key,
                                           const float* __restrict__ table,
                                           int n_res, int s4, int d,
                                           bool vec4) {
  if (vec4) {
    for (int i = threadIdx.x; i < n_res * s4; i += kThreads) {
      const int c = i / s4;
      if (!kAlive || key[c] != CUDART_INF_F)
        cp_async16(rows + i, reinterpret_cast<const float4*>(
                                 table + (long long)max(sid[c], 0) * d) +
                                 (i - c * s4));
    }
    cp_async_wait_all();
  } else {
    float* rf = reinterpret_cast<float*>(rows);
    const int w = s4 * 4;
    for (int i = threadIdx.x; i < n_res * w; i += kThreads) {
      const int c = i / w, j = i - c * w;
      if (!kAlive || key[c] != CUDART_INF_F)
        rf[i] = j < d ? table[(long long)max(sid[c], 0) * d + j] : 0.f;
    }
  }
}

// A lane's J chunks l8 + 8 j of candidate c (zeros past d): plain
// shared-memory loads for a resident row, device memory otherwise.
template <int J>
__device__ __forceinline__ void load_chunks(float4 (&x)[J], const Rows& src,
                                            int c, int l8) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < src.n_res) {
    const float4* r = src.smem + c * src.s4;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = l8 + kLanes * j;
      x[j] = k < src.s4 ? r[k] : zero;
    }
  } else {
    const float* g = src.table + (long long)max(src.sid[c], 0) * src.d;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = l8 + kLanes * j;
      x[j] = k < src.s4 ? global_chunk(g, k, src.d, src.vec4) : zero;
    }
  }
}

// A lane's share of |a - b|^2 over its J chunks l8 + 8 j < s4, one sum per
// chunk and a tree over them (short dependency chains).
template <int J>
__device__ __forceinline__ float partial(const float4 (&a)[J],
                                         const float4 (&b)[J], int l8,
                                         int s4) {
  float p[J];
#pragma unroll
  for (int j = 0; j < J; ++j)
    p[j] = l8 + kLanes * j < s4 ? sq(a[j], b[j], 0.f) : 0.f;
#pragma unroll
  for (int h = 1; h < J; h <<= 1)
#pragma unroll
    for (int j = 0; j + h < J; j += 2 * h) p[j] += p[j + h];
  return p[0];
}

// The sum over a lane group (8 lanes); every lane of the warp calls it.
__device__ __forceinline__ float group_sum(float a) {
  for (int o = 1; o < kLanes; o <<= 1) a += __shfl_xor_sync(kFull, a, o);
  return a;
}

// The cover test of an alive candidate c (key kc, cover distance acc):
// retire it (the winner itself too) or keep it as the group's least
// survivor so far.  Only its owning group touches key[c].
__device__ __forceinline__ void settle(int c, float kc, float acc, int star,
                                       float alpha, float* key, float& nv,
                                       int& nc, int l8) {
  if (c == star || alpha * acc <= kc) {
    if (l8 == 0) key[c] = CUDART_INF_F;
  } else if (better(kc, c, nv, nc)) {
    nv = kc;
    nc = c;
  }
}

// The block's least (value, column) from each lane's group best; every
// lane of a group must hold the same pair.  One barrier, on the slot
// `parity` (alternated by the caller, so a slot is rewritten only after
// the next barrier, when every thread has read it).
__device__ __forceinline__ void block_best(float& bv, int& bc,
                                           float (*w_val)[kWarps],
                                           int (*w_col)[kWarps], int parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = kLanes; o < 32; o <<= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, o);
    const int oc = __shfl_xor_sync(kFull, bc, o);
    if (better(ov, oc, bv, bc)) {
      bv = ov;
      bc = oc;
    }
  }
  if (lane == 0) {
    w_val[parity][warp] = bv;
    w_col[parity][warp] = bc;
  }
  __syncthreads();
  bv = w_val[parity][0];
  bc = w_col[parity][0];
  for (int w = 1; w < kWarps; ++w)
    if (better(w_val[parity][w], w_col[parity][w], bv, bc)) {
      bv = w_val[parity][w];
      bc = w_col[parity][w];
    }
}

// Up to R rounds over C candidates from the first winner (bv, bc), which
// the caller found with block_best on parity 0: each round emits the
// winner's id to out_row[r] and retires what it alpha-covers; a round
// without a finite winner retires the row.  Returns the ids emitted.
// J == 4: d <= 128, the winner's slice (4 float4s a lane, zeros past s4)
// is held in registers; J == 0: any d, the slice is read again for each
// candidate.
template <int J>
__device__ __forceinline__ int run_rounds(const Rows& src, float* key, int C,
                                          int R, float alpha, float bv,
                                          int bc, int32_t* out_row,
                                          float (*w_val)[kWarps],
                                          int (*w_col)[kWarps]) {
  const int tid = threadIdx.x;
  const int l8 = tid & (kLanes - 1), grp = tid / kLanes;
  const int n_res = src.n_res, s4 = src.s4;
  int r = 0;
  for (; r < R; ++r) {
    if (!(bv < CUDART_INF_F)) break;          // no winner: the row retires
    const int star = bc;
    if (tid == 0) out_row[r] = src.sid[star];
    constexpr int JR = J > 0 ? J : 1;
    float4 vs[JR];
    if (J > 0) load_chunks<JR>(vs, src, star, l8);
    // Retire what the winner alpha-covers (and the winner itself), keeping
    // the least survivor of the group for the next round.  Resident rows
    // first: a group scores two candidates at once with straight-line
    // shared-memory reads (a dead or missing candidate's lanes read a
    // resident row and their sum is dropped).
    float nv = CUDART_INF_F;
    int nc = C;
    if (J > 0) {
      for (int c0 = 0; c0 < n_res; c0 += 2 * kGroups) {
        const int ca = c0 + grp, cb = ca + kGroups;
        const float ka = ca < n_res ? key[ca] : CUDART_INF_F;
        const float kb = cb < n_res ? key[cb] : CUDART_INF_F;
        const bool la = ka != CUDART_INF_F, lb = kb != CUDART_INF_F;
        if (!__any_sync(kFull, la || lb)) continue;
        const float4* ra = src.smem + min(ca, n_res - 1) * s4;
        const float4* rb = src.smem + min(cb, n_res - 1) * s4;
        float4 xa[JR], xb[JR];
#pragma unroll
        for (int j = 0; j < JR; ++j) {
          const int k = min(l8 + kLanes * j, s4 - 1);
          xa[j] = ra[k];
          xb[j] = rb[k];
        }
        const float aa = group_sum(partial<JR>(vs, xa, l8, s4));
        const float ab = group_sum(partial<JR>(vs, xb, l8, s4));
        if (la) settle(ca, ka, aa, star, alpha, key, nv, nc, l8);
        if (lb) settle(cb, kb, ab, star, alpha, key, nv, nc, l8);
      }
    }
    // The rest (the tiled path's rows in device memory; every row when
    // J == 0), one candidate a group.
    for (int c0 = J > 0 ? n_res / kGroups * kGroups : 0; c0 < C;
         c0 += kGroups) {
      const int c = c0 + grp;
      const bool mine = c < C && (J == 0 || c >= n_res);
      const float kc = mine ? key[c] : CUDART_INF_F;
      const bool live = kc != CUDART_INF_F;
      if (!__any_sync(kFull, live)) continue;
      float acc = 0.f;
      if (live) {
        if (J > 0) {
          float4 x[JR];
          load_chunks<JR>(x, src, c, l8);
          acc = partial<JR>(vs, x, l8, s4);
        } else {
          for (int k = l8; k < s4; k += kLanes)
            acc = sq(src.chunk(star, k), src.chunk(c, k), acc);
        }
      }
      acc = group_sum(acc);
      if (live) settle(c, kc, acc, star, alpha, key, nv, nc, l8);
    }
    bv = nv;
    bc = nc;
    block_best(bv, bc, w_val, w_col, (r + 1) & 1);
  }
  return r;
}

}  // namespace fpr
