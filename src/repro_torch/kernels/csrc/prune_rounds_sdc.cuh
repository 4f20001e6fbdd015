// The RobustPrune rounds with symmetric distances from PQ codes (SDC),
// the cover read straight from the [m, ksub, ksub] tables: no slice of the
// tables is staged in shared memory.  Used by robust_prune_sdc.cu and
// delete_repair_sdc.cu.
//
// A candidate list of n columns (0..n-1, in the contract's column order)
// is held in shared memory as its anchor distances dp[c] and alive flags;
// a row source (TableRows, StagedRows) gives each column's emitted id and
// its m-byte code row.  The distance of a candidate c to the round's
// winner s is
//   sum_j T[j, code(s)_j, code(c)_j],  summed in j order,
// read with m independent loads from the tables (global memory, the
// read-only path): the bytes a round moves are the sectors the alive
// candidates' codes touch, not the winner's whole m x ksub slice (32 KB at
// m 32, ksub 256), and they fall as candidates retire.  The code rows are
// read from the code table (TableRows: L1 after the first pass) or from
// rows staged once in shared memory (StagedRows), so that a round's only
// trip to L2 is the table gathers.
//
// The rounds (block_rounds) are run by the whole block: column c belongs
// to thread c % blockDim.x for the whole run, alive[c] marks it, and the
// next winner is folded into the cover pass: one barrier a round.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "prune_common.cuh"

namespace sdcr {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 32;       // table loads in flight a candidate
constexpr int kMaxWarps = 32;

using prune::better;

// Column c's code row is cid[c]'s row of the code table (device memory),
// and its emitted id is cid[c].
struct TableRows {
  static constexpr bool kShared = false;
  const uint8_t* codes;
  const int* cid;
  int m;
  __device__ __forceinline__ int id(int c) const { return cid[c]; }
  __device__ __forceinline__ const uint8_t* row(int c) const {
    return codes + (long long)cid[c] * m;
  }
};

// Column c's code row is staged in shared memory at rows + c * m; its
// emitted id is sid[c] (which need not name that row).
struct StagedRows {
  static constexpr bool kShared = true;
  const uint8_t* rows;
  const int* sid;
  int m;
  __device__ __forceinline__ int id(int c) const { return sid[c]; }
  __device__ __forceinline__ const uint8_t* row(int c) const {
    return rows + c * m;
  }
};

// One 8-byte word or one byte of a code row, in shared memory (kShared) or
// device memory (the read-only path).
template <bool kShared>
__device__ __forceinline__ uint2 code_word(const uint8_t* p) {
  if constexpr (kShared) return *reinterpret_cast<const uint2*>(p);
  else return __ldg(reinterpret_cast<const uint2*>(p));
}

template <bool kShared>
__device__ __forceinline__ int code_byte(const uint8_t* p) {
  if constexpr (kShared) return *p;
  else return __ldg(p);
}

// sum_{j<m} T[j, a_j, c_j] of the code rows a and c (both in shared memory
// when kShared, else in device memory), in j order; kChunk loads are
// issued before the first add.  kVec: m % 8 == 0 and the code rows 8-byte
// aligned (they are read as 8-byte words).
template <bool kVec, bool kShared = false>
__device__ __forceinline__ float sdc_gather(const float* __restrict__ tables,
                                            const uint8_t* __restrict__ a,
                                            const uint8_t* __restrict__ c,
                                            int m, int ksub) {
  const int kk = ksub * ksub;
  float acc = 0.f;
  for (int j0 = 0; j0 < m; j0 += kChunk) {
    float v[kChunk];
    if (kVec) {
#pragma unroll
      for (int w = 0; w < kChunk / 8; ++w) {
        const int jw = j0 + 8 * w;
        if (jw < m) {
          const uint2 aw = code_word<kShared>(a + jw);
          const uint2 cw = code_word<kShared>(c + jw);
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const int ai = ((t < 4 ? aw.x : aw.y) >> (8 * (t & 3))) & 0xff;
            const int ci = ((t < 4 ? cw.x : cw.y) >> (8 * (t & 3))) & 0xff;
            v[8 * w + t] = __ldg(tables + (jw + t) * kk + ai * ksub + ci);
          }
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t) v[8 * w + t] = 0.f;
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const int j = j0 + t;
        v[t] = j < m ? __ldg(tables + j * kk +
                             code_byte<kShared>(a + j) * ksub +
                             code_byte<kShared>(c + j))
                     : 0.f;
      }
    }
#pragma unroll
    for (int t = 0; t < kChunk; ++t)
      if (j0 + t < m) acc += v[t];
  }
  return acc;
}

// The warp's least (value, column); every lane ends with it.
__device__ __forceinline__ void warp_best(float& bv, int& bc) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, o);
    const int oc = __shfl_xor_sync(kFull, bc, o);
    if (better(ov, oc, bv, bc)) {
      bv = ov;
      bc = oc;
    }
  }
}

// The block's least (value, column) from each thread's pair: one barrier,
// on the slot `parity` (alternated by the caller, so a slot is rewritten
// only after the next barrier, when every thread has read it).
__device__ __forceinline__ void block_best(float& bv, int& bc,
                                           float (*w_val)[kMaxWarps],
                                           int (*w_col)[kMaxWarps],
                                           int parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_best(bv, bc);
  if (lane == 0) {
    w_val[parity][warp] = bv;
    w_col[parity][warp] = bc;
  }
  __syncthreads();
  const int nw = blockDim.x >> 5;
  bv = w_val[parity][0];
  bc = w_col[parity][0];
  for (int w = 1; w < nw; ++w)
    if (better(w_val[parity][w], w_col[parity][w], bv, bc)) {
      bv = w_val[parity][w];
      bc = w_col[parity][w];
    }
}

// Up to R rounds of one list, run by the whole block over alive[c] (1
// while column c is alive), from the first winner (bv, bc), the least
// (dp, column) among the alive columns (bv = +inf when there is none),
// which the caller found with block_best on parity 0.  Each round emits
// the winner's id (rows.id) to out_row[r], scores every other alive column
// against it through their code rows (rows.row), retires what it
// alpha-covers and takes the least survivor as the next winner.  A round
// without a finite winner retires the row.  Returns the ids emitted.
// Every thread must call it.
template <bool kVec, class Rows>
__device__ __forceinline__ int block_rounds(
    const float* __restrict__ tables, const Rows& rows, int ksub,
    const float* dp, uint8_t* alive, int n, int R, float alpha, float bv,
    int bc, int32_t* __restrict__ out_row, float (*w_val)[kMaxWarps],
    int (*w_col)[kMaxWarps]) {
  const int m = rows.m;
  int r = 0;
  for (; r < R; ++r) {
    if (!(bv < CUDART_INF_F)) break;          // no winner: the row retires
    const int star = bc;
    if (threadIdx.x == 0) out_row[r] = rows.id(star);
    const uint8_t* a = rows.row(star);
    float nv = CUDART_INF_F;
    int nc = 0x7fffffff;
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      if (!alive[c]) continue;
      if (c == star) {
        alive[c] = 0;
        continue;
      }
      const float kc = dp[c];
      const float acc = sdc_gather<kVec, Rows::kShared>(tables, a, rows.row(c),
                                                        m, ksub);
      if (alpha * acc <= kc) {
        alive[c] = 0;
      } else if (better(kc, c, nv, nc)) {
        nv = kc;
        nc = c;
      }
    }
    block_best(nv, nc, w_val, w_col, (r + 1) & 1);
    bv = nv;
    bc = nc;
  }
  return r;
}

}  // namespace sdcr
