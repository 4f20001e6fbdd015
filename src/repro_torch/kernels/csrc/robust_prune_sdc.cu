// robust_prune_sdc: RobustPrune (Algorithm 3) rounds with symmetric
// distances from PQ codes (SDC), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/robust_prune.py::robust_prune_sdc_kernel
// (_sdc_kernel, _prune_rounds, _sdc_cover), which took the candidates'
// codes pre-gathered as [B, C, m] int32 and extracted the winner's LUT
// rows with one-hot contractions.
//
// Per node row b (contract: repro_torch.kernels.ref.robust_prune_sdc_ref on
// the gathered codes codes[clamp(ids[b], 0, N-1)]): exactly R rounds; each
// takes the alive candidate (ok and a finite d_p) with the least anchor
// distance (lowest column on ties), emits its raw id ids[b, star], and
// retires every candidate c with
//   alpha * sum_j T[j, code(star)_j, code(c)_j] <= d_p[c]
// (the sum taken in j order).  A round that finds no finite candidate
// retires the row: the remaining outputs are INVALID (-1).
//
// Bound: device-memory bytes -- d_p, ids and ok once, the alive
// candidates' m-byte code rows once, the tables (8 MB at m 32, ksub 256,
// nearly every row of which a block of 256 node rows touches) and the
// outputs.  At the main path's shapes (B 226-298 rows, C 128 or 203) every
// row is resident at once, so the kernel's time is one row's chain of up
// to R rounds.  Design: one block of 256 threads a row;
//  * one pass loads d_p, ok and the ids, marks the alive candidates, stages
//    each alive candidate's code row once in shared memory as u8 (C 203 x
//    m 32 = 6.5 KB; an id < 0 or >= N reads the clamped row, as the plain
//    version's gather does) and folds the first argmin;
//  * the rounds are prune_rounds_sdc.cuh's block_rounds over the staged
//    rows (StagedRows): column c stays with thread c % 256, a cover is m
//    table gathers summed in j order, so a round's only trip to L2 is those
//    gathers (no slice of the tables is staged), and the next argmin is
//    folded into the cover pass: one block barrier a round.
// Shared memory: C * (9 + m) bytes, 8.3 KB at C 203.  Reading the code rows
// from the code table each round instead (a dependent trip for the code
// words before the table gathers) measured 7-8 % slower (PERF.md).
#include "prune_common.cuh"
#include "prune_rounds_sdc.cuh"

namespace {

// A block of prune::kThreads threads a row, three blocks an SM (at most 85
// registers a thread).
template <bool kVec>
__global__ void __launch_bounds__(prune::kThreads, 3)
    robust_prune_sdc_kernel(const float* __restrict__ d_p,
                            const uint8_t* __restrict__ codes,
                            const float* __restrict__ tables,
                            const int32_t* __restrict__ ids,
                            const bool* __restrict__ ok,
                            int32_t* __restrict__ out_ids,
                            int32_t* __restrict__ counts, int C, int N, int m,
                            int ksub, int R, float alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* sid = reinterpret_cast<int*>(smem);                    // [C]
  float* dp = reinterpret_cast<float*>(sid + C);              // [C]
  uint8_t* rows = reinterpret_cast<uint8_t*>(dp + C);         // [C * m]
  uint8_t* alive = rows + (size_t)C * m;                      // [C]
  __shared__ float w_val[2][sdcr::kMaxWarps];
  __shared__ int w_col[2][sdcr::kMaxWarps];

  const int b = blockIdx.x, tid = threadIdx.x;
  const long long rc = (long long)b * C;
  float bv = CUDART_INF_F;
  int bc = 0x7fffffff;
  for (int c = tid; c < C; c += blockDim.x) {
    const float v = d_p[rc + c];
    const int id = ids[rc + c];
    const bool live = ok[rc + c] && isfinite(v);
    sid[c] = id;
    dp[c] = v;
    alive[c] = live ? 1 : 0;
    if (!live) continue;
    const uint8_t* src = codes + (long long)min(max(id, 0), N - 1) * m;
    uint8_t* dst = rows + (size_t)c * m;
    if (kVec) {
      for (int w = 0; w < m; w += 8)
        *reinterpret_cast<uint2*>(dst + w) =
            __ldg(reinterpret_cast<const uint2*>(src + w));
    } else {
      for (int j = 0; j < m; ++j) dst[j] = __ldg(src + j);
    }
    if (sdcr::better(v, c, bv, bc)) {
      bv = v;
      bc = c;
    }
  }
  // Its barrier also makes every staged row visible to the whole block.
  sdcr::block_best(bv, bc, w_val, w_col, 0);
  const sdcr::StagedRows staged{rows, sid, m};
  int32_t* out_row = out_ids + (long long)b * R;
  const int r = sdcr::block_rounds<kVec>(tables, staged, ksub, dp, alive, C,
                                         R, alpha, bv, bc, out_row, w_val,
                                         w_col);
  for (int i = r + tid; i < R; i += blockDim.x) out_row[i] = -1;
  if (tid == 0) counts[b] = r;
}

template <bool kVec>
int launch(const float* d_p, const uint8_t* codes, const float* tables,
           const int32_t* ids, const bool* ok, int32_t* out_ids,
           int32_t* counts, int B, int C, int N, int m, int ksub, int R,
           float alpha, cudaStream_t stream) {
  const size_t smem = (size_t)C * (9 + m);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        robust_prune_sdc_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  robust_prune_sdc_kernel<kVec><<<B, prune::kThreads, smem, stream>>>(
      d_p, codes, tables, ids, ok, out_ids, counts, C, N, m, ksub, R, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int robust_prune_sdc(const void* d_p, const void* codes,
                                const void* tables, const void* ids,
                                const void* ok, void* out_ids, void* counts,
                                int B, int C, int N, int m, int ksub, int R,
                                float alpha, void* stream) {
  if (B == 0) return 0;
  // 8-byte words of the code rows: m % 8 == 0 and an 8-byte aligned table.
  const bool vec =
      m % 8 == 0 && (reinterpret_cast<uintptr_t>(codes) & 7) == 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* dp = (const float*)d_p;
  const auto* cd = (const uint8_t*)codes;
  const auto* t = (const float*)tables;
  const auto* id = (const int32_t*)ids;
  const auto* o = (const bool*)ok;
  auto* out = (int32_t*)out_ids;
  auto* cnt = (int32_t*)counts;
  return vec ? launch<true>(dp, cd, t, id, o, out, cnt, B, C, N, m, ksub, R,
                            alpha, st)
             : launch<false>(dp, cd, t, id, o, out, cnt, B, C, N, m, ksub, R,
                             alpha, st);
}
