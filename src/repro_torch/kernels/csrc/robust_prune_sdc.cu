// robust_prune_sdc: RobustPrune (Algorithm 3) rounds with symmetric
// distances from PQ codes (SDC), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/robust_prune.py::robust_prune_sdc_kernel
// (_sdc_kernel, _prune_rounds, _sdc_cover), which took the candidates'
// codes pre-gathered as [B, C, m] int32 and extracted the winner's LUT
// rows with one-hot contractions.
//
// Per node row b (contract: repro_torch.kernels.ref.robust_prune_sdc_ref on
// the gathered codes codes[ids[b]]): exactly R rounds; each takes the
// alive candidate with the least anchor distance (lowest column on ties),
// emits its id, and retires every candidate c with
//   alpha * sum_j T[j, code(star)_j, code(c)_j] <= d_p[c]
// (the sum taken in j order).  A round that finds no finite candidate
// retires the row: the remaining outputs are INVALID (-1).
//
// Bound: device-memory bytes -- d_p, ids and ok once, the alive
// candidates' m-byte code rows once, and per round the winner's LUT slice
// T[j, code(star)_j, :] (m * ksub * 4 = 32 KB at m=32, ksub=256; the
// 8 MB tables stay in L2 across rows and rounds).  Design: one block per
// row; the candidates' codes are gathered once into shared memory as u8
// (C=203 x m=32 = 6.5 KB), the anchor distances and the alive mask sit in
// shared memory, the argmin is a warp-shuffle reduction on (distance,
// column), the winner's LUT slice is staged in shared memory with 16-byte
// loads each round, and each thread scores its candidates with m
// shared-memory lookups.  Dead candidates are skipped.
#include "prune_common.cuh"

namespace {

using prune::kThreads;

__global__ void robust_prune_sdc_kernel(
    const float* __restrict__ d_p, const uint8_t* __restrict__ codes,
    const float* __restrict__ tables, const int32_t* __restrict__ ids,
    const bool* __restrict__ ok, int32_t* __restrict__ out_ids,
    int32_t* __restrict__ counts, int C, int N, int m, int ksub, int R,
    float alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut = reinterpret_cast<float*>(smem);                // [m * ksub]
  float* dp = lut + m * ksub;                                 // [C]
  uint8_t* cc = reinterpret_cast<uint8_t*>(dp + C);           // [C * m]
  uint8_t* alive = cc + (size_t)C * m;                        // [C]
  __shared__ prune::Scratch scr;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long rc = (long long)b * C;

  for (int c = tid; c < C; c += blockDim.x) {
    const bool o = ok[rc + c];
    const float v = o ? d_p[rc + c] : CUDART_INF_F;
    dp[c] = v;
    alive[c] = (o && isfinite(v)) ? 1 : 0;
  }
  __syncthreads();
  // Gather the alive candidates' code rows (one byte per subspace; an id
  // < 0 reads row 0, as the plain version's clamped gather does).
  for (int i = tid; i < C * m; i += blockDim.x) {
    const int c = i / m, j = i - c * m;
    if (alive[c]) {
      const int id = min(max(ids[rc + c], 0), N - 1);
      cc[i] = codes[(long long)id * m + j];
    }
  }
  __syncthreads();

  int r = 0;
  for (; r < R; ++r) {
    const int star = prune::block_argmin(dp, alive, C, scr);
    if (star < 0) break;                    // no winner: the row retires
    if (tid == 0) out_ids[(long long)b * R + r] = ids[rc + star];
    prune::stage_lut(tables, cc + (size_t)star * m, m, ksub, lut);
    __syncthreads();
    // Retire what the winner alpha-covers (and the winner itself).
    for (int c = tid; c < C; c += blockDim.x) {
      if (!alive[c]) continue;
      const float acc = prune::sdc_sum(lut, cc + (size_t)c * m, m, ksub);
      if (c == star || alpha * acc <= dp[c]) alive[c] = 0;
    }
    __syncthreads();
  }
  for (int i = r + tid; i < R; i += blockDim.x)
    out_ids[(long long)b * R + i] = -1;
  if (tid == 0) counts[b] = r;
}

}  // namespace

extern "C" int robust_prune_sdc(const void* d_p, const void* codes,
                                const void* tables, const void* ids,
                                const void* ok, void* out_ids, void* counts,
                                int B, int C, int N, int m, int ksub, int R,
                                float alpha, void* stream) {
  if (B == 0) return 0;
  const size_t smem = (size_t)m * ksub * 4 + (size_t)C * 4 +
                      (size_t)C * m + (size_t)C;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        robust_prune_sdc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  robust_prune_sdc_kernel<<<B, kThreads, smem,
                            reinterpret_cast<cudaStream_t>(stream)>>>(
      (const float*)d_p, (const uint8_t*)codes, (const float*)tables,
      (const int32_t*)ids, (const bool*)ok, (int32_t*)out_ids,
      (int32_t*)counts, C, N, m, ksub, R, alpha);
  return (int)cudaGetLastError();
}
