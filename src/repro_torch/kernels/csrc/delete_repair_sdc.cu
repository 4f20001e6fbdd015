// delete_repair_sdc: Algorithm 4 (delete consolidation) for a block of
// nodes with symmetric distances from PQ codes (SDC) and a capped
// expansion, gathers fused in, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/delete_repair.py::delete_repair_sdc_kernel
// (_sdc_kernel, _assemble), which took pre-gathered operands: the node
// rows, the expansion rows of the first `cap` deleted neighbours, the
// candidates' anchor distances and their codes [B, C, m] int32 with
// C = R + cap*R (576 at R=64, cap=8).
//
// Per node p = node_ids[b] (contract: repro_torch.kernels.ref.
// delete_repair_sdc_ref on ref.repair_operands_sdc): a node that is not
// usable or has no deleted out-neighbour keeps its row.  Otherwise the
// candidates are its kept edges and the rows of its FIRST `cap` deleted
// neighbours in column order (what lax.top_k over the 0/1 indicator
// picks), each kept when usable and not p; the anchor distance is
// adc(codes[c], sdc_lut(tables, codes[p])) = sum_j T[j, code(p)_j,
// code(c)_j], summed in j order; then the R RobustPrune rounds with SDC
// cover (prune_rounds_sdc.cuh) give the new row.
//
// Bound: device-memory bytes -- the nodes' rows and their neighbours'
// deleted flags; for the repaired nodes the deleted neighbours' rows and
// the candidates' usable flags and m-byte codes, read once; the 8 MB
// tables stay in L2.  What holds the kernel is the L2 -> SM traffic of the
// cover: a round needs T[j, code(star)_j, code(c)_j] for every alive c, and
// the first form of this kernel staged the winner's whole m x ksub slice
// (32 KB) in shared memory for it, up to 2 MB a node, behind four block
// barriers a round.  Design:
//  * one block of 256 threads a node; it reads its row and flags and
//    leaves at once when the node is not repaired (about half of the live
//    nodes at 1 % deletes, and every empty slot of a block of consecutive
//    slots), then compacts the live candidate lanes IN COLUMN ORDER
//    (prune::load_row, prune::compact), which keeps the lowest-column
//    tie-break;
//  * the anchor distances and every round's cover are m loads from the
//    tables a candidate (prune_rounds_sdc.cuh): a round reads the sectors
//    the alive codes touch, fewer as candidates retire, and no 32 KB slice
//    sits in shared memory (~6 KB a block at C 576);
//  * column c stays with thread c % 256, which folds the next argmin into
//    its cover pass: one block barrier a round;
//  * three blocks an SM: the rounds are chains of dependent L2 reads, and
//    a build at two blocks an SM ran markedly slower, while register caps
//    for four to eight (smaller load chunks) ran no faster, and a carveout
//    hint for a larger L1 changed nothing measurable (PERF.md).
// A warp for the short lists (at most 128 candidates) beside a block for
// the long ones, in one launch, was measured against this form on the
// port's merged graph (PERF.md): as fast at a block of affected nodes,
// ~40 % slower at a block of consecutive slots, where a short list's
// rounds, a few candidates a lane, outlast a block's.
#include "prune_common.cuh"
#include "prune_rounds_sdc.cuh"

namespace {

// A block of prune::kThreads threads a node, three blocks an SM (at most
// 85 registers a thread).
template <bool kVec>
__global__ void __launch_bounds__(prune::kThreads, 3)
    delete_repair_sdc_block_kernel(
        const int32_t* __restrict__ adj, const bool* __restrict__ deleted,
        const bool* __restrict__ usable, const uint8_t* __restrict__ codes,
        const float* __restrict__ tables, const int32_t* __restrict__ node_ids,
        int32_t* __restrict__ out, int N, int R, int m, int ksub, int cap,
        float alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cmax = R + cap * R;
  int* row_s = reinterpret_cast<int*>(smem);                  // [R]
  int* par_s = row_s + R;                                     // [R]
  int* cid = par_s + R;                                       // [cmax]
  float* dp = reinterpret_cast<float*>(cid + cmax);           // [cmax]
  uint8_t* alive = reinterpret_cast<uint8_t*>(dp + cmax);     // [cmax]
  uint8_t* del_s = alive + cmax;                              // [R]
  __shared__ prune::Scratch scr;
  __shared__ float w_val[2][sdcr::kMaxWarps];
  __shared__ int w_col[2][sdcr::kMaxWarps];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int p = node_ids[b];
  int32_t* out_row = out + (long long)b * R;
  if (p < 0 || p >= N) {
    for (int r = tid; r < R; r += blockDim.x) out_row[r] = -1;
    return;
  }
  int n_par;
  if (!prune::load_row(adj, deleted, usable, N, R, p, cap, row_s, par_s,
                       del_s, &n_par, scr)) {
    for (int r = tid; r < R; r += blockDim.x) out_row[r] = row_s[r];
    return;
  }
  const int n = prune::compact(adj, deleted, usable, N, R, p, row_s, par_s,
                               n_par, cid, scr);
  const uint8_t* pc = codes + (long long)p * m;
  float bv = CUDART_INF_F;
  int bc = 0x7fffffff;
  for (int c = tid; c < n; c += blockDim.x) {
    const float v = sdcr::sdc_gather<kVec>(
        tables, pc, codes + (long long)cid[c] * m, m, ksub);
    const bool ok = isfinite(v);
    dp[c] = ok ? v : CUDART_INF_F;
    alive[c] = ok ? 1 : 0;
    if (ok && sdcr::better(v, c, bv, bc)) {
      bv = v;
      bc = c;
    }
  }
  sdcr::block_best(bv, bc, w_val, w_col, 0);
  const sdcr::TableRows rows{codes, cid, m};
  const int r = sdcr::block_rounds<kVec>(tables, rows, ksub, dp, alive, n, R,
                                         alpha, bv, bc, out_row, w_val, w_col);
  for (int i = r + tid; i < R; i += blockDim.x) out_row[i] = -1;
}

template <bool kVec>
int launch(const int32_t* adj, const bool* deleted, const bool* usable,
           const uint8_t* codes, const float* tables, const int32_t* node_ids,
           int32_t* out, int B, int N, int R, int m, int ksub, int cap,
           float alpha, cudaStream_t stream) {
  const int cmax = R + cap * R;
  const size_t smem = (size_t)R * 9 + (size_t)cmax * 9;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        delete_repair_sdc_block_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  delete_repair_sdc_block_kernel<kVec><<<B, prune::kThreads, smem, stream>>>(
      adj, deleted, usable, codes, tables, node_ids, out, N, R, m, ksub, cap,
      alpha);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int delete_repair_sdc(const void* adj, const void* deleted,
                                 const void* usable, const void* codes,
                                 const void* tables, const void* node_ids,
                                 void* out, int B, int N, int R, int m,
                                 int ksub, int cap, float alpha,
                                 void* stream) {
  if (B == 0) return 0;
  const bool vec =
      m % 8 == 0 && (reinterpret_cast<uintptr_t>(codes) & 7) == 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* a = (const int32_t*)adj;
  const auto* d = (const bool*)deleted;
  const auto* u = (const bool*)usable;
  const auto* c = (const uint8_t*)codes;
  const auto* t = (const float*)tables;
  const auto* ids = (const int32_t*)node_ids;
  auto* o = (int32_t*)out;
  return vec ? launch<true>(a, d, u, c, t, ids, o, B, N, R, m, ksub, cap,
                            alpha, st)
             : launch<false>(a, d, u, c, t, ids, o, B, N, R, m, ksub, cap,
                             alpha, st);
}
