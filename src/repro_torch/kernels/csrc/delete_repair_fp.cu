// delete_repair_fp: Algorithm 4 (delete consolidation) for a block of
// nodes, full precision, with the gathers fused in, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/delete_repair.py::delete_repair_fp_kernel
// (_fp_kernel, _assemble), which took pre-gathered operands: the node
// rows, the expansion rows [B, R*R], and the candidates' anchor distances
// and vectors in raw concat(row, exp) order -- vecs [B, C, d] with
// C = R + R*R, 2.18 GB for a block of 1024 nodes at R=64, d=128.
//
// Per node p = node_ids[b] (contract: repro_torch.kernels.ref.
// delete_repair_fp_ref on ref.repair_operands_fp): a node that is not
// usable or has no deleted out-neighbour keeps its row.  Otherwise the
// candidates are its kept edges (target exists and is not deleted) and the
// rows of its deleted neighbours, each kept when usable and not p; the
// anchor distances are |table[p] - table[c]|^2 in the elementwise form;
// then the R RobustPrune rounds of robust_prune_fp.cu (lowest column on
// ties, a round without a finite winner retires the row, -1 past the
// count) give the new row.
//
// Bound: device-memory bytes -- the nodes' rows and their neighbours'
// deleted flags; for the repaired nodes the deleted neighbours' rows, the
// candidates' usable flags and their d-float vectors, read once (L2 holds
// them across the rounds).  Design: one block per node.  The block reads
// its row and flags, and leaves at once when the node is not repaired (at
// a 1 % delete rate about half of all nodes).  Otherwise it compacts the
// live candidate lanes into shared memory IN COLUMN ORDER (ballot + popc
// per warp): at 1 % deletes a row has ~0.64 deleted neighbours, so ~100
// of the 4,160 lanes survive, and the rounds walk only those -- the
// column order keeps the lowest-column tie-break.  Anchor distances and
// each round's cover are a warp per candidate with lanes along d and a
// shuffle sum; the winner's vector is staged in shared memory.
#include "prune_common.cuh"

namespace {

using prune::kThreads;
using prune::kWarps;

__global__ void delete_repair_fp_kernel(const int32_t* __restrict__ adj,
                                        const bool* __restrict__ deleted,
                                        const bool* __restrict__ usable,
                                        const float* __restrict__ table,
                                        const int32_t* __restrict__ node_ids,
                                        int32_t* __restrict__ out, int N,
                                        int R, int d, float alpha, int cmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* vbuf = reinterpret_cast<float*>(smem);               // [d]
  float* dp = vbuf + d;                                       // [cmax]
  int* cid = reinterpret_cast<int*>(dp + cmax);               // [cmax]
  int* row_s = cid + cmax;                                    // [R]
  int* par_s = row_s + R;                                     // [R]
  uint8_t* alive = reinterpret_cast<uint8_t*>(par_s + R);     // [cmax]
  uint8_t* del_s = alive + cmax;                              // [R]
  __shared__ prune::Scratch scr;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = node_ids[b];
  int32_t* out_row = out + (long long)b * R;
  if (p < 0 || p >= N) {
    for (int r = tid; r < R; r += blockDim.x) out_row[r] = -1;
    return;
  }
  int n_par;
  if (!prune::load_row(adj, deleted, usable, N, R, p, R, row_s, par_s, del_s,
                       &n_par, scr)) {
    for (int r = tid; r < R; r += blockDim.x) out_row[r] = row_s[r];
    return;
  }
  const int n = prune::compact(adj, deleted, usable, N, R, p, row_s, par_s,
                               n_par, cid, scr);

  // Anchor distances, elementwise |table[p] - table[c]|^2.
  for (int j = tid; j < d; j += blockDim.x)
    vbuf[j] = table[(long long)p * d + j];
  __syncthreads();
  for (int c = warp; c < n; c += kWarps) {
    const float* vc = table + (long long)cid[c] * d;
    float acc = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float df = vbuf[j] - vc[j];
      acc += df * df;
    }
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      dp[c] = acc;
      alive[c] = isfinite(acc) ? 1 : 0;
    }
  }
  __syncthreads();

  int r = 0;
  for (; r < R; ++r) {
    const int star = prune::block_argmin(dp, alive, n, scr);
    if (star < 0) break;                    // no winner: the row retires
    if (tid == 0) out_row[r] = cid[star];
    const float* vs = table + (long long)cid[star] * d;
    for (int j = tid; j < d; j += blockDim.x) vbuf[j] = vs[j];
    __syncthreads();
    // Retire what the winner alpha-covers (and the winner itself).
    for (int c = warp; c < n; c += kWarps) {
      if (!alive[c]) continue;
      const float* vc = table + (long long)cid[c] * d;
      float acc = 0.f;
      for (int j = lane; j < d; j += 32) {
        const float df = vbuf[j] - vc[j];
        acc += df * df;
      }
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0 && (c == star || alpha * acc <= dp[c])) alive[c] = 0;
    }
    __syncthreads();
  }
  for (int i = r + tid; i < R; i += blockDim.x) out_row[i] = -1;
}

}  // namespace

extern "C" int delete_repair_fp(const void* adj, const void* deleted,
                                const void* usable, const void* table,
                                const void* node_ids, void* out, int B, int N,
                                int R, int d, float alpha, void* stream) {
  if (B == 0) return 0;
  const int cmax = R + R * R;
  const size_t smem = (size_t)d * 4 + (size_t)cmax * 9 + (size_t)R * 9;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        delete_repair_fp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  delete_repair_fp_kernel<<<B, kThreads, smem,
                            reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int32_t*)adj, (const bool*)deleted, (const bool*)usable,
      (const float*)table, (const int32_t*)node_ids, (int32_t*)out, N, R, d,
      alpha, cmax);
  return (int)cudaGetLastError();
}
