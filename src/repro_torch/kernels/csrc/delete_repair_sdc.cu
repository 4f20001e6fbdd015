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
// code(c)_j], computed here from the staged slice; then the R RobustPrune
// rounds with SDC cover (as robust_prune_sdc.cu) give the new row.
//
// Bound: device-memory bytes -- the nodes' rows and their neighbours'
// deleted flags; for the repaired nodes the deleted neighbours' rows and
// the candidates' usable flags and m-byte codes, read once, and one
// m x ksub LUT slice (32 KB) per round from the [m, ksub, ksub] tables,
// which stay in L2.  Design: one block per node; it leaves at once when
// the node is not repaired; otherwise it compacts the live candidate lanes
// into shared memory in column order, gathers their codes as u8, stages
// the anchor's LUT slice for the anchor distances and then each winner's
// slice for the cover, a thread per candidate with m shared-memory
// lookups summed in j order.
#include "prune_common.cuh"

namespace {

using prune::kThreads;

__global__ void delete_repair_sdc_kernel(
    const int32_t* __restrict__ adj, const bool* __restrict__ deleted,
    const bool* __restrict__ usable, const uint8_t* __restrict__ codes,
    const float* __restrict__ tables, const int32_t* __restrict__ node_ids,
    int32_t* __restrict__ out, int N, int R, int m, int ksub, int cap,
    float alpha, int cmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut = reinterpret_cast<float*>(smem);                // [m * ksub]
  float* dp = lut + m * ksub;                                 // [cmax]
  int* cid = reinterpret_cast<int*>(dp + cmax);               // [cmax]
  int* row_s = cid + cmax;                                    // [R]
  int* par_s = row_s + R;                                     // [R]
  uint8_t* cs = reinterpret_cast<uint8_t*>(par_s + R);        // [cmax * m]
  uint8_t* alive = cs + (size_t)cmax * m;                     // [cmax]
  uint8_t* del_s = alive + cmax;                              // [R]
  uint8_t* pcode = del_s + R;                                 // [m]
  __shared__ prune::Scratch scr;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
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
  for (int i = tid; i < n * m; i += blockDim.x) {
    const int c = i / m, j = i - c * m;
    cs[i] = codes[(long long)cid[c] * m + j];
  }
  for (int j = tid; j < m; j += blockDim.x)
    pcode[j] = codes[(long long)p * m + j];
  __syncthreads();
  prune::stage_lut(tables, pcode, m, ksub, lut);
  __syncthreads();
  for (int c = tid; c < n; c += blockDim.x) {
    const float v = prune::sdc_sum(lut, cs + (size_t)c * m, m, ksub);
    dp[c] = v;
    alive[c] = isfinite(v) ? 1 : 0;
  }
  __syncthreads();

  int r = 0;
  for (; r < R; ++r) {
    const int star = prune::block_argmin(dp, alive, n, scr);
    if (star < 0) break;                    // no winner: the row retires
    if (tid == 0) out_row[r] = cid[star];
    prune::stage_lut(tables, cs + (size_t)star * m, m, ksub, lut);
    __syncthreads();
    for (int c = tid; c < n; c += blockDim.x) {
      if (!alive[c]) continue;
      const float acc = prune::sdc_sum(lut, cs + (size_t)c * m, m, ksub);
      if (c == star || alpha * acc <= dp[c]) alive[c] = 0;
    }
    __syncthreads();
  }
  for (int i = r + tid; i < R; i += blockDim.x) out_row[i] = -1;
}

}  // namespace

extern "C" int delete_repair_sdc(const void* adj, const void* deleted,
                                 const void* usable, const void* codes,
                                 const void* tables, const void* node_ids,
                                 void* out, int B, int N, int R, int m,
                                 int ksub, int cap, float alpha,
                                 void* stream) {
  if (B == 0) return 0;
  const int cmax = R + cap * R;
  const size_t smem = (size_t)m * ksub * 4 + (size_t)cmax * (8 + m + 1) +
                      (size_t)R * 9 + (size_t)m;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        delete_repair_sdc_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  delete_repair_sdc_kernel<<<B, kThreads, smem,
                             reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int32_t*)adj, (const bool*)deleted, (const bool*)usable,
      (const uint8_t*)codes, (const float*)tables, (const int32_t*)node_ids,
      (int32_t*)out, N, R, m, ksub, cap, alpha, cmax);
  return (int)cudaGetLastError();
}
