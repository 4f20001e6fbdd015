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
// candidates' usable flags and their d-float vectors, read once.  What
// holds the kernel is the rounds: up to R dependent steps a node, each a
// pass over the alive candidates.  A round that reads the candidates' rows
// from L2 waits on a dozen dependent round trips (a warp's ~n/8
// candidates, 512 bytes each), and each barrier a round adds to the chain.
// Design:
//  * one 256-thread block a node; it reads its row and flags and leaves at
//    once when the node is not repaired (at a 1 % delete rate about half
//    of all live nodes, and every empty slot of a block of consecutive
//    slots);
//  * it compacts the live candidate lanes IN COLUMN ORDER (ballot + popc a
//    warp; prune::compact): at 1 % deletes a row has ~0.64 deleted
//    neighbours, so ~100 of the 4,160 lanes survive -- the column order
//    keeps the lowest-column tie-break;
//  * then the staged rounds of prune_rounds_fp.cuh, as robust_prune_fp.cu
//    runs them: the survivors' rows go to shared memory once (16-byte
//    cp.async), each candidate belongs to one 8-lane group, the anchor
//    distances are that group's first pass (table[p]'s slice in
//    registers), and each round's cover pass folds in the next argmin: one
//    barrier a round;
//  * shared memory holds what the block needs: after the n compacted ids
//    come their keys, then as many rows as fit in a fixed arena; a list
//    longer than that (a node whose deleted neighbours bring many rows)
//    reads its other rows from L2 every round, the tiled path.  The arena
//    is half an SM (112 KB at R 64: ~220 rows of d 128 beside ~100 lanes),
//    so two blocks share an SM, and never below the lane state of the
//    widest list.  Smaller arenas, for three or four blocks an SM (the
//    registers allow four), measured slower on a random R-64 graph with
//    1 % deleted: its lists of ~140 candidates ran past the ~107 rows a
//    four-block arena holds.
#include "prune_common.cuh"
#include "prune_rounds_fp.cuh"

namespace {

using fpr::kGroups;
using fpr::kLanes;
using fpr::kThreads;
using fpr::kWarps;
static_assert(fpr::kThreads == prune::kThreads, "one block shape");
constexpr int kMaxDevices = 64;
constexpr int kBlocksPerSM = 2;
constexpr size_t kStaticReserve = 512;        // static shared memory

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// The resident rows of a list of n candidates in an arena of `arena`
// bytes that starts with their ids and keys (8 bytes each).
__device__ __forceinline__ int resident(int n, int arena, int row_bytes) {
  const long long fit =
      row_bytes > 0 ? (arena - (long long)align16((size_t)n * 8)) / row_bytes
                    : n;
  return fit < n ? (int)fit : n;
}

// J == 4: d <= 128 (table[p]'s and the winner's slices in registers);
// J == 0: any d.
template <int J>
__global__ void __launch_bounds__(kThreads)
    delete_repair_fp_kernel(const int32_t* __restrict__ adj,
                            const bool* __restrict__ deleted,
                            const bool* __restrict__ usable,
                            const float* __restrict__ table,
                            const int32_t* __restrict__ node_ids,
                            int32_t* __restrict__ out, int N, int R, int d,
                            float alpha, int s4, bool vec4, int arena) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* row_s = reinterpret_cast<int*>(smem);                  // [R]
  int* par_s = row_s + R;                                     // [R]
  uint8_t* del_s = reinterpret_cast<uint8_t*>(par_s + R);     // [R]
  unsigned char* lanes = smem + align16((size_t)R * 9);       // the arena
  int* sid = reinterpret_cast<int*>(lanes);                   // [n]
  __shared__ prune::Scratch scr;
  __shared__ float w_val[2][kWarps];
  __shared__ int w_col[2][kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, l8 = tid & (kLanes - 1), grp = tid / kLanes;
  const int p = node_ids[b];
  int32_t* out_row = out + (long long)b * R;
  if (p < 0 || p >= N) {
    for (int r = tid; r < R; r += kThreads) out_row[r] = -1;
    return;
  }
  int n_par;
  if (!prune::load_row(adj, deleted, usable, N, R, p, R, row_s, par_s, del_s,
                       &n_par, scr)) {
    for (int r = tid; r < R; r += kThreads) out_row[r] = row_s[r];
    return;
  }
  const int n = prune::compact(adj, deleted, usable, N, R, p, row_s, par_s,
                               n_par, sid, scr);

  // After the n ids: their keys, then the resident rows.
  float* key = reinterpret_cast<float*>(sid + n);
  float4* rows = reinterpret_cast<float4*>(lanes + align16((size_t)n * 8));
  const int n_res = resident(n, arena, s4 * 16);
  fpr::stage_rows<false>(rows, sid, key, table, n_res, s4, d, vec4);
  __syncthreads();
  const fpr::Rows src{rows, sid, table, n_res, s4, d, vec4};

  // Anchor distances, elementwise |table[p] - table[c]|^2, each by its
  // column's group, which keeps its least (key, column): the first winner.
  constexpr int JR = J > 0 ? J : 1;
  const float* prow = table + (long long)p * d;
  float4 vp[JR];
  if (J > 0) {
#pragma unroll
    for (int j = 0; j < JR; ++j) {
      const int k = l8 + kLanes * j;
      vp[j] = k < s4 ? fpr::global_chunk(prow, k, d, vec4)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  float bv = CUDART_INF_F;
  int bc = n;
  for (int c0 = 0; c0 < n; c0 += kGroups) {
    const int c = c0 + grp;
    const bool mine = c < n;
    float acc = 0.f;
    if (mine) {
      if (J > 0) {
        float4 x[JR];
        fpr::load_chunks<JR>(x, src, c, l8);
        acc = fpr::partial<JR>(vp, x, l8, s4);
      } else {
        for (int k = l8; k < s4; k += kLanes)
          acc = fpr::sq(fpr::global_chunk(prow, k, d, vec4), src.chunk(c, k),
                        acc);
      }
    }
    acc = fpr::group_sum(acc);
    if (mine) {
      const float kc = isfinite(acc) ? acc : CUDART_INF_F;
      if (l8 == 0) key[c] = kc;
      if (fpr::better(kc, c, bv, bc)) {
        bv = kc;
        bc = c;
      }
    }
  }
  fpr::block_best(bv, bc, w_val, w_col, 0);

  const int r = fpr::run_rounds<J>(src, key, n, R, alpha, bv, bc, out_row,
                                   w_val, w_col);
  for (int i = r + tid; i < R; i += kThreads) out_row[i] = -1;
}

template <int J>
int launch(const void* adj, const void* deleted, const void* usable,
           const void* table, const void* node_ids, void* out, int B, int N,
           int R, int d, float alpha, int s4, bool vec4, int dev,
           cudaStream_t stream) {
  static size_t opted[kMaxDevices];           // dynamic bytes allowed so far
  static int per_sm[kMaxDevices], optin[kMaxDevices], reserved[kMaxDevices];
  if (per_sm[dev] == 0) {
    cudaError_t e = cudaDeviceGetAttribute(
        &optin[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&reserved[dev],
                                 cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &per_sm[dev], cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (e != cudaSuccess) return (int)e;
  }
  // The arena: the SM's share for one of kBlocksPerSM blocks, less the
  // per-block reserve, the static bytes and the row scratch; never below
  // the lane state of the widest list (R + R^2 ids and keys).
  const size_t fixed = align16((size_t)R * 9);
  const size_t widest = align16((size_t)(R + R * R) * 8);
  const size_t share = (size_t)per_sm[dev] / kBlocksPerSM;
  const size_t cut = (size_t)reserved[dev] + kStaticReserve + fixed;
  const size_t fit = share > cut ? (share - cut) & ~size_t(15) : 0;
  const size_t arena = fit > widest ? fit : widest;
  if (fixed + arena > (size_t)optin[dev])
    return (int)cudaErrorInvalidValue;               // R too large
  const size_t smem = fixed + arena;
  if (smem > opted[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        delete_repair_fp_kernel<J>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(delete_repair_fp_kernel<J>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = smem;
  }
  delete_repair_fp_kernel<J><<<B, kThreads, smem, stream>>>(
      (const int32_t*)adj, (const bool*)deleted, (const bool*)usable,
      (const float*)table, (const int32_t*)node_ids, (int32_t*)out, N, R, d,
      alpha, s4, vec4, (int)arena);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int delete_repair_fp(const void* adj, const void* deleted,
                                const void* usable, const void* table,
                                const void* node_ids, void* out, int B, int N,
                                int R, int d, float alpha, void* stream) {
  if (B == 0) return 0;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const int s4 = (d + 3) / 4;
  const bool vec4 =
      d % 4 == 0 && (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (s4 <= 4 * kLanes)
    return launch<4>(adj, deleted, usable, table, node_ids, out, B, N, R, d,
                     alpha, s4, vec4, dev, st);
  return launch<0>(adj, deleted, usable, table, node_ids, out, B, N, R, d,
                   alpha, s4, vec4, dev, st);
}
