// robust_prune_fp: RobustPrune (Algorithm 3) rounds, full precision, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/robust_prune.py::robust_prune_fp_kernel
// (_fp_kernel, _prune_rounds, _fp_cover), which ran the R rounds over a
// [B, C] block of pre-gathered candidate vectors as whole-tile vector ops
// padded to 128 lanes.
//
// Per node row b (contract: repro_torch.kernels.ref.robust_prune_fp_ref on
// the candidates' vectors table[max(ids[b, c], 0)]): exactly R rounds; each
// takes the alive candidate with the least anchor distance (lowest column
// on ties, as robust_prune.py:72-73), emits its id, and retires every
// candidate c with alpha * |v* - v_c|^2 <= d_p[c].  A round that finds no
// finite candidate retires the row: the remaining outputs are INVALID (-1).
//
// Bound: device-memory bytes, each input read once -- d*4 bytes for each
// distinct table row an alive candidate (ok, finite d_p) names, plus d_p,
// ids and ok for all B*C and the outputs.  At chip_smoke.py's B 256 x C 203
// x d 128 about three quarters of the B*C candidates need a row: ~20 MB,
// 0.0061 ms at 3.35 TB/s (every row counted, 26.6 MB and 0.0081 ms).  The
// rounds themselves are R dependent steps, so the design keeps each step
// short and off device memory:
//  * the kernel gathers its own rows from table [N, d] and ids [B, C] (no
//    [B, C, d] copy is built for it);
//  * one 256-thread block per row stages the alive candidates' rows in
//    shared memory once, with 16-byte cp.async copies (104 KB at C 203,
//    d 128; the block opts in to up to 227 KB and the largest carveout, so
//    two blocks share an SM).  Rows are packed at ceil(d/4) float4s: each
//    candidate is read by 8 consecutive lanes (a quarter-warp phase of a
//    16-byte load) on 128 consecutive bytes, so the reads are free of bank
//    conflicts without padding;
//  * the cover pass reads shared memory only: 8 lanes a candidate, two
//    candidates a lane group, 8 a warp and 64 a block in flight, the
//    winner's slice held in registers (d <= 128) and a 3-step shuffle sum;
//  * each candidate belongs to one lane group for the whole kernel, so its
//    alive flag (its key set to +inf) needs no barrier; the group keeps the
//    least surviving (key, column) while it retires candidates, so the next
//    round's argmin is folded into the cover pass: a warp shuffle, one
//    __syncthreads on a double-buffered per-warp slot, and every thread
//    reads the winner.  One barrier per round;
//  * a C whose rows do not all fit takes the tiled path of the same kernel:
//    the first n_res candidates are resident, the rest are read from device
//    memory (L2) in every round's cover pass.
// The staging and the rounds are prune_rounds_fp.cuh's, shared with
// delete_repair_fp.cu.
// On the card the rounds, not the bytes, set the time: every round re-reads
// the alive rows from shared memory and waits on its barrier, and the
// slowest row of the grid (up to R rounds) ends the kernel.  PERF.md §6 has
// the measurements, with the variants that ran slower.
#include "prune_rounds_fp.cuh"

namespace {

using fpr::kGroups;
using fpr::kLanes;
using fpr::kThreads;
using fpr::kWarps;
constexpr int kMaxDevices = 64;
constexpr size_t kStaticReserve = 1024;       // static shared memory

template <int J>
__global__ void __launch_bounds__(kThreads)
    robust_prune_fp_kernel(const float* __restrict__ d_p,
                           const float* __restrict__ table,
                           const int32_t* __restrict__ ids,
                           const bool* __restrict__ ok,
                           int32_t* __restrict__ out_ids,
                           int32_t* __restrict__ counts, int C, int d, int R,
                           float alpha, int n_res, int s4, bool vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* rows = reinterpret_cast<float4*>(smem);                  // [n_res*s4]
  float* key = reinterpret_cast<float*>(rows + (size_t)n_res * s4);  // [C]
  int* sid = reinterpret_cast<int*>(key + C);                        // [C]
  __shared__ float w_val[2][kWarps];
  __shared__ int w_col[2][kWarps];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int grp = tid / kLanes;
  const long long rc = (long long)b * C;
  int32_t* out_row = out_ids + (long long)b * R;

  // Anchor distances and ids; a candidate is alive while its key is finite.
  for (int c = tid; c < C; c += kThreads) {
    const float v = d_p[rc + c];
    key[c] = (ok[rc + c] && isfinite(v)) ? v : CUDART_INF_F;
    sid[c] = ids[rc + c];
  }
  __syncthreads();

  // Stage the alive resident rows, once.
  fpr::stage_rows<true>(rows, sid, key, table, n_res, s4, d, vec4);
  const fpr::Rows src{rows, sid, table, n_res, s4, d, vec4};

  // The first winner: each group scans the columns it owns.
  float bv = CUDART_INF_F;
  int bc = C;
  for (int c = grp; c < C; c += kGroups)
    if (fpr::better(key[c], c, bv, bc)) {
      bv = key[c];
      bc = c;
    }
  fpr::block_best(bv, bc, w_val, w_col, 0);  // also publishes the staging

  const int r = fpr::run_rounds<J>(src, key, C, R, alpha, bv, bc, out_row,
                                   w_val, w_col);
  for (int i = r + tid; i < R; i += kThreads) out_row[i] = -1;
  if (tid == 0) counts[b] = r;
}

template <int J>
int launch(const void* d_p, const void* table, const void* ids,
           const void* ok, void* out_ids, void* counts, int B, int C, int d,
           int R, float alpha, int n_res, int s4, bool vec4, size_t smem,
           int dev, cudaStream_t stream) {
  static size_t opted[kMaxDevices];           // dynamic bytes allowed so far
  if (smem > opted[dev]) {
    // Opt in to the bytes, and ask for the largest shared-memory carveout
    // so that two 105 KB blocks share an SM (the CUDA driver may otherwise
    // size the carveout for one).
    cudaError_t e = cudaFuncSetAttribute(
        robust_prune_fp_kernel<J>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(robust_prune_fp_kernel<J>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = smem;
  }
  robust_prune_fp_kernel<J><<<B, kThreads, smem, stream>>>(
      (const float*)d_p, (const float*)table, (const int32_t*)ids,
      (const bool*)ok, (int32_t*)out_ids, (int32_t*)counts, C, d, R, alpha,
      n_res, s4, vec4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int robust_prune_fp(const void* d_p, const void* table,
                               const void* ids, const void* ok, void* out_ids,
                               void* counts, int B, int C, int d, int R,
                               float alpha, void* stream) {
  if (B == 0) return 0;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static int optin[kMaxDevices];              // per-block limit, bytes
  if (optin[dev] == 0) {
    e = cudaDeviceGetAttribute(&optin[dev],
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int s4 = (d + 3) / 4;
  const size_t row = (size_t)s4 * 16, fixed = (size_t)C * 8;
  const size_t avail = (size_t)optin[dev] - kStaticReserve;
  if (fixed > avail) return (int)cudaErrorInvalidValue;  // C too large
  const size_t fit = row ? (avail - fixed) / row : (size_t)C;
  const int n_res = (int)(fit < (size_t)C ? fit : (size_t)C);
  const size_t smem = (size_t)n_res * row + fixed;
  const bool vec4 =
      d % 4 == 0 && (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (s4 <= 4 * kLanes)
    return launch<4>(d_p, table, ids, ok, out_ids, counts, B, C, d, R, alpha,
                     n_res, s4, vec4, smem, dev, st);
  return launch<0>(d_p, table, ids, ok, out_ids, counts, B, C, d, R, alpha,
                   n_res, s4, vec4, smem, dev, st);
}
