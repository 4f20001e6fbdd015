// robust_prune_fp: RobustPrune (Algorithm 3) rounds, full precision, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/robust_prune.py::robust_prune_fp_kernel
// (_fp_kernel, _prune_rounds, _fp_cover), which ran the R rounds over a
// [B, C] block as whole-tile vector ops padded to 128 lanes.
//
// Per node row b (contract: repro_torch.kernels.ref.robust_prune_fp_ref):
// exactly R rounds; each takes the alive candidate with the least anchor
// distance (lowest column on ties, as robust_prune.py:72-73), emits its id,
// and retires every candidate c with alpha * |v* - v_c|^2 <= d_p[c].  A
// round that finds no finite candidate retires the row: the remaining
// outputs are INVALID (-1).
//
// Bound: device-memory bytes while the candidate rows are read -- each
// round re-reads the still-alive candidates' vectors (the first round all
// C*d*4 bytes, then fewer as candidates retire; L2 holds a block's rows
// between rounds).  Design: one block per row; the anchor distances and
// the alive mask sit in shared memory, the argmin is a warp-shuffle
// reduction on (distance, column), the winner's vector is staged in shared
// memory, and each warp scores one alive candidate at a time with lanes
// striding along d (coalesced row reads) and a shuffle sum.  Dead
// candidates are skipped, so later rounds cost less.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float va, int ca, float vb, int cb) {
  return va < vb || (va == vb && ca < cb);
}

__global__ void robust_prune_fp_kernel(const float* __restrict__ d_p,
                                       const float* __restrict__ vecs,
                                       const int32_t* __restrict__ ids,
                                       const bool* __restrict__ ok,
                                       int32_t* __restrict__ out_ids,
                                       int32_t* __restrict__ counts, int C,
                                       int d, int R, float alpha) {
  extern __shared__ unsigned char smem[];
  float* dp = reinterpret_cast<float*>(smem);         // [C]
  float* vstar = dp + C;                              // [d]
  unsigned char* alive = reinterpret_cast<unsigned char*>(vstar + d);  // [C]
  __shared__ float w_val[kWarps];
  __shared__ int w_col[kWarps];
  __shared__ int s_star;
  __shared__ int s_ok;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long rc = (long long)b * C;
  const float* vb = vecs + rc * d;

  for (int c = tid; c < C; c += blockDim.x) {
    const bool o = ok[rc + c];
    const float v = o ? d_p[rc + c] : CUDART_INF_F;
    dp[c] = v;
    alive[c] = (o && isfinite(v)) ? 1 : 0;
  }
  __syncthreads();

  int count = 0;
  int r = 0;
  for (; r < R; ++r) {
    // Masked argmin, lowest column on ties.
    float bv = CUDART_INF_F;
    int bc = C;
    for (int c = tid; c < C; c += blockDim.x) {
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
      w_val[warp] = bv;
      w_col[warp] = bc;
    }
    __syncthreads();
    if (tid == 0) {
      float v = w_val[0];
      int c = w_col[0];
      for (int w = 1; w < kWarps; ++w)
        if (better(w_val[w], w_col[w], v, c)) {
          v = w_val[w];
          c = w_col[w];
        }
      s_ok = isfinite(v) ? 1 : 0;
      s_star = c;
    }
    __syncthreads();
    if (!s_ok) break;                       // no winner: the row retires
    const int star = s_star;
    if (tid == 0) out_ids[(long long)b * R + r] = ids[rc + star];
    ++count;
    for (int j = tid; j < d; j += blockDim.x)
      vstar[j] = vb[(long long)star * d + j];
    __syncthreads();

    // Retire what the winner alpha-covers (and the winner itself).
    for (int c = warp; c < C; c += kWarps) {
      if (!alive[c]) continue;
      const float* vc = vb + (long long)c * d;
      float acc = 0.f;
      for (int j = lane; j < d; j += 32) {
        const float df = vstar[j] - vc[j];
        acc += df * df;
      }
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0 && (c == star || alpha * acc <= dp[c])) alive[c] = 0;
    }
    __syncthreads();
  }
  for (int i = r + tid; i < R; i += blockDim.x)
    out_ids[(long long)b * R + i] = -1;
  if (tid == 0) counts[b] = count;
}

}  // namespace

extern "C" int robust_prune_fp(const void* d_p, const void* vecs,
                               const void* ids, const void* ok, void* out_ids,
                               void* counts, int B, int C, int d, int R,
                               float alpha, void* stream) {
  if (B == 0) return 0;
  const size_t smem = (size_t)C * 4 + (size_t)d * 4 + (size_t)C;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        robust_prune_fp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  robust_prune_fp_kernel<<<B, kThreads, smem,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      (const float*)d_p, (const float*)vecs, (const int32_t*)ids,
      (const bool*)ok, (int32_t*)out_ids, (int32_t*)counts, C, d, R, alpha);
  return (int)cudaGetLastError();
}
