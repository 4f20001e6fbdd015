// frontier_select: one fused beam-search round step, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/frontier_select.py::frontier_select_kernel
// (_frontier_kernel).  The TPU kernel ran L rounds of (min, first column,
// mask) over 128-lane padded rows; here each query row gets one block and a
// real sort.
//
// Per row b (contract: repro_torch.kernels.ref.frontier_select_batch_ref):
//   1. stable top-L merge of the L candidates and K fresh neighbours: the
//      L+K (distance, position) pairs are bitonic-sorted in shared memory on
//      the key (distance, position) -- unique positions make that order the
//      stable order;
//   2. open mask: merged entry has id >= 0, finite distance, and is not in
//      the visited set (<= V ids, held in shared memory);
//   3. frontier: the first min(W, max_visits - vis_cnt) open entries,
//      ranked by a warp scan over the open flags;
//   4. the frontier is appended to the visited arrays at vis_cnt...
// The kernel does no arithmetic on distances, only compares and moves them,
// so it is bit-identical to its plain version.  Inputs are unpadded.
//
// Bound: latency of one small block per row -- the bytes (about
// (2(L+K) + 4V) * 4 per row) are tiny; the sort's log^2 passes of
// __syncthreads dominate.  Design: one block per row so rows never wait for
// each other, everything in shared memory, one read and one write of each
// operand in device memory.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool key_less(float da, int pa, float db, int pb) {
  return da < db || (da == db && pa < pb);
}

__global__ void frontier_select_kernel(
    const int32_t* __restrict__ cand_ids, const float* __restrict__ cand_d,
    const int32_t* __restrict__ new_ids, const float* __restrict__ new_d,
    const int32_t* __restrict__ vis_ids, const float* __restrict__ vis_d,
    const int32_t* __restrict__ vis_cnt, int32_t* __restrict__ m_ids_out,
    float* __restrict__ m_d_out, int32_t* __restrict__ f_ids_out,
    float* __restrict__ f_d_out, int32_t* __restrict__ ov_ids,
    float* __restrict__ ov_d, int32_t* __restrict__ ov_cnt, int L, int K,
    int V, int P, int W, int max_visits) {
  extern __shared__ unsigned char smem[];
  float* key = reinterpret_cast<float*>(smem);            // [P]
  int* pos = reinterpret_cast<int*>(key + P);             // [P]
  int* vis = pos + P;                                     // [V]
  int* mid = vis + V;                                     // [L] merged ids
  int* rank = mid + L;                                    // [L] open rank/-1
  int* fid = rank + L;                                    // [W]
  float* fd = reinterpret_cast<float*>(fid + W);          // [W]
  __shared__ int s_total;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int M = L + K;
  const long long rl = (long long)b * L, rk = (long long)b * K,
                  rv = (long long)b * V, rw = (long long)b * W;

  for (int i = tid; i < P; i += blockDim.x) {
    float d;
    if (i < L) d = cand_d[rl + i];
    else if (i < M) d = new_d[rk + (i - L)];
    else d = CUDART_INF_F;
    key[i] = d;
    pos[i] = i;
  }
  for (int i = tid; i < V; i += blockDim.x) vis[i] = vis_ids[rv + i];
  for (int i = tid; i < W; i += blockDim.x) {
    fid[i] = -1;
    fd[i] = CUDART_INF_F;
  }
  __syncthreads();

  // 1. bitonic sort of (key, pos) ascending.
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = (i & k) == 0;
          const bool gt = key_less(key[ixj], pos[ixj], key[i], pos[i]);
          if (gt == up) {
            const float tk = key[i];
            key[i] = key[ixj];
            key[ixj] = tk;
            const int tp = pos[i];
            pos[i] = pos[ixj];
            pos[ixj] = tp;
          }
        }
      }
      __syncthreads();
    }
  }

  // 2. merged list + open mask.
  for (int i = tid; i < L; i += blockDim.x) {
    const float d = key[i];
    const int p = pos[i];
    int id = p < L ? cand_ids[rl + p] : new_ids[rk + (p - L)];
    const bool fin = isfinite(d);
    if (!fin) id = -1;
    mid[i] = id;
    m_ids_out[rl + i] = id;
    m_d_out[rl + i] = d;
    bool open = fin && id >= 0;
    for (int v = 0; open && v < V; ++v) open = vis[v] != id;
    rank[i] = open ? 1 : 0;
  }
  __syncthreads();

  // 3. warp 0 ranks the open entries (inclusive scan, carried over chunks).
  const int cnt0 = vis_cnt[b];
  const int allowed = min(W, max_visits - cnt0);
  if (tid < 32) {
    int carry = 0;
    for (int base = 0; base < L; base += 32) {
      const int i = base + tid;
      const int flag = i < L ? rank[i] : 0;
      int x = flag;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (tid >= o) x += y;
      }
      if (i < L) rank[i] = flag ? carry + x - 1 : -1;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (tid == 0) s_total = carry;
  }
  __syncthreads();
  for (int i = tid; i < L; i += blockDim.x) {
    const int r = rank[i];
    if (r >= 0 && r < allowed) {
      fid[r] = mid[i];
      fd[r] = key[i];
    }
  }
  __syncthreads();

  // 4. frontier out + visited append.
  const int n_take = max(0, min(s_total, allowed));
  for (int i = tid; i < W; i += blockDim.x) {
    f_ids_out[rw + i] = fid[i];
    f_d_out[rw + i] = fd[i];
  }
  for (int v = tid; v < V; v += blockDim.x) {
    const int j = v - cnt0;
    if (j >= 0 && j < n_take) {
      ov_ids[rv + v] = fid[j];
      ov_d[rv + v] = fd[j];
    } else {
      ov_ids[rv + v] = vis[v];
      ov_d[rv + v] = vis_d[rv + v];
    }
  }
  if (tid == 0) ov_cnt[b] = cnt0 + n_take;
}

}  // namespace

extern "C" int frontier_select(const void* cand_ids, const void* cand_d,
                               const void* new_ids, const void* new_d,
                               const void* vis_ids, const void* vis_d,
                               const void* vis_cnt, void* m_ids, void* m_d,
                               void* f_ids, void* f_d, void* ov_ids,
                               void* ov_d, void* ov_cnt, int B, int L, int K,
                               int V, int W, int max_visits, void* stream) {
  if (B == 0) return 0;
  int P = 1;
  while (P < L + K) P <<= 1;
  const size_t smem = (size_t)P * 8 + (size_t)V * 4 + (size_t)L * 8 +
                      (size_t)W * 8;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        frontier_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  frontier_select_kernel<<<B, kThreads, smem,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int32_t*)cand_ids, (const float*)cand_d, (const int32_t*)new_ids,
      (const float*)new_d, (const int32_t*)vis_ids, (const float*)vis_d,
      (const int32_t*)vis_cnt, (int32_t*)m_ids, (float*)m_d, (int32_t*)f_ids,
      (float*)f_d, (int32_t*)ov_ids, (float*)ov_d, (int32_t*)ov_cnt, L, K, V,
      P, W, max_visits);
  return (int)cudaGetLastError();
}
