// frontier_select: one fused beam-search round step, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/frontier_select.py::frontier_select_kernel
// (_frontier_kernel).  The TPU kernel ran L rounds of (min, first column,
// mask) over 128-lane padded rows.
//
// Per row b (contract: repro_torch.kernels.ref.frontier_select_batch_ref):
//   1. stable top-L merge of the L candidates and K fresh neighbours on the
//      key (distance, position) -- unique positions make that order the
//      stable order;
//   2. open mask: merged entry has id >= 0, finite distance, and is not in
//      the visited set (all V ids);
//   3. frontier: the first min(W, max_visits - vis_cnt) open entries;
//   4. the frontier is appended to the visited arrays at vis_cnt...
// The kernel does no arithmetic on distances, only compares and moves them,
// so it is bit-identical to its plain version.  It does not rely on either
// list being sorted.  Distances are finite or +-inf; the order treats -0
// as +0, as the plain version's comparisons do.
//
// Bound: the bytes, each operand read once and each output written once,
// (2(L+K) + 2V + 1) * 4 in and (2L + 2W + 2V + 1) * 4 out a row: 6.5 MB and
// 0.0019 ms at B 1024, L 100, K 256, V 166 (3.35 TB/s).  No arithmetic.
// What holds the kernel is each row's dependent steps, their barriers and
// the instructions between them, not bytes.  A full sort of the L + K
// lanes (padded to 512: 45 passes, each closed by a barrier) would order
// lanes the engine hands in as (-1, +inf), most of the fresh ones; a
// thread per merged entry scanning the visited set one id after another,
// or one warp ranking the open entries alone, would serialise.  Design:
//  * compacts the lanes whose distance is below +inf with ballot and popc:
//    warp w packs its 32-lane chunks into its own segment of slots, so no
//    barrier or atomic orders the warps;
//  * ranks each kept entry by counting the kept keys below it; the key is
//    the distance's order-preserving bits above the position, so one 64-bit
//    compare orders (distance, position).  Every thread of a warp reads the
//    same two keys at once (a 16-byte shared-memory broadcast), and a warp
//    ranks only as many entries a pass as it holds: O(n_kept) a thread,
//    about n_kept^2 / 32 compares a row in all.  Entries of rank < L are
//    scattered to their place, the rest of the merged list is (-1, +inf);
//  * tests the open mask a warp per 32 merged entries: each lane holds its
//    share of the visited ids in registers (V <= 256; the rest are read
//    from L1), compares, and the warp votes with __any_sync;
//  * ranks the open entries by a block-wide scan: each warp's ballot and
//    popc, then one barrier for the warps' totals.
// Three barriers a row on the main path (L + K <= 384, L <= 128).
// Block shape: one 128-thread block a row.  The main path's 1,024 rows
// make ~8 blocks on each of 132 SMs, all resident at once (6.9 KB of
// shared memory a block), so the rows run in one wave; four warps cover
// the L = 100 merged entries in one open-test pass and the 12 input
// chunks in three each.  A larger block would only add warps that read the
// same broadcast keys in the rank loop, which is where the time goes.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kOwn = 3;               // entries a thread ranks in one pass
constexpr int kVisRegs = 8;           // visited ids a lane holds (V <= 256)
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;

// (distance, position) as one unsigned key: the distance's bits mapped to
// an unsigned order (sign flipped, negatives inverted; -0 taken as +0),
// above the position.  For distances below +inf, so never kNone.
__device__ __forceinline__ unsigned long long sort_key(float d, int pos) {
  unsigned u = d == 0.f ? 0u : __float_as_uint(d);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned>(pos);
}

// Slots of one warp's segment: its share of the 32-lane input chunks.
__host__ __device__ __forceinline__ int segment(int M) {
  return ((M + 31) / 32 + kWarps - 1) / kWarps * 32;
}

// cnt[k] += the kept keys below mine[k], k < N: every warp segment's keys
// two at a time (one 16-byte broadcast read; a segment's odd tail is
// padded with kNone, which is below no key).
template <int N>
__device__ __forceinline__ void count_below(const unsigned long long* key,
                                            const int* w_n, int seg,
                                            const unsigned long long* mine,
                                            int* cnt) {
  for (int w = 0; w < kWarps; ++w) {
    const ulonglong2* kw = reinterpret_cast<const ulonglong2*>(key + w * seg);
    const int pairs = (w_n[w] + 1) >> 1;
#pragma unroll 4
    for (int j = 0; j < pairs; ++j) {
      const ulonglong2 kj = kw[j];
#pragma unroll
      for (int k = 0; k < N; ++k)
        cnt[k] += (kj.x < mine[k] ? 1 : 0) + (kj.y < mine[k] ? 1 : 0);
    }
  }
}

__global__ void __launch_bounds__(kThreads) frontier_select_kernel(
    const int32_t* __restrict__ cand_ids, const float* __restrict__ cand_d,
    const int32_t* __restrict__ new_ids, const float* __restrict__ new_d,
    const int32_t* __restrict__ vis_ids, const float* __restrict__ vis_d,
    const int32_t* __restrict__ vis_cnt, int32_t* __restrict__ m_ids_out,
    float* __restrict__ m_d_out, int32_t* __restrict__ f_ids_out,
    float* __restrict__ f_d_out, int32_t* __restrict__ ov_ids,
    float* __restrict__ ov_d, int32_t* __restrict__ ov_cnt, int L, int K,
    int V, int W, int max_visits) {
  const int M = L + K, seg = segment(M), S = kWarps * seg;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* key = reinterpret_cast<unsigned long long*>(smem);  // [S] keys
  int* cid = reinterpret_cast<int*>(key + S);          // [S] kept ids
  float* cd = reinterpret_cast<float*>(cid + S);       // [S] kept distances
  int* mid = reinterpret_cast<int*>(cd + S);           // [L] merged ids
  float* md = reinterpret_cast<float*>(mid + L);       // [L] merged dists
  __shared__ int w_n[kWarps];
  __shared__ int w_tot[2][kWarps];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long rl = (long long)b * L, rk = (long long)b * K,
                  rv = (long long)b * V, rw = (long long)b * W;

  // The visited ids this lane tests (v = lane + 32 k), read early.
  int vreg[kVisRegs];
#pragma unroll
  for (int k = 0; k < kVisRegs; ++k) {
    const int v = lane + 32 * k;
    vreg[k] = v < V ? vis_ids[rv + v] : -1;
  }

  // 1a. Compaction: warp w packs the kept lanes of chunks w, w + 4, ...
  // into slots [w * seg, w * seg + w_n[w]).
  int n_w = 0;
  for (int ch = warp; ch * 32 < M; ch += kWarps) {
    const int i = ch * 32 + lane;
    float dv = CUDART_INF_F;
    int id = -1;
    if (i < L) {
      dv = cand_d[rl + i];
      id = cand_ids[rl + i];
    } else if (i < M) {
      dv = new_d[rk + (i - L)];
      id = new_ids[rk + (i - L)];
    }
    const bool keep = dv < CUDART_INF_F;
    const unsigned bal = __ballot_sync(kFull, keep);
    if (keep) {
      const int s = warp * seg + n_w + __popc(bal & below);
      key[s] = sort_key(dv, i);
      cid[s] = id;
      cd[s] = dv;
    }
    n_w += __popc(bal);
  }
  if (lane == 0) {
    w_n[warp] = n_w;
    if (n_w < seg) key[warp * seg + n_w] = kNone;     // the pair's pad
  }
  __syncthreads();

  // 1b. Rank of each kept entry = kept keys below it; scatter rank < L.
  // Thread t ranks the kept entries e = t + 128 k (in segment order), a
  // warp only as many a pass as it holds.
  int pre[kWarps + 1];
  pre[0] = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) pre[w + 1] = pre[w] + w_n[w];
  const int n_kept = pre[kWarps];
  for (int e0 = 0; e0 < n_kept; e0 += kThreads * kOwn) {
    const int own =
        min(kOwn, (n_kept - e0 - 32 * warp + kThreads - 1) / kThreads);
    if (own <= 0) continue;                           // warp-uniform
    unsigned long long mine[kOwn];
    int slot[kOwn], cnt[kOwn];
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
      // Entry e's slot: e plus the unused slots of the segments before
      // its own.
      const int e = e0 + tid + kThreads * k;
      slot[k] = e;
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        slot[k] += e >= pre[w] ? seg - w_n[w - 1] : 0;
      mine[k] = k < own && e < n_kept ? key[slot[k]] : kNone;
      cnt[k] = 0;
    }
    if (own == 1)
      count_below<1>(key, w_n, seg, mine, cnt);
    else if (own == 2)
      count_below<2>(key, w_n, seg, mine, cnt);
    else
      count_below<kOwn>(key, w_n, seg, mine, cnt);
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
      const int r = cnt[k];
      if (mine[k] == kNone || r >= L) continue;
      const float dv = cd[slot[k]];
      const int id = isfinite(dv) ? cid[slot[k]] : -1;
      m_ids_out[rl + r] = id;
      m_d_out[rl + r] = dv;
      mid[r] = id;
      md[r] = dv;
    }
  }
  for (int i = n_kept + tid; i < L; i += kThreads) {
    m_ids_out[rl + i] = -1;
    m_d_out[rl + i] = CUDART_INF_F;
  }
  __syncthreads();

  // 2-3. Open test a warp per 32 merged entries (each lane compares the
  // visited ids it holds, then a vote), then a block-wide scan of the open
  // flags; the first `allowed` open entries are the frontier and go to the
  // visited arrays at vis_cnt...
  const int n_m = min(n_kept, L);
  const int cnt0 = vis_cnt[b];
  const int allowed = min(W, max_visits - cnt0);
  int carry = 0;
  for (int base = 0, it = 0; base < n_m; base += kThreads, ++it) {
    const int e0 = base + warp * 32;
    bool open = false;
    for (int j = 0; j < 32 && e0 + j < n_m; ++j) {
      const int id = mid[e0 + j];
      bool hit = false;
#pragma unroll
      for (int k = 0; k < kVisRegs; ++k) hit |= vreg[k] == id;
      for (int v = lane + 32 * kVisRegs; v < V; v += 32)
        hit |= vis_ids[rv + v] == id;
      const bool seen = __any_sync(kFull, hit);
      if (lane == j) open = id >= 0 && !seen;
    }
    const unsigned bal = __ballot_sync(kFull, open);
    if (lane == 0) w_tot[it & 1][warp] = __popc(bal);
    __syncthreads();
    int before = carry;
    for (int w = 0; w < kWarps; ++w) {
      const int t = w_tot[it & 1][w];
      if (w < warp) before += t;
      carry += t;
    }
    const int r = before + __popc(bal & below);
    if (open && r < allowed) {
      const int e = e0 + lane;
      f_ids_out[rw + r] = mid[e];
      f_d_out[rw + r] = md[e];
      const int v = cnt0 + r;
      if (v >= 0 && v < V) {
        ov_ids[rv + v] = mid[e];
        ov_d[rv + v] = md[e];
      }
    }
  }

  // 4. Frontier padding, the rest of the visited arrays, the new count.
  const int n_take = max(0, min(carry, allowed));
  for (int i = n_take + tid; i < W; i += kThreads) {
    f_ids_out[rw + i] = -1;
    f_d_out[rw + i] = CUDART_INF_F;
  }
  for (int v = tid; v < V; v += kThreads) {
    const int j = v - cnt0;
    if (j < 0 || j >= n_take) {
      ov_ids[rv + v] = vis_ids[rv + v];
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
  const size_t smem = (size_t)kWarps * segment(L + K) * 16 + (size_t)L * 8;
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
      W, max_visits);
  return (int)cudaGetLastError();
}
