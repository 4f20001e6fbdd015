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
// On the card the rounds, not the bytes, set the time: every round re-reads
// the alive rows from shared memory and waits on its barrier, and the
// slowest row of the grid (up to R rounds) ends the kernel.  PERF.md §6 has
// the measurements, with the variants that ran slower.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;                     // lanes per candidate
constexpr int kGroups = kThreads / kLanes;    // candidates in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr size_t kStaticReserve = 1024;       // static shared memory

__device__ __forceinline__ bool better(float va, int ca, float vb, int cb) {
  return va < vb || (va == vb && ca < cb);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Floats 4k..4k+3 of a row in device memory (zero past d).
__device__ __forceinline__ float4 global_chunk(const float* row, int k, int d,
                                               bool vec4) {
  if (vec4) return __ldg(reinterpret_cast<const float4*>(row) + k);
  const int j = 4 * k;
  return make_float4(j < d ? __ldg(row + j) : 0.f,
                     j + 1 < d ? __ldg(row + j + 1) : 0.f,
                     j + 2 < d ? __ldg(row + j + 2) : 0.f,
                     j + 3 < d ? __ldg(row + j + 3) : 0.f);
}

struct Rows {
  const float4* smem;       // [n_res][s4] resident rows
  const int* sid;           // [C] candidate ids
  const float* table;       // [N, d]
  int n_res, s4, d;
  bool vec4;

  __device__ __forceinline__ float4 chunk(int c, int k) const {
    if (c < n_res) return smem[c * s4 + k];
    return global_chunk(table + (long long)max(sid[c], 0) * d, k, d, vec4);
  }
};

__device__ __forceinline__ float sq(float4 a, float4 b, float acc) {
  const float x = a.x - b.x, y = a.y - b.y, z = a.z - b.z, w = a.w - b.w;
  return acc + x * x + y * y + z * z + w * w;
}

// A lane's J chunks l8 + 8 j of candidate c (zeros past d): plain
// shared-memory loads for a resident row, device memory otherwise.
template <int J>
__device__ __forceinline__ void load_row(float4 (&x)[J], const float4* rows,
                                         const Rows& src, int c, int l8) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < src.n_res) {
    const float4* r = rows + c * src.s4;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = l8 + kLanes * j;
      x[j] = k < src.s4 ? r[k] : zero;
    }
  } else {
    const float* g = src.table + (long long)max(src.sid[c], 0) * src.d;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = l8 + kLanes * j;
      x[j] = k < src.s4 ? global_chunk(g, k, src.d, src.vec4) : zero;
    }
  }
}

// A lane's share of |a - b|^2 over its J chunks l8 + 8 j < s4, one sum per
// chunk and a tree over them (short dependency chains).
template <int J>
__device__ __forceinline__ float partial(const float4 (&a)[J],
                                         const float4 (&b)[J], int l8,
                                         int s4) {
  float p[J];
#pragma unroll
  for (int j = 0; j < J; ++j)
    p[j] = l8 + kLanes * j < s4 ? sq(a[j], b[j], 0.f) : 0.f;
#pragma unroll
  for (int h = 1; h < J; h <<= 1)
#pragma unroll
    for (int j = 0; j + h < J; j += 2 * h) p[j] += p[j + h];
  return p[0];
}

// The sum over a lane group (8 lanes); every lane of the warp calls it.
__device__ __forceinline__ float group_sum(float a) {
  for (int o = 1; o < kLanes; o <<= 1) a += __shfl_xor_sync(kFull, a, o);
  return a;
}

// The cover test of an alive candidate c (key kc, cover distance acc):
// retire it (the winner itself too) or keep it as the group's least
// survivor so far.  Only its owning group touches key[c].
__device__ __forceinline__ void settle(int c, float kc, float acc, int star,
                                       float alpha, float* key, float& nv,
                                       int& nc, int l8) {
  if (c == star || alpha * acc <= kc) {
    if (l8 == 0) key[c] = CUDART_INF_F;
  } else if (better(kc, c, nv, nc)) {
    nv = kc;
    nc = c;
  }
}

// The block's least (value, column) from each lane's group best; every
// lane of a group must hold the same pair.  One barrier, on the slot
// `parity` (alternated by the caller, so a slot is rewritten only after
// the next barrier, when every thread has read it).
__device__ __forceinline__ void block_best(float& bv, int& bc,
                                           float (*w_val)[kWarps],
                                           int (*w_col)[kWarps], int parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = kLanes; o < 32; o <<= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, o);
    const int oc = __shfl_xor_sync(kFull, bc, o);
    if (better(ov, oc, bv, bc)) {
      bv = ov;
      bc = oc;
    }
  }
  if (lane == 0) {
    w_val[parity][warp] = bv;
    w_col[parity][warp] = bc;
  }
  __syncthreads();
  bv = w_val[parity][0];
  bc = w_col[parity][0];
  for (int w = 1; w < kWarps; ++w)
    if (better(w_val[parity][w], w_col[parity][w], bv, bc)) {
      bv = w_val[parity][w];
      bc = w_col[parity][w];
    }
}

// J == 4: d <= 128, the winner's slice (4 float4s a lane, zeros past s4)
// is held in registers; J == 0: any d, the slice is read again for each
// candidate.
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
  const int l8 = tid & (kLanes - 1), grp = tid / kLanes;
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
  if (vec4) {
    for (int i = tid; i < n_res * s4; i += kThreads) {
      const int c = i / s4;
      if (key[c] != CUDART_INF_F)
        cp_async16(rows + i, reinterpret_cast<const float4*>(
                                 table + (long long)max(sid[c], 0) * d) +
                                 (i - c * s4));
    }
    cp_async_wait_all();
  } else {
    float* rf = reinterpret_cast<float*>(rows);
    const int w = s4 * 4;
    for (int i = tid; i < n_res * w; i += kThreads) {
      const int c = i / w, j = i - c * w;
      if (key[c] != CUDART_INF_F)
        rf[i] = j < d ? table[(long long)max(sid[c], 0) * d + j] : 0.f;
    }
  }
  const Rows src{rows, sid, table, n_res, s4, d, vec4};

  // The first winner: each group scans the columns it owns.
  float bv = CUDART_INF_F;
  int bc = C;
  for (int c = grp; c < C; c += kGroups)
    if (better(key[c], c, bv, bc)) {
      bv = key[c];
      bc = c;
    }
  block_best(bv, bc, w_val, w_col, 0);       // also publishes the staging

  int count = 0, r = 0;
  for (; r < R; ++r) {
    if (!(bv < CUDART_INF_F)) break;          // no winner: the row retires
    const int star = bc;
    if (tid == 0) out_row[r] = sid[star];
    ++count;
    constexpr int JR = J > 0 ? J : 1;
    float4 vs[JR];
    if (J > 0) load_row<JR>(vs, rows, src, star, l8);
    // Retire what the winner alpha-covers (and the winner itself), keeping
    // the least survivor of the group for the next round.  Resident rows
    // first: a group scores two candidates at once with straight-line
    // shared-memory reads (a dead or missing candidate's lanes read a
    // resident row and their sum is dropped).
    float nv = CUDART_INF_F;
    int nc = C;
    if (J > 0) {
      for (int c0 = 0; c0 < n_res; c0 += 2 * kGroups) {
        const int ca = c0 + grp, cb = ca + kGroups;
        const float ka = ca < n_res ? key[ca] : CUDART_INF_F;
        const float kb = cb < n_res ? key[cb] : CUDART_INF_F;
        const bool la = ka != CUDART_INF_F, lb = kb != CUDART_INF_F;
        if (!__any_sync(kFull, la || lb)) continue;
        const float4* ra = rows + min(ca, n_res - 1) * s4;
        const float4* rb = rows + min(cb, n_res - 1) * s4;
        float4 xa[JR], xb[JR];
#pragma unroll
        for (int j = 0; j < JR; ++j) {
          const int k = min(l8 + kLanes * j, s4 - 1);
          xa[j] = ra[k];
          xb[j] = rb[k];
        }
        const float aa = group_sum(partial<JR>(vs, xa, l8, s4));
        const float ab = group_sum(partial<JR>(vs, xb, l8, s4));
        if (la) settle(ca, ka, aa, star, alpha, key, nv, nc, l8);
        if (lb) settle(cb, kb, ab, star, alpha, key, nv, nc, l8);
      }
    }
    // The rest (the tiled path's rows in device memory; every row when
    // J == 0), one candidate a group.
    for (int c0 = J > 0 ? n_res / kGroups * kGroups : 0; c0 < C;
         c0 += kGroups) {
      const int c = c0 + grp;
      const bool mine = c < C && (J == 0 || c >= n_res);
      const float kc = mine ? key[c] : CUDART_INF_F;
      const bool live = kc != CUDART_INF_F;
      if (!__any_sync(kFull, live)) continue;
      float acc = 0.f;
      if (live) {
        if (J > 0) {
          float4 x[JR];
          load_row<JR>(x, rows, src, c, l8);
          acc = partial<JR>(vs, x, l8, s4);
        } else {
          for (int k = l8; k < s4; k += kLanes)
            acc = sq(src.chunk(star, k), src.chunk(c, k), acc);
        }
      }
      acc = group_sum(acc);
      if (live) settle(c, kc, acc, star, alpha, key, nv, nc, l8);
    }
    bv = nv;
    bc = nc;
    block_best(bv, bc, w_val, w_col, (r + 1) & 1);
  }
  for (int i = r + tid; i < R; i += kThreads) out_row[i] = -1;
  if (tid == 0) counts[b] = count;
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
