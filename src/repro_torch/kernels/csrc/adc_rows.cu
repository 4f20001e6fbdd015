// adc_rows: fused id->code gather + PQ asymmetric distance, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/pq_adc.py::adc_distances_kernel (_adc_kernel),
// which computed out[q,n] = sum_m lut[q,m,codes[n,m]] as a one-hot matmul on
// the MXU -- the TPU's way around scalar gathers.  The engine called it with
// Q = 1 on W*R code rows it had gathered first (core/search.py:121-124);
// here the gather is fused in.
//
// Computes out[b,k] = sum_{j<m} luts[b, j, codes[ids[b,k], j]] in f32,
// summed in j order; ids < 0 (or past the table) give +inf.
//
// Bound: device-memory bytes -- each query's LUT (m*ksub*4 = 32 KB at
// m=32, ksub=256) plus K code rows of m bytes; the m adds per candidate are
// negligible.  There is no one-hot matmul: Hopper's shared memory does the
// scalar gathers the TPU could not.  Design (adc_rows_bulk_kernel):
//  * persistent blocks, as many as are resident at once, spread evenly:
//    block g takes queries g, g + G, g + 2G, ... (G the grid), so the last
//    turn is the only partial one and no second wave of blocks runs on an
//    idle card;
//  * each block holds two LUT buffers; one thread copies a query's LUT
//    with one bulk copy (cp.async.bulk, global to shared memory), which
//    completes on the buffer's mbarrier.  The first two queries' copies
//    are issued at once, and each buffer is refilled with the query two
//    turns ahead as soon as the block has scored it, so the next LUT lands
//    while the current one is scored;
//  * every thread loads its candidates' ids and 16-byte code words into
//    registers a turn ahead (the first 2 * 256 candidates of a query), so
//    the id -> code chain of the next query overlaps the scoring of this
//    one and the LUT copies; a candidate then costs m shared-memory
//    lookups.
// adc_rows_loop_kernel, one block a query (the LUT copied by all threads,
// then the lookups), takes the layouts the bulk copy cannot (m*ksub*4 not
// a multiple of 16, a LUT or code table not 16-byte aligned, m % 16 != 0,
// or two LUTs past the shared memory of a block), and every B whose grid
// of one block a query fits one wave: there is no tail to remove then, and
// its copy by all threads lands sooner than one bulk copy.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kPerThread = 2;    // candidates a thread holds in registers
constexpr int kPreWords = 2;     // 16-byte code words loaded before the wait

// ---------------------------------------------------------------- fallback
template <bool kVec16>
__global__ void adc_rows_loop_kernel(const float* __restrict__ luts,
                                     const uint8_t* __restrict__ codes,
                                     const int32_t* __restrict__ ids,
                                     float* __restrict__ out, int K, int N,
                                     int m, int ksub) {
  extern __shared__ float lut[];
  const int b = blockIdx.x;
  const int n_lut = m * ksub;
  const float* src = luts + (long long)b * n_lut;
  if ((n_lut & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(lut);
    for (int i = threadIdx.x; i < (n_lut >> 2); i += blockDim.x) d4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < n_lut; i += blockDim.x) lut[i] = src[i];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int id = ids[(long long)b * K + k];
    float acc = CUDART_INF_F;
    if (id >= 0 && id < N) {
      const uint8_t* row = codes + (long long)id * m;
      acc = 0.f;
      if (kVec16) {
        for (int j0 = 0; j0 < m; j0 += 16) {
          const uint4 w = *reinterpret_cast<const uint4*>(row + j0);
          const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int t = 0; t < 16; ++t) {
            const int c = (words[t >> 2] >> (8 * (t & 3))) & 0xff;
            acc += lut[(j0 + t) * ksub + c];
          }
        }
      } else {
        for (int j = 0; j < m; ++j) acc += lut[j * ksub + row[j]];
      }
    }
    out[(long long)b * K + k] = acc;
  }
}

// ---------------------------------------------- bulk copies on mbarriers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

// Expect `bytes` on `bar` (its one arrival), then copy them.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// sum_t lut[(j0 + t) * ksub + byte t of w] for t < 16, added to acc in t
// order.
__device__ __forceinline__ float add16(float acc, const float* lut, int j0,
                                       int ksub, uint4 w) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int c = (words[t >> 2] >> (8 * (t & 3))) & 0xff;
    acc += lut[(j0 + t) * ksub + c];
  }
  return acc;
}

// A thread's candidates k0 + u * kThreads + tid (u < kPerThread) of one
// query: their ids (-1 past K, below 0 or past the table) and the first
// kPreWords 16-byte words of their code rows.
struct Chunk {
  int id[kPerThread];
  uint4 w[kPerThread][kPreWords];
};

__device__ __forceinline__ void load_chunk(Chunk& c,
                                           const int32_t* __restrict__ qids,
                                           const uint8_t* __restrict__ codes,
                                           int k0, int K, int N, int m) {
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int k = k0 + u * kThreads + threadIdx.x;
    c.id[u] = k < K ? __ldg(qids + k) : -1;
    if (c.id[u] >= N) c.id[u] = -1;
  }
#pragma unroll
  for (int u = 0; u < kPerThread; ++u)
#pragma unroll
    for (int v = 0; v < kPreWords; ++v)
      if (c.id[u] >= 0 && 16 * v < m)
        c.w[u][v] = __ldg(
            reinterpret_cast<const uint4*>(codes + (long long)c.id[u] * m) +
            v);
}

__device__ __forceinline__ void score_chunk(const Chunk& c, const float* lut,
                                            const uint8_t* __restrict__ codes,
                                            float* __restrict__ qout, int k0,
                                            int K, int m, int ksub) {
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int k = k0 + u * kThreads + threadIdx.x;
    if (k >= K) continue;
    float acc = CUDART_INF_F;
    if (c.id[u] >= 0) {
      const uint4* row =
          reinterpret_cast<const uint4*>(codes + (long long)c.id[u] * m);
      acc = 0.f;
#pragma unroll
      for (int v = 0; v < kPreWords; ++v)
        if (16 * v < m) acc = add16(acc, lut, 16 * v, ksub, c.w[u][v]);
      for (int j0 = 16 * kPreWords; j0 < m; j0 += 16)
        acc = add16(acc, lut, j0, ksub, __ldg(row + j0 / 16));
    }
    qout[k] = acc;
  }
}

// Needs m % 16 == 0, m*ksub*4 % 16 == 0 and luts, codes 16-byte aligned.
__global__ void __launch_bounds__(kThreads, 3)
    adc_rows_bulk_kernel(const float* __restrict__ luts,
                         const uint8_t* __restrict__ codes,
                         const int32_t* __restrict__ ids,
                         float* __restrict__ out, int B, int K, int N, int m,
                         int ksub) {
  extern __shared__ __align__(16) float bufs[];   // [2][m * ksub]
  __shared__ __align__(8) uint64_t bar[2];
  const int tid = threadIdx.x;
  const int G = gridDim.x;
  const int n_lut = m * ksub;
  const uint32_t bytes = (uint32_t)n_lut * 4u;
  // The first chunk of each query is loaded a turn ahead: the ids and code
  // words of query q + G are in flight while query q is scored.
  Chunk cur, next;
  load_chunk(cur, ids + (long long)blockIdx.x * K, codes, 0, K, N, m);
  // Thread 0 starts the first two copies before the barrier that makes
  // the initialised mbarriers visible to the other threads.
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < 2; ++s) {
      const int q = blockIdx.x + s * G;
      if (q < B)
        bulk_load(bufs + s * n_lut, luts + (long long)q * n_lut, bytes,
                  &bar[s]);
    }
  }
  __syncthreads();

  for (int t = 0, q = blockIdx.x; q < B; ++t, q += G) {
    const int s = t & 1;
    const float* lut = bufs + s * n_lut;
    float* qout = out + (long long)q * K;
    mbar_wait(&bar[s], (t >> 1) & 1);
    if (q + G < B)
      load_chunk(next, ids + (long long)(q + G) * K, codes, 0, K, N, m);
    score_chunk(cur, lut, codes, qout, 0, K, m, ksub);
    for (int k0 = kPerThread * kThreads; k0 < K; k0 += kPerThread * kThreads) {
      Chunk c;
      load_chunk(c, ids + (long long)q * K, codes, k0, K, N, m);
      score_chunk(c, lut, codes, qout, k0, K, m, ksub);
    }
    cur = next;
    // Every thread has read this buffer: refill it two turns ahead.
    __syncthreads();
    const int q2 = q + 2 * G;
    if (tid == 0 && q2 < B) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bulk_load(bufs + s * n_lut, luts + (long long)q2 * n_lut, bytes,
                &bar[s]);
    }
  }
}

// The resident blocks of a kernel at a dynamic shared memory size, found
// once a device and size.
struct Residency {
  size_t smem[kMaxDevices];
  int slots[kMaxDevices];
};

cudaError_t resident_blocks(const void* kernel, size_t smem, int dev,
                            Residency& cache, int* slots) {
  static int sms[kMaxDevices];
  if (cache.smem[dev] == smem && cache.slots[dev] > 0) {
    *slots = cache.slots[dev];
    return cudaSuccess;
  }
  cudaError_t e = cudaSuccess;
  if (sms[dev] == 0)
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm == 0) return cudaErrorInvalidValue;
  cache.smem[dev] = smem;
  cache.slots[dev] = per_sm * sms[dev];
  *slots = cache.slots[dev];
  return cudaSuccess;
}

// The persistent grid: the resident blocks (slots) spread evenly over the
// turns, ceil(B / slots) queries a block, the last turn partial.
int persistent_grid(int B, int slots) {
  const int turns = (B + slots - 1) / slots;
  return (B + turns - 1) / turns;
}

}  // namespace

extern "C" int adc_rows(const void* luts, const void* codes, const void* ids,
                        void* out, int B, int K, int N, int m, int ksub,
                        void* stream) {
  static int optin[kMaxDevices];
  static Residency loop_res[2], bulk_res;
  if (B == 0 || K == 0) return 0;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (optin[dev] == 0) {
    e = cudaDeviceGetAttribute(&optin[dev],
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t lut_bytes = (size_t)m * ksub * sizeof(float);
  if (lut_bytes > (size_t)optin[dev]) return (int)cudaErrorInvalidValue;
  const bool codes16 =
      (m % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  const void* loop = codes16
                         ? reinterpret_cast<const void*>(
                               adc_rows_loop_kernel<true>)
                         : reinterpret_cast<const void*>(
                               adc_rows_loop_kernel<false>);
  int loop_slots = 0;
  e = resident_blocks(loop, lut_bytes, dev, loop_res[codes16], &loop_slots);
  if (e != cudaSuccess) return (int)e;
  // The bulk kernel where its layout holds, two LUTs and the mbarriers fit
  // a block, and the loop kernel's grid would run past one wave (a tail of
  // blocks on a mostly idle card).  Within one wave the loop kernel has no
  // tail, and its copy by all threads lands sooner than one bulk copy (B
  // 256 x K 256 on an H100 80GB HBM3 at 700 W, both run twice in one
  // call: 0.00452, 0.00451 against 0.00459, 0.00457 ms; PERF.md).
  const bool bulk = codes16 && lut_bytes % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(luts) % 16 == 0 &&
                    2 * lut_bytes + 16 <= (size_t)optin[dev] &&
                    B > loop_slots;
  if (bulk) {
    int slots = 0;
    e = resident_blocks(reinterpret_cast<const void*>(adc_rows_bulk_kernel),
                        2 * lut_bytes, dev, bulk_res, &slots);
    if (e != cudaSuccess) return (int)e;
    adc_rows_bulk_kernel<<<persistent_grid(B, slots), kThreads,
                           2 * lut_bytes, s>>>(
        (const float*)luts, (const uint8_t*)codes, (const int32_t*)ids,
        (float*)out, B, K, N, m, ksub);
    return (int)cudaGetLastError();
  }
  auto* o = (float*)out;
  auto* l = (const float*)luts;
  auto* c = (const uint8_t*)codes;
  auto* i = (const int32_t*)ids;
  if (codes16)
    adc_rows_loop_kernel<true><<<B, kThreads, lut_bytes, s>>>(l, c, i, o, K,
                                                             N, m, ksub);
  else
    adc_rows_loop_kernel<false><<<B, kThreads, lut_bytes, s>>>(l, c, i, o, K,
                                                              N, m, ksub);
  return (int)cudaGetLastError();
}
