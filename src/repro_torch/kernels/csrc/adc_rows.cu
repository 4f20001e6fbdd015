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
// negligible.  Design: one block per query.  The block stages its LUT in
// shared memory once (16-byte loads), then each thread scores candidates
// k = tid, tid+blockDim, ..., reading its code row with 16-byte loads and
// doing m shared-memory lookups.  There is no one-hot matmul: Hopper's
// shared memory does the scalar gathers the TPU could not.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kVec16>
__global__ void adc_rows_kernel(const float* __restrict__ luts,
                                const uint8_t* __restrict__ codes,
                                const int32_t* __restrict__ ids,
                                float* __restrict__ out, int K, int N, int m,
                                int ksub) {
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

template <bool kVec16>
int launch(const void* luts, const void* codes, const void* ids, void* out,
           int B, int K, int N, int m, int ksub, cudaStream_t s) {
  const size_t smem = (size_t)m * ksub * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        adc_rows_kernel<kVec16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  adc_rows_kernel<kVec16><<<B, kThreads, smem, s>>>(
      (const float*)luts, (const uint8_t*)codes, (const int32_t*)ids,
      (float*)out, K, N, m, ksub);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int adc_rows(const void* luts, const void* codes, const void* ids,
                        void* out, int B, int K, int N, int m, int ksub,
                        void* stream) {
  if (B == 0 || K == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool vec16 =
      (m % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  return vec16 ? launch<true>(luts, codes, ids, out, B, K, N, m, ksub, s)
               : launch<false>(luts, codes, ids, out, B, K, N, m, ksub, s);
}
