// l2_rows: fused id->row gather + squared L2, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/l2_distance.py::l2_distances_kernel
// (_l2_kernel), a tiled [Q,d] x [N,d] MXU contraction.  The engine called it
// with Q = 1 on W*R rows it had already gathered (core/search.py:103-105)
// and on the L rerank rows; here the gather is fused in, so each row is read
// from the vector table once and never copied.
//
// Computes out[b,k] = max(|q_b|^2 - 2 q_b.x + |x|^2, 0) with x =
// table[ids[b,k]] in f32 (the TPU kernel's norm identity); ids < 0 (or past
// the table) give +inf.
//
// Bound: device-memory bytes.  Each (b,k) reads one d-float row (B*K*d*4
// bytes) and does 3d multiply-adds on it, far below the card's compute
// rate.  Design: one warp per (b,k), lanes stride along d with float4 loads
// (16 bytes a thread, a 128-float row in one coalesced 512-byte warp load),
// and a shuffle reduction; no shared memory, so many warps stay in flight to
// hide the random-row latency.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool kVec4>
__global__ void l2_rows_kernel(const float* __restrict__ q,
                               const float* __restrict__ table,
                               const int32_t* __restrict__ ids,
                               float* __restrict__ out, int B, int K, int N,
                               int d) {
  const int lane = threadIdx.x & 31;
  const long long pair =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= (long long)B * K) return;
  const int b = (int)(pair / K);
  const int id = ids[pair];
  if (id < 0 || id >= N) {
    if (lane == 0) out[pair] = CUDART_INF_F;
    return;
  }
  const float* qr = q + (long long)b * d;
  const float* xr = table + (long long)id * d;
  float qq = 0.f, xx = 0.f, qx = 0.f;
  if (kVec4) {
    const float4* q4 = reinterpret_cast<const float4*>(qr);
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int j = lane; j < (d >> 2); j += 32) {
      const float4 a = q4[j];
      const float4 x = x4[j];
      qq += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
      xx += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
      qx += a.x * x.x + a.y * x.y + a.z * x.z + a.w * x.w;
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      const float a = qr[j];
      const float x = xr[j];
      qq += a * a;
      xx += x * x;
      qx += a * x;
    }
  }
  qq = warp_sum(qq);
  xx = warp_sum(xx);
  qx = warp_sum(qx);
  if (lane == 0) out[pair] = fmaxf(qq - 2.f * qx + xx, 0.f);
}

}  // namespace

extern "C" int l2_rows(const void* q, const void* table, const void* ids,
                       void* out, int B, int K, int N, int d, void* stream) {
  const long long pairs = (long long)B * K;
  if (pairs == 0) return 0;
  const dim3 grid((unsigned)((pairs + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(32 * kWarpsPerBlock);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool vec4 = (d % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(table) % 16 == 0);
  if (vec4) {
    l2_rows_kernel<true><<<grid, block, 0, s>>>(
        (const float*)q, (const float*)table, (const int32_t*)ids,
        (float*)out, B, K, N, d);
  } else {
    l2_rows_kernel<false><<<grid, block, 0, s>>>(
        (const float*)q, (const float*)table, (const int32_t*)ids,
        (float*)out, B, K, N, d);
  }
  return (int)cudaGetLastError();
}
