// l2_rows: fused id->row gather + squared L2, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/l2_distance.py::l2_distances_kernel
// (_l2_kernel), a tiled [Q,d] x [N,d] MXU contraction.  The engine called it
// with Q = 1 on W*R rows it had already gathered (core/search.py:103-105)
// and on the L rerank rows; here the gather is fused in, so each row is read
// from the vector table once and never copied.
//
// Computes out[b,k] = max(|q_b|^2 - 2 q_b.x + |x|^2, 0) with x =
// table[ids[b,k]] in f32 (the TPU kernel's norm identity); ids < 0 or >= N
// give +inf.
//
// Bound: device-memory bytes.  Each valid (b,k) reads one d-float row from
// a random place in the table and does 2d multiply-adds on it, far below
// the card's compute rate; the kernel has to keep enough row bytes in
// flight to cover the memory latency.  Design:
//  * one block serves a tile of pairs of one query: its threads copy q into
//    shared memory (zero-padded to whole 4-float chunks) and the tile's ids
//    once, coalesced; warp 0 sums |q|^2 once for the block;
//  * a row is served by a group of G lanes, G the least power of two that
//    gives a lane at most kChunksPerLane 4-float chunks (G 8 at d 128, 4 at
//    d 50, 32 at most); lane l of a group takes chunks l, l + G, l + 2G, ...
//    Each group takes kRowsPerGroup rows and issues all their loads
//    (read-only path, ld.global.nc) before any arithmetic: 4 KB a warp in
//    flight at d 128, 3.2 KB at d 50;
//  * loads are 16 bytes when d % 4 == 0 and the table is 16-byte aligned,
//    8 bytes when d % 2 == 0 and it is 8-byte aligned (d 50's rows are),
//    else 4 bytes; floats past d (the last chunk when d % 4 != 0) read as 0.
//    q goes through shared memory, so only the table's alignment counts;
//  * one summation order for every route: a lane adds its chunks in chunk
//    order, the four floats of a chunk in order (fma), then the group adds
//    its lanes' sums by an xor butterfly over log2(G) steps.  That order
//    depends on d alone (G does), never on B, K, the tile, the pair's
//    place or the load width, so a pair gives the same bits from any table
//    it is read from (search_disk's freshly fetched rows, a shard's table).
//    |q|^2 takes the same walk over q;
//  * each store writes 32 / G consecutive outputs of a warp;
//  * a block has at most 4 warps, fewer when K is small: on an H100, 4
//    took less time than 8 at the main path's three shapes, and other
//    group sizes and rows a group did not gain.
// No allocation, no synchronisation with the host; the C entry returns
// cudaGetLastError() (cudaErrorInvalidValue if q and the tile's ids pass
// the 48 KB of shared memory a block gets without opting in: d past
// ~11,000).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

// The lanes a row, and so the summation order, follow from kChunksPerLane;
// tests/test_torch_kernels.py's walk reads these three lines.
constexpr int kMaxWarps = 4;       // warps a block at most
constexpr int kRowsPerGroup = 2;   // rows a group loads at once
constexpr int kChunksPerLane = 4;  // 4-float chunks a lane loads at once
constexpr int kMaxSmem = 48 * 1024;

// Lanes per row: the least power of two that leaves a lane at most
// kChunksPerLane chunks of the row, at most a warp.
int group_lanes(int d) {
  const int nc = (d + 3) / 4;
  int g = 1;
  while (g < 32 && g * kChunksPerLane < nc) g *= 2;
  return g;
}

// Chunk c of a row (floats 4c .. 4c+3), floats at d and past read as 0:
// one 16-byte load, two 8-byte loads or four 4-byte loads (V floats each).
template <int V>
__device__ __forceinline__ float4 load_chunk(const float* __restrict__ row,
                                             int c, int d) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  const int j = 4 * c;
  if (V == 4) {
    if (j < d) v = __ldg(reinterpret_cast<const float4*>(row + j));
  } else if (V == 2) {
    if (j < d) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(row + j));
      v.x = a.x;
      v.y = a.y;
    }
    if (j + 2 < d) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(row + j + 2));
      v.z = a.x;
      v.w = a.y;
    }
  } else {
    if (j < d) v.x = __ldg(row + j);
    if (j + 1 < d) v.y = __ldg(row + j + 1);
    if (j + 2 < d) v.z = __ldg(row + j + 2);
    if (j + 3 < d) v.w = __ldg(row + j + 3);
  }
  return v;
}

// acc + a.b over the chunk's four floats, in order, each step one fma.
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}

// The sum over a group of G lanes, the same bits in each of them.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int G, int V>
__global__ void __launch_bounds__(32 * kMaxWarps)
l2_rows_kernel(const float* __restrict__ q, const float* __restrict__ table,
               const int32_t* __restrict__ ids, float* __restrict__ out,
               int K, int N, int d, int tiles, int tile) {
  constexpr int kGroups = 32 / G;
  extern __shared__ float4 smem[];
  const int nc = (d + 3) >> 2;
  float4* qs = smem;                                        // [nc]
  int* id_s = reinterpret_cast<int*>(smem + nc);            // [tile]
  float* qq_s = reinterpret_cast<float*>(id_s + tile);      // [1]

  const int b = blockIdx.x / tiles;
  const int k0 = (blockIdx.x - b * tiles) * tile;
  const int kn = min(tile, K - k0);
  const float* qrow = q + (long long)b * d;
  float* qf = reinterpret_cast<float*>(qs);
  for (int j = threadIdx.x; j < 4 * nc; j += blockDim.x)
    qf[j] = j < d ? __ldg(qrow + j) : 0.f;
  const int32_t* idrow = ids + (long long)b * K + k0;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    int id = t < kn ? __ldg(idrow + t) : -1;
    id_s[t] = (id < 0 || id >= N) ? -1 : id;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);                   // lane within its group
  const int r0 = warp * kRowsPerGroup * kGroups + lane / G;
  int id[kRowsPerGroup];
  const float* xr[kRowsPerGroup];
#pragma unroll
  for (int u = 0; u < kRowsPerGroup; ++u) {
    id[u] = id_s[r0 + u * kGroups];
    xr[u] = table + (long long)max(id[u], 0) * d;
  }

  float qx[kRowsPerGroup], xx[kRowsPerGroup];
#pragma unroll
  for (int u = 0; u < kRowsPerGroup; ++u) qx[u] = xx[u] = 0.f;
  for (int cb = 0; cb < nc; cb += G * kChunksPerLane) {
    float4 x[kRowsPerGroup][kChunksPerLane];
#pragma unroll
    for (int u = 0; u < kRowsPerGroup; ++u) {
#pragma unroll
      for (int i = 0; i < kChunksPerLane; ++i) {
        x[u][i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (id[u] >= 0) x[u][i] = load_chunk<V>(xr[u], cb + i * G + gl, d);
      }
    }
#pragma unroll
    for (int i = 0; i < kChunksPerLane; ++i) {
      const int c = cb + i * G + gl;
      const float4 a = c < nc ? qs[c] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kRowsPerGroup; ++u) {
        qx[u] = dot4(x[u][i], a, qx[u]);
        xx[u] = dot4(x[u][i], x[u][i], xx[u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kRowsPerGroup; ++u) {
    qx[u] = group_sum<G>(qx[u]);
    xx[u] = group_sum<G>(xx[u]);
  }

  if (warp == 0) {                  // |q|^2, walked as a row's |x|^2 is
    float acc = 0.f;
    for (int cb = 0; cb < nc; cb += G * kChunksPerLane) {
#pragma unroll
      for (int i = 0; i < kChunksPerLane; ++i) {
        const int c = cb + i * G + gl;
        const float4 a = c < nc ? qs[c] : make_float4(0.f, 0.f, 0.f, 0.f);
        acc = dot4(a, a, acc);
      }
    }
    acc = group_sum<G>(acc);
    if (lane == 0) *qq_s = acc;
  }
  __syncthreads();
  const float qq = *qq_s;
  if (gl == 0) {
    float* orow = out + (long long)b * K + k0;
#pragma unroll
    for (int u = 0; u < kRowsPerGroup; ++u) {
      const int r = r0 + u * kGroups;
      if (r < kn)
        orow[r] = id[u] < 0 ? CUDART_INF_F
                            : fmaxf(__fadd_rn(__fmaf_rn(-2.f, qx[u], qq),
                                              xx[u]), 0.f);
    }
  }
}

template <int G>
void launch(int V, unsigned blocks, int threads, size_t smem,
            cudaStream_t s, const float* q, const float* table,
            const int32_t* ids, float* out, int K, int N, int d, int tiles,
            int tile) {
  if (V == 4)
    l2_rows_kernel<G, 4><<<blocks, threads, smem, s>>>(q, table, ids, out, K,
                                                       N, d, tiles, tile);
  else if (V == 2)
    l2_rows_kernel<G, 2><<<blocks, threads, smem, s>>>(q, table, ids, out, K,
                                                       N, d, tiles, tile);
  else
    l2_rows_kernel<G, 1><<<blocks, threads, smem, s>>>(q, table, ids, out, K,
                                                       N, d, tiles, tile);
}

}  // namespace

extern "C" int l2_rows(const void* q, const void* table, const void* ids,
                       void* out, int B, int K, int N, int d, void* stream) {
  if (B == 0 || K == 0) return 0;
  const int G = group_lanes(d);
  const int rows_per_warp = kRowsPerGroup * 32 / G;
  const int warps =
      std::min(kMaxWarps, (K + rows_per_warp - 1) / rows_per_warp);
  const int tile = warps * rows_per_warp;
  const int tiles = (K + tile - 1) / tile;
  const long long blocks = (long long)B * tiles;
  const int nc = (d + 3) / 4;
  const size_t smem = 16 * (size_t)nc + 4 * (size_t)tile + 4;
  if (blocks > 0x7fffffffLL || smem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const uintptr_t base = reinterpret_cast<uintptr_t>(table);
  const int V = (d % 4 == 0 && base % 16 == 0)  ? 4
                : (d % 2 == 0 && base % 8 == 0) ? 2
                                                : 1;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const float*>(q);
  const auto* tp = static_cast<const float*>(table);
  const auto* ip = static_cast<const int32_t*>(ids);
  auto* op = static_cast<float*>(out);
  const unsigned nb = (unsigned)blocks;
  const int threads = 32 * warps;
  const auto go = [&](auto g) {
    launch<decltype(g)::value>(V, nb, threads, smem, s, qp, tp, ip, op, K, N,
                               d, tiles, tile);
  };
  switch (G) {
    case 1: go(std::integral_constant<int, 1>()); break;
    case 2: go(std::integral_constant<int, 2>()); break;
    case 4: go(std::integral_constant<int, 4>()); break;
    case 8: go(std::integral_constant<int, 8>()); break;
    case 16: go(std::integral_constant<int, 16>()); break;
    default: go(std::integral_constant<int, 32>()); break;
  }
  return (int)cudaGetLastError();
}
