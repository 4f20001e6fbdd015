// gather_rows: the adjacency row gather of the storage tier, for Hopper
// (sm_90a).
//
// Replaces: src/repro/storage/prefetch.py::hbm_gather_rows (_gather_kernel),
// a Pallas scalar-prefetch pipeline on the TPU: the ids rode as the
// scalar-prefetch operand, each grid step's BlockSpec index map turned one id
// into one [1, R] row DMA from HBM to VMEM, and the pipeline kept the next
// row's DMA in flight while the current one was written out.
//
// Computes out[r, :] = table[ids[r], :] over the n flattened ids, and a row
// of INVALID (-1) where ids[r] < 0.  An id >= the table's row count is the
// caller's error and undefined, as in the Pallas gather.
//
// Bound: device-memory bytes -- n*R*4 read, n*R*4 written and n*4 of ids,
// with no arithmetic.  At the main path's B 1024 x W 4 x R 64 that is about
// 2.1 MB, under a microsecond at 3.35 TB/s, so the launch itself dominates.
// Design: a block loads its own ids (no scalar prefetch, no staging).  A
// group of G lanes copies one row with 16-byte int4 loads and stores; R 64
// is 16 int4s, so G = 16 and a warp copies two rows at once.  Groups walk
// the rows in a grid-stride loop.  A row width that is not a multiple of 4,
// or an unaligned table, takes 4-byte copies.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <int G, bool kVec4>
__global__ void gather_rows_kernel(const int32_t* __restrict__ table,
                                   const int32_t* __restrict__ ids,
                                   int32_t* __restrict__ out, long long n,
                                   int R) {
  const int sub = threadIdx.x % G;
  const long long first =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const long long stride = (long long)gridDim.x * blockDim.x / G;
  for (long long r = first; r < n; r += stride) {
    const int id = __ldg(ids + r);
    if (kVec4) {
      const int R4 = R >> 2;
      int4* dst = reinterpret_cast<int4*>(out + r * R);
      if (id < 0) {
        const int4 inv = make_int4(-1, -1, -1, -1);
        for (int j = sub; j < R4; j += G) dst[j] = inv;
      } else {
        const int4* src =
            reinterpret_cast<const int4*>(table + (long long)id * R);
        for (int j = sub; j < R4; j += G) dst[j] = __ldg(src + j);
      }
    } else {
      int32_t* dst = out + r * R;
      if (id < 0) {
        for (int j = sub; j < R; j += G) dst[j] = -1;
      } else {
        const int32_t* src = table + (long long)id * R;
        for (int j = sub; j < R; j += G) dst[j] = __ldg(src + j);
      }
    }
  }
}

template <int G, bool kVec4>
void launch(const void* table, const void* ids, void* out, long long n,
            int R, cudaStream_t s) {
  const long long rows_per_block = kThreads / G;
  long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_rows_kernel<G, kVec4><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const int32_t*)table, (const int32_t*)ids, (int32_t*)out, n, R);
}

}  // namespace

extern "C" int gather_rows(const void* table, const void* ids, void* out,
                           long long n, int R, void* stream) {
  if (n == 0 || R == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool vec4 = (R % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int per_row = vec4 ? R / 4 : R;     // copies per row
  if (per_row <= 8) {
    if (vec4) launch<8, true>(table, ids, out, n, R, s);
    else launch<8, false>(table, ids, out, n, R, s);
  } else if (per_row <= 16) {
    if (vec4) launch<16, true>(table, ids, out, n, R, s);
    else launch<16, false>(table, ids, out, n, R, s);
  } else {
    if (vec4) launch<32, true>(table, ids, out, n, R, s);
    else launch<32, false>(table, ids, out, n, R, s);
  }
  return (int)cudaGetLastError();
}
