// Two-lane 32-bit tuple hash over k integer columns.
//
// Replaces the TPU kernel `hash32x2_pallas` (src/repro/kernels/hash32x2.py,
// body `_kernel`), which pads the rows to a multiple of 1024, tiles them
// (1024, k) into VMEM and mixes the k columns of a tile into both lanes in
// registers.  Here one thread owns one row of any n: no padding, and the
// last block masks its tail.  For each of the two seeds (0x9E3779B9,
// 0x7F4A7C15), h = fmix32(h ^ fmix32(col_j + j + 1)) over the columns j,
// all arithmetic modulo 2^32, so the result equals the plain version bit
// for bit.  int32 input is read as its uint32 bits.
//
// What bounds it on an H100: bytes.  4 n k bytes are read and 8 n written,
// with about 20 integer operations per column and lane: far below the
// card's operation rate.  So the design is about the reads.  A row of k
// int32 is 4 k bytes, so a thread reading its own row makes a warp touch
// 32 rows spread over 128 k bytes, one word each.  Instead, a block of
// 256 rows stages its rows, which lie contiguously in device memory,
// through shared memory: consecutive threads load consecutive words
// (coalesced), then each thread hashes its row from shared memory.  This
// takes k <= kMaxStagedCols (32 KB of shared memory); wider rows are read
// straight from device memory, row by row.  The two lanes of a row are
// written as one 8-byte store, consecutive threads on consecutive rows.
//
// C interface: one function, loaded with ctypes.  It launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStagedCols = 32;
constexpr uint32_t kSeed0 = 0x9E3779B9u;
constexpr uint32_t kSeed1 = 0x7F4A7C15u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Both lanes of one row, whose k words start at `src`.
__device__ __forceinline__ uint2 hash_row(const uint32_t* src, int k) {
  uint32_t h0 = kSeed0, h1 = kSeed1;
  for (int j = 0; j < k; ++j) {
    const uint32_t x = fmix32(src[j] + static_cast<uint32_t>(j + 1));
    h0 = fmix32(h0 ^ x);
    h1 = fmix32(h1 ^ x);
  }
  return make_uint2(h0, h1);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) hash32x2_kernel(const uint32_t* __restrict__ cols,
                                                            long long n, int k,
                                                            uint2* __restrict__ out) {
  extern __shared__ uint32_t stage[];
  const long long row0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long row = row0 + threadIdx.x;
  if (kStaged) {
    const long long rows = min(static_cast<long long>(kThreads), n - row0);
    const long long words = rows * k;
    const uint32_t* src = cols + row0 * k;
    for (long long e = threadIdx.x; e < words; e += kThreads) stage[e] = src[e];
    __syncthreads();
    if (row < n) out[row] = hash_row(stage + threadIdx.x * k, k);
  } else if (row < n) {
    out[row] = hash_row(cols + row * k, k);
  }
}

}  // namespace

// cols (n, k) int32/uint32, contiguous; out (n, 2) uint32, contiguous.
// n >= 1, k >= 0.
extern "C" int repro_hash32x2(const void* cols, long long n, int k, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kThreads - 1) / kThreads;
  const uint32_t* c = static_cast<const uint32_t*>(cols);
  uint2* o = static_cast<uint2*>(out);
  if (k <= kMaxStagedCols) {
    const size_t smem = static_cast<size_t>(kThreads) * k * sizeof(uint32_t);
    hash32x2_kernel<true><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(c, n, k, o);
  } else {
    hash32x2_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(c, n, k, o);
  }
  return static_cast<int>(cudaGetLastError());
}
