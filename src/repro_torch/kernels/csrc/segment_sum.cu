// Per-segment sum over segment ids in any order (the group-by sum).
//
// Replaces the TPU kernel `segment_sum_sorted_pallas`
// (src/repro/kernels/segment_reduce.py, body `_kernel`), which ranks
// sorted ids inside a 512-row block and reduces the block with one MXU
// one-hot product.  The engine's group ids come in row order, not
// sorted, and its measures are float64 and its counts int64, so this
// kernel takes float32, float64 and int64 values with int64 ids in any
// order.  Ids outside [0, num_segments) are dropped, as
// jax.ops.segment_sum drops them.
//
// What bounds it on an H100: bytes.  Each row is read once (a value and
// an 8-byte id) and each segment written once; there are no operations
// to speak of.  Two things stand between the kernel and that bound:
//   * few segments (TPC-H q1: millions of rows into 4 groups) make plain
//     global atomics serialise on a handful of addresses.  When the
//     segments fit in shared memory (kSmemSlots), each block sums into
//     shared-memory partials and adds each non-zero partial to device
//     memory once.
//   * many segments (q18: 6 M rows into 1.5 M orders) do not fit in
//     shared memory; each row then adds straight into device memory
//     with a native atomicAdd (float64 on sm_90; int64 through unsigned
//     long long, which wraps as two's complement does).
// Float atomics add in an order that changes from run to run, so float
// results agree with a sequential sum only to rounding.
//
// C interface: one function, loaded with ctypes.  It launches on the
// given stream, allocates nothing (the caller zeroes `out`), and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kSmemSlots = 4096;  // 32 KB of float64 / int64

__device__ __forceinline__ void atomic_add(float* addr, float v) { atomicAdd(addr, v); }
__device__ __forceinline__ void atomic_add(double* addr, double v) { atomicAdd(addr, v); }
__device__ __forceinline__ void atomic_add(long long* addr, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(addr), static_cast<unsigned long long>(v));
}

template <typename T>
__global__ void segment_sum_smem(const T* __restrict__ vals, const long long* __restrict__ ids,
                                 long long n, long long m, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* part = reinterpret_cast<T*>(smem_raw);
  for (long long s = threadIdx.x; s < m; s += blockDim.x) part[s] = T(0);
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long g = ids[i];
    if (g >= 0 && g < m) atomic_add(&part[g], vals[i]);
  }
  __syncthreads();
  // A zero partial changes nothing: out starts at +0 and +0 + -0 == +0.
  for (long long s = threadIdx.x; s < m; s += blockDim.x) {
    const T v = part[s];
    if (v != T(0)) atomic_add(&out[s], v);
  }
}

template <typename T>
__global__ void segment_sum_global(const T* __restrict__ vals, const long long* __restrict__ ids,
                                   long long n, long long m, T* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long g = ids[i];
    if (g >= 0 && g < m) atomic_add(&out[g], vals[i]);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <typename T>
void launch(const void* vals, const void* ids, long long n, long long m, void* out,
            cudaStream_t stream) {
  const long long want = (n + kThreads - 1) / kThreads;
  const T* v = static_cast<const T*>(vals);
  const long long* g = static_cast<const long long*>(ids);
  T* o = static_cast<T*>(out);
  if (m <= kSmemSlots) {
    // Few blocks: every block flushes all m partials, so keep the grid
    // at a few blocks per SM and let the grid-stride loop cover n.
    const long long cap = 4LL * sm_count();
    const int blocks = static_cast<int>(want < cap ? want : cap);
    const size_t smem = static_cast<size_t>(m) * sizeof(T);
    segment_sum_smem<T><<<blocks, kThreads, smem, stream>>>(v, g, n, m, o);
  } else {
    const long long cap = 32LL * sm_count();
    const int blocks = static_cast<int>(want < cap ? want : cap);
    segment_sum_global<T><<<blocks, kThreads, 0, stream>>>(v, g, n, m, o);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float64, 2 = int64.  n > 0 and m > 0.
extern "C" int repro_segment_sum(int dtype, const void* vals, const void* ids, long long n,
                                 long long m, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(vals, ids, n, m, out, s); break;
    case 1: launch<double>(vals, ids, n, m, out, s); break;
    case 2: launch<long long>(vals, ids, n, m, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
