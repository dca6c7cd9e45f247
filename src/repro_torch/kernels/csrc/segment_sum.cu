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
// to speak of.  What stands between a kernel and that bound is the
// atomics: many rows adding into one address serialise.  So the kernel
// has three paths, chosen by the caller from m = num_segments:
//   * few (m <= kFewSlots; TPC-H q1: 6 M rows into 6 slots): no atomics
//     per row.  Each thread keeps kFewSlots-or-fewer accumulators in
//     registers and adds each row to the one its id selects (compare and
//     select); at the end each warp reduces every slot with shuffles,
//     the block sums its warps' partials in shared memory, and each block
//     adds each non-zero slot to device memory once.
//   * mid (m <= kSmemSlots): shared-memory partials per block, flushed
//     once per block; before a row's shared atomic the warp finds the
//     lanes holding the same id (__match_any_sync) and sums them with a
//     log-step shuffle tree led by the lowest lane, so 32 rows with 6
//     distinct ids make 6 shared atomics, not 32.
//   * many (q18: 6 M rows into 1.5 M orders): partials would not fit in
//     shared memory, so rows add straight into device memory.  Group ids
//     come in runs (lineitem is generated in order key order), so a warp
//     first sums runs of equal ids over neighbouring rows with a
//     segmented shuffle scan, and only the last row of each run makes
//     the global atomicAdd.
// Every path loads two rows a thread as one 16-byte load of ids and one
// load of values where both pointers allow it (a scalar row before and
// after), else one row a thread.  A warp works on a tile of 32 or 64
// consecutive rows, two tiles in flight.  The grid is at most what fits
// on the card at once, so no block waits for a second wave (the mid
// path, whose every block flushes all m partials, at most 4 per SM).
// Float atomics add in an order that changes from run to run, so float
// results agree with a sequential sum only to rounding; int64 adds wrap
// as two's complement does and are exact in any order.
//
// C interface: one function, loaded with ctypes.  It launches on the
// given stream, allocates nothing (the caller zeroes `out`), and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFewSlots = 16;
constexpr long long kSmemSlots = 4096;  // 32 KB of float64 / int64
enum Path { kFew = 0, kMid = 1, kMany = 2 };

__device__ __forceinline__ void atomic_add(float* addr, float v) { atomicAdd(addr, v); }
__device__ __forceinline__ void atomic_add(double* addr, double v) { atomicAdd(addr, v); }
__device__ __forceinline__ void atomic_add(long long* addr, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(addr), static_cast<unsigned long long>(v));
}

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };
template <> struct Pair<long long> { using type = longlong2; };

// Rows [lo, hi) are loaded VEC to a thread in warp tiles; rows outside
// them (at most one before and one after, VEC == 2 only) one by one.
struct Span {
  long long lo, hi;
};

// Lane `lane` of the tile at row `base` gets rows base + lane*VEC + e.
// A row past `hi` or with an id outside [0, m) gets an id of its own
// below zero (unique in the warp, so it joins no run or peer group) and
// the value 0.
template <typename T, int VEC>
__device__ __forceinline__ void load_tile(const T* __restrict__ vals,
                                          const long long* __restrict__ ids, long long base,
                                          long long hi, long long m, int lane,
                                          long long (&g)[VEC], T (&v)[VEC]) {
  const long long row = base + static_cast<long long>(lane) * VEC;
  if constexpr (VEC == 2) {
    if (row < hi) {  // the span holds whole pairs
      const longlong2 gi = *reinterpret_cast<const longlong2*>(ids + row);
      const typename Pair<T>::type vi = *reinterpret_cast<const typename Pair<T>::type*>(vals + row);
      g[0] = gi.x;
      g[VEC - 1] = gi.y;
      v[0] = vi.x;
      v[VEC - 1] = vi.y;
    } else {
      g[0] = g[VEC - 1] = -1;
    }
  } else {
    if (row < hi) {
      g[0] = ids[row];
      v[0] = vals[row];
    } else {
      g[0] = -1;
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    if (g[e] < 0 || g[e] >= m) {
      g[e] = -1 - (lane * VEC + e);
      v[e] = T(0);
    }
  }
}

// Walks the warp tiles of `span`, two in flight, and hands each to
// `visit(g, v)`.  The loop is uniform over the warp (shuffles inside
// `visit` see all 32 lanes).
template <typename T, int VEC, typename Visit>
__device__ __forceinline__ void for_each_tile(const T* __restrict__ vals,
                                              const long long* __restrict__ ids, Span span,
                                              long long m, Visit visit) {
  const int lane = threadIdx.x & 31;
  constexpr long long kTile = 32 * VEC;
  const long long ntiles = (span.hi - span.lo + kTile - 1) / kTile;
  const long long wstride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long t = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       t < ntiles; t += 2 * wstride) {
    long long g0[VEC], g1[VEC];
    T v0[VEC], v1[VEC];
    load_tile<T, VEC>(vals, ids, span.lo + t * kTile, span.hi, m, lane, g0, v0);
    load_tile<T, VEC>(vals, ids, span.lo + (t + wstride) * kTile, span.hi, m, lane, g1, v1);
    visit(g0, v0);
    visit(g1, v1);
  }
}

// The rows outside the tiles: at most two, one per thread of block 0.
template <typename T, typename Add>
__device__ __forceinline__ void for_each_loose_row(const T* __restrict__ vals,
                                                   const long long* __restrict__ ids,
                                                   long long n, Span span, long long m, Add add) {
  if (blockIdx.x != 0) return;
  const long long before = span.lo, after = n - span.hi;
  if (threadIdx.x < before + after) {
    const long long row = threadIdx.x < before ? threadIdx.x : span.hi + (threadIdx.x - before);
    const long long g = ids[row];
    if (g >= 0 && g < m) add(g, vals[row]);
  }
}

// ---- few: register accumulators ---------------------------------------
template <typename T, int VEC, int M>
__global__ void __launch_bounds__(kThreads) segment_sum_few(
    const T* __restrict__ vals, const long long* __restrict__ ids, long long n, long long m,
    Span span, T* __restrict__ out) {
  __shared__ T part[kWarps][M];
  T acc[M];
#pragma unroll
  for (int s = 0; s < M; ++s) acc[s] = T(0);
  auto add = [&](long long g, T x) {
#pragma unroll
    for (int s = 0; s < M; ++s) acc[s] += (g == s) ? x : T(0);
  };
  for_each_loose_row<T>(vals, ids, n, span, m, add);
  for_each_tile<T, VEC>(vals, ids, span, m, [&](long long (&g)[VEC], T (&v)[VEC]) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) add(g[e], v[e]);
  });
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < M; ++s) {
    T x = acc[s];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
    if (lane == 0) part[warp][s] = x;
  }
  __syncthreads();
  if (threadIdx.x < m) {
    T x = part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x += part[w][threadIdx.x];
    // A zero partial changes nothing: out starts at +0 and +0 + -0 == +0.
    if (x != T(0)) atomic_add(&out[threadIdx.x], x);
  }
}

// ---- mid: shared partials, equal ids summed in the warp first ---------
// The sum of x over the lanes in `peers` (this lane's group), valid in
// the group's lowest lane: a tree over the group's members in lane
// order, log2(group size) shuffles.  Every lane of the warp takes part.
template <typename T>
__device__ __forceinline__ T sum_peers(unsigned peers, T x, int lane) {
  unsigned rank = __popc(peers & ((1u << lane) - 1));  // members below this lane
  unsigned rest = peers & (0xfffffffeu << lane);       // members above it, still summing
  while (__any_sync(kFull, rest != 0)) {
    const int next = __ffs(rest);  // 1 + the next member above, or 0
    const T t = __shfl_sync(kFull, x, next ? next - 1 : lane);
    if (next) x += t;
    // members of odd rank have handed their sum down: drop them
    rest &= ~__ballot_sync(kFull, rank & 1);
    rank >>= 1;
  }
  return x;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) segment_sum_mid(
    const T* __restrict__ vals, const long long* __restrict__ ids, long long n, long long m,
    Span span, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* part = reinterpret_cast<T*>(smem_raw);
  for (long long s = threadIdx.x; s < m; s += blockDim.x) part[s] = T(0);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for_each_loose_row<T>(vals, ids, n, span, m, [&](long long g, T x) { atomic_add(&part[g], x); });
  for_each_tile<T, VEC>(vals, ids, span, m, [&](long long (&g)[VEC], T (&v)[VEC]) {
    if (VEC == 2 && g[0] == g[VEC - 1]) {  // both rows of the thread in one group
      v[VEC - 1] += v[0];
      g[0] = -1 - 2 * lane;  // the unique id of an empty row
      v[0] = T(0);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const unsigned peers = __match_any_sync(kFull, static_cast<unsigned long long>(g[e]));
      const T x = sum_peers(peers, v[e], lane);
      if (g[e] >= 0 && (peers & ((1u << lane) - 1)) == 0) atomic_add(&part[g[e]], x);
    }
  });
  __syncthreads();
  for (long long s = threadIdx.x; s < m; s += blockDim.x) {
    const T x = part[s];
    if (x != T(0)) atomic_add(&out[s], x);
  }
}

// ---- many: runs of equal ids summed in the warp, then global atomics ---
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) segment_sum_many(
    const T* __restrict__ vals, const long long* __restrict__ ids, long long n, long long m,
    Span span, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  for_each_loose_row<T>(vals, ids, n, span, m, [&](long long g, T x) { atomic_add(&out[g], x); });
  for_each_tile<T, VEC>(vals, ids, span, m, [&](long long (&g)[VEC], T (&v)[VEC]) {
    // The tile's rows in order are lane 0's VEC rows, then lane 1's, ...
    // A row starts a run when its id differs from the row before it.
    const long long prev = __shfl_up_sync(kFull, g[VEC - 1], 1);
    const bool head0 = lane == 0 || prev != g[0];
    const bool head1 = VEC == 2 && g[VEC - 1] != g[0];
    // the sum of this thread's last run (all of its rows if none starts here)
    T x = (VEC == 2 && !head1) ? v[0] + v[VEC - 1] : v[VEC - 1];
    // segmented inclusive scan over lanes: each lane sums back to the
    // nearest lane at or below it in which a run starts
    const unsigned starts = __ballot_sync(kFull, head0 || head1);
    const int first = 31 - __clz(starts & ((2u << lane) - 1));
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(kFull, x, d);
      if (lane - d >= first) x += y;
    }
    const T carry = __shfl_up_sync(kFull, x, 1);  // the run reaching into this lane
    const bool next_head0 = __shfl_down_sync(kFull, head0, 1);
    const bool last_ends = lane == 31 || next_head0;
    const T e0 = head0 ? v[0] : carry + v[0];  // the run's sum up to row 0
    if (VEC == 2) {
      if (head1 && g[0] >= 0) atomic_add(&out[g[0]], e0);  // row 0 ends its run
      const T e1 = head1 ? v[VEC - 1] : e0 + v[VEC - 1];
      if (last_ends && g[VEC - 1] >= 0) atomic_add(&out[g[VEC - 1]], e1);
    } else if (last_ends && g[0] >= 0) {
      atomic_add(&out[g[0]], e0);
    }
  });
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// Blocks of `kernel` that fit on the card at once with `smem` bytes each.
template <typename K>
long long resident_blocks(K kernel, size_t smem) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  return static_cast<long long>(per_sm > 0 ? per_sm : 1) * sm_count();
}

template <typename T, int VEC, typename K>
void run(K kernel, size_t smem, const T* v, const long long* g, long long n, long long m,
         Span span, T* o, cudaStream_t stream) {
  // two tiles a warp and step, so no more blocks than keep every warp busy
  const long long want = (n + 2LL * kThreads * VEC - 1) / (2LL * kThreads * VEC);
  long long cap = resident_blocks(kernel, smem);
  // every block of the mid path flushes all m partials: a few blocks per SM
  if (smem > 0 && cap > 4LL * sm_count()) cap = 4LL * sm_count();
  const int blocks = static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
  kernel<<<blocks, kThreads, smem, stream>>>(v, g, n, m, span, o);
}

template <typename T, int VEC>
int launch_path(int path, const T* v, const long long* g, long long n, long long m, Span span,
                T* o, cudaStream_t s) {
  switch (path) {
    case kFew:
      if (m <= 1) run<T, VEC>(segment_sum_few<T, VEC, 1>, 0, v, g, n, m, span, o, s);
      else if (m <= 2) run<T, VEC>(segment_sum_few<T, VEC, 2>, 0, v, g, n, m, span, o, s);
      else if (m <= 4) run<T, VEC>(segment_sum_few<T, VEC, 4>, 0, v, g, n, m, span, o, s);
      else if (m <= 8) run<T, VEC>(segment_sum_few<T, VEC, 8>, 0, v, g, n, m, span, o, s);
      else if (m <= kFewSlots) run<T, VEC>(segment_sum_few<T, VEC, kFewSlots>, 0, v, g, n, m, span, o, s);
      else return static_cast<int>(cudaErrorInvalidValue);
      return 0;
    case kMid:
      if (m > kSmemSlots) return static_cast<int>(cudaErrorInvalidValue);
      run<T, VEC>(segment_sum_mid<T, VEC>, static_cast<size_t>(m) * sizeof(T), v, g, n, m, span,
                  o, s);
      return 0;
    case kMany:
      run<T, VEC>(segment_sum_many<T, VEC>, 0, v, g, n, m, span, o, s);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(int path, const void* vals, const void* ids, long long n, long long m, void* out,
           cudaStream_t stream) {
  const T* v = static_cast<const T*>(vals);
  const long long* g = static_cast<const long long*>(ids);
  T* o = static_cast<T*>(out);
  // Pairs of rows load as one 16-byte id load and one 2 * sizeof(T) value
  // load: start at the first row where both are aligned, if there is one.
  const long long lead = (reinterpret_cast<uintptr_t>(g) % 16) ? 1 : 0;
  const bool paired = (reinterpret_cast<uintptr_t>(v + lead) % (2 * sizeof(T))) == 0 &&
                      n - lead >= 2;
  if (paired) {
    const Span span{lead, lead + (n - lead) / 2 * 2};
    return launch_path<T, 2>(path, v, g, n, m, span, o, stream);
  }
  return launch_path<T, 1>(path, v, g, n, m, Span{0, n}, o, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float64, 2 = int64.  path: 0 = few (m <= 16),
// 1 = mid (m <= 4096), 2 = many (any m).  n > 0 and m > 0.
extern "C" int repro_segment_sum(int dtype, int path, const void* vals, const void* ids,
                                 long long n, long long m, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case 0: err = launch<float>(path, vals, ids, n, m, out, s); break;
    case 1: err = launch<double>(path, vals, ids, n, m, out, s); break;
    case 2: err = launch<long long>(path, vals, ids, n, m, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
