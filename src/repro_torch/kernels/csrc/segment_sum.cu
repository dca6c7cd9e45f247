// Per-segment sum over segment ids in any order (the group-by sum),
// deterministic: every launch on a card returns the same bits.
//
// Replaces the TPU kernel `segment_sum_sorted_pallas`
// (src/repro/kernels/segment_reduce.py, body `_kernel`), which ranks
// sorted ids inside a 512-row block and reduces the block with one MXU
// one-hot product.  The engine's group ids come in row order, not
// sorted, and its measures are float64 and its counts int64, so this
// kernel takes float32, float64 and int64 values with int64 ids in any
// order.  Ids outside [0, num_segments) are dropped, as
// jax.ops.segment_sum drops them (the compiled SQL path sends its padding
// rows to id num_segments).
//
// Determinism.  Float addition is not associative, so float atomics
// (whose order changes from launch to launch) change a sum's last bits.
// Integer addition is exact in any order, so float sums are made integer
// sums: each segment gets a grid, 2^(E - kFrac), where 2^E bounds the
// |value| of every finite row of that segment, and each value is rounded
// to it and split into three 32-bit limbs held in int64 (|v| = l2 2^64
// + l1 2^32 + l0, l0 and l1 in [0, 2^32], each limb taking v's sign).
// Limbs add with int64 atomics, exactly and in any order, for up to 2^31
// rows.  Each segment's
// limbs then become one correctly rounded float.  The grid is the
// segment's own, so a segment of 1e-15s beside one of 1e15s keeps its
// 80 bits; within a segment the rounding is at most n 2^-kFrac of its
// largest |value|.  NaN and infinities are kept as flags per segment (any
// NaN, or +inf with -inf, gives NaN), as a sum in any order gives them.
// So a float call makes three passes over the rows' segment structure:
//   1. the largest exponent and the flags of each segment (max and or,
//      order-free),
//   2. the limbs of each row on its segment's grid, added,
//   3. each segment's limbs to its float (one thread a segment).
// int64 values are their own limb: one pass, adds wrap as two's
// complement does.
//
// What bounds it on an H100: bytes.  Each row is read once a pass (a
// value and an 8-byte id) and each segment written once; there are no
// operations to speak of.  What stands between a pass and that bound is
// the atomics: many rows adding into one address serialise.  So every
// pass has three paths, chosen by the caller from m = num_segments:
//   * few (m <= kFewSlots; TPC-H q1: 6 M rows into 6 slots): no atomics
//     per row.  Each thread keeps kFewSlots-or-fewer accumulators in
//     registers and folds each row into the one its id selects (compare
//     and select); at the end each warp reduces every slot with shuffles,
//     the block folds its warps' partials in shared memory, and each block
//     folds each non-empty slot into device memory once.
//   * mid (m <= kSmemSlots): shared-memory partials per block, flushed
//     once per block; before a row's shared atomic the warp finds the
//     lanes holding the same id (__match_any_sync) and folds them with a
//     log-step shuffle tree led by the lowest lane, so 32 rows with 6
//     distinct ids make 6 shared atomics, not 32.
//   * many (q18: 6 M rows into 1.5 M orders): partials would not fit in
//     shared memory, so rows fold straight into device memory.  Group ids
//     come in runs (lineitem is generated in order key order), so a warp
//     first folds runs of equal ids over neighbouring rows with a
//     segmented shuffle scan, and only the last row of each run makes
//     the global atomic.
// Every path loads two rows a thread as one 16-byte load of ids and one
// load of values where both pointers allow it (a scalar row before and
// after), else one row a thread.  A warp works on a tile of 32 or 64
// consecutive rows, two tiles in flight.  The grid is at most what fits
// on the card at once, so no block waits for a second wave (the mid
// path, whose every block flushes all m partials, at most 4 per SM).
//
// C interface: one function, loaded with ctypes.  It launches on the
// given stream and allocates nothing: the caller zeroes `out` and, for
// float values, passes `scratch` of 32 * m bytes, 8-byte aligned (zeroed
// here by a kernel on the stream), so a CUDA graph captures a call whole.
// It returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFewSlots = 16;
constexpr long long kSmemSlots = 4096;
enum Path { kFew = 0, kMid = 1, kMany = 2 };

// Bits of a segment's grid below its top exponent, and the bias that
// keeps a stored exponent above 0 (0 marks a segment with no finite
// non-zero row).
constexpr int kFrac = 80;
constexpr int kBias = 2048;
constexpr unsigned kNan = 1u, kPosInf = 2u, kNegInf = 4u;
constexpr long long kLow32 = 0xffffffffLL;

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };
template <> struct Pair<long long> { using type = longlong2; };

// ---- accumulators: K words, folded by the pass's op -------------------
template <typename W, int K>
struct Acc {
  W w[K];
};

template <typename W, int K>
__device__ __forceinline__ Acc<W, K> shfl(Acc<W, K> a, int src) {
#pragma unroll
  for (int k = 0; k < K; ++k) a.w[k] = __shfl_sync(kFull, a.w[k], src);
  return a;
}
template <typename W, int K>
__device__ __forceinline__ Acc<W, K> shfl_up(Acc<W, K> a, int d) {
#pragma unroll
  for (int k = 0; k < K; ++k) a.w[k] = __shfl_up_sync(kFull, a.w[k], d);
  return a;
}
template <typename W, int K>
__device__ __forceinline__ Acc<W, K> shfl_xor(Acc<W, K> a, int d) {
#pragma unroll
  for (int k = 0; k < K; ++k) a.w[k] = __shfl_xor_sync(kFull, a.w[k], d);
  return a;
}

__device__ __forceinline__ void atomic_add(long long* addr, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(addr), static_cast<unsigned long long>(v));
}

// A pass: how a row becomes an accumulator (`make`, given its segment's
// stored exponent where kNeedsExp), how two fold (`fold`, associative and
// commutative, so any order gives the same bits), and how a partial folds
// into a slot of a table (`store`; slot s of a table is words
// [s * K, s * K + K)).
// int64 values: one exact add.
struct IntSum {
  using Word = long long;
  static constexpr int K = 1;
  using A = Acc<Word, K>;
  static constexpr bool kNeedsExp = false;
  template <typename T>
  __device__ static A make(T v, unsigned) { return A{{static_cast<long long>(v)}}; }
  __device__ static A zero() { return A{{0}}; }
  __device__ static A fold(A a, const A& b) { a.w[0] += b.w[0]; return a; }
  __device__ static bool empty(const A& a) { return a.w[0] == 0; }
  __device__ static void store(long long* tab, long long s, const A& a) {
    atomic_add(&tab[s], a.w[0]);
  }
};

// Float pass 1: the segment's largest exponent (biased) and its flags.
struct ExpFlags {
  using Word = unsigned;
  static constexpr int K = 2;
  using A = Acc<Word, K>;
  static constexpr bool kNeedsExp = false;
  template <typename T>
  __device__ static A make(T v, unsigned) {
    const double x = static_cast<double>(v);
    const unsigned long long bits = static_cast<unsigned long long>(__double_as_longlong(x));
    const int field = static_cast<int>((bits >> 52) & 0x7ff);
    if (field == 0x7ff) {
      if (bits << 12) return A{{0u, kNan}};
      return A{{0u, x > 0 ? kPosInf : kNegInf}};
    }
    if ((bits << 1) == 0) return A{{0u, 0u}};
    // |x| < 2^e: a normal x is 1.f 2^(field - 1023)
    const int e = field ? field - 1022 : ilogb(x) + 1;
    return A{{static_cast<unsigned>(e + kBias), 0u}};
  }
  __device__ static A zero() { return A{{0u, 0u}}; }
  __device__ static A fold(A a, const A& b) {
    a.w[0] = max(a.w[0], b.w[0]);
    a.w[1] |= b.w[1];
    return a;
  }
  __device__ static bool empty(const A& a) { return a.w[0] == 0u && a.w[1] == 0u; }
  __device__ static void store(unsigned* tab, long long s, const A& a) {
    if (a.w[0]) atomicMax(&tab[2 * s], a.w[0]);
    if (a.w[1]) atomicOr(&tab[2 * s + 1], a.w[1]);
  }
};

// x 2^k: one product by a power of two where 2^k is a normal double,
// else ldexp.
__device__ __forceinline__ double scale2(double x, int k) {
  if (k >= -1022 && k <= 1023) {
    return x * __longlong_as_double(static_cast<long long>(k + 1023) << 52);
  }
  return ldexp(x, k);
}

// Float pass 2: the row rounded to its segment's grid, as three limbs.
struct LimbSum {
  using Word = long long;
  static constexpr int K = 3;
  using A = Acc<Word, K>;
  static constexpr bool kNeedsExp = true;
  template <typename T>
  __device__ static A make(T v, unsigned be) {
    const double x = static_cast<double>(v);
    if (be == 0u || !isfinite(x) || x == 0.0) return zero();
    // |x| on the grid: a power-of-two scaling (exact) to s < 2^80, split
    // exactly at 2^64 and 2^32, the lowest limb rounded to nearest
    const double s = scale2(fabs(x), kFrac - (static_cast<int>(be) - kBias));
    const double t2 = floor(s * 0x1p-64);
    const double r = s - t2 * 0x1p64;  // in [0, 2^64)
    const double t1 = floor(r * 0x1p-32);
    const double t0 = rint(r - t1 * 0x1p32);  // in [0, 2^32]
    const long long sign = x < 0 ? -1 : 1;
    return A{{sign * static_cast<long long>(t0), sign * static_cast<long long>(t1),
              sign * static_cast<long long>(t2)}};
  }
  __device__ static A zero() { return A{{0, 0, 0}}; }
  __device__ static A fold(A a, const A& b) {
#pragma unroll
    for (int k = 0; k < 3; ++k) a.w[k] += b.w[k];
    return a;
  }
  __device__ static bool empty(const A& a) { return (a.w[0] | a.w[1] | a.w[2]) == 0; }
  __device__ static void store(long long* tab, long long s, const A& a) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (a.w[k]) atomic_add(&tab[3 * s + k], a.w[k]);
  }
};

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

// The accumulator of a loaded row: `etab[g * ES]` holds segment g's
// stored exponent (pass 2 only; ES is 1 in shared memory, 2 in pass 1's
// table).
template <typename Op, int ES, typename T>
__device__ __forceinline__ typename Op::A make_row(long long g, T v, const unsigned* etab) {
  if constexpr (Op::kNeedsExp) {
    return g >= 0 ? Op::make(v, etab[g * ES]) : Op::zero();
  } else {
    return Op::make(v, 0u);
  }
}

// Walks the warp tiles of `span`, two in flight, and hands each to
// `visit(g, a)` with each row's accumulator.  The loop is uniform over the
// warp (shuffles inside `visit` see all 32 lanes).
template <typename Op, int ES, typename T, int VEC, typename Visit>
__device__ __forceinline__ void for_each_tile(const T* __restrict__ vals,
                                              const long long* __restrict__ ids, Span span,
                                              long long m, const unsigned* etab, Visit visit) {
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
    typename Op::A a0[VEC], a1[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      a0[e] = make_row<Op, ES>(g0[e], v0[e], etab);
      a1[e] = make_row<Op, ES>(g1[e], v1[e], etab);
    }
    visit(g0, a0);
    visit(g1, a1);
  }
}

// The rows outside the tiles: at most two, one per thread of block 0.
template <typename Op, int ES, typename T, typename Add>
__device__ __forceinline__ void for_each_loose_row(const T* __restrict__ vals,
                                                   const long long* __restrict__ ids,
                                                   long long n, Span span, long long m,
                                                   const unsigned* etab, Add add) {
  if (blockIdx.x != 0) return;
  const long long before = span.lo, after = n - span.hi;
  if (threadIdx.x < before + after) {
    const long long row = threadIdx.x < before ? threadIdx.x : span.hi + (threadIdx.x - before);
    const long long g = ids[row];
    if (g >= 0 && g < m) add(g, make_row<Op, ES>(g, vals[row], etab));
  }
}

// Copies each segment's stored exponent (pass 1's table, two words a
// segment) into shared memory for pass 2 of the few and mid paths.
__device__ __forceinline__ void load_exps(unsigned* dst, const unsigned* etab, long long m) {
  for (long long s = threadIdx.x; s < m; s += blockDim.x) dst[s] = etab[2 * s];
}

// ---- few: register accumulators ---------------------------------------
template <typename Op, typename T, int VEC, int M>
__global__ void __launch_bounds__(kThreads) segment_sum_few(
    const T* __restrict__ vals, const long long* __restrict__ ids, long long n, long long m,
    Span span, const unsigned* __restrict__ etab, void* __restrict__ table) {
  using A = typename Op::A;
  __shared__ A part[kWarps][M];
  __shared__ unsigned exps[M];
  if constexpr (Op::kNeedsExp) {
    load_exps(exps, etab, m);
    __syncthreads();
  }
  A acc[M];
#pragma unroll
  for (int s = 0; s < M; ++s) acc[s] = Op::zero();
  auto add = [&](long long g, const A& x) {
#pragma unroll
    for (int s = 0; s < M; ++s)
      if (g == s) acc[s] = Op::fold(acc[s], x);
  };
  for_each_loose_row<Op, 1, T>(vals, ids, n, span, m, exps, add);
  for_each_tile<Op, 1, T, VEC>(vals, ids, span, m, exps, [&](long long (&g)[VEC], A (&a)[VEC]) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) add(g[e], a[e]);
  });
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < M; ++s) {
    A x = acc[s];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = Op::fold(x, shfl_xor(x, off));
    if (lane == 0) part[warp][s] = x;
  }
  __syncthreads();
  if (threadIdx.x < m) {
    A x = part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x = Op::fold(x, part[w][threadIdx.x]);
    if (!Op::empty(x)) Op::store(static_cast<typename Op::Word*>(table), threadIdx.x, x);
  }
}

// ---- mid: shared partials, equal ids folded in the warp first ---------
// The fold of x over the lanes in `peers` (this lane's group), valid in
// the group's lowest lane: a tree over the group's members in lane
// order, log2(group size) shuffles.  Every lane of the warp takes part.
template <typename Op>
__device__ __forceinline__ typename Op::A fold_peers(unsigned peers, typename Op::A x, int lane) {
  unsigned rank = __popc(peers & ((1u << lane) - 1));  // members below this lane
  unsigned rest = peers & (0xfffffffeu << lane);       // members above it, still folding
  while (__any_sync(kFull, rest != 0)) {
    const int next = __ffs(rest);  // 1 + the next member above, or 0
    const typename Op::A t = shfl(x, next ? next - 1 : lane);
    if (next) x = Op::fold(x, t);
    // members of odd rank have handed their fold down: drop them
    rest &= ~__ballot_sync(kFull, rank & 1);
    rank >>= 1;
  }
  return x;
}

template <typename Op, typename T, int VEC>
__global__ void __launch_bounds__(kThreads) segment_sum_mid(
    const T* __restrict__ vals, const long long* __restrict__ ids, long long n, long long m,
    Span span, const unsigned* __restrict__ etab, void* __restrict__ table) {
  using A = typename Op::A;
  using Word = typename Op::Word;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Word* part = reinterpret_cast<Word*>(smem_raw);
  unsigned* exps = reinterpret_cast<unsigned*>(part + m * Op::K);
  for (long long s = threadIdx.x; s < m * Op::K; s += blockDim.x) part[s] = Word(0);
  if constexpr (Op::kNeedsExp) load_exps(exps, etab, m);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for_each_loose_row<Op, 1, T>(vals, ids, n, span, m, exps,
                            [&](long long g, const A& x) { Op::store(part, g, x); });
  for_each_tile<Op, 1, T, VEC>(vals, ids, span, m, exps, [&](long long (&g)[VEC], A (&a)[VEC]) {
    if (VEC == 2 && g[0] == g[VEC - 1]) {  // both rows of the thread in one group
      a[VEC - 1] = Op::fold(a[VEC - 1], a[0]);
      g[0] = -1 - 2 * lane;  // the unique id of an empty row
      a[0] = Op::zero();
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const unsigned peers = __match_any_sync(kFull, static_cast<unsigned long long>(g[e]));
      const A x = fold_peers<Op>(peers, a[e], lane);
      if (g[e] >= 0 && (peers & ((1u << lane) - 1)) == 0 && !Op::empty(x)) Op::store(part, g[e], x);
    }
  });
  __syncthreads();
  Word* out = static_cast<Word*>(table);
  for (long long s = threadIdx.x; s < m; s += blockDim.x) {
    A x;
#pragma unroll
    for (int k = 0; k < Op::K; ++k) x.w[k] = part[s * Op::K + k];
    if (!Op::empty(x)) Op::store(out, s, x);
  }
}

// ---- many: runs of equal ids folded in the warp, then global atomics ---
template <typename Op, typename T, int VEC>
__global__ void __launch_bounds__(kThreads) segment_sum_many(
    const T* __restrict__ vals, const long long* __restrict__ ids, long long n, long long m,
    Span span, const unsigned* __restrict__ etab, void* __restrict__ table) {
  using A = typename Op::A;
  using Word = typename Op::Word;
  Word* out = static_cast<Word*>(table);
  const int lane = threadIdx.x & 31;
  for_each_loose_row<Op, 2, T>(vals, ids, n, span, m, etab,
                            [&](long long g, const A& x) { Op::store(out, g, x); });
  for_each_tile<Op, 2, T, VEC>(vals, ids, span, m, etab, [&](long long (&g)[VEC], A (&a)[VEC]) {
    // The tile's rows in order are lane 0's VEC rows, then lane 1's, ...
    // A row starts a run when its id differs from the row before it.
    const long long prev = __shfl_up_sync(kFull, g[VEC - 1], 1);
    const bool head0 = lane == 0 || prev != g[0];
    const bool head1 = VEC == 2 && g[VEC - 1] != g[0];
    // the fold of this thread's last run (all of its rows if none starts here)
    A x = (VEC == 2 && !head1) ? Op::fold(a[0], a[VEC - 1]) : a[VEC - 1];
    // segmented inclusive scan over lanes: each lane folds back to the
    // nearest lane at or below it in which a run starts
    const unsigned starts = __ballot_sync(kFull, head0 || head1);
    const int first = 31 - __clz(starts & ((2u << lane) - 1));
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const A y = shfl_up(x, d);
      if (lane - d >= first) x = Op::fold(x, y);
    }
    const A carry = shfl_up(x, 1);  // the run reaching into this lane
    const bool next_head0 = __shfl_down_sync(kFull, head0, 1);
    const bool last_ends = lane == 31 || next_head0;
    const A e0 = head0 ? a[0] : Op::fold(carry, a[0]);  // the run's fold up to row 0
    if (VEC == 2) {
      if (head1 && g[0] >= 0 && !Op::empty(e0)) Op::store(out, g[0], e0);  // row 0 ends its run
      const A e1 = head1 ? a[VEC - 1] : Op::fold(e0, a[VEC - 1]);
      if (last_ends && g[VEC - 1] >= 0 && !Op::empty(e1)) Op::store(out, g[VEC - 1], e1);
    } else if (last_ends && g[0] >= 0 && !Op::empty(e0)) {
      Op::store(out, g[0], e0);
    }
  });
}

// ---- float pass 3: each segment's limbs to one float -------------------
// v = l2 2^64 + l1 2^32 + l0 (after the carries), scaled by the segment's
// grid; the magnitude is rounded to a double once (its top 64 bits with a
// sticky bit), then scaled.
__device__ __forceinline__ double limbs_to_double(long long l0, long long l1, long long l2,
                                                  int e) {
  l1 += l0 >> 32;
  l0 &= kLow32;
  l2 += l1 >> 32;
  l1 &= kLow32;
  const bool neg = l2 < 0;
  if (neg) {  // the magnitude: negate all three, carry again
    l0 = -l0;
    l1 = -l1;
    l2 = -l2;
    l1 += l0 >> 32;
    l0 &= kLow32;
    l2 += l1 >> 32;
    l1 &= kLow32;
  }
  const unsigned long long hi = static_cast<unsigned long long>(l2);
  const unsigned long long lo = (static_cast<unsigned long long>(l1) << 32) |
                                static_cast<unsigned long long>(l0);
  double d;
  if (hi == 0) {
    d = __ull2double_rn(lo);
  } else {
    const int k = 64 - __clzll(hi);  // bits of hi, 1..63
    const unsigned long long top = (hi << (64 - k)) | (lo >> k) |
                                   ((lo & ((1ULL << k) - 1)) != 0 ? 1ULL : 0ULL);
    d = ldexp(__ull2double_rn(top), k);
  }
  d = ldexp(d, e - kFrac);
  return neg ? -d : d;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) segment_sum_finish(
    const unsigned* __restrict__ etab, const long long* __restrict__ limbs, long long m,
    T* __restrict__ out) {
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; s < m;
       s += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned be = etab[2 * s], flags = etab[2 * s + 1];
    double d = 0.0;
    if ((flags & kNan) || (flags & (kPosInf | kNegInf)) == (kPosInf | kNegInf)) {
      d = __longlong_as_double(0x7ff8000000000000LL);
    } else if (flags & kPosInf) {
      d = __longlong_as_double(0x7ff0000000000000LL);
    } else if (flags & kNegInf) {
      d = -__longlong_as_double(0x7ff0000000000000LL);
    } else if (be != 0u) {
      d = limbs_to_double(limbs[3 * s], limbs[3 * s + 1], limbs[3 * s + 2],
                          static_cast<int>(be) - kBias);
    }
    out[s] = static_cast<T>(d);
  }
}

// Zeroes the scratch of a float call: 32 bytes a segment.
__global__ void __launch_bounds__(kThreads)
    segment_sum_clear(unsigned long long* __restrict__ p, long long words) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < words;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    p[i] = 0ULL;
  }
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

struct Args {
  long long n, m;
  Span span;
  const unsigned* etab;  // pass 2: pass 1's table
  void* table;           // the table this pass folds into
  cudaStream_t stream;
};

template <typename Op, typename T, int VEC, typename K>
void run(K kernel, size_t smem, const T* v, const long long* g, const Args& a) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  // two tiles a warp and step, so no more blocks than keep every warp busy
  const long long want = (a.n + 2LL * kThreads * VEC - 1) / (2LL * kThreads * VEC);
  long long cap = resident_blocks(kernel, smem);
  // every block of the mid path flushes all m partials: a few blocks per SM
  if (smem > 0 && cap > 4LL * sm_count()) cap = 4LL * sm_count();
  const int blocks = static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
  kernel<<<blocks, kThreads, smem, a.stream>>>(v, g, a.n, a.m, a.span, a.etab, a.table);
}

template <typename Op, typename T, int VEC>
int launch_path(int path, const T* v, const long long* g, const Args& a) {
  switch (path) {
    case kFew:
      if (a.m <= 1) run<Op, T, VEC>(segment_sum_few<Op, T, VEC, 1>, 0, v, g, a);
      else if (a.m <= 2) run<Op, T, VEC>(segment_sum_few<Op, T, VEC, 2>, 0, v, g, a);
      else if (a.m <= 4) run<Op, T, VEC>(segment_sum_few<Op, T, VEC, 4>, 0, v, g, a);
      else if (a.m <= 8) run<Op, T, VEC>(segment_sum_few<Op, T, VEC, 8>, 0, v, g, a);
      else if (a.m <= kFewSlots)
        run<Op, T, VEC>(segment_sum_few<Op, T, VEC, kFewSlots>, 0, v, g, a);
      else return static_cast<int>(cudaErrorInvalidValue);
      return 0;
    case kMid: {
      if (a.m > kSmemSlots) return static_cast<int>(cudaErrorInvalidValue);
      const size_t smem = static_cast<size_t>(a.m) * (Op::K * sizeof(typename Op::Word) +
                                                      (Op::kNeedsExp ? sizeof(unsigned) : 0));
      run<Op, T, VEC>(segment_sum_mid<Op, T, VEC>, smem, v, g, a);
      return 0;
    }
    case kMany:
      run<Op, T, VEC>(segment_sum_many<Op, T, VEC>, 0, v, g, a);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Op, typename T>
int launch_pass(int path, const T* v, const long long* g, Args a) {
  // Pairs of rows load as one 16-byte id load and one 2 * sizeof(T) value
  // load: start at the first row where both are aligned, if there is one.
  const long long lead = (reinterpret_cast<uintptr_t>(g) % 16) ? 1 : 0;
  const bool paired = (reinterpret_cast<uintptr_t>(v + lead) % (2 * sizeof(T))) == 0 &&
                      a.n - lead >= 2;
  if (paired) {
    a.span = Span{lead, lead + (a.n - lead) / 2 * 2};
    return launch_path<Op, T, 2>(path, v, g, a);
  }
  a.span = Span{0, a.n};
  return launch_path<Op, T, 1>(path, v, g, a);
}

template <typename T>
int launch_float(int path, const T* v, const long long* g, long long n, long long m, T* out,
                 void* scratch, cudaStream_t stream) {
  // scratch: the limbs (3 int64 a segment), then pass 1's table (2 words
  // a segment: biased exponent, flags)
  long long* limbs = static_cast<long long*>(scratch);
  unsigned* etab = reinterpret_cast<unsigned*>(limbs + 3 * m);
  long long clear_blocks = (4 * m + kThreads - 1) / kThreads;
  if (clear_blocks > 8LL * sm_count()) clear_blocks = 8LL * sm_count();
  segment_sum_clear<<<static_cast<int>(clear_blocks), kThreads, 0, stream>>>(
      static_cast<unsigned long long*>(scratch), 4 * m);
  const Args pass1{n, m, Span{0, n}, nullptr, etab, stream};
  int err = launch_pass<ExpFlags, T>(path, v, g, pass1);
  if (err != 0) return err;
  const Args pass2{n, m, Span{0, n}, etab, limbs, stream};
  err = launch_pass<LimbSum, T>(path, v, g, pass2);
  if (err != 0) return err;
  long long blocks = (m + kThreads - 1) / kThreads;
  if (blocks > 8LL * sm_count()) blocks = 8LL * sm_count();
  segment_sum_finish<T><<<static_cast<int>(blocks), kThreads, 0, stream>>>(etab, limbs, m, out);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = float64, 2 = int64.  path: 0 = few (m <= 16),
// 1 = mid (m <= 4096), 2 = many (any m).  n > 0 and m > 0.  `scratch`:
// 32 * m bytes for float values (unused for int64).
extern "C" int repro_segment_sum(int dtype, int path, const void* vals, const void* ids,
                                 long long n, long long m, void* out, void* scratch,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* g = static_cast<const long long*>(ids);
  int err;
  switch (dtype) {
    case 0:
      err = launch_float<float>(path, static_cast<const float*>(vals), g, n, m,
                                static_cast<float*>(out), scratch, s);
      break;
    case 1:
      err = launch_float<double>(path, static_cast<const double*>(vals), g, n, m,
                                 static_cast<double*>(out), scratch, s);
      break;
    case 2:
      err = launch_pass<IntSum, long long>(path, static_cast<const long long*>(vals), g,
                                           Args{n, m, Span{0, n}, nullptr, out, s});
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
