// First occurrence of a byte pattern in each row of a packed string
// tensor, and the two-pattern test built on it (the string predicates
// behind TPC-H q9, q13 and q16).
//
// Replaces the TPU kernels `substr_find_pallas` and `exists_before_pallas`
// (src/repro/kernels/substr_find.py).  The TPU kernel compares a 512-row
// block against the pattern as m shifted vector compares over all L bytes
// of every row, with the pattern baked into the compiled kernel, and
// `exists_before_pallas` runs it twice.  Here the patterns are runtime
// arguments (device pointers), so one build serves every pattern, and
// exists_before is one launch.
//
// Semantics, per row r with length len[r] and end = min(len[r], L):
//   find: the least pos with pos >= start[r] (when start is given),
//     pos + m <= end and packed[r, pos : pos + m] == pattern, else -1.
//     The caller handles m == 0 (every row gives 0) and m > L (every row
//     gives -1) without a launch.
//   exists_before: fa = find(a) (0 when a is empty, as find gives); true
//     where fa >= 0 and b occurs at some pos >= fa + len(a) with
//     pos + len(b) <= end (an empty b occurs at once).  The caller
//     handles len(a) > L or len(b) > L (every row false) without a launch.
//
// What bounds it on an H100: bytes.  A row needs its bytes up to its
// scan end, which on most rows is its length (about 55 of the 128 bytes
// of a q13 comment: "special" is in 1 % of them), plus its length read
// and its result written; a compare per byte is far below the operation
// rate.  What keeps a kernel from that bound is latency: each row is a
// short read of its own, so many rows must be in flight.  The first
// design (one warp scanning one row at a time, a dependent load of the
// length first) had one row's bytes in flight per warp and ran at 9 x its
// bound; searching each row with a group of 8 lanes spends most of its
// instructions on shuffles, reductions and idle lanes.  This design:
//   * a warp takes 32 rows at a time, one a lane, and the lengths of its
//     next 32 rows are loaded before the current ones are searched, so a
//     step waits on one round trip to memory, not two;
//   * each row's live span ([start, end) for find, [0, end) for
//     exists_before) is copied into its lane's shared buffer as the
//     16-byte aligned chunks that overlap it, and no more: 8 lanes copy
//     one row's chunks (cp.async, lane k taking chunks k, k + 8, ...), so
//     one copy instruction covers 4 rows' contiguous spans.  Bytes of a
//     neighbouring row, or just outside the tensor, that share an aligned
//     chunk with the span are copied and never looked at, so any base
//     address and any L take this one path (an aligned 16-byte chunk
//     never crosses a page).  A row's buffer is an odd number of chunks,
//     so 8 lanes reading their rows' chunks hit distinct banks;
//   * each lane then searches its own row, a chunk a step: per 4-byte
//     word, the word xor the pattern's first byte, or'd with the word
//     shifted on by one byte (__funnelshift_r with the next word) xor its
//     second byte, has a zero byte exactly at each position where both
//     match (an exact SWAR zero-byte test), and only those candidates
//     compare the rest of the pattern with the staged bytes.  Positions
//     grow, so the first verified candidate is the answer;
//   * exists_before searches b from fa + len(a) in the bytes already
//     staged, and only on rows where a was found: each row is read once.
// The grid is one wave (occupancy calculator) and the warps walk the
// rows in a persistent loop.  Shared memory (144 bytes a row at L = 128)
// and 40 registers a thread allow 48 warps an SM, so 1,536 rows in
// flight.  Designs that overlap a step's copies with its search by a
// second set of buffers, or that pack two rows a lane, hold fewer warps
// or spill, and measured slower; so did a grid that evens out the steps
// per warp with fewer warps.
//
// C interface: one function, loaded with ctypes.  It launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpRows = 32;          // rows a warp takes at a time: one a lane
constexpr int kMaxWarps = 8;           // warps of a block: 256 threads
constexpr int kBlockBudget = 48 * 1024;  // shared bytes a block spends before it takes fewer warps
constexpr int kMaxSmem = 227 * 1024;   // shared bytes a block can have on sm_90
constexpr unsigned kFull = 0xffffffffu;

struct Pattern {
  const uint8_t* bytes;
  int m;
  uint32_t first, second;  // pattern bytes 0 and 1, each in all four bytes of a word
};

__device__ __forceinline__ Pattern make_pattern(const uint8_t* p, int m) {
  Pattern pat{p, m, 0u, 0u};
  if (m > 0) pat.first = 0x01010101u * p[0];
  if (m > 1) pat.second = 0x01010101u * p[1];
  return pat;
}

__device__ __forceinline__ void cp_async16(void* dst, uintptr_t src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 0x80 in each byte of t that is 0, else 0; exact (no carry crosses a byte).
__device__ __forceinline__ uint32_t zero_bytes(uint32_t t) {
  return ~(((t & 0x7f7f7f7fu) + 0x7f7f7f7fu) | t | 0x7f7f7f7fu);
}

// 0x80 in each byte of word x (followed by word y) at which the pattern's
// first byte occurs, followed (m > 1) by its second.
__device__ __forceinline__ uint32_t candidates(uint32_t x, uint32_t y, const Pattern& pat) {
  uint32_t t = x ^ pat.first;
  if (pat.m > 1) t |= __funnelshift_r(x, y, 8) ^ pat.second;
  return zero_bytes(t);
}

// Verify the candidates `hit` of the word at position pos (0x80 in each
// candidate byte): the first that is a match in [lo, hi] goes to *found;
// returns whether the search is over (a match, or positions past hi).
__device__ __forceinline__ bool verify(uint32_t hit, int pos, const uint8_t* buf, int base, int lo,
                                       int hi, const Pattern& pat, int* found) {
  for (; hit != 0u; hit &= hit - 1u) {
    const int p = pos + ((__ffs(hit) - 1) >> 3);
    if (p < lo) continue;
    if (p > hi) return true;  // positions only grow from here
    const uint8_t* s = buf + (p - base);
    int t = 2;  // bytes 0 and 1 passed the filter
    while (t < pat.m && s[t] == __ldg(pat.bytes + t)) ++t;
    if (t >= pat.m) {
      *found = p;
      return true;
    }
  }
  return false;
}

// The least pos in [lo, hi] where `pat` occurs in one lane's staged row,
// or -1.  buf holds `chunks` 16-byte chunks, buf[i] the row's byte at
// position base + i (base <= lo); every byte of [lo, hi + m) is staged.
__device__ __forceinline__ int lane_find(const uint8_t* buf, int base, int chunks, int lo, int hi,
                                         const Pattern& pat) {
  const uint4* c4 = reinterpret_cast<const uint4*>(buf);
  int c = (lo - base) >> 4;
  const int c_last = (hi - base) >> 4;  // the chunk of the last position
  uint4 cur = c4[c];
  int found = -1;
  for (; c <= c_last; ++c) {
    // past the last staged chunk no position can match: its bytes read as 0
    const uint4 nxt = c + 1 < chunks ? c4[c + 1] : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t h0 = candidates(cur.x, cur.y, pat), h1 = candidates(cur.y, cur.z, pat),
                   h2 = candidates(cur.z, cur.w, pat), h3 = candidates(cur.w, nxt.x, pat);
    if ((h0 | h1 | h2 | h3) != 0u) {
      const int pos = base + 16 * c;
      if (verify(h0, pos, buf, base, lo, hi, pat, &found) ||
          verify(h1, pos + 4, buf, base, lo, hi, pat, &found) ||
          verify(h2, pos + 8, buf, base, lo, hi, pat, &found) ||
          verify(h3, pos + 12, buf, base, lo, hi, pat, &found))
        return found;
    }
    cur = nxt;
  }
  return -1;
}

// Where one lane's row lies: its first position to search (lo), its end,
// the position of its first staged byte (base, 16-byte aligned in
// memory), and how many chunks are staged (0: the row cannot match).
struct Span {
  int lo, end, base, chunks;
};

__device__ __forceinline__ Span span_of(uintptr_t origin, long long r, bool live, int len, int st,
                                        int L, int need) {
  Span sp;
  sp.lo = max(st, 0);
  sp.end = min(len, L);
  sp.base = sp.lo - static_cast<int>((origin + r * L + sp.lo) & 15);
  sp.chunks = live && need > 0 && sp.end - need >= sp.lo ? (sp.end - sp.base + 15) >> 4 : 0;
  return sp;
}

// Copy the staged chunks of the warp's rows row0 .. row0 + rows - 1 into
// their buffers: 8 lanes a row, 4 rows a round, lane k taking chunks
// k, k + 8, ...  Every lane of the warp calls it.
__device__ __forceinline__ void stage(uintptr_t origin, long long row0, int L, int rows,
                                      int rowcap, const Span& sp, uint8_t* bufs, int lane) {
  for (int q0 = 0; q0 < rows; q0 += 4) {
    const int q = q0 + (lane >> 3);
    const int qc = __shfl_sync(kFull, sp.chunks, q & 31);
    const int qb = __shfl_sync(kFull, sp.base, q & 31);
    if (q < rows) {
      const uintptr_t src = origin + static_cast<uintptr_t>((row0 + q) * L + qb);
      for (int c = lane & 7; c < qc; c += 8) cp_async16(bufs + q * rowcap + 16 * c, src + 16 * c);
    }
  }
}

template <bool kExists>
__device__ __forceinline__ void scan_rows(const uint8_t* __restrict__ packed,
                                          const int32_t* __restrict__ lens,
                                          const int32_t* __restrict__ start,
                                          const uint8_t* pat_a, int ma, const uint8_t* pat_b,
                                          int mb, long long n, int L, int rows, int rowcap,
                                          void* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t staged[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  uint8_t* const bufs = staged + static_cast<size_t>(warp) * rows * rowcap;
  const uint8_t* const mine = bufs + lane * rowcap;  // lane < rows
  const Pattern a = make_pattern(pat_a, ma);
  const Pattern b = kExists ? make_pattern(pat_b, mb) : Pattern{nullptr, 0, 0u, 0u};
  // a row is staged only where the first search can match (for
  // exists_before with an empty a, the search for b)
  const int need = kExists ? (ma > 0 ? ma : mb) : ma;
  const uintptr_t origin = reinterpret_cast<uintptr_t>(packed);
  const long long stride = static_cast<long long>(gridDim.x) * warps * rows;
  long long row0 = (static_cast<long long>(blockIdx.x) * warps + warp) * rows;
  // lane q < rows reads the length (and start) of row r0 + q
  auto read = [&](long long r0, int& len, int& st) {
    len = 0;
    st = 0;
    if (lane < rows && r0 + lane < n) {
      len = lens[r0 + lane];
      if (start != nullptr) st = start[r0 + lane];
    }
  };
  int len, st;
  read(row0, len, st);
  for (; row0 < n; row0 += stride) {
    const long long r = row0 + lane;
    const bool live = lane < rows && r < n;
    const Span sp = span_of(origin, r, live, len, st, L, need);
    stage(origin, row0, L, rows, rowcap, sp, bufs, lane);
    // the next rows' lengths are in flight while these rows are searched
    read(row0 + stride, len, st);
    cp_async_wait_all();
    __syncwarp();
    if (live) {
      if (!kExists) {
        static_cast<int32_t*>(out)[r] =
            sp.chunks > 0 ? lane_find(mine, sp.base, sp.chunks, sp.lo, sp.end - ma, a) : -1;
      } else {
        const int fa = ma == 0 ? 0
                       : sp.chunks > 0 ? lane_find(mine, sp.base, sp.chunks, 0, sp.end - ma, a)
                                       : -1;
        bool hit = false;
        if (fa >= 0) {
          hit = mb == 0 || (sp.end - mb >= fa + ma &&
                            lane_find(mine, sp.base, sp.chunks, fa + ma, sp.end - mb, b) >= 0);
        }
        static_cast<uint8_t*>(out)[r] = hit;
      }
    }
    __syncwarp();  // the warp is done with its buffers before the next copies land
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    substr_find_rows(const uint8_t* packed, const int32_t* lens, const int32_t* start,
                     const uint8_t* pat, int m, long long n, int L, int rows, int rowcap,
                     int32_t* out) {
  scan_rows<false>(packed, lens, start, pat, m, nullptr, 0, n, L, rows, rowcap, out);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    exists_before_rows(const uint8_t* packed, const int32_t* lens, const uint8_t* pat_a, int ma,
                       const uint8_t* pat_b, int mb, long long n, int L, int rows, int rowcap,
                       uint8_t* out) {
  scan_rows<true>(packed, lens, nullptr, pat_a, ma, pat_b, mb, n, L, rows, rowcap, out);
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = sms > 0 ? sms : 1;
  }
  return cached[dev];
}

// Blocks of `kernel` that fit on one SM with `threads` threads and `smem`
// bytes each; the last answer per kernel is kept, as the main path asks
// the same question on every call.
template <typename K>
int blocks_per_sm(K kernel, int slot, int threads, int smem) {
  static int last[2][3] = {{0, 0, 0}, {0, 0, 0}};  // threads, smem, blocks
  int* c = last[slot];
  if (c[0] != threads || c[1] != smem || c[2] == 0) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    c[0] = threads;
    c[1] = smem;
    c[2] = per_sm > 0 ? per_sm : 1;
  }
  return c[2];
}

}  // namespace

// mode 0 (find): pat_a (ma,) with 1 <= ma <= L, start (n,) int32 or null,
// out (n,) int32.  mode 1 (exists_before): pat_a (ma,), pat_b (mb,) with
// 0 <= ma, mb <= L, start null, out (n,) bool.  packed (n, L) uint8 at any
// address, lens (n,) int32; n > 0.  A row longer than one block's shared
// memory holds (L above about 232 K) is refused with cudaErrorInvalidValue.
extern "C" int repro_substr_find(int mode, const void* packed, const void* lens,
                                 const void* start, const void* pat_a, int ma, const void* pat_b,
                                 int mb, long long n, int L, void* out, void* stream) {
  if (n <= 0 || L <= 0 || ma < 0 || ma > L || mb < 0 || mb > L) return cudaErrorInvalidValue;
  if (mode == 0 ? ma == 0 : (mode != 1 || start != nullptr)) return cudaErrorInvalidValue;
  // a row's staged chunks: at most (L + 14) / 16 + 1, rounded up to an odd
  // number so that lanes reading their rows' chunks hit distinct banks
  const int row_chunks = ((L + 14) / 16 + 1) | 1;
  const int rowcap = 16 * row_chunks;
  if (rowcap > kMaxSmem) return cudaErrorInvalidValue;
  int rows = kWarpRows, warps = kMaxWarps;
  while (rows > 1 && rows * rowcap > kMaxSmem) rows /= 2;
  while (warps > 1 && warps * rows * rowcap > kBlockBudget) warps /= 2;
  const int threads = warps * 32;
  const int smem = warps * rows * rowcap;
  const long long per_block = static_cast<long long>(warps) * rows;
  const long long want = (n + per_block - 1) / per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const int32_t* l = static_cast<const int32_t*>(lens);
  const uint8_t* a = static_cast<const uint8_t*>(pat_a);
  if (mode == 0) {
    const long long cap = static_cast<long long>(blocks_per_sm(substr_find_rows, 0, threads, smem)) * sm_count();
    const int blocks = static_cast<int>(want < cap ? want : cap);
    substr_find_rows<<<blocks, threads, smem, s>>>(p, l, static_cast<const int32_t*>(start), a, ma,
                                                   n, L, rows, rowcap, static_cast<int32_t*>(out));
  } else {
    const long long cap = static_cast<long long>(blocks_per_sm(exists_before_rows, 1, threads, smem)) * sm_count();
    const int blocks = static_cast<int>(want < cap ? want : cap);
    exists_before_rows<<<blocks, threads, smem, s>>>(p, l, a, ma, static_cast<const uint8_t*>(pat_b),
                                                     mb, n, L, rows, rowcap, static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
