// First occurrence of a byte pattern in each row of a packed string
// tensor (the string predicate behind TPC-H q9, q13 and q16).
//
// Replaces the TPU kernel `substr_find_pallas`
// (src/repro/kernels/substr_find.py, body built by `_make_kernel`),
// which compares a 512-row block against the pattern as m shifted
// vector compares and bakes the pattern into the compiled kernel.  Here
// the pattern is a runtime argument (a device pointer), so one build
// serves every pattern.
//
// Semantics, per row r with length len[r]: the least pos with
// pos + m <= min(len[r], L), pos >= start[r] (when start is given) and
// packed[r, pos : pos + m] == pattern, else -1.  The caller handles
// m == 0 (every row gives 0) and m > L (every row gives -1) without a
// launch.
//
// What bounds it on an H100: bytes.  Each row's L bytes are read once
// and one int32 written; a byte compare per byte read is far below the
// card's operation rate.  The design keeps the reads coalesced: one warp
// scans one row, lane j testing position base + j, so the 32 lanes read
// 32 neighbouring bytes of the same row, and a ballot picks the first
// matching lane.  The warp stops at the first window that matches, so a
// row that matches early is not read to its end.
//
// C interface: one function, loaded with ctypes.  It launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void substr_find_rows(const uint8_t* __restrict__ packed,
                                 const int32_t* __restrict__ lens,
                                 const uint8_t* __restrict__ pat, int m,
                                 const int32_t* __restrict__ start, long long n, int L,
                                 int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long row = warp; row < n; row += nwarps) {
    const uint8_t* s = packed + row * static_cast<long long>(L);
    const int len = lens[row];
    const int last = (len < L ? len : L) - m;  // last admissible position
    int p0 = 0;
    if (start != nullptr) p0 = start[row] > 0 ? start[row] : 0;
    int found = -1;
    // row, last and p0 are the same in every lane, so the trip count is
    // warp-uniform and the full-mask ballot is safe
    for (int base = p0; base <= last; base += 32) {
      const int p = base + lane;
      bool hit = p <= last;
      for (int k = 0; hit && k < m; ++k) hit = s[p + k] == pat[k];
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (mask != 0u) {
        found = base + __ffs(mask) - 1;
        break;
      }
    }
    if (lane == 0) out[row] = found;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace

// packed (n, L) uint8, lens (n,) int32, pat (m,) uint8 with 1 <= m <= L,
// start (n,) int32 or null, out (n,) int32.  n > 0.
extern "C" int repro_substr_find(const void* packed, const void* lens, const void* pat, int m,
                                 const void* start, long long n, int L, void* out,
                                 void* stream) {
  const long long want = (n + kWarps - 1) / kWarps;
  const long long cap = 16LL * sm_count();
  const int blocks = static_cast<int>(want < cap ? want : cap);
  substr_find_rows<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<const int32_t*>(lens),
      static_cast<const uint8_t*>(pat), m, static_cast<const int32_t*>(start), n, L,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
