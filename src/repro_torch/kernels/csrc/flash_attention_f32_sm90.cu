// Causal or full grouped-query attention in float32 on Hopper's tensor
// cores, in split TF32 ("3xTF32").
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_kernel`) for float32
// inputs; bf16 inputs run csrc/flash_attention_sm90.cu, whose machinery
// this source takes over.  The TPU kernel walks a sequential kv grid
// dimension per (batch, head, q block) and carries the running max,
// denominator and accumulator in VMEM scratch; here one block owns one
// (batch, q head, 64-row q tile) and loops over the key tiles itself,
// with those three in registers.
//
// Contract, as the TPU kernel's and the bf16 kernel's: query head h reads
// kv head h / (Hq / Hkv); the causal mask keeps key j for query i when
// j <= i + (Sk - Sq), masked logits are -1e30; any Sq and Sk, ragged
// tails masked; key tiles wholly above the diagonal are not visited; q,
// k, v with any batch, head and sequence strides and a contiguous last
// dim.  D is a multiple of 16 up to 128.  Causal with Sq > Sk is refused
// by the wrapper.
//
// Float32 on the tensor cores.  One TF32 product keeps 11 bits of each
// operand's mantissa, too few for the float32 tolerance (2e-5 against
// the plain version).  Split TF32 (split_tf32.cuh, which the backward
// shares) keeps about 22: three TF32 products of hi and lo parts for
// each float32 one.
//
// What bounds it on an H100: operations.  Qwen3-14B's prefill (Hq 40,
// Hkv 8, S 4096, D 128, causal) needs 4 * Hq * D * S (S + 1) / 2 = 171.8
// GFLOP; three TF32 products for each at 495 TFLOP/s take 1.041 ms (the
// CUDA cores' 67 TFLOP/s would take 2.565 ms), against 0.060 ms for its
// 201 MB of q, k, v and o.
//
// Design.  Two kernels, launched in order on one stream by one C call.
//   1. split: q and k into (B H, S, 2 DQ) rows, hi in the first DQ
//      columns and lo in the next (DQ = D rounded up to 32, zeros past
//      D), and v into (B Hkv, 2, DV, Skp), hi then lo, transposed (DV = D
//      rounded up to 64, Skp = Sk rounded up to 32, zeros past either).
//      For .tf32 wgmma has no transpose flag: both shared-memory operands
//      must be K-major, and for O += P V that is V^T.  The scratch is one
//      buffer of the wrapper's (0.35 GB at Qwen3-14B's shape, 0.1 ms of
//      copying at 3.35 TB/s); the copy engine reads it with plain 3-D
//      tensor maps.
//   2. attention: 160 threads, one consumer warpgroup owning the tile's
//      64 q rows and one producer warp, of which one thread issues the
//      copies.
//   * Shared memory.  Float32 tiles are twice bf16's and the split
//     doubles them again: a 64-row Q tile (hi and lo) would be 64 KB at D
//     128, and a 32-key stage of K or of V^T is 32 KB.  So a block has one
//     consumer warpgroup (64 q rows) and 32-key tiles; Q's hi part lives
//     in registers (below), and Q's lo part (32 KB) and three stages of
//     each of K and V^T take 224 KB of the 227 KB a block may have.  With
//     160 threads each has up to 255 registers without setmaxnreg.
//   * Copies.  TMA (cp.async.bulk.tensor) with the 128-byte swizzle into
//     the ring; K and V^T of a stage each have a "full" mbarrier (the
//     copy's byte count) and an "empty" one (every consumer warp), as in
//     the bf16 kernel.  Rows past Sq and Sk are the copy engine's zero
//     fill.  A box is 32 floats (128 bytes) wide.
//   * S = Q K^T.  wgmma.mma_async m64n32k8 .f32.tf32.tf32, three per k8
//     slice, D / 8 slices: Q_lo K_hi with both operands K-major in shared
//     memory, then Q_hi K_lo and Q_hi K_hi with Q's hi part as the
//     register A operand (64 registers a thread at D 128, loaded once),
//     so two of the three read only K from shared memory (13 % faster
//     than all three from shared memory at Qwen3-14B's shape, PERF.md).
//   * O += P V.  P is split in registers.  wgmma's register A fragment of
//     a k8 slice holds columns (t, t + 4) of a quad's row, where the f32
//     accumulator holds (2t, 2t + 1).  So the split kernel permutes the
//     keys within each group of 8 in V^T (position p holds key 2p for p <
//     4, key 2 (p - 4) + 1 after): the accumulator then feeds wgmma with
//     no shuffle and no trip through shared memory, which a staged P
//     (hi and lo, 16 KB a tile) would cost.  m64nDVk8, three per slice.
//   * Overlap, as the bf16 kernel: S of tile kt and P V of tile kt - 1
//     are issued back to back, and tile kt's softmax runs while P V runs.
//   * Softmax.  The bf16 kernel's: online, base 2 (one FFMA and one
//     ex2.approx a logit, within the lse tolerance of 1e-4), a row in the
//     four threads of a quad.
//   * Promotion.  The tensor cores' float32 accumulation drifts with the
//     number of products summed into one accumulator, so the key tiles
//     run in runs of 64 (768 products), and between runs O is folded into
//     the block's own rows of the output in float32 on the CUDA cores and
//     the accumulator zeroed, as the backward does with dK, dV and dQ; a
//     sum over any Sk then runs at most 768 products on the tensor cores.
//     The fold between runs, not on a branch inside the loop, costs 2 %
//     at Qwen3-14B's shape where the branch cost 5 % (PERF.md).
//   * The end: O divided by the denominator, written in float32; where
//     the caller passes an `lse` buffer (training), also each row's
//     log-sum-exp of the scaled logits, m / sqrt(D) + log l.
//   * Grid: (batch x q head, q tile), the q tile reversed so the causal
//     tiles with the most key tiles launch first.
//
// Left for later: forming hi and lo of K and V on the chip from one
// float32 copy (the copies of the split parts from L2 are twice those of
// float32), a second consumer warpgroup over the same K and V tiles.
//
// C interface: one function, loaded with ctypes.  It launches on the given
// stream, allocates nothing (the split scratch is the caller's), and
// returns cudaGetLastError(), or 1000 plus the driver's error if a tensor
// map cannot be encoded.

#include "split_tf32.cuh"

namespace {

constexpr int kBM = 64;                     // q rows per block: one consumer warpgroup
constexpr int kBN = 32;                     // keys per tile
constexpr int kStages = 3;                  // depth of the K and V^T rings
constexpr int kPromote = 64;                // key tiles an O accumulation runs (768 products)
constexpr float kNegInf = -1e30f;

// d (64 x 32, f32) {=, +=} A (64 x 8, tf32, K-major in shared memory)
//   x B (32 x 8, tf32, K-major in shared memory); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32, f32) += A (64 x 8, tf32, in registers) x B (32 x 8, tf32,
//   K-major in shared memory).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- 1. split --------------------------------------------------------
// q, k and v into their split parts (split_tf32.cuh).
__global__ void __launch_bounds__(256)
    fa_f32_sm90_split_kernel(const __grid_constant__ SplitArgs a) {
  split_tile(a);
}

// ---- 2. attention ----------------------------------------------------
// O's rows lo and hi times their own factor.
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], float lo, float hi) {
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    acc[4 * c] *= lo;
    acc[4 * c + 1] *= lo;
    acc[4 * c + 2] *= hi;
    acc[4 * c + 3] *= hi;
  }
}

// Folds a 64 x DV accumulator fragment into rows [row_lo, row_lo + 8) of
// o (row stride oss): o = o * keep + acc * mul, each row (lo, hi) with its
// own factors, or with `first` o = acc * mul; rows at or past n skipped.
// Each thread reads back only what it wrote; the old values of 8 column
// chunks are loaded together, then the sums stored.
template <int D, int DV>
__device__ __forceinline__ void fold_rows(float* o, long long oss, const float (&acc)[DV / 2],
                                          int row_lo, int n, int col_lane, float2 keep, float2 mul,
                                          bool first) {
  constexpr int J = D / 8, kBatch = 8;
  float* rows[2] = {o + row_lo * oss + col_lane, o + (row_lo + 8) * oss + col_lane};
  const bool in[2] = {row_lo < n, row_lo + 8 < n};
  const float k2[2] = {keep.x, keep.y}, m2[2] = {mul.x, mul.y};
#pragma unroll
  for (int j0 = 0; j0 < J; j0 += kBatch) {
    float2 was[kBatch][2];
#pragma unroll
    for (int j = j0; j < j0 + kBatch && j < J; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        was[j - j0][half] = first || !in[half]
                                ? make_float2(0.f, 0.f)
                                : *reinterpret_cast<const float2*>(rows[half] + 8 * j);
#pragma unroll
    for (int j = j0; j < j0 + kBatch && j < J; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        if (in[half])
          *reinterpret_cast<float2*>(rows[half] + 8 * j) =
              make_float2(fmaf(acc[4 * j + 2 * half], m2[half], was[j - j0][half].x * k2[half]),
                          fmaf(acc[4 * j + 2 * half + 1], m2[half], was[j - j0][half].y * k2[half]));
  }
}

struct Params {
  int hq, group, Sq, Sk, n_qt, causal;
  float scale_log2;                // 1 / sqrt(D) * log2(e)
  float scale;                     // 1 / sqrt(D)
  float* lse;                      // (B, Hq, Sq) float32 log-sum-exp, or null
  long long osb, osh, oss;         // o's element strides
  const float* qs;                 // the split q, (B Hq, Sq, qcols)
  int qcols;                       // 2 DQ
};

// Byte offsets of the shared-memory buffers of one block.  The Q tile is
// Q's lo part, NQ boxes of (64 rows x 128 bytes) (its hi part lives in
// registers); a K stage 2 NQ boxes of (32 rows x 128 bytes), hi parts then
// lo parts; a V^T stage two boxes of (DV x 128 bytes), hi then lo; each
// 1024-byte aligned as the 128-byte swizzle wants.
template <int NQ, int DV>
struct Layout {
  static constexpr uint32_t kQBox = kBM * 128, kKBox = kBN * 128, kVBox = DV * 128;
  static constexpr uint32_t kQBytes = NQ * kQBox;
  static constexpr uint32_t kKBytes = 2 * NQ * kKBox;
  static constexpr uint32_t kVBytes = 2 * kVBox;
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKBytes;
  // q_full, k_full[], v_full[], k_empty[], v_empty[]
  static constexpr uint32_t kBars = kV + kStages * kVBytes;
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
};

// Issues O += P V over one key tile: kBN / 8 k8 slices of three products,
// the slice's keys 32 bytes on within V^T's 128-byte rows.
template <int DV>
__device__ __forceinline__ void pv_product(float (&acc)[DV / 2], const uint32_t (&ph)[kBN / 8][4],
                                           const uint32_t (&pl)[kBN / 8][4], uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBN / 8; ++kk) {
    const uint64_t bh = desc128(v_tile + kk * 32), bl = desc128(v_tile + DV * 128 + kk * 32);
    if constexpr (DV == 64) {
      wgmma_rs_n64(acc, pl[kk], bh);
      wgmma_rs_n64(acc, ph[kk], bl);
      wgmma_rs_n64(acc, ph[kk], bh);
    } else {
      wgmma_rs_n128(acc, pl[kk], bh);
      wgmma_rs_n128(acc, ph[kk], bl);
      wgmma_rs_n128(acc, ph[kk], bh);
    }
  }
}

// Issues S = Q K^T over one key tile: D / 8 k8 slices of three products,
// the next slice 32 bytes on within a box, the next 4 one box on; Q's lo
// part from shared memory, its hi part (qh, the A fragment of each slice)
// from registers; the first product overwrites s.
template <int D, int NQ>
__device__ __forceinline__ void qk_product(float (&s)[kBN / 2], const uint32_t (&qh)[D / 8][4],
                                           uint32_t q_lo, uint32_t k_tile) {
  using L = Layout<NQ, 64>;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t bt = k_tile + (kk / 4) * L::kKBox + (kk % 4) * 32;
    const uint64_t al = desc128(q_lo + (kk / 4) * L::kQBox + (kk % 4) * 32);
    const uint64_t bh = desc128(bt), bl = desc128(bt + NQ * L::kKBox);
    wgmma_ss_n32(s, al, bh, kk > 0);
    wgmma_rs_n32(s, qh[kk], bl);
    wgmma_rs_n32(s, qh[kk], bh);
  }
}

// The online softmax's state for a thread's two rows (lo and hi).
struct Softmax {
  float m_lo = kNegInf, m_hi = kNegInf;  // running max of the raw logits
  float l_lo = 0.f, l_hi = 0.f;          // this thread's share of the denominator
  float alpha_lo = 0.f, alpha_hi = 0.f;  // rescale of O owed by the last tile
};

// The online softmax of the key tile at k0 on its S fragment, base 2:
// s becomes p = 2^(s c - m c), c = log2(e) / sqrt(D), masked logits first
// set to -1e30; a row lives in the four threads of a quad.
__device__ __forceinline__ void softmax_tile(float (&s)[kBN / 2], Softmax& sm, int k0, int q0,
                                             int row_lo, int col_lane, int offset,
                                             const Params& p) {
  const bool masked = k0 + kBN > p.Sk || (p.causal && k0 + kBN - 1 > q0 + offset);
  if (masked) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + col_lane + (e & 1);
        const int row = row_lo + (e & 2 ? 8 : 0);
        if (col >= p.Sk || (p.causal && col > row + offset)) s[4 * j + e] = kNegInf;
      }
    }
  }
  float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, sh));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, sh));
  }
  const float c = p.scale_log2;
  const float new_lo = fmaxf(sm.m_lo, mx_lo), new_hi = fmaxf(sm.m_hi, mx_hi);
  sm.alpha_lo = ex2((sm.m_lo - new_lo) * c);
  sm.alpha_hi = ex2((sm.m_hi - new_hi) * c);
  sm.m_lo = new_lo;
  sm.m_hi = new_hi;
  const float off_lo = -new_lo * c, off_hi = -new_hi * c;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], c, off_lo));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], c, off_lo));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], c, off_hi));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], c, off_hi));
    sum_lo += s[4 * j] + s[4 * j + 1];
    sum_hi += s[4 * j + 2] + s[4 * j + 3];
  }
  sm.l_lo = sm.l_lo * sm.alpha_lo + sum_lo;
  sm.l_hi = sm.l_hi * sm.alpha_hi + sum_hi;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_f32_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
                       const Params p) {
  constexpr int NQ = (D + kBoxCols - 1) / kBoxCols;  // boxes of each part of a Q or K row
  constexpr int DV = (D + 63) / 64 * 64;              // N of O += P V
  using L = Layout<NQ, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + L::kK, sV = base + L::kV, bars = base + L::kBars;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8u * (1 + st); };
  auto v_full = [&](int st) { return bars + 8u * (1 + kStages + st); };
  auto k_empty = [&](int st) { return bars + 8u * (1 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return bars + 8u * (1 + 3 * kStages + st); };

  const int h = blockIdx.x % p.hq, b = blockIdx.x / p.hq;
  const int bhk = b * (p.hq / p.group) + h / p.group;
  const int q0 = (p.n_qt - 1 - static_cast<int>(blockIdx.y)) * kBM;
  const int offset = p.Sk - p.Sq;
  int nk = (p.Sk + kBN - 1) / kBN;
  if (p.causal) nk = min(nk, (min(q0 + kBM, p.Sq) - 1 + offset) / kBN + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), kConsumers / 32);
      mbar_init(v_empty(st), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread issues every copy ----
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < NQ; ++c)  // Q's lo part
        tma_load_3d(sQ + c * L::kQBox, &tq, q_full, (NQ + c) * kBoxCols, q0, blockIdx.x);
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kStages;
        const uint32_t free_parity = ((kt / kStages) & 1) ^ 1;  // the first round passes at once
        mbar_wait(k_empty(st), free_parity);
        mbar_expect_tx(k_full(st), L::kKBytes);
        for (int c = 0; c < 2 * NQ; ++c)
          tma_load_3d(sK + st * L::kKBytes + c * L::kKBox, &tk, k_full(st), c * kBoxCols,
                      kt * kBN, bhk);
        mbar_wait(v_empty(st), free_parity);
        mbar_expect_tx(v_full(st), L::kVBytes);
        for (int part = 0; part < 2; ++part)
          tma_load_3d(sV + st * L::kVBytes + part * L::kVBox, &tv, v_full(st), kt * kBN, 0,
                      2 * bhk + part);
      }
    }
    return;
  }

  // ---- consumers: the warpgroup owns q rows q0 .. q0 + 63 ----
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // accumulator fragment: this thread holds rows row_lo and row_lo + 8,
  // columns 8 j + col_lane + {0, 1} of every 8-column chunk j
  const int row_lo = q0 + 16 * warp + lane / 4;
  const int col_lane = 2 * (lane % 4);

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  Softmax sm;
  // O leaves the tensor cores' accumulator every kPromote key tiles: the
  // tensor cores' float32 accumulation drifts with the number of products
  // summed into one accumulator (see the dkdv kernel of
  // csrc/flash_attention_bwd_f32_sm90.cu).  The block's own rows of o take
  // it in float32 on the CUDA cores and hold it relative to the running max
  // at that time (mo); at the end o = (o 2^((mo - m) c) + acc) / l.
  float* const ob = o + b * p.osb + h * p.osh;
  float mo_lo = 0.f, mo_hi = 0.f;
  bool promoted = false;
  uint32_t ph[kBN / 8][4], pl[kBN / 8][4];  // P of the last tile, hi and lo, as A fragments
  // Q's hi part as the A fragment of each k8 slice: registers 0 and 1
  // hold column t of rows row_lo and row_lo + 8, 2 and 3 column t + 4
  uint32_t qh[D / 8][4];
  {
    const float* qb = p.qs + static_cast<size_t>(blockIdx.x) * p.Sq * p.qcols;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_lo + (e & 1) * 8, col = 8 * kk + lane % 4 + (e >> 1) * 4;
        qh[kk][e] = row < p.Sq ? __float_as_uint(qb[static_cast<size_t>(row) * p.qcols + col]) : 0u;
      }
  }

  mbar_wait(q_full, 0);
  // Tile 0 alone (its S), then each later tile's S issued with the last
  // tile's P V: the first iteration is peeled off so that no product is
  // issued or waited for in a branch (ptxas serialises every product of
  // the kernel for that, C7518).
  {
    float s[kBN / 2];
    mbar_wait(k_full(0), 0);
    fence_regs(s);
    wgmma_fence();
    qk_product<D, NQ>(s, qh, sQ, sK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(k_empty(0));
    softmax_tile(s, sm, 0, q0, row_lo, col_lane, offset, p);
    split_a<kBN / 8>(ph, pl, s);
  }
  // the later tiles in runs of kPromote, O folded into its rows between runs
  for (int kt0 = 1; kt0 < nk; kt0 += kPromote) {
    const int kt_end = min(nk, kt0 + kPromote);
    for (int kt = kt0; kt < kt_end; ++kt) {
      const int st = kt % kStages, prev = (kt - 1) % kStages;
      const uint32_t parity = (kt / kStages) & 1, prev_parity = ((kt - 1) / kStages) & 1;
      float s[kBN / 2];
      mbar_wait(k_full(st), parity);
      mbar_wait(v_full(prev), prev_parity);  // before the fence: no waits in the batch

      // S = Q K^T of tile kt, then (O rescaled) O += P V of tile kt - 1,
      // issued back to back
      fence_regs(s);
      wgmma_fence();
      qk_product<D, NQ>(s, qh, sQ, sK + st * L::kKBytes);
      wgmma_commit();
      rescale(acc, sm.alpha_lo, sm.alpha_hi);
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_fence();
      pv_product<DV>(acc, ph, pl, sV + prev * L::kVBytes);
      wgmma_commit();

      // S is ready when at most the P V product is still running
      wgmma_wait<1>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(k_empty(st));  // this warp is done with K of tile kt
      softmax_tile(s, sm, kt * kBN, q0, row_lo, col_lane, offset, p);

      // P of tile kt may overwrite ph and pl once the P V product of kt - 1 is done
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      if (lane == 0) mbar_arrive(v_empty(prev));  // this warp is done with V of tile kt - 1
      split_a<kBN / 8>(ph, pl, s);
    }
    if (kt_end < nk) {
      // acc (tiles up to kt_end - 2, its P V done) is relative to the max
      // before tile kt_end - 1, sm.m the max after it, sm.alpha the factor
      // between the two; the next run's first P V is that tile's
      const float c = p.scale_log2;
      const float2 keep = make_float2(promoted ? ex2((mo_lo - sm.m_lo) * c) : 0.f,
                                      promoted ? ex2((mo_hi - sm.m_hi) * c) : 0.f);
      fold_rows<D, DV>(ob, p.oss, acc, row_lo, p.Sq, col_lane, keep,
                       make_float2(sm.alpha_lo, sm.alpha_hi), !promoted);
      mo_lo = sm.m_lo;
      mo_hi = sm.m_hi;
      promoted = true;
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    }
  }

  // the last tile's O += P V
  {
    const int last = (nk - 1) % kStages;
    rescale(acc, sm.alpha_lo, sm.alpha_hi);
    mbar_wait(v_full(last), ((nk - 1) / kStages) & 1);
    fence_regs(acc);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
    pv_product<DV>(acc, ph, pl, sV + last * L::kVBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // ---- O / denominator ----
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    sm.l_lo += __shfl_xor_sync(0xffffffffu, sm.l_lo, sh);
    sm.l_hi += __shfl_xor_sync(0xffffffffu, sm.l_hi, sh);
  }
  const float inv_lo = 1.f / sm.l_lo, inv_hi = 1.f / sm.l_hi;
  if (p.lse != nullptr && (lane & 3) == 0) {  // one thread of each row's quad
    float* lb = p.lse + static_cast<size_t>(blockIdx.x) * p.Sq;
    if (row_lo < p.Sq) lb[row_lo] = sm.m_lo * p.scale + logf(sm.l_lo);
    if (row_lo + 8 < p.Sq) lb[row_lo + 8] = sm.m_hi * p.scale + logf(sm.l_hi);
  }
  const float c = p.scale_log2;
  const float2 keep = make_float2(promoted ? ex2((mo_lo - sm.m_lo) * c) * inv_lo : 0.f,
                                  promoted ? ex2((mo_hi - sm.m_hi) * c) * inv_hi : 0.f);
  fold_rows<D, DV>(ob, p.oss, acc, row_lo, p.Sq, col_lane, keep, make_float2(inv_lo, inv_hi),
                   !promoted);
}

// ---- host ------------------------------------------------------------
template <int D>
int launch_d(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o,
             int B, const Params& p, cudaStream_t s) {
  constexpr int NQ = (D + kBoxCols - 1) / kBoxCols, DV = (D + 63) / 64 * 64;
  constexpr uint32_t smem = Layout<NQ, DV>::kBytes;
  auto kern = fa_f32_sm90_kernel<D>;
  static bool attr_set = false;
  const int err = allow_smem(kern, smem, attr_set);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(B) * p.hq, p.n_qt);
  kern<<<grid, kThreads, smem, s>>>(tq, tk, tv, static_cast<float*>(o), p);
  return 0;
}

}  // namespace

// float32 q (B, Hq, Sq, D) and k/v (B, Hkv, Sk, D) with the given element
// strides (batch, head, seq; the last dim contiguous); o likewise, any
// strides.  lse, if not null, receives the float32 (B, Hq, Sq) log-sum-exp
// of each row's scaled logits.  scratch is one contiguous float32 buffer
// this call fills with the split parts, one after the other: qs (B Hq, Sq,
// 2 DQ), ks (B Hkv, Sk, 2 DQ) and vt (B Hkv, 2, DV, Skp) (DQ = D rounded
// up to 32, DV = D rounded up to 64, Skp = Sk rounded up to 32).  D a
// multiple of 16 in [16, 128]; Hq a multiple of Hkv; Sq, Sk >= 1; causal
// needs Sq <= Sk.
extern "C" int repro_flash_attention_f32_sm90(const void* q, const void* k, const void* v, void* o,
                                              void* lse, void* scratch, int B, int Hq,
                                              int Hkv, int Sq, int Sk, int D,
                                              long long qsb, long long qsh, long long qss,
                                              long long ksb, long long ksh, long long kss,
                                              long long vsb, long long vsh, long long vss,
                                              long long osb, long long osh, long long oss,
                                              float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int DQ = (D + kBoxCols - 1) / kBoxCols * kBoxCols, DV = (D + 63) / 64 * 64;
  const int Sqp = (Sq + 31) / 32 * 32, Skp = (Sk + 31) / 32 * 32;
  float* const qs = static_cast<float*>(scratch);
  float* const ks = qs + static_cast<long long>(B) * Hq * Sq * 2 * DQ;
  float* const vt = ks + static_cast<long long>(B) * Hkv * Sk * 2 * DQ;
  Params p;
  p.hq = Hq;
  p.group = Hq / Hkv;
  p.Sq = Sq;
  p.Sk = Sk;
  p.n_qt = (Sq + kBM - 1) / kBM;
  p.causal = causal;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.scale = scale;
  p.lse = static_cast<float*>(lse);
  p.osb = osb;
  p.osh = osh;
  p.oss = oss;
  p.qs = qs;
  p.qcols = 2 * DQ;
  if (D < 16 || D > 128 || D % 16 != 0 || p.n_qt > 65535 ||
      static_cast<long long>(B) * Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);

  SplitArgs sa;
  sa.D = D;
  sa.DQ = DQ;
  sa.DV = DV;
  sa.src[0] = {static_cast<const float*>(q), qsb, qsh, qss, Hq, B * Hq, Sq, Sqp, qs, nullptr};
  sa.src[1] = {static_cast<const float*>(k), ksb, ksh, kss, Hkv, B * Hkv, Sk, Skp, ks, nullptr};
  sa.src[2] = {static_cast<const float*>(v), vsb, vsh, vss, Hkv, B * Hkv, Sk, Skp, nullptr, vt};
  const dim3 split_grid((Sqp > Skp ? Sqp : Skp) / 32 * (DV / 32), B * Hq, 3);
  fa_f32_sm90_split_kernel<<<split_grid, dim3(32, 8), 0, s>>>(sa);

  CUtensorMap tq, tk, tv;
  const CUtensorMapSwizzle w128 = CU_TENSOR_MAP_SWIZZLE_128B;
  int err = make_map(&tq, qs, 2 * DQ, Sq, static_cast<long long>(B) * Hq, kBoxCols, kBM, w128);
  if (err == 0)
    err = make_map(&tk, ks, 2 * DQ, Sk, static_cast<long long>(B) * Hkv, kBoxCols, kBN, w128);
  if (err == 0) err = make_map(&tv, vt, Skp, DV, 2LL * B * Hkv, kBoxCols, DV, w128);
  if (err != 0) return err;
#define REPRO_FAF32_CASE(DD) \
  case DD:                   \
    err = launch_d<DD>(tq, tk, tv, o, B, p, s); \
    break;
  switch (D) {
    REPRO_FAF32_CASE(16)
    REPRO_FAF32_CASE(32)
    REPRO_FAF32_CASE(48)
    REPRO_FAF32_CASE(64)
    REPRO_FAF32_CASE(80)
    REPRO_FAF32_CASE(96)
    REPRO_FAF32_CASE(112)
    REPRO_FAF32_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FAF32_CASE
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
