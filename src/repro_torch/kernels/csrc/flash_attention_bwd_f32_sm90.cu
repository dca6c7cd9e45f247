// Backward of causal or full grouped-query attention in float32 on
// Hopper's tensor cores, in split TF32 ("3xTF32"): dq, dk and dv from q,
// k, v, the forward's output o, its gradient dO and the forward's per-row
// log-sum-exp.
//
// The TPU kernel `flash_attention_pallas` (src/repro/kernels/flash_attention.py)
// has no backward: the JAX package differentiates through XLA attention.
// The port's forward runs the hand-written K4 kernels, so training on the
// card needs a backward.  This source is the float32 one; bf16 runs
// csrc/flash_attention_bwd_sm90.cu, whose structure it takes over.  It
// computes what autograd of `flash_attention_plain` computes:
//
//   P  = exp(Q K^T * scale - lse)     (recomputed, the forward's mask)
//   dV = P^T dO                        dP = dO V^T
//   dS = P * (dP - Delta)              Delta = rowsum(dO * O)
//   dQ = dS K * scale                  dK = dS^T Q * scale
//
// with the forward's masks: the causal mask keeps key j for query i when
// j <= i + (Sk - Sq); rows past Sq and keys past Sk are masked (ragged
// last tiles); non-causal calls (cross-attention, Sq > Sk) mask nothing
// else.  Query head h reads kv head h / (Hq / Hkv); dk and dv sum over
// the Hq / Hkv query heads of their kv head.
//
// Float32 on the tensor cores, as csrc/flash_attention_f32_sm90.cu, with
// which it shares split_tf32.cuh: every product is three TF32 products of
// split operands (x = hi + lo, each rounded with cvt.rna), a_lo b_hi +
// a_hi b_lo + a_hi b_hi, the small terms first, accumulated in float32.
//
// What bounds it on an H100: operations.  Qwen3-14B's training shape (B 1,
// Hq 40, Hkv 8, S 4096, D 128, causal) needs five products of 2 S^2 D a
// head, halved by the mask: 429.5 GFLOP; three TF32 products for each at
// 495 TFLOP/s take 2.603 ms (the CUDA cores' 67 TFLOP/s: 6.412 ms).
//
// Five kernels, launched in order on one stream by one C call:
//   1. split: q, dO, k and v into (B H, S, 2 DQ) rows, hi in the first DQ
//      columns and lo in the next (DQ = D rounded up to 32), and q, dO and
//      k also transposed into (B H, 2, DV, Sp), hi then lo (DV = D rounded
//      up to 64, Sp = S rounded up to 32), zeros past D and S.  wgmma has
//      no transpose flag for .tf32, so every operand that the bf16 kernel
//      reads through it needs a K-major copy: Q^T and dO^T for dK += dS^T Q
//      and dV += P^T dO, K^T for dQ += dS K.  In each group of 8 positions
//      of a transposed copy the keys (or queries) are permuted to 0, 2, 4,
//      6, 1, 3, 5, 7, so that the f32 accumulator of P^T, dS^T or dS feeds
//      wgmma's tf32 A fragment (columns t and t + 4 of a quad's row, where
//      the accumulator holds 2t and 2t + 1) straight from registers.
//   2. delta: Delta = rowsum(dO * O) and lse * log2(e), one warp a row,
//      into a float32 (B Hq, 2, Sqp) buffer (Sqp = Sq rounded up to 64,
//      zeros past Sq);
//   3. dkdv: one block per (batch, kv head, 64-key tile), one consumer
//      warpgroup, looping over the query heads of its group and the
//      16-query tiles that see its keys:
//        S^T = K Q^T and dP^T = V dO^T (m64n16k8, both operands K-major,
//          K and V resident, Q and dO in a ring of stages);
//        P^T and dS^T on the accumulator fragment, split in registers;
//        dV += P^T dO and dK += dS^T Q (m64nDVk8, dO^T and Q^T the B
//          operand, 16 queries wide: the 64-byte swizzle);
//      dK and dV accumulate in registers and are added to the block's
//      own rows of the output every 128 query tiles, in float32 on the
//      CUDA cores: the tensor cores' float32 accumulation drifts over
//      long runs (1.2e-4 of the largest gradient at Qwen3-14B's training
//      shape when left alone for all 1280 tiles, against 1e-4);
//   4. dq: one block per (batch, q head, 64-query tile), one consumer
//      warpgroup, Q and dO resident, looping over the 16-key tiles its
//      queries see: S = Q K^T and dP = dO V^T, dS, then dQ += dS K (K^T the
//      B operand); dQ is added to the block's own rows of the output every
//      128 key tiles, as dK and dV are, so that no accumulation runs past
//      768 products at any length.
// No block writes what another writes: no atomics, so the result repeats
// bit for bit.
//
// Shared memory (the binding constraint: float32 tiles are twice bf16's
// and the split doubles them again), at D 128: the dkdv kernel's K and V
// tiles, hi and lo (128 KB), one stage of Q and dO (16 queries, 32 KB)
// and two of Q^T and dO^T (32 KB each; two here and one of Q and dO
// measured 6 % faster than the other way round, PERF.md): 225 KB of the
// 227 KB a block may have; the dq kernel's Q and dO tiles (128 KB), two
// stages of K and V (16 keys, 32 KB each) and two of K^T (16 KB each).
// So the looped tiles are 16 rows, and one consumer warpgroup works a
// block (the bf16 kernels have two or three).  Registers, a consumer
// thread at D 128: dK 64 + dV 64 + S^T 8 + dP^T 8 + P^T and dS^T split
// 32 in the dkdv kernel (190 in all, by ptxas); dQ 64 + S 8 + dP 8 + dS
// split 16 in the dq kernel (128); 160 threads a block leave up to 255
// registers a thread without setmaxnreg.  A box is 32 floats (128
// bytes) wide, or 16 (64 bytes) for the transposed copies; rows past Sq
// and Sk are the copy engine's zero fill.
//
// Measured slower on the H100 (PERF.md): the dq kernel with Q's (and
// dO's) hi part in registers as the A operand, which the forward gains
// from at 32-key tiles (1.13 to 1.15 x slower here at 16-key tiles,
// with one more K/V stage).  Left for later: forming hi and lo (and the
// transposes) on the chip from one float32 copy, which would cut the
// looped tiles' copies from L2 by four; wider looped tiles (the m64n16
// products read their 64-row A operand from shared memory twice as often
// as they keep the tensor cores busy); overlap of one tile's products
// with the last tile's softmax gradient.
//
// C interface: one function, loaded with ctypes.  It launches on the given
// stream, allocates nothing (the lse/Delta buffer and the split scratch
// are the caller's), and returns cudaGetLastError(), or 1000 plus the
// driver's error if a tensor map cannot be encoded.

#include "split_tf32.cuh"

namespace {

constexpr int kKeys = 64;                   // keys of a dkdv block
constexpr int kRows = 64;                   // queries of a dq block
constexpr int kSub = 16;                    // rows of a looped tile (queries or keys)
constexpr int kKvStagesA = 1, kKvStagesB = 2;  // dkdv: Q/dO (and lse/Delta), Q^T/dO^T
constexpr int kQStagesA = 2, kQStagesB = 2;    // dq: K/V, K^T
constexpr int kPromote = 128;               // looped tiles a dK/dV or dQ accumulation runs
constexpr int kRowPad = 64;                 // Sqp: Sq rounded up to this
constexpr int kColPad = 32;                 // Sp of the transposed copies
constexpr float kLog2e = 1.4426950408889634f;

// d (64 x 16, f32) {=, +=} A (64 x 8, tf32, K-major in shared memory)
//   x B (16 x 8, tf32, K-major in shared memory); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- 1. split --------------------------------------------------------
// q, dO, k and v into their split parts (split_tf32.cuh).
__global__ void __launch_bounds__(256)
    fa_bwd_f32_sm90_split_kernel(const __grid_constant__ SplitArgs a) {
  split_tile(a);
}

struct Params {
  int hq, hkv, group, Sq, Sk, Sqp, causal;
  int n_qt;                // kRows-query tiles (dq kernel)
  float scale_log2;        // 1 / sqrt(D) * log2(e)
  float scale;             // 1 / sqrt(D)
  const float* ld;         // (B Hq, 2, Sqp): lse * log2(e), then Delta
  float *dq, *dk, *dv;     // contiguous outputs
};

// Adds a 64 x DV float fragment times `mul` to rows [row_lo, row_lo + 8)
// of a contiguous (rows, D) slice, or with `first` stores it there; rows
// at or past n skipped.  Each thread reads back only what it wrote: the
// old values of 8 column chunks are loaded together, then the sums
// stored, so the loads of a batch are in flight at once.
template <int D, int DV>
__device__ __forceinline__ void add_rows(float* out, const float (&acc)[DV / 2], int row_lo, int n,
                                         int col_lane, float mul, bool first) {
  constexpr int J = D / 8, kBatch = 8;
  float* rows[2] = {out + static_cast<size_t>(row_lo) * D + col_lane,
                    out + static_cast<size_t>(row_lo + 8) * D + col_lane};
  const bool keep[2] = {row_lo < n, row_lo + 8 < n};
#pragma unroll
  for (int j0 = 0; j0 < J; j0 += kBatch) {
    float2 was[kBatch][2];
#pragma unroll
    for (int j = j0; j < j0 + kBatch && j < J; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        was[j - j0][half] = first || !keep[half]
                                ? make_float2(0.f, 0.f)
                                : *reinterpret_cast<const float2*>(rows[half] + 8 * j);
#pragma unroll
    for (int j = j0; j < j0 + kBatch && j < J; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        if (keep[half])
          *reinterpret_cast<float2*>(rows[half] + 8 * j) =
              make_float2(fmaf(acc[4 * j + 2 * half], mul, was[j - j0][half].x),
                          fmaf(acc[4 * j + 2 * half + 1], mul, was[j - j0][half].y));
  }
}

// d (64 x 16) {=, +=} A (64 rows at `a`) B^T (16 rows at `b`), both split
// tiles of 2 NQ boxes (hi boxes, then lo), a_box and b_box bytes apart,
// over the D / 8 k8 slices: three products a slice, the small terms first.
template <int D, int NQ>
__device__ __forceinline__ void ss_product(float (&d)[8], uint32_t a, uint32_t a_box, uint32_t b,
                                           uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint32_t at = a + (kk / 4) * a_box + (kk % 4) * 32;
    const uint32_t bt = b + (kk / 4) * b_box + (kk % 4) * 32;
    const uint64_t ah = desc128(at), al = desc128(at + NQ * a_box);
    const uint64_t bh = desc128(bt), bl = desc128(bt + NQ * b_box);
    wgmma_ss_n16(d, al, bh, kk > 0);
    wgmma_ss_n16(d, ah, bl, 1);
    wgmma_ss_n16(d, ah, bh, 1);
  }
}

// acc (64 x DV) += A (64 x 16, split, registers) B (DV x 16 at `b`: a hi
// box, then a lo box of DV rows of 64 bytes): two k8 slices, 32 bytes apart.
template <int DV>
__device__ __forceinline__ void rs_product(float (&acc)[DV / 2], const uint32_t (&ah)[2][4],
                                           const uint32_t (&al)[2][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const uint64_t bh = desc64(b + kk * 32), bl = desc64(b + DV * 64 + kk * 32);
    if constexpr (DV == 64) {
      wgmma_rs_n64(acc, al[kk], bh);
      wgmma_rs_n64(acc, ah[kk], bl);
      wgmma_rs_n64(acc, ah[kk], bh);
    } else {
      wgmma_rs_n128(acc, al[kk], bh);
      wgmma_rs_n128(acc, ah[kk], bl);
      wgmma_rs_n128(acc, ah[kk], bh);
    }
  }
}

// ---- 2. delta --------------------------------------------------------
struct DeltaArgs {
  int Hq, Sq, Sqp, D;
  long long osb, osh, oss, gsb, gsh, gss;  // element strides of o and dO
};

__global__ void __launch_bounds__(256) fa_bwd_f32_sm90_delta_kernel(
    const float* __restrict__ o, const float* __restrict__ dO, const float* __restrict__ lse,
    float* __restrict__ ld, DeltaArgs a) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= a.Sqp) return;
  const size_t bh = static_cast<size_t>(b) * a.Hq + h;
  float acc = 0.f;
  if (row < a.Sq) {
    const float* op = o + b * a.osb + h * a.osh + row * a.oss;
    const float* gp = dO + b * a.gsb + h * a.gsh + row * a.gss;
    for (int c = lane; c < a.D; c += 32) acc = fmaf(op[c], gp[c], acc);
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, sh);
  if (lane == 0) {
    float* out = ld + bh * 2 * a.Sqp;
    out[row] = row < a.Sq ? lse[bh * a.Sq + row] * kLog2e : 0.f;
    out[a.Sqp + row] = acc;
  }
}

// ---- 3. dk, dv -------------------------------------------------------
// Byte offsets of one dkdv block's shared-memory buffers: its K and V
// tiles (kKeys rows, 2 NQ boxes each); kKvStagesA stages of Q and dO
// (kSub rows, 2 NQ boxes each); kKvStagesB stages of Q^T and dO^T (a hi
// and a lo box of DV rows of 64 bytes each); kKvStagesA stages of the
// lse/Delta rows (2 x kSub floats).
template <int NQ, int DV>
struct KvLayout {
  static constexpr uint32_t kBigBox = kKeys * 128, kSubBox = kSub * 128, kTBox = DV * 64;
  static constexpr uint32_t kBigBytes = 2 * NQ * kBigBox;
  static constexpr uint32_t kABytes = 2 * 2 * NQ * kSubBox;  // Q, then dO
  static constexpr uint32_t kBBytes = 2 * 2 * kTBox;         // Q^T hi, lo, then dO^T hi, lo
  static constexpr uint32_t kK = 0, kV = kBigBytes;
  static constexpr uint32_t kA = 2 * kBigBytes;
  static constexpr uint32_t kB = kA + kKvStagesA * kABytes;
  static constexpr uint32_t kLd = kB + kKvStagesB * kBBytes;
  // kv_full, a_full[], a_empty[], b_full[], b_empty[]
  static constexpr uint32_t kBars = kLd + kKvStagesA * 2 * kSub * 4;
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 2 * kKvStagesA + 2 * kKvStagesB) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_f32_sm90_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap tqt,
                                const __grid_constant__ CUtensorMap tdot,
                                const __grid_constant__ CUtensorMap tld, const Params p) {
  constexpr int NQ = (D + kBoxCols - 1) / kBoxCols, DV = (D + 63) / 64 * 64;
  using L = KvLayout<NQ, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* ld_smem = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::kLd);
  const uint32_t bars = base + L::kBars;
  const uint32_t kv_full = bars;
  auto a_full = [&](int st) { return bars + 8u * (1 + st); };
  auto a_empty = [&](int st) { return bars + 8u * (1 + kKvStagesA + st); };
  auto b_full = [&](int st) { return bars + 8u * (1 + 2 * kKvStagesA + st); };
  auto b_empty = [&](int st) { return bars + 8u * (1 + 2 * kKvStagesA + kKvStagesB + st); };
  auto a_tile = [&](int st) { return base + L::kA + st * L::kABytes; };
  auto b_tile = [&](int st) { return base + L::kB + st * L::kBBytes; };

  const int bhk = blockIdx.x, hk = blockIdx.x % p.hkv, b = blockIdx.x / p.hkv;
  const int k0 = blockIdx.y * kKeys;
  const int offset = p.Sk - p.Sq;
  // the query tiles with a row that sees a key of this tile, for each
  // query head of the group
  const int qt0 = p.causal ? max(0, k0 - offset) / kSub : 0;
  const int per_head = (p.Sq + kSub - 1) / kSub - qt0;
  const int n_iter = p.group * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kKvStagesA; ++st) {
      mbar_init(a_full(st), 1);
      mbar_init(a_empty(st), kConsumers / 32);
    }
    for (int st = 0; st < kKvStagesB; ++st) {
      mbar_init(b_full(st), 1);
      mbar_init(b_empty(st), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread issues every copy ----
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(kv_full, 2 * L::kBigBytes);
      for (int c = 0; c < 2 * NQ; ++c) {
        tma_load_3d(base + L::kK + c * L::kBigBox, &tk, kv_full, c * kBoxCols, k0, bhk);
        tma_load_3d(base + L::kV + c * L::kBigBox, &tv, kv_full, c * kBoxCols, k0, bhk);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int bh = b * p.hq + hk * p.group + it / per_head;
        const int q0 = (qt0 + it % per_head) * kSub;
        const int sa = it % kKvStagesA, sb = it % kKvStagesB;
        mbar_wait(a_empty(sa), ((it / kKvStagesA) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(a_full(sa), L::kABytes + 2 * kSub * 4);
        for (int c = 0; c < 2 * NQ; ++c) {
          tma_load_3d(a_tile(sa) + c * L::kSubBox, &tq, a_full(sa), c * kBoxCols, q0, bh);
          tma_load_3d(a_tile(sa) + (2 * NQ + c) * L::kSubBox, &tdo, a_full(sa), c * kBoxCols, q0,
                      bh);
        }
        tma_load_2d(base + L::kLd + sa * 2 * kSub * 4, &tld, a_full(sa), q0, 2 * bh);
        mbar_wait(b_empty(sb), ((it / kKvStagesB) & 1) ^ 1);
        mbar_expect_tx(b_full(sb), L::kBBytes);
        for (int part = 0; part < 2; ++part) {
          tma_load_3d(b_tile(sb) + part * L::kTBox, &tqt, b_full(sb), q0, 0, 2 * bh + part);
          tma_load_3d(b_tile(sb) + (2 + part) * L::kTBox, &tdot, b_full(sb), q0, 0,
                      2 * bh + part);
        }
      }
    }
    return;
  }

  // ---- consumers: the warpgroup owns keys k0 .. k0 + 63 ----
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // accumulator fragment: this thread holds rows (keys) key_lo and
  // key_lo + 8, columns 8 j + col_lane + {0, 1} of every 8-column chunk j
  const int key_lo = k0 + 16 * warp + lane / 4;
  const int col_lane = 2 * (lane % 4);

  float dk[DV / 2], dv[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dk[i] = dv[i] = 0.f;

  // dK and dV leave the tensor cores' accumulator every kPromote query
  // tiles: added to the block's own rows of the output in float32 on the
  // CUDA cores (round to nearest), the registers then zeroed.  The tensor
  // cores' float32 accumulation drifts with the number of products summed
  // into one accumulator (1.2e-4 of the largest gradient over the 7680
  // products of Qwen3-14B's group of 5 heads at 4096 queries, against the
  // tolerance of 1e-4); kPromote tiles are 768 products.  No other block
  // writes these rows, so the result still repeats bit for bit.
  const size_t at = static_cast<size_t>(bhk) * p.Sk * D;
  mbar_wait(kv_full, 0);
  for (int it0 = 0; it0 < n_iter; it0 += kPromote) {
    const int it_end = min(n_iter, it0 + kPromote);
    for (int it = it0; it < it_end; ++it) {
      const int sa = it % kKvStagesA, sb = it % kKvStagesB;
      const int q0 = (qt0 + it % per_head) * kSub;
      mbar_wait(a_full(sa), (it / kKvStagesA) & 1);
      const uint32_t qs = a_tile(sa), dos = qs + 2 * NQ * L::kSubBox;
      float s[8], dp[8];
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      ss_product<D, NQ>(s, base + L::kK, L::kBigBox, qs, L::kSubBox);    // S^T = K Q^T
      ss_product<D, NQ>(dp, base + L::kV, L::kBigBox, dos, L::kSubBox);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P^T = 2^(s c - lse2[q]) where kept, else 0; dS^T = P^T (dP^T - Delta[q])
      const float* lse2 = ld_smem + sa * 2 * kSub;
      const float* delta = lse2 + kSub;
      float2 l2[2], de[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        l2[j] = *reinterpret_cast<const float2*>(lse2 + 8 * j + col_lane);
        de[j] = *reinterpret_cast<const float2*>(delta + 8 * j + col_lane);
      }
      if (lane == 0) mbar_arrive(a_empty(sa));  // this warp is done with the stage
      const bool masked = k0 + kKeys > p.Sk || q0 + kSub > p.Sq ||
                          (p.causal && k0 + kKeys - 1 > q0 + offset);
      const float c = p.scale_log2;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pv = ex2(fmaf(s[4 * j + e], c, -((e & 1) ? l2[j].y : l2[j].x)));
          if (masked) {
            const int key = key_lo + ((e & 2) ? 8 : 0);
            const int q = q0 + 8 * j + col_lane + (e & 1);
            if (key >= p.Sk || q >= p.Sq || (p.causal && key > q + offset)) pv = 0.f;
          }
          s[4 * j + e] = pv;
          dp[4 * j + e] = pv * (dp[4 * j + e] - ((e & 1) ? de[j].y : de[j].x));
        }
      }
      uint32_t ph[2][4], pl[2][4], dh[2][4], dl[2][4];
      split_a<2>(ph, pl, s);
      split_a<2>(dh, dl, dp);

      // dV += P^T dO, dK += dS^T Q
      mbar_wait(b_full(sb), (it / kKvStagesB) & 1);
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(dh);
      fence_regs(dl);
      wgmma_fence();
      rs_product<DV>(dv, ph, pl, b_tile(sb) + 2 * L::kTBox);
      rs_product<DV>(dk, dh, dl, b_tile(sb));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      if (lane == 0) mbar_arrive(b_empty(sb));
    }
    add_rows<D, DV>(p.dk + at, dk, key_lo, p.Sk, col_lane, p.scale, it0 == 0);
    add_rows<D, DV>(p.dv + at, dv, key_lo, p.Sk, col_lane, 1.f, it0 == 0);
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dk[i] = dv[i] = 0.f;
  }
}

// ---- 4. dq -----------------------------------------------------------
// Byte offsets of one dq block's shared-memory buffers: its Q and dO
// tiles (kRows rows, 2 NQ boxes each); kQStagesA stages of K and V (kSub
// rows, 2 NQ boxes each); kQStagesB stages of K^T (a hi and a lo box of DV
// rows of 64 bytes).
template <int NQ, int DV>
struct QLayout {
  static constexpr uint32_t kBigBox = kRows * 128, kSubBox = kSub * 128, kTBox = DV * 64;
  static constexpr uint32_t kBigBytes = 2 * NQ * kBigBox;
  static constexpr uint32_t kABytes = 2 * 2 * NQ * kSubBox;  // K, then V
  static constexpr uint32_t kBBytes = 2 * kTBox;             // K^T hi, lo
  static constexpr uint32_t kQ = 0, kDo = kBigBytes;
  static constexpr uint32_t kA = 2 * kBigBytes;
  static constexpr uint32_t kB = kA + kQStagesA * kABytes;
  // q_full, a_full[], a_empty[], b_full[], b_empty[]
  static constexpr uint32_t kBars = kB + kQStagesB * kBBytes;
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 2 * kQStagesA + 2 * kQStagesB) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_f32_sm90_dq_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tkt, const Params p) {
  constexpr int NQ = (D + kBoxCols - 1) / kBoxCols, DV = (D + 63) / 64 * 64;
  using L = QLayout<NQ, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBars;
  const uint32_t q_full = bars;
  auto a_full = [&](int st) { return bars + 8u * (1 + st); };
  auto a_empty = [&](int st) { return bars + 8u * (1 + kQStagesA + st); };
  auto b_full = [&](int st) { return bars + 8u * (1 + 2 * kQStagesA + st); };
  auto b_empty = [&](int st) { return bars + 8u * (1 + 2 * kQStagesA + kQStagesB + st); };
  auto a_tile = [&](int st) { return base + L::kA + st * L::kABytes; };
  auto b_tile = [&](int st) { return base + L::kB + st * L::kBBytes; };

  const int bh = blockIdx.x, h = blockIdx.x % p.hq, b = blockIdx.x / p.hq;
  const int bhk = b * p.hkv + h / p.group;
  // the q tile reversed, so the causal tiles with the most key tiles launch first
  const int q0 = (p.n_qt - 1 - static_cast<int>(blockIdx.y)) * kRows;
  const int offset = p.Sk - p.Sq;
  int nk = (p.Sk + kSub - 1) / kSub;
  if (p.causal) nk = min(nk, (min(q0 + kRows, p.Sq) - 1 + offset) / kSub + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kQStagesA; ++st) {
      mbar_init(a_full(st), 1);
      mbar_init(a_empty(st), kConsumers / 32);
    }
    for (int st = 0; st < kQStagesB; ++st) {
      mbar_init(b_full(st), 1);
      mbar_init(b_empty(st), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, 2 * L::kBigBytes);
      for (int c = 0; c < 2 * NQ; ++c) {
        tma_load_3d(base + L::kQ + c * L::kBigBox, &tq, q_full, c * kBoxCols, q0, bh);
        tma_load_3d(base + L::kDo + c * L::kBigBox, &tdo, q_full, c * kBoxCols, q0, bh);
      }
      for (int kt = 0; kt < nk; ++kt) {
        const int sa = kt % kQStagesA, sb = kt % kQStagesB;
        mbar_wait(a_empty(sa), ((kt / kQStagesA) & 1) ^ 1);
        mbar_expect_tx(a_full(sa), L::kABytes);
        for (int c = 0; c < 2 * NQ; ++c) {
          tma_load_3d(a_tile(sa) + c * L::kSubBox, &tk, a_full(sa), c * kBoxCols, kt * kSub, bhk);
          tma_load_3d(a_tile(sa) + (2 * NQ + c) * L::kSubBox, &tv, a_full(sa), c * kBoxCols,
                      kt * kSub, bhk);
        }
        mbar_wait(b_empty(sb), ((kt / kQStagesB) & 1) ^ 1);
        mbar_expect_tx(b_full(sb), L::kBBytes);
        for (int part = 0; part < 2; ++part)
          tma_load_3d(b_tile(sb) + part * L::kTBox, &tkt, b_full(sb), kt * kSub, 0,
                      2 * bhk + part);
      }
    }
    return;
  }

  // ---- consumers: the warpgroup owns queries q0 .. q0 + 63 ----
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_lo = q0 + 16 * warp + lane / 4;
  const int col_lane = 2 * (lane % 4);
  // rows below Sqp (a multiple of kRows) always lie in the buffer
  const float* ldr = p.ld + static_cast<size_t>(bh) * 2 * p.Sqp;
  const float lse_lo = ldr[row_lo], lse_hi = ldr[row_lo + 8];
  const float de_lo = ldr[p.Sqp + row_lo], de_hi = ldr[p.Sqp + row_lo + 8];

  float dq[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dq[i] = 0.f;

  // dQ leaves the tensor cores' accumulator every kPromote key tiles, as
  // dK and dV do in the dkdv kernel (768 products a run).  It costs this
  // kernel 5 to 9 % at Qwen3-14B's shape, written this way or with a
  // second register accumulator (PERF.md).
  float* dq_rows = p.dq + static_cast<size_t>(bh) * p.Sq * D;
  mbar_wait(q_full, 0);
  for (int kt0 = 0; kt0 < nk; kt0 += kPromote) {
    const int kt_end = min(nk, kt0 + kPromote);
    for (int kt = kt0; kt < kt_end; ++kt) {
      const int sa = kt % kQStagesA, sb = kt % kQStagesB;
      const int kb0 = kt * kSub;
      mbar_wait(a_full(sa), (kt / kQStagesA) & 1);
      const uint32_t ks = a_tile(sa), vs = ks + 2 * NQ * L::kSubBox;
      float s[8], dp[8];
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      ss_product<D, NQ>(s, base + L::kQ, L::kBigBox, ks, L::kSubBox);    // S = Q K^T
      ss_product<D, NQ>(dp, base + L::kDo, L::kBigBox, vs, L::kSubBox);  // dP = dO V^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (lane == 0) mbar_arrive(a_empty(sa));

      const bool masked = kb0 + kSub > p.Sk || q0 + kRows > p.Sq ||
                          (p.causal && kb0 + kSub - 1 > q0 + offset);
      const float c = p.scale_log2;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = (e & 2) != 0;
          float pv = ex2(fmaf(s[4 * j + e], c, -(hi ? lse_hi : lse_lo)));
          if (masked) {
            const int key = kb0 + 8 * j + col_lane + (e & 1);
            const int row = row_lo + (hi ? 8 : 0);
            if (key >= p.Sk || row >= p.Sq || (p.causal && key > row + offset)) pv = 0.f;
          }
          dp[4 * j + e] = pv * (dp[4 * j + e] - (hi ? de_hi : de_lo));
        }
      }
      uint32_t dh[2][4], dl[2][4];
      split_a<2>(dh, dl, dp);

      // dQ += dS K
      mbar_wait(b_full(sb), (kt / kQStagesB) & 1);
      fence_regs(dq);
      fence_regs(dh);
      fence_regs(dl);
      wgmma_fence();
      rs_product<DV>(dq, dh, dl, b_tile(sb));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      if (lane == 0) mbar_arrive(b_empty(sb));
    }
    add_rows<D, DV>(dq_rows, dq, row_lo, p.Sq, col_lane, p.scale, kt0 == 0);
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dq[i] = 0.f;
  }
}

// ---- host ------------------------------------------------------------
struct Maps {
  CUtensorMap q16, do16, k64, v64, qt, dot, ld;  // the dkdv kernel's
  CUtensorMap q64, do64, k16, v16, kt;           // the dq kernel's
};

template <int D>
int launch_d(const Maps& m, int B, const Params& p, cudaStream_t s) {
  constexpr int NQ = (D + kBoxCols - 1) / kBoxCols, DV = (D + 63) / 64 * 64;
  static bool kv_set = false, q_set = false;
  auto kv = fa_bwd_f32_sm90_dkdv_kernel<D>;
  auto qk = fa_bwd_f32_sm90_dq_kernel<D>;
  int err = allow_smem(kv, KvLayout<NQ, DV>::kBytes, kv_set);
  if (err == 0) err = allow_smem(qk, QLayout<NQ, DV>::kBytes, q_set);
  if (err != 0) return err;
  const dim3 keys(static_cast<unsigned>(B) * p.hkv, (p.Sk + kKeys - 1) / kKeys);
  kv<<<keys, kThreads, KvLayout<NQ, DV>::kBytes, s>>>(m.q16, m.k64, m.v64, m.do16, m.qt, m.dot,
                                                      m.ld, p);
  const dim3 queries(static_cast<unsigned>(B) * p.hq, p.n_qt);
  qk<<<queries, kThreads, QLayout<NQ, DV>::kBytes, s>>>(m.q64, m.k16, m.v16, m.do64, m.kt, p);
  return 0;
}

}  // namespace

// float32 q, o, dO (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D) with the given
// element strides.  dims holds 21 values: B, Hq, Hkv, Sq, Sk, D, then the
// (batch, head, seq) element strides of q, k, v, o and dO (the last dim
// contiguous).  lse is the forward's float32 (B, Hq, Sq) log-sum-exp; ld a
// float32 buffer of B Hq 2 Sqp elements this call fills, Sqp = Sq rounded
// up to 64.  scratch is one contiguous float32 buffer this call fills with
// the split parts, one after the other: qs, dos (B Hq, Sq, 2 DQ), ks, vs
// (B Hkv, Sk, 2 DQ), qt, dot (B Hq, 2, DV, Sq rounded up to 32) and kt (B
// Hkv, 2, DV, Sk rounded up to 32) (DQ = D rounded up to 32, DV = D
// rounded up to 64).  dq (B, Hq, Sq, D) and dk, dv (B, Hkv, Sk, D) are
// written contiguous.  D a multiple of 16 in [16, 128]; Hq a multiple of
// Hkv; Sq, Sk >= 1; causal needs Sq <= Sk.
extern "C" int repro_flash_attention_bwd_f32_sm90(
    const void* q, const void* k, const void* v, const void* o, const void* dO, const void* lse,
    void* ld, void* dq, void* dk, void* dv, void* scratch, const long long* dims, float scale,
    int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = static_cast<int>(dims[0]), D = static_cast<int>(dims[5]);
  Params p;
  p.hq = static_cast<int>(dims[1]);
  p.hkv = static_cast<int>(dims[2]);
  p.Sq = static_cast<int>(dims[3]);
  p.Sk = static_cast<int>(dims[4]);
  p.group = p.hq / p.hkv;
  p.Sqp = (p.Sq + kRowPad - 1) / kRowPad * kRowPad;
  p.causal = causal;
  p.n_qt = (p.Sq + kRows - 1) / kRows;
  p.scale_log2 = scale * kLog2e;
  p.scale = scale;
  p.ld = static_cast<const float*>(ld);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  const long long* sq = dims + 6;
  const long long* sk = dims + 9;
  const long long* sv = dims + 12;
  const long long* so = dims + 15;
  const long long* sg = dims + 18;
  if (D < 16 || D > 128 || D % 16 != 0 || B > 65535 || p.hq > 65535 || p.n_qt > 65535 ||
      static_cast<long long>(B) * p.hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int DQ = (D + kBoxCols - 1) / kBoxCols * kBoxCols, DV = (D + 63) / 64 * 64;
  const int Sqc = (p.Sq + kColPad - 1) / kColPad * kColPad;
  const int Skc = (p.Sk + kColPad - 1) / kColPad * kColPad;
  const long long BHq = static_cast<long long>(B) * p.hq, BHk = static_cast<long long>(B) * p.hkv;
  float* const qs = static_cast<float*>(scratch);
  float* const dos = qs + BHq * p.Sq * 2 * DQ;
  float* const ks = dos + BHq * p.Sq * 2 * DQ;
  float* const vs = ks + BHk * p.Sk * 2 * DQ;
  float* const qt = vs + BHk * p.Sk * 2 * DQ;
  float* const dot = qt + BHq * 2 * DV * Sqc;
  float* const kt = dot + BHq * 2 * DV * Sqc;

  SplitArgs sa;
  sa.D = D;
  sa.DQ = DQ;
  sa.DV = DV;
  sa.src[0] = {static_cast<const float*>(q), sq[0], sq[1], sq[2], p.hq, B * p.hq, p.Sq, Sqc, qs,
               qt};
  sa.src[1] = {static_cast<const float*>(dO), sg[0], sg[1], sg[2], p.hq, B * p.hq, p.Sq, Sqc, dos,
               dot};
  sa.src[2] = {static_cast<const float*>(k), sk[0], sk[1], sk[2], p.hkv, B * p.hkv, p.Sk, Skc, ks,
               kt};
  sa.src[3] = {static_cast<const float*>(v), sv[0], sv[1], sv[2], p.hkv, B * p.hkv, p.Sk, Skc, vs,
               nullptr};
  const dim3 split_grid((Sqc > Skc ? Sqc : Skc) / 32 * (DV / 32), B * p.hq, 4);
  fa_bwd_f32_sm90_split_kernel<<<split_grid, dim3(32, 8), 0, s>>>(sa);

  Maps m;
  const CUtensorMapSwizzle w128 = CU_TENSOR_MAP_SWIZZLE_128B, w64 = CU_TENSOR_MAP_SWIZZLE_64B;
  int err = make_map(&m.q16, qs, 2 * DQ, p.Sq, BHq, kBoxCols, kSub, w128);
  if (err == 0) err = make_map(&m.q64, qs, 2 * DQ, p.Sq, BHq, kBoxCols, kRows, w128);
  if (err == 0) err = make_map(&m.do16, dos, 2 * DQ, p.Sq, BHq, kBoxCols, kSub, w128);
  if (err == 0) err = make_map(&m.do64, dos, 2 * DQ, p.Sq, BHq, kBoxCols, kRows, w128);
  if (err == 0) err = make_map(&m.k64, ks, 2 * DQ, p.Sk, BHk, kBoxCols, kKeys, w128);
  if (err == 0) err = make_map(&m.k16, ks, 2 * DQ, p.Sk, BHk, kBoxCols, kSub, w128);
  if (err == 0) err = make_map(&m.v64, vs, 2 * DQ, p.Sk, BHk, kBoxCols, kKeys, w128);
  if (err == 0) err = make_map(&m.v16, vs, 2 * DQ, p.Sk, BHk, kBoxCols, kSub, w128);
  if (err == 0) err = make_map(&m.qt, qt, Sqc, DV, 2 * BHq, kSub, DV, w64);
  if (err == 0) err = make_map(&m.dot, dot, Sqc, DV, 2 * BHq, kSub, DV, w64);
  if (err == 0) err = make_map(&m.kt, kt, Skc, DV, 2 * BHk, kSub, DV, w64);
  if (err == 0)
    err = make_map(&m.ld, ld, p.Sqp, 2 * BHq, 0, kSub, 2, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;

  DeltaArgs da{p.hq, p.Sq, p.Sqp, D, so[0], so[1], so[2], sg[0], sg[1], sg[2]};
  const dim3 rows(p.Sqp / 8, p.hq, B);
  fa_bwd_f32_sm90_delta_kernel<<<rows, 256, 0, s>>>(
      static_cast<const float*>(o), static_cast<const float*>(dO),
      static_cast<const float*>(lse), static_cast<float*>(ld), da);
#define REPRO_FABF32_CASE(DD)             \
  case DD:                                \
    err = launch_d<DD>(m, B, p, s);       \
    break;
  switch (D) {
    REPRO_FABF32_CASE(16)
    REPRO_FABF32_CASE(32)
    REPRO_FABF32_CASE(48)
    REPRO_FABF32_CASE(64)
    REPRO_FABF32_CASE(80)
    REPRO_FABF32_CASE(96)
    REPRO_FABF32_CASE(112)
    REPRO_FABF32_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FABF32_CASE
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
