// Backward of causal or full grouped-query attention in bf16 on Hopper's
// tensor cores: dq, dk and dv from q, k, v, the forward's output o, its
// gradient dO and the forward's per-row log-sum-exp.
//
// The TPU kernel `flash_attention_pallas` (src/repro/kernels/flash_attention.py)
// has no backward: the JAX package differentiates through XLA attention.
// The port's forward runs the hand-written K4 kernels, so training on the
// card needs a backward.  This source is the bf16 one; float32 runs
// csrc/flash_attention_bwd_f32_sm90.cu, also on the tensor cores, in
// split TF32 (one TF32 product would miss the float32 tolerance, three do
// not), just as the forward's two sources are split.  It computes what
// autograd of `flash_attention_plain` computes:
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
// What bounds it on an H100: operations.  Qwen3-14B's training shape (B 1,
// Hq 40, Hkv 8, S 4096, D 128, causal) needs five products of 2 S^2 D a
// head, halved by the mask: 429.5 GFLOP, 0.434 ms at the 989 TFLOP/s of
// the bf16 tensor cores.  So every product runs on the tensor cores
// (wgmma), fed by the copy engine (TMA), with the machinery of the
// forward (csrc/flash_attention_sm90.cu): tensor maps from
// cuTensorMapEncodeTiled reached through the driver entry point, a ring
// of shared-memory stages with full and empty mbarriers, a producer
// warpgroup that gives up its registers with setmaxnreg, and
// wgmma.mma_async m64nNk16, bf16 in and float32 accumulate.
//
// Three kernels, launched in order on one stream by one C call:
//   1. delta: Delta = rowsum(dO * O) and lse * log2(e), one warp a row,
//      into a float32 (B Hq, 2, Sqp) buffer (Sqp = Sq rounded up to 192,
//      zeros past Sq), whose rows of 16-byte multiples the copy engine
//      can load beside each query tile;
//   2. dkdv: one block per (batch, kv head, 128-key tile), two consumer
//      warpgroups of 64 keys each, looping over the query heads of its
//      group and the 64-query tiles that see its keys:
//        S^T = K Q^T and dP^T = V dO^T (m64n64k16, both operands K-major
//          in shared memory, as the forward's S);
//        P^T and dS^T computed on the accumulator fragment, rounded to
//          bf16 in registers, where the fragment already has the layout of
//          wgmma's register A operand (as the forward's P);
//        dV += P^T dO and dK += dS^T Q (m64nDPk16, dO and Q the B operand
//          through the transpose flag, as the forward's V);
//      dK and dV stay in registers to the end;
//   3. dq: one block per (batch, q head, 192-query tile), three consumer
//      warpgroups of 64 queries (three, so that every key tile read from
//      L2 serves 192 queries), looping over the 64-key tiles its queries
//      see: S = Q K^T and dP = dO V^T, dS, then dQ += dS K (K the B
//      operand through the transpose flag).
// No block writes what another writes: no atomics, so the result repeats
// bit for bit.  The split builds S and dP in both kernels: seven products
// where five would do, so at most 5/7 of the bound is reachable.
//
// Registers at D 128, a consumer thread: dK 64 + dV 64 + S^T 32 + dP^T 32
// floats in the dkdv kernel, whose producer warpgroup gives its
// registers down to 40 so that a consumer thread may hold 232; dQ 64 +
// S 32 + dP 32 in the dq kernel, whose producer gives them down to 24
// for 160 a consumer thread.  Shared memory at D 128: the dkdv kernel's K
// and V tiles (64 KB) and three stages of Q, dO (64 rows each) and their
// lse and Delta (97.5 KB); the dq kernel's Q and dO tiles (96 KB) and
// three stages of K and V (64 rows each, 96 KB).  A box is 64 columns (128 bytes) wide
// with the 128-byte swizzle: D < 64 and the second half of D = 80, 96, 112
// are zeros from the copy engine's out-of-bounds fill, as are rows past
// Sq and Sk.
//
// Within a tile the products run back to back: S and dP, then the
// softmax's gradient, then the two products into dK and dV (or dQ).  The
// consumer warpgroups take turns to issue their products (ping-pong, with
// named barriers), so one's softmax gradient runs while another's
// products hold the tensor cores; the dq kernel also computes P while dP
// still runs.  Measured slower on the H100 (PERF.md): starting the dkdv
// kernel's dV product before dS^T is done (ptxas runs out of registers
// and serialises its wgmma, C7512), skipping the products of fully masked
// tiles in a branch, and keeping two key tiles in flight in the dq kernel
// (both serialised, C7518); and a dq kernel of two warpgroups over
// 128-key tiles (m64n128 products for S and dP).  Left for later:
// overlap of one tile's S with the last tile's dK/dV products, a
// persistent grid, and one kernel with dQ summed across blocks (the
// five-product design, which needs atomics or a reduction pass).
//
// C interface: one function, loaded with ctypes.  It launches on the given
// stream, allocates nothing (the lse/Delta buffer is the caller's), and
// returns cudaGetLastError(), or 1000 plus the driver's error if a tensor
// map cannot be encoded.

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 128;                   // keys of a dkdv block's own tile
constexpr int kSmall = 64;                  // rows of a looped tile (queries or keys)
constexpr int kStages = 3;                  // depth of the ring of looped tiles
constexpr int kConsumers = 256;             // dkdv: two warpgroups
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kDqRows = 192;                    // queries of a dq block's own tile
constexpr int kDqConsumers = 384;               // dq: three warpgroups
constexpr int kDqThreads = kDqConsumers + 128;  // and one producer warpgroup
constexpr int kDqProducerRegs = 24;
constexpr int kDqConsumerRegs = 160;
constexpr int kBoxCols = 64;  // bf16 columns of a 128-byte swizzled box
constexpr int kRowPad = 192;  // Sqp: Sq rounded up to this (a multiple of kSmall and kDqRows)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------
// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of a register operand
// across the asynchronous products, which read and write it later.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// Named barriers that pass the turn to issue products from one consumer
// warpgroup to the next (ids 1 to 3; 0 is __syncthreads): 128 threads
// sync on a barrier, the 128 of the warpgroup before arrive on it.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 64, f32) {=, +=} A (64 x 16, bf16, K-major in shared memory)
//   x B (64 x 16, bf16, K-major in shared memory); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16, in registers)
//   x B (16 x 64, bf16, 64 contiguous in shared memory: the transpose flag).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16, in registers)
//   x B (16 x 128, bf16, 128 contiguous in shared memory: the transpose flag).
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A 64 x 64 accumulator fragment rounded to bf16 in wgmma's A-operand
// layout: for the k16 slice kk, registers 0, 1 are chunk 2 kk (rows lo,
// hi), 2, 3 chunk 2 kk + 1.
__device__ __forceinline__ void to_a_operand(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j / 2][(j % 2) * 2] = pack_bf16(x[4 * j], x[4 * j + 1]);
    a[j / 2][(j % 2) * 2 + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// acc (64 x DP) += A (64 x 64, registers) x B (64 rows of a tile at
// `tile`, DP columns as DP / 64 boxes of box_bytes each): four k16 slices
// of 16 rows, 16 x 128 bytes apart; the next 64 columns lie one box on,
// the next 8 rows 1024 bytes on.
template <int DP>
__device__ __forceinline__ void rs_product(float (&acc)[DP / 2], const uint32_t (&a)[4][4],
                                           uint32_t tile, uint32_t box_bytes) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = smem_desc(tile + kk * 16 * 128, box_bytes, 1024);
    if constexpr (DP == 64) {
      wgmma_rs_n64_tb(acc, a[kk], db);
    } else {
      wgmma_rs_n128_tb(acc, a[kk], db);
    }
  }
}

// d (64 x 64) = A (64 rows at a_rows in boxes of a_box bytes) x B^T (64
// rows at b_rows in boxes of b_box bytes), over D / 16 k16 slices: both
// K-major, the next 16 columns 32 bytes on within a box, the next 64 one
// box on.
template <int D>
__device__ __forceinline__ void ss_product(float (&d)[32], uint32_t a_rows, uint32_t a_box,
                                           uint32_t b_rows, uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t at = (kk / 4) * a_box + (kk % 4) * 32;
    const uint32_t bt = (kk / 4) * b_box + (kk % 4) * 32;
    wgmma_ss_n64(d, smem_desc(a_rows + at, 16, 1024), smem_desc(b_rows + bt, 16, 1024), kk > 0);
  }
}

struct Params {
  int hq, hkv, group, Sq, Sk, Sqp, causal;
  int n_qt;                // kDqRows-query tiles (dq kernel)
  float scale_log2;        // 1 / sqrt(D) * log2(e)
  float scale;             // 1 / sqrt(D)
  const float* ld;         // (B Hq, 2, Sqp): lse * log2(e), then Delta
  __nv_bfloat16 *dq, *dk, *dv;  // contiguous outputs
  int pos_q[3], pos_k[3], pos_v[3], pos_do[3];  // tensor-map dim of (seq, head, batch)
};

// The NB boxes of rows [row, row + box rows) of (batch b, head), box_bytes
// apart, onto barrier bar.
template <int NB>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, const int (&pos)[3],
                                          uint32_t dst, uint32_t box_bytes, uint32_t bar,
                                          int row, int head, int b) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    int at[4];
    at[0] = c * kBoxCols;
    at[pos[0]] = row;
    at[pos[1]] = head;
    at[pos[2]] = b;
    tma_load_4d(dst + c * box_bytes, map, bar, at[0], at[1], at[2], at[3]);
  }
}

// Stores a 64 x DP float fragment times `mul` as bf16 rows [row_lo,
// row_lo + 8) of a contiguous (rows, D) slice, rows at or past n skipped.
template <int D, int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[DP / 2],
                                           int row_lo, int n, int col_lane, float mul) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + col_lane;
    if (row_lo < n)
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row_lo) * D + col) =
          __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (row_lo + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row_lo + 8) * D + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// ---- 1. delta --------------------------------------------------------
struct DeltaArgs {
  int Hq, Sq, Sqp, D;
  long long osb, osh, oss, gsb, gsh, gss;  // element strides of o and dO
};

__global__ void __launch_bounds__(256) fa_bwd_sm90_delta_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dO,
    const float* __restrict__ lse, float* __restrict__ ld, DeltaArgs a) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= a.Sqp) return;
  const size_t bh = static_cast<size_t>(b) * a.Hq + h;
  float acc = 0.f;
  if (row < a.Sq) {
    const __nv_bfloat16* op = o + b * a.osb + h * a.osh + row * a.oss;
    const __nv_bfloat16* gp = dO + b * a.gsb + h * a.gsh + row * a.gss;
    for (int c = lane; c < a.D; c += 32)
      acc = fmaf(__bfloat162float(op[c]), __bfloat162float(gp[c]), acc);
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, sh);
  if (lane == 0) {
    float* out = ld + bh * 2 * a.Sqp;
    out[row] = row < a.Sq ? lse[bh * a.Sq + row] * kLog2e : 0.f;
    out[a.Sqp + row] = acc;
  }
}

// ---- 2. dk, dv -------------------------------------------------------
// Byte offsets of one dkdv block's shared-memory buffers: the block's K
// and V tiles (kBig rows), then kStages stages of Q and dO (kSmall rows)
// and of their lse/Delta rows (2 x 64 floats).
template <int DP>
struct KvLayout {
  static constexpr uint32_t kBigBox = kBig * 128, kSmallBox = kSmall * 128;
  static constexpr uint32_t kBigBytes = DP / kBoxCols * kBigBox;
  static constexpr uint32_t kSmallBytes = DP / kBoxCols * kSmallBox;
  static constexpr uint32_t kK = 0, kV = kBigBytes;
  static constexpr uint32_t kQ = 2 * kBigBytes;  // stage st: Q at kQ + 2 st kSmallBytes, dO after
  static constexpr uint32_t kLd = kQ + kStages * 2 * kSmallBytes;  // stage st at + 512 st
  // kv_full, full[], empty[]
  static constexpr uint32_t kBars = kLd + kStages * 2 * kSmall * 4;
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_sm90_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tld, const Params p) {
  constexpr int DP = (D + kBoxCols - 1) / kBoxCols * kBoxCols;  // N of dV, dK
  constexpr int NB = DP / kBoxCols;
  using L = KvLayout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* ld_smem = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::kLd);
  const uint32_t bars = base + L::kBars;
  const uint32_t kv_full = bars;
  auto full = [&](int st) { return bars + 8u * (1 + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + kStages + st); };
  auto q_tile = [&](int st) { return base + L::kQ + 2u * st * L::kSmallBytes; };

  const int hk = blockIdx.x % p.hkv, b = blockIdx.x / p.hkv;
  const int k0 = blockIdx.y * kBig;
  const int offset = p.Sk - p.Sq;
  // the query tiles with a row that sees a key of this tile, for each
  // query head of the group
  const int qt0 = p.causal ? max(0, k0 - offset) / kSmall : 0;
  const int per_head = (p.Sq + kSmall - 1) / kSmall - qt0;
  const int n_iter = p.group * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(kv_full, 2 * L::kBigBytes);
      load_tile<NB>(&tk, p.pos_k, base + L::kK, L::kBigBox, kv_full, k0, hk, b);
      load_tile<NB>(&tv, p.pos_v, base + L::kV, L::kBigBox, kv_full, k0, hk, b);
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % kStages;
        const int h = hk * p.group + it / per_head, qt = qt0 + it % per_head;
        mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full(st), 2 * L::kSmallBytes + 2 * kSmall * 4);
        load_tile<NB>(&tq, p.pos_q, q_tile(st), L::kSmallBox, full(st), qt * kSmall, h, b);
        load_tile<NB>(&tdo, p.pos_do, q_tile(st) + L::kSmallBytes, L::kSmallBox, full(st),
                      qt * kSmall, h, b);
        tma_load_2d(base + L::kLd + st * 2 * kSmall * 4, &tld, full(st), qt * kSmall,
                    2 * (b * p.hq + h));
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys k0 + 64 wg .. + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  // accumulator fragment: this thread holds rows (keys) key_lo and
  // key_lo + 8, columns 8 j + col_lane + {0, 1} of every 8-column chunk j
  const int kw0 = k0 + 64 * wg;
  const int key_lo = kw0 + 16 * warp + lane / 4;
  const int col_lane = 2 * (lane % 4);
  const uint32_t k_rows = base + L::kK + wg * 64 * 128;
  const uint32_t v_rows = base + L::kV + wg * 64 * 128;

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

  // Ping-pong: the two warpgroups take turns to issue their products
  // (barrier 1 + wg is this one's turn), so one's softmax gradient runs
  // while the other's products hold the tensor cores.  Warpgroup 0 goes
  // first.  No tile is skipped (a warpgroup whose keys no query of the
  // tile sees gets P = 0 from the mask): a branch around the products
  // makes ptxas serialise them (C7518).
  if (wg == 1) named_arrive(1);
  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int st = it % kStages;
    const int q0 = (qt0 + it % per_head) * kSmall;
    mbar_wait(full(st), (it / kStages) & 1);
    const uint32_t qt = q_tile(st), dot = qt + L::kSmallBytes;
    float s[32], dp[32];
    named_sync(1 + wg);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    ss_product<D>(s, k_rows, L::kBigBox, qt, L::kSmallBox);   // S^T = K Q^T
    ss_product<D>(dp, v_rows, L::kBigBox, dot, L::kSmallBox);  // dP^T = V dO^T
    wgmma_commit();
    named_arrive(2 - wg);
    uint32_t pa[4][4], da[4][4];
    {
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P^T = 2^(s c - lse2[q]) where kept, else 0; dS^T = P^T (dP^T - Delta[q]).
      // (dV's product is not started before dS^T is done: with S^T, dP^T
      // and P^T live beside dK and dV the products would be serialised.)
      const float* lse2 = ld_smem + st * 2 * kSmall;
      const float* delta = lse2 + kSmall;
      const bool masked = kw0 + 64 > p.Sk || q0 + kSmall > p.Sq ||
                          (p.causal && kw0 + 63 > q0 + offset);
      const float c = p.scale_log2;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + col_lane);
        const float2 de = *reinterpret_cast<const float2*>(delta + 8 * j + col_lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pv = ex2(fmaf(s[4 * j + e], c, -((e & 1) ? l2.y : l2.x)));
          if (masked) {
            const int key = key_lo + ((e & 2) ? 8 : 0);
            const int q = q0 + 8 * j + col_lane + (e & 1);
            if (key >= p.Sk || q >= p.Sq || (p.causal && key > q + offset)) pv = 0.f;
          }
          s[4 * j + e] = pv;
          dp[4 * j + e] = pv * (dp[4 * j + e] - ((e & 1) ? de.y : de.x));
        }
      }
      to_a_operand(pa, s);
      to_a_operand(da, dp);
    }
    // dV += P^T dO, dK += dS^T Q
    named_sync(1 + wg);
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
    rs_product<DP>(dv, pa, dot, L::kSmallBox);
    rs_product<DP>(dk, da, qt, L::kSmallBox);
    wgmma_commit();
    named_arrive(2 - wg);
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    if (lane == 0) mbar_arrive(empty(st));  // this warp is done with the stage
  }

  const size_t at = (static_cast<size_t>(b) * p.hkv + hk) * p.Sk * D;
  store_rows<D, DP>(p.dk + at, dk, key_lo, p.Sk, col_lane, p.scale);
  store_rows<D, DP>(p.dv + at, dv, key_lo, p.Sk, col_lane, 1.f);
}

// ---- 3. dq -----------------------------------------------------------
// Byte offsets of one dq block's shared-memory buffers: its Q and dO
// tiles (kDqRows rows), then kStages stages of K and V (kSmall rows).
template <int DP>
struct QLayout {
  static constexpr uint32_t kBigBox = kDqRows * 128, kSmallBox = kSmall * 128;
  static constexpr uint32_t kBigBytes = DP / kBoxCols * kBigBox;
  static constexpr uint32_t kSmallBytes = DP / kBoxCols * kSmallBox;
  static constexpr uint32_t kQ = 0, kDo = kBigBytes;
  static constexpr uint32_t kK = 2 * kBigBytes;  // stage st: K at kK + 2 st kSmallBytes, V after
  // q_full, full[], empty[]
  static constexpr uint32_t kBars = kK + kStages * 2 * kSmallBytes;
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
    fa_bwd_sm90_dq_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, const Params p) {
  constexpr int DP = (D + kBoxCols - 1) / kBoxCols * kBoxCols;
  constexpr int NB = DP / kBoxCols;
  using L = QLayout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBars;
  const uint32_t q_full = bars;
  auto full = [&](int st) { return bars + 8u * (1 + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + kStages + st); };
  auto k_tile = [&](int st) { return base + L::kK + 2u * st * L::kSmallBytes; };

  const int h = blockIdx.x % p.hq, b = blockIdx.x / p.hq;
  const int hk = h / p.group;
  // the q tile reversed, so the causal tiles with the most key tiles launch first
  const int q0 = (p.n_qt - 1 - static_cast<int>(blockIdx.y)) * kDqRows;
  const int offset = p.Sk - p.Sq;
  int nk = (p.Sk + kSmall - 1) / kSmall;
  if (p.causal) nk = min(nk, (min(q0 + kDqRows, p.Sq) - 1 + offset) / kSmall + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kDqConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kDqConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kDqProducerRegs));
    if (threadIdx.x == kDqConsumers) {
      mbar_expect_tx(q_full, 2 * L::kBigBytes);
      load_tile<NB>(&tq, p.pos_q, base + L::kQ, L::kBigBox, q_full, q0, h, b);
      load_tile<NB>(&tdo, p.pos_do, base + L::kDo, L::kBigBox, q_full, q0, h, b);
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kStages;
        mbar_wait(empty(st), ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * L::kSmallBytes);
        load_tile<NB>(&tk, p.pos_k, k_tile(st), L::kSmallBox, full(st), kt * kSmall, hk, b);
        load_tile<NB>(&tv, p.pos_v, k_tile(st) + L::kSmallBytes, L::kSmallBox, full(st),
                      kt * kSmall, hk, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns queries q0 + 64 wg .. + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kDqConsumerRegs));
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int qw0 = q0 + 64 * wg;
  const int row_lo = qw0 + 16 * warp + lane / 4;
  const int col_lane = 2 * (lane % 4);
  const size_t bh = static_cast<size_t>(b) * p.hq + h;
  // rows below Sqp (a multiple of kDqRows) always lie in the buffer
  const float* ldr = p.ld + bh * 2 * p.Sqp;
  const float lse_lo = ldr[row_lo], lse_hi = ldr[row_lo + 8];
  const float de_lo = ldr[p.Sqp + row_lo], de_hi = ldr[p.Sqp + row_lo + 8];
  const uint32_t q_rows = base + L::kQ + wg * 64 * 128;
  const uint32_t do_rows = base + L::kDo + wg * 64 * 128;

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

  // The three warpgroups take turns to issue their products (barrier
  // 1 + wg is this one's turn, then the next one's), so their softmax
  // gradients run while the others' products hold the tensor cores;
  // warpgroup 0 goes first.  No tile is skipped (queries that see none of
  // a tile's keys get P = 0 from the mask): a branch around the products
  // makes ptxas serialise them (C7518).
  const int next_turn = 1 + (wg + 1) % 3;
  if (wg == 2) named_arrive(1);
  mbar_wait(q_full, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kStages;
    const int kb0 = kt * kSmall;
    mbar_wait(full(st), (kt / kStages) & 1);
    const uint32_t kt_s = k_tile(st), vt_s = kt_s + L::kSmallBytes;
    float s[32], dp[32];
    named_sync(1 + wg);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    ss_product<D>(s, q_rows, L::kBigBox, kt_s, L::kSmallBox);  // S = Q K^T
    wgmma_commit();
    ss_product<D>(dp, do_rows, L::kBigBox, vt_s, L::kSmallBox);  // dP = dO V^T
    wgmma_commit();
    named_arrive(next_turn);
    wgmma_wait<1>();  // S is ready, dP may still run
    fence_regs(s);

    const bool masked = kb0 + kSmall > p.Sk || qw0 + 64 > p.Sq ||
                        (p.causal && kb0 + kSmall - 1 > qw0 + offset);
    const float c = p.scale_log2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = (e & 2) != 0;
        float pv = ex2(fmaf(s[4 * j + e], c, -(hi ? lse_hi : lse_lo)));
        if (masked) {
          const int key = kb0 + 8 * j + col_lane + (e & 1);
          const int row = row_lo + (hi ? 8 : 0);
          if (key >= p.Sk || row >= p.Sq || (p.causal && key > row + offset)) pv = 0.f;
        }
        s[4 * j + e] = pv;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 2) ? de_hi : de_lo));
    uint32_t da[4][4];
    to_a_operand(da, dp);

    // dQ += dS K
    named_sync(1 + wg);
    fence_regs(dq);
    fence_regs(da);
    wgmma_fence();
    rs_product<DP>(dq, da, kt_s, L::kSmallBox);
    wgmma_commit();
    named_arrive(next_turn);
    wgmma_wait<0>();
    fence_regs(dq);
    if (lane == 0) mbar_arrive(empty(st));
  }

  store_rows<D, DP>(p.dq + bh * p.Sq * D, dq, row_lo, p.Sq, col_lane, p.scale);
}

// ---- host ------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// A 4-D tensor map over a bf16 (B, H, S, D) view with element strides
// (sb, sh, ss, 1), as the forward's: dim 0 is D, boxed 64 wide; the other
// three are (seq, head, batch) in the order of their strides, ascending,
// and pos[] records where each went.  The box takes `rows` of seq and one
// head and batch.  A dim of size 1 goes last with a stride that keeps the
// strides ascending.
int make_map(CUtensorMap* map, const void* ptr, int B, int H, int S, int D, long long sb,
             long long sh, long long ss, int rows, int pos[3]) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  struct Dim {
    long long size, stride;
    int box, which;
  } d[3] = {{S, ss * 2, rows, 0}, {H, sh * 2, 1, 1}, {B, sb * 2, 1, 2}};
  auto before = [](const Dim& x, const Dim& y) {
    if ((x.size == 1) != (y.size == 1)) return y.size == 1;
    return x.stride < y.stride;
  };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && before(d[j], d[j - 1]); --j) {
      const Dim t = d[j];
      d[j] = d[j - 1];
      d[j - 1] = t;
    }
  long long extent = static_cast<long long>(D) * 2;  // bytes spanned by the dims below
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D)}, strides[3];
  cuuint32_t box[4] = {kBoxCols}, estride[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    if (d[i].size == 1) d[i].stride = (extent + 15) / 16 * 16;
    extent = d[i].stride * d[i].size > extent ? d[i].stride * d[i].size : extent;
    dims[i + 1] = static_cast<cuuint64_t>(d[i].size);
    strides[i] = static_cast<cuuint64_t>(d[i].stride);
    box[i + 1] = static_cast<cuuint32_t>(d[i].box);
    pos[d[i].which] = i + 1;
  }
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

// A 2-D map over the float32 (rows, Sqp) lse/Delta buffer, boxed 64
// columns by 2 rows (a query tile's lse and Delta), no swizzle.
int make_ld_map(CUtensorMap* map, const void* ptr, long long rows, int Sqp) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Sqp), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Sqp) * 4};
  const cuuint32_t box[2] = {kSmall, 2}, estride[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
                            strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

template <typename Kern>
int allow_smem(Kern kern, uint32_t bytes, bool& done) {  // above 48 KB needs the opt-in, once
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;
  return 0;
}

struct Maps {
  CUtensorMap q64, k128, v128, do64, ld;  // the dkdv kernel's
  CUtensorMap q192, k64, v64, do192;      // the dq kernel's
};

template <int D>
int launch_d(const Maps& m, int B, const Params& p, cudaStream_t s) {
  constexpr int DP = (D + kBoxCols - 1) / kBoxCols * kBoxCols;
  static bool kv_set = false, q_set = false;
  auto kv = fa_bwd_sm90_dkdv_kernel<D>;
  auto qk = fa_bwd_sm90_dq_kernel<D>;
  int err = allow_smem(kv, KvLayout<DP>::kBytes, kv_set);
  if (err == 0) err = allow_smem(qk, QLayout<DP>::kBytes, q_set);
  if (err != 0) return err;
  const dim3 keys(static_cast<unsigned>(B) * p.hkv, (p.Sk + kBig - 1) / kBig);
  kv<<<keys, kThreads, KvLayout<DP>::kBytes, s>>>(m.q64, m.k128, m.v128, m.do64, m.ld, p);
  const dim3 queries(static_cast<unsigned>(B) * p.hq, p.n_qt);
  qk<<<queries, kDqThreads, QLayout<DP>::kBytes, s>>>(m.q192, m.k64, m.v64, m.do192, p);
  return 0;
}

}  // namespace

// bf16 q, o, dO (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D) with the given
// element strides.  dims holds 21 values: B, Hq, Hkv, Sq, Sk, D, then the
// (batch, head, seq) element strides of q, k, v, o and dO (the last dim
// contiguous; for q, k, v and dO every stride of a dim longer than 1 a
// multiple of 8 elements and every base 16-byte aligned, as the copy
// engine wants).  lse is the forward's float32 (B, Hq, Sq) log-sum-exp;
// ld a float32 buffer of B Hq 2 Sqp elements this call fills, Sqp = Sq
// rounded up to 192.  dq (B, Hq, Sq, D) and dk, dv (B, Hkv, Sk, D) are
// written contiguous, in bf16.  D a multiple of 16 in [16, 128]; Hq a
// multiple of Hkv; Sq, Sk >= 1; causal needs Sq <= Sk.
extern "C" int repro_flash_attention_bwd_sm90(const void* q, const void* k, const void* v,
                                              const void* o, const void* dO, const void* lse,
                                              void* ld, void* dq, void* dk, void* dv,
                                              const long long* dims, float scale, int causal,
                                              void* stream) {
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
  p.n_qt = (p.Sq + kDqRows - 1) / kDqRows;
  p.scale_log2 = scale * kLog2e;
  p.scale = scale;
  p.ld = static_cast<const float*>(ld);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  const long long* sq = dims + 6;
  const long long* sk = dims + 9;
  const long long* sv = dims + 12;
  const long long* so = dims + 15;
  const long long* sg = dims + 18;
  if (B > 65535 || p.hq > 65535 || p.n_qt > 65535 ||
      static_cast<long long>(B) * p.hq > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);

  Maps m;
  int err = make_map(&m.q64, q, B, p.hq, p.Sq, D, sq[0], sq[1], sq[2], kSmall, p.pos_q);
  if (err == 0)
    err = make_map(&m.q192, q, B, p.hq, p.Sq, D, sq[0], sq[1], sq[2], kDqRows, p.pos_q);
  if (err == 0) err = make_map(&m.k128, k, B, p.hkv, p.Sk, D, sk[0], sk[1], sk[2], kBig, p.pos_k);
  if (err == 0) err = make_map(&m.k64, k, B, p.hkv, p.Sk, D, sk[0], sk[1], sk[2], kSmall, p.pos_k);
  if (err == 0) err = make_map(&m.v128, v, B, p.hkv, p.Sk, D, sv[0], sv[1], sv[2], kBig, p.pos_v);
  if (err == 0) err = make_map(&m.v64, v, B, p.hkv, p.Sk, D, sv[0], sv[1], sv[2], kSmall, p.pos_v);
  if (err == 0) err = make_map(&m.do64, dO, B, p.hq, p.Sq, D, sg[0], sg[1], sg[2], kSmall, p.pos_do);
  if (err == 0)
    err = make_map(&m.do192, dO, B, p.hq, p.Sq, D, sg[0], sg[1], sg[2], kDqRows, p.pos_do);
  if (err == 0) err = make_ld_map(&m.ld, ld, 2LL * B * p.hq, p.Sqp);
  if (err != 0) return err;

  DeltaArgs da{p.hq, p.Sq, p.Sqp, D, so[0], so[1], so[2], sg[0], sg[1], sg[2]};
  const dim3 rows(p.Sqp / 8, p.hq, B);
  fa_bwd_sm90_delta_kernel<<<rows, 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dO),
      static_cast<const float*>(lse), static_cast<float*>(ld), da);
#define REPRO_FAB90_CASE(DD)              \
  case DD:                                \
    err = launch_d<DD>(m, B, p, s);       \
    break;
  switch (D) {
    REPRO_FAB90_CASE(16)
    REPRO_FAB90_CASE(32)
    REPRO_FAB90_CASE(48)
    REPRO_FAB90_CASE(64)
    REPRO_FAB90_CASE(80)
    REPRO_FAB90_CASE(96)
    REPRO_FAB90_CASE(112)
    REPRO_FAB90_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FAB90_CASE
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
