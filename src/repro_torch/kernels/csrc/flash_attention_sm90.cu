// Causal or full grouped-query attention in bf16 on Hopper's tensor cores.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_kernel`) for bf16 inputs;
// float32 inputs stay on csrc/flash_attention.cu, on the CUDA cores, the
// only kernel here that meets the float32 tolerance (TF32 would not).
// The TPU kernel walks a sequential kv grid dimension per (batch, head,
// q block) and carries the running max, denominator and accumulator in
// VMEM scratch.  Hopper blocks run in no order, so one block owns one
// (batch, q head, 128-row q tile) and loops over the kv tiles itself,
// with those three in registers.
//
// Contract, as the TPU kernel's: query head h reads kv head
// h / (Hq / Hkv), never replicated; the causal mask keeps key j for
// query i when j <= i + (Sk - Sq), and masked logits are -1e30, not -inf
// (every real row sees key 0 in the first tile, so the running max is
// finite from then on and masked entries add exp(-huge) = 0); any Sq and
// Sk, ragged tails masked; kv tiles wholly above the diagonal are not
// visited; q, k, v with any batch, head and sequence strides (multiples
// of 16 bytes) and a contiguous last dim.  D is a multiple of 16 up to
// 128.  Causal with Sq > Sk is refused by the wrapper.
//
// What bounds it on an H100: operations.  Qwen3-14B's prefill (Hq 40,
// Hkv 8, S 4096, D 128, causal) needs 4 * Hq * D * S (S + 1) / 2 = 1.7e11
// operations, 0.174 ms at the 989 TFLOP/s of the bf16 tensor cores,
// against 0.030 ms for its 100 MB of q, k, v and o.  So the products run
// on the tensor cores (wgmma), fed by the copy engine (TMA), and the
// softmax stays in registers.
//
// Design.  384 threads: two consumer warpgroups, each owning 64 of the
// tile's q rows, and one producer warpgroup, of which one thread works.
//   * Copies.  The producer loads the Q tile once, then the K and V tiles
//     (128 kv rows each) into a ring of kStages stages in shared memory,
//     with TMA (cp.async.bulk.tensor) and a 128-byte swizzle.  K and V of
//     a stage each have a "full" mbarrier (completed by the copy's byte
//     count) and an "empty" one, on which every consumer warp arrives
//     when it is done with that tile, so K is refilled as soon as S is
//     computed and V once P V is.  The tensor maps come from
//     cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint(ByVersion), so the library does not link
//     libcuda.  A box is 64 columns (128 bytes) wide: D < 64 and the
//     second half of D = 80, 96, 112 are padded with zeros by the copy
//     engine (its out-of-bounds fill), as are rows past Sq and Sk, so a V
//     row past Sk is 0 and never NaN.  Three stages of K and V at D 128
//     and the Q tile take 225 KB of the 227 KB a block may have.
//   * Registers.  The producer warpgroup gives its registers up
//     (setmaxnreg) so that a consumer thread has 232: S (64), O (64) and
//     P (32) live at once, with no spills.
//   * S = Q K^T.  wgmma.mma_async m64n128k16 (bf16 in, f32 accumulate),
//     both operands K-major in shared memory, D / 16 instructions a tile.
//   * O += P V.  P is rounded to bf16 in registers, where the S fragment
//     already has the layout of wgmma's register A operand; V is the B
//     operand through the transpose flag (its D columns are contiguous).
//     N is D rounded up to 64 (m64n64k16 or m64n128k16); the padded
//     columns are zeros and are not written.
//   * Overlap.  A warpgroup issues S of tile kt and P V of tile kt - 1
//     back to back, then runs tile kt's softmax while P V still runs.
//   * Softmax.  The online softmax (running max, denominator, rescale of
//     O) runs in f32 on the accumulator fragment, base 2 (one FFMA and one
//     ex2.approx per logit); a row lives in the four threads of a quad,
//     so row maxima are two shuffles; the denominator is kept per thread
//     and reduced once, at the end.
//   * The end: O divided by the denominator, written in bf16; where the
//     caller passes an `lse` buffer (training), also each row's float32
//     log-sum-exp of the scaled logits, m / sqrt(D) + log l, which the
//     backward kernel (flash_attention_bwd.cu) recomputes P from.  Serving
//     passes null: the same work as without it.
//   * Grid: (batch x q head, q tile), the q tile reversed so the causal
//     tiles with the most kv tiles launch first.
//
// Differs from the TPU kernel in one rounding: P is rounded to bf16
// before P V, where the TPU kernel multiplies p @ v in f32
// (flash_attention.py:45-55).  The bf16 tolerance of 2e-2 against the
// plain version holds anyway.
//
// Left for later: a persistent grid, overlap of the next tile's S with
// this tile's softmax (a second S in registers), clusters (one K/V copy
// multicast to the q tiles of a head group) and fp8.  Ping-pong ordering
// of the two warpgroups' products with named barriers measured slower on
// the H100 than letting them interleave freely (PERF.md).  A layout
// that TMA cannot describe (a stride or base address not a multiple of 16
// bytes) is made contiguous by the wrapper first, not read with cp.async.
//
// C interface: one function, loaded with ctypes.  It launches on the given
// stream, allocates nothing, and returns cudaGetLastError(), or 1000 plus
// the driver's error if a tensor map cannot be encoded.

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                  // q rows per block
constexpr int kBN = 128;                  // kv rows per tile
constexpr int kStages = 3;                // depth of the K/V ring
constexpr int kConsumers = 256;           // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
// Registers per thread after the hand-over: the producer, which only
// issues copies, gives its warpgroup's down to kProducerRegs so that each
// consumer thread can hold kConsumerRegs (the launch gives every thread
// 65536 / 384 = 168, rounded down to a multiple of 8).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBoxCols = 64;              // bf16 columns of a 128-byte swizzled box
constexpr float kNegInf = -1e30f;

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
// Waits until at most N committed groups of products are still running.
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 128, f32) {=, +=} A (64 x 16, bf16, K-major in shared memory)
//   x B (128 x 16, bf16, K-major in shared memory); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
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
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
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

// Issues O += P V over one kv tile (kBN rows at v_tile): kBN / 16 products
// of 16 kv rows each; the next 64 columns of V lie one box (kBN x 128
// bytes) on, the next 8 rows 1024 bytes on.
template <int DP>
__device__ __forceinline__ void pv_product(float (&acc)[DP / 2], const uint32_t (&pa)[kBN / 16][4],
                                           uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t db = smem_desc(v_tile + kk * 16 * 128, kBN * 128, 1024);
    if constexpr (DP == 64) {
      wgmma_rs_n64_tb(acc, pa[kk], db);
    } else {
      wgmma_rs_n128_tb(acc, pa[kk], db);
    }
  }
}

struct Params {
  int hq, group, Sq, Sk, n_qt, causal;
  float scale_log2;                // 1 / sqrt(D) * log2(e)
  float scale;                     // 1 / sqrt(D)
  float* lse;                      // (B, Hq, Sq) float32 log-sum-exp, or null
  long long osb, osh, oss;         // o's element strides
  int pos_q[3], pos_k[3], pos_v[3];  // tensor-map dim of (seq, head, batch)
};

// Byte offsets of the shared-memory buffers of one block; every tile is
// DP / 64 boxes of (rows x 128 bytes), each 1024-byte aligned as the
// 128-byte swizzle wants.
template <int DP>
struct Layout {
  static constexpr uint32_t kQBox = kBM * 128, kKVBox = kBN * 128;
  static constexpr uint32_t kQBytes = DP / kBoxCols * kQBox;
  static constexpr uint32_t kKVBytes = DP / kBoxCols * kKVBox;
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKVBytes;
  // q_full, k_full[], v_full[], k_empty[], v_empty[]
  static constexpr uint32_t kBars = kV + kStages * kKVBytes;
  static constexpr uint32_t kBytes = kBars + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                __nv_bfloat16* __restrict__ o, const Params p) {
  constexpr int DP = (D + kBoxCols - 1) / kBoxCols * kBoxCols;  // N of O += P V
  constexpr int NB = DP / kBoxCols;
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + L::kK, sV = base + L::kV, bars = base + L::kBars;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8u * (1 + st); };
  auto v_full = [&](int st) { return bars + 8u * (1 + kStages + st); };
  auto k_empty = [&](int st) { return bars + 8u * (1 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return bars + 8u * (1 + 3 * kStages + st); };

  const int h = blockIdx.x % p.hq, b = blockIdx.x / p.hq;
  const int hk = h / p.group;
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      // the NB boxes of rows [row, row + box rows) of (batch b, head), box_bytes apart
      auto load = [&](const CUtensorMap* map, const int (&pos)[3], uint32_t dst,
                      uint32_t box_bytes, uint32_t bar, int row, int head) {
        for (int c = 0; c < NB; ++c) {
          int at[4];
          at[0] = c * kBoxCols;
          at[pos[0]] = row;
          at[pos[1]] = head;
          at[pos[2]] = b;
          tma_load_4d(dst + c * box_bytes, map, bar, at[0], at[1], at[2], at[3]);
        }
      };
      mbar_expect_tx(q_full, L::kQBytes);
      load(&tq, p.pos_q, sQ, L::kQBox, q_full, q0, h);
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kStages;
        const uint32_t free_parity = ((kt / kStages) & 1) ^ 1;  // the first round passes at once
        mbar_wait(k_empty(st), free_parity);
        mbar_expect_tx(k_full(st), L::kKVBytes);
        load(&tk, p.pos_k, sK + st * L::kKVBytes, L::kKVBox, k_full(st), kt * kBN, hk);
        mbar_wait(v_empty(st), free_parity);
        mbar_expect_tx(v_full(st), L::kKVBytes);
        load(&tv, p.pos_v, sV + st * L::kKVBytes, L::kKVBox, v_full(st), kt * kBN, hk);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  // accumulator fragment: this thread holds rows row_lo and row_lo + 8,
  // columns 8 j + col_lane + {0, 1} of every 8-column chunk j
  const int wg_row0 = q0 + 64 * wg;
  const int row_lo = wg_row0 + 16 * warp + lane / 4;
  const int col_lane = 2 * (lane % 4);

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf;  // running max of the raw logits
  float l_lo = 0.f, l_hi = 0.f;          // this thread's share of the denominator
  float alpha_lo = 0.f, alpha_hi = 0.f;  // rescale of O owed by the last softmax
  // P of the last tile in bf16, laid out as wgmma's A fragment: for the
  // k16 slice kk, registers 0, 1 are chunk 2 kk (rows lo, hi), 2, 3 chunk 2 kk + 1
  uint32_t pa[kBN / 16][4];

  mbar_wait(q_full, 0);
  const uint32_t q_rows = sQ + wg * 64 * 128;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kStages, prev = (kt + kStages - 1) % kStages;
    const uint32_t parity = (kt / kStages) & 1, prev_parity = ((kt - 1) / kStages) & 1;
    const int k0 = kt * kBN;
    float s[kBN / 2];
    mbar_wait(k_full(st), parity);
    if (kt > 0) mbar_wait(v_full(prev), prev_parity);  // before the fence: no waits in the batch

    // S = Q K^T of tile kt, then (O rescaled) O += P V of tile kt - 1,
    // issued back to back
    fence_regs(s);
    wgmma_fence();
    const uint32_t k_tile = sK + st * L::kKVBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t at = (kk / 4) * L::kQBox + (kk % 4) * 32;
      const uint32_t bt = (kk / 4) * L::kKVBox + (kk % 4) * 32;
      wgmma_ss_n128(s, smem_desc(q_rows + at, 16, 1024), smem_desc(k_tile + bt, 16, 1024), kk > 0);
    }
    wgmma_commit();
    if (kt > 0) {
      rescale(acc, alpha_lo, alpha_hi);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      pv_product<DP>(acc, pa, sV + prev * L::kKVBytes);
      wgmma_commit();
    }

    // S is ready when at most the P V product is still running
    if (kt > 0) {
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);
    if (lane == 0) mbar_arrive(k_empty(st));  // this warp is done with K of tile kt

    // online softmax on the fragment, base 2: p = 2^(s c - m c), c = log2(e) / sqrt(D)
    const bool masked = k0 + kBN > p.Sk || (p.causal && k0 + kBN - 1 > wg_row0 + offset);
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
    const float new_lo = fmaxf(m_lo, mx_lo), new_hi = fmaxf(m_hi, mx_hi);
    alpha_lo = ex2((m_lo - new_lo) * c);
    alpha_hi = ex2((m_hi - new_hi) * c);
    m_lo = new_lo;
    m_hi = new_hi;
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
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;

    // P of tile kt may overwrite pa once the P V product of kt - 1 is done
    if (kt > 0) {
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(v_empty(prev));  // this warp is done with V of tile kt - 1
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      pa[j / 2][(j % 2) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
  }

  // the last tile's O += P V
  {
    const int last = (nk - 1) % kStages;
    rescale(acc, alpha_lo, alpha_hi);
    mbar_wait(v_full(last), ((nk - 1) / kStages) & 1);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
    pv_product<DP>(acc, pa, sV + last * L::kKVBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // ---- O / denominator, in bf16 ----
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, sh);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, sh);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  if (p.lse != nullptr && (lane & 3) == 0) {  // one thread of each row's quad
    float* lb = p.lse + (static_cast<size_t>(b) * p.hq + h) * p.Sq;
    if (row_lo < p.Sq) lb[row_lo] = m_lo * p.scale + logf(l_lo);
    if (row_lo + 8 < p.Sq) lb[row_lo + 8] = m_hi * p.scale + logf(l_hi);
  }
  __nv_bfloat16* ob = o + b * p.osb + h * p.osh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + col_lane;
    if (row_lo < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_lo * p.oss + col) =
          __floats2bfloat162_rn(acc[4 * j] * inv_lo, acc[4 * j + 1] * inv_lo);
    if (row_lo + 8 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (row_lo + 8) * p.oss + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv_hi, acc[4 * j + 3] * inv_hi);
  }
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
// (sb, sh, ss, 1): dim 0 is D, boxed 64 wide; the other three are
// (seq, head, batch) in the order of their strides, ascending, and
// pos[] records where each went.  The box takes `rows` of seq and one
// head and batch, so it lands in shared memory as rows x 128 bytes.  A
// dim of size 1 is never stepped over: it goes last with a stride that
// keeps the strides ascending.
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

template <int D>
int launch_d(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o,
             int B, const Params& p, cudaStream_t s) {
  constexpr int DP = (D + kBoxCols - 1) / kBoxCols * kBoxCols;
  constexpr uint32_t smem = Layout<DP>::kBytes;
  auto kern = flash_attention_sm90_kernel<D>;
  static bool attr_set = false;  // above 48 KB needs the opt-in, once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid(static_cast<unsigned>(B) * p.hq, p.n_qt);
  kern<<<grid, kThreads, smem, s>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), p);
  return 0;
}

}  // namespace

// bf16 q (B, Hq, Sq, D) and k/v (B, Hkv, Sk, D) with the given element
// strides (batch, head, seq; the last dim contiguous; every stride of a
// dim longer than 1 a multiple of 8 elements, every base 16-byte
// aligned); o likewise, any strides.  lse, if not null, receives the
// float32 (B, Hq, Sq) log-sum-exp of each row's scaled logits.  D a
// multiple of 16 in [16, 128]; Hq a multiple of Hkv; Sq, Sk >= 1; causal
// needs Sq <= Sk.
extern "C" int repro_flash_attention_sm90(const void* q, const void* k, const void* v, void* o,
                                          void* lse,
                                          int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                          long long qsb, long long qsh, long long qss,
                                          long long ksb, long long ksh, long long kss,
                                          long long vsb, long long vsh, long long vss,
                                          long long osb, long long osh, long long oss, float scale,
                                          int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  if (p.n_qt > 65535 || static_cast<long long>(B) * Hq > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, Hq, Sq, D, qsb, qsh, qss, kBM, p.pos_q);
  if (err == 0) err = make_map(&tk, k, B, Hkv, Sk, D, ksb, ksh, kss, kBN, p.pos_k);
  if (err == 0) err = make_map(&tv, v, B, Hkv, Sk, D, vsb, vsh, vss, kBN, p.pos_v);
  if (err != 0) return err;
#define REPRO_FA90_CASE(DD) \
  case DD:                  \
    err = launch_d<DD>(tq, tk, tv, o, B, p, s); \
    break;
  switch (D) {
    REPRO_FA90_CASE(16)
    REPRO_FA90_CASE(32)
    REPRO_FA90_CASE(48)
    REPRO_FA90_CASE(64)
    REPRO_FA90_CASE(80)
    REPRO_FA90_CASE(96)
    REPRO_FA90_CASE(112)
    REPRO_FA90_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FA90_CASE
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
