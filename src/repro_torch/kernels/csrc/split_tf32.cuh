// What the two float32 attention sources (split TF32 on Hopper's tensor
// cores) share: csrc/flash_attention_f32_sm90.cu (the forward) and
// csrc/flash_attention_bwd_f32_sm90.cu (the backward) include it.  It holds
// the PTX wrappers both use (mbarriers, TMA, wgmma over .tf32 operands),
// the split of float32 inputs into TF32 parts, which both run first, and
// the tensor maps over those parts.  Everything is in an anonymous
// namespace: each source compiles into a library of its own.
//
// Split TF32: each operand x is taken as hi = tf32(x) and lo = tf32(x -
// hi) (cvt.rna: rounded, not left to the tensor cores to truncate), and a
// b as a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms first,
// accumulated in float32 (CUTLASS's OpMultiplyAddFastF32).  That keeps
// about 22 bits of each operand where one TF32 product keeps 11; only
// a_lo b_lo, about 2^-22 of a b, is dropped.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 128;             // one consumer warpgroup a block
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kBoxCols = 32;                // floats of a 128-byte swizzled box row

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
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------
// Shared-memory matrix descriptors of a K-major operand: start address,
// leading and stride byte offsets (in 16-byte units), layout.  Rows of
// 128 bytes with the 128-byte swizzle (the next 8 rows 1024 bytes on,
// layout 1), or of 64 bytes with the 64-byte swizzle (512 bytes on,
// layout 2).
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}
__device__ __forceinline__ uint64_t desc64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) |
         (2ull << 62);
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

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// as a float with the low 13 bits zero.
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// d (64 x 64, f32) += A (64 x 8, tf32, in registers) x B (64 x 8, tf32,
//   K-major in shared memory).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 8, tf32, in registers) x B (128 x 8, tf32,
//   K-major in shared memory).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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

// ---- split -----------------------------------------------------------
// One float32 (B, H, S, D) input with element strides (sb, sh, ss, 1), and
// where its split parts go: `rows` (B H, S, 2 DQ), hi in columns [0, DQ)
// and lo in [DQ, 2 DQ), zeros past D; `cols` (B H, 2, DV, Sp), hi then
// lo of the transpose, zeros past D and S, the positions of each group of
// 8 holding keys (or queries) 0, 2, 4, 6, 1, 3, 5, 7: wgmma's tf32 A
// fragment of a k8 slice holds columns (t, t + 4) of a quad's row where
// the f32 accumulator holds (2t, 2t + 1), so with this order an
// accumulator fragment (P, P^T, dS^T, dS) is the A operand of a product
// with the copy, split in registers by split_a and fed to wgmma with no
// shuffle.  Either may be null.
struct SplitSrc {
  const float* x;
  long long sb, sh, ss;
  int H, BH, S, Sp;
  float* rows;
  float* cols;
};
struct SplitArgs {
  SplitSrc src[4];
  int D, DQ, DV;
};

// The body of each source's split kernel, a block (32, 8) per (32
// positions of S x 32 columns of D, b h, input): the tile is read once,
// coalesced along D, written out as rows at once and, through shared
// memory, as columns coalesced along S.
__device__ __forceinline__ void split_tile(const SplitArgs& a) {
  const SplitSrc& j = a.src[blockIdx.z];
  const int d_tiles = a.DV / 32;
  const int bh = blockIdx.y, d0 = (blockIdx.x % d_tiles) * 32;
  const int s0 = (blockIdx.x / d_tiles) * 32;
  if (bh >= j.BH || s0 >= j.Sp) return;
  const int b = bh / j.H, h = bh % j.H;
  const int tx = threadIdx.x, ty = threadIdx.y;
  __shared__ float tile[32][33];
  const float* xb = j.x + b * j.sb + h * j.sh;
#pragma unroll 4
  for (int i = ty; i < 32; i += 8) {
    const int s = s0 + i, d = d0 + tx;
    const float x = (s < j.S && d < a.D) ? xb[s * j.ss + d] : 0.f;
    tile[i][tx] = x;
    if (j.rows != nullptr && s < j.S && d < a.DQ) {
      const float hi = tf32_round(x);
      float* r = j.rows + (static_cast<size_t>(bh) * j.S + s) * 2 * a.DQ;
      r[d] = hi;
      r[a.DQ + d] = tf32_round(x - hi);
    }
  }
  if (j.cols == nullptr) return;  // the same for the whole block
  __syncthreads();
  const int e = tx & 7;
  const int key = (tx & ~7) + (e < 4 ? 2 * e : 2 * (e - 4) + 1);
  const size_t part = static_cast<size_t>(a.DV) * j.Sp;
#pragma unroll 4
  for (int i = ty; i < 32; i += 8) {
    const float x = tile[key][i];
    const float hi = tf32_round(x);
    float* c = j.cols + (static_cast<size_t>(bh) * 2 * a.DV + d0 + i) * j.Sp + s0 + tx;
    c[0] = hi;
    c[part] = tf32_round(x - hi);
  }
}

// hi and lo of a 64 x 8n accumulator fragment as wgmma's tf32 A fragments:
// for the k8 slice j, registers 0 and 1 are column t of rows lo and hi,
// 2 and 3 column t + 4, which the permuted B operand pairs with the
// accumulator's columns 2t and 2t + 1.
template <int N>
__device__ __forceinline__ void split_a(uint32_t (&hi)[N][4], uint32_t (&lo)[N][4],
                                        const float (&x)[4 * N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (e & 1) * 2 + (e >> 1);  // register of accumulator element e
      const float h = tf32_round(x[4 * j + e]);
      hi[j][r] = __float_as_uint(h);
      lo[j][r] = __float_as_uint(tf32_round(x[4 * j + e] - h));
    }
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

// A tensor map over a contiguous float32 (n2, n1, n0) scratch tensor (n2
// = 0: a 2-D (n1, n0) one), boxed (1, box1, box0): box0 floats of 32 (the
// 128-byte swizzle) or 16 (the 64-byte one), or, unswizzled, the
// lse/Delta rows.
int make_map(CUtensorMap* map, const void* ptr, long long n0, long long n1, long long n2,
             int box0, int box1, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint32_t rank = n2 == 0 ? 2 : 3;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n0), static_cast<cuuint64_t>(n1),
                              static_cast<cuuint64_t>(n2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(n0 * 4),
                                 static_cast<cuuint64_t>(n0 * n1 * 4)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box0), static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(ptr),
                            dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
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

}  // namespace
