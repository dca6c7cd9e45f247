// Causal or full grouped-query attention with an online softmax.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_kernel`), which walks a
// sequential kv grid dimension per (batch, head, q block) and carries the
// running max, denominator and accumulator in VMEM scratch.  Hopper
// blocks run in no order, so here one thread block owns one
// (batch, q head, 64-row q tile) and loops over the kv tiles itself,
// keeping those three in registers.  Query head h reads kv head
// h / (Hq / Hkv), so kv heads are never replicated.  The causal mask is
// col <= row + (Sk - Sq), as on the TPU; kv tiles wholly above the
// diagonal are not visited.  Masked logits are -1e30 (not -inf), as on
// the TPU: every real row sees key 0 in the first tile, so the running
// max is finite from then on and masked entries add exp(-huge) = 0.
// Rows and columns past Sq and Sk are masked, so any lengths work.
// Where the caller passes an `lse` buffer (training), the finish step
// also writes each row's log-sum-exp of the scaled logits, m + log l, in
// float32 (B, Hq, Sq): the backward kernel (flash_attention_bwd.cu)
// recomputes the probabilities from it.  Serving passes null and the
// kernel does the same work as before.
//
// Layout: 256 threads, thread (ty, tx) = (tid / 16, tid % 16) owns q rows
// ty + 16 i (i < 4) of the tile; for the logits it owns columns
// tx + 16 j (j < 4) and for the output columns tx + 16 c (c < D / 16).
// Q, then K, then V (reusing K's buffer) and the probabilities P sit in
// shared memory as float32, padded to D + 1 so the reads of a warp fall
// in distinct banks.  Inputs are float32 or bfloat16; everything is
// computed in float32 and the output is written in q's dtype.
//
// What bounds it on an H100: operations.  Qwen3-14B's prefill (Hq 40,
// Hkv 8, S 4096, D 128) needs 4 * Hq * D * S (S + 1) / 2 = 1.7e11
// operations for about 100 MB of q/k/v/o.  This first version computes
// on the CUDA cores in float32 (67 TFLOP/s peak), not on the tensor cores
// (989 TFLOP/s in bf16), so it sits far above the bound; wgmma, TMA and a
// pipelined kv ring are the way down, in a later version.
//
// C interface: one function, loaded with ctypes.  It launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kLdP = kBK + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {  // in elements; the last dim is contiguous
  long long b, h, s;
};

template <int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(2 * kBQ * (D + 1) + kBQ * kLdP) * sizeof(float);
}

// Rows [row0, row0 + 64) of a (S, D) slice into a (64, D + 1) float tile;
// rows at or past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, long long ss,
                                          int row0, int S) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = row0 + r;
    dst[r * LD + c] = row < S ? to_f(src[row * ss + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int group, int Sq, int Sk, Strides qs,
    Strides ks, Strides vs, Strides os, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sKV = sQ + kBQ * LD;
  float* sP = sKV + kBK * LD;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qt * kBQ;
  const int offset = Sk - Sq;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  load_tile<T, D>(sQ, qb, qs.s, q0, Sq);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int nk = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int last_row = min(q0 + kBQ, Sq) - 1;
    nk = min(nk, (last_row + offset) / kBK + 1);
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's P.V is done with sKV and sP
    load_tile<T, D>(sKV, kb, ks.s, k0, Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sKV[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < Sk && (!causal || col <= row + offset);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are one half of a warp
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every thread is done reading K and writing P
    load_tile<T, D>(sKV, vb, vs.s, k0, Sk);
    __syncthreads();

#pragma unroll 4
    for (int c2 = 0; c2 < kBK; ++c2) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * kLdP + c2];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = sKV[c2 * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < Sq) {
#pragma unroll
      for (int c = 0; c < DC; ++c) ob[row * os.s + tx + 16 * c] = from_f<T>(acc[i][c] / l[i]);
      if (lse != nullptr && tx == 0)
        lse[(static_cast<size_t>(b) * gridDim.y + h) * Sq + row] = m[i] + logf(l[i]);
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Hq,
             int group,
             int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os, float scale,
             int causal, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_attention_kernel<T, D>;
  static bool attr_set = false;  // above 48 KB needs the opt-in, once per instantiation
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                    static_cast<const T*>(v), static_cast<T*>(o), lse, group, Sq,
                                    Sk, qs, ks, vs, os, scale, causal);
  return 0;
}

template <typename T>
int launch(int D, const void* q, const void* k, const void* v, void* o, float* lse, int B, int Hq,
           int group,
           int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os, float scale,
           int causal, cudaStream_t s) {
#define REPRO_FA_CASE(DD)                                                                 \
  case DD:                                                                                \
    return launch_d<T, DD>(q, k, v, o, lse, B, Hq, group, Sq, Sk, qs, ks, vs, os, scale,   \
                           causal, s);
  switch (D) {
    REPRO_FA_CASE(16)
    REPRO_FA_CASE(32)
    REPRO_FA_CASE(48)
    REPRO_FA_CASE(64)
    REPRO_FA_CASE(80)
    REPRO_FA_CASE(96)
    REPRO_FA_CASE(112)
    REPRO_FA_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FA_CASE
}

}  // namespace

// dtype of q/k/v/o: 0 = float32, 1 = bfloat16.  q (B, Hq, Sq, D) and
// k/v (B, Hkv, Sk, D) with the given element strides (batch, head, seq;
// the last dim contiguous); o likewise.  lse, if not null, receives the
// float32 (B, Hq, Sq) log-sum-exp of each row's scaled logits.  D a
// multiple of 16 in [16, 128]; Hq a multiple of Hkv; Sq, Sk >= 1; causal
// needs Sq <= Sk.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* o, void* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                                     int D,
                                     long long qsb, long long qsh, long long qss, long long ksb,
                                     long long ksh, long long kss, long long vsb, long long vsh,
                                     long long vss, long long osb, long long osh, long long oss,
                                     float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = Hq / Hkv;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  int err;
  switch (dtype) {
    case 0:
      err = launch<float>(D, q, k, v, o, static_cast<float*>(lse), B, Hq, group, Sq, Sk, qs, ks,
                          vs, os, scale, causal, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(D, q, k, v, o, static_cast<float*>(lse), B, Hq, group, Sq, Sk,
                                  qs, ks, vs, os, scale, causal, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
