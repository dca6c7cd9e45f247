// Backward of causal or full grouped-query attention in float32: dq, dk
// and dv from q, k, v, the forward's output o, its gradient dO and the
// forward's per-row log-sum-exp.  bf16 runs csrc/flash_attention_bwd_sm90.cu
// on the tensor cores; this kernel, on the CUDA cores, is the one that
// meets the float32 tolerance (the tensor cores' TF32 would not).
//
// The TPU kernel `flash_attention_pallas` (src/repro/kernels/flash_attention.py)
// has no backward: the JAX package differentiates through XLA attention.
// The port's forward runs the hand-written K4 kernels (flash_attention.cu,
// flash_attention_sm90.cu), so training on the card needs this one.  It
// computes what autograd of `flash_attention_plain` computes:
//
//   P  = exp(Q K^T * scale - lse)     (recomputed, the forward's mask)
//   dV = P^T dO                        dP = dO V^T
//   dS = P * (dP - Delta)              Delta = rowsum(dO * O)
//   dQ = dS K * scale                  dK = dS^T Q * scale
//
// with the forward's masks: the causal mask keeps key j for query i when
// j <= i + (Sk - Sq), rows past Sq and keys past Sk are masked (ragged
// last tiles), and non-causal calls (cross-attention, Sq > Sk) mask
// nothing else.  Query head h reads kv head h / (Hq / Hkv); dk and dv sum
// over the Hq / Hkv query heads of their kv head.
//
// Three kernels, launched in order on one stream by one C call:
//   1. delta: Delta = rowsum(dO * O), one warp a row, float32 (B, Hq, Sq);
//   2. dkdv: one block per (batch, kv head, 64-key tile) loops over the
//      query heads of its group and the query tiles that see its keys,
//      and keeps its dK and dV tiles in registers to the end;
//   3. dq: one block per (batch, q head, 64-query tile) loops over the key
//      tiles its queries see, keeping dQ in registers.
// No block writes what another writes, so there are no atomics and the
// result repeats bit for bit from run to run.
//
// Layout, as the CUDA-core forward: 256 threads, thread (ty, tx) =
// (tid / 16, tid % 16) owns rows ty + 16 i (i < 4) of its block's tile and,
// for a 64 x 64 product, columns tx + 16 j (j < 4); for a 64 x D one,
// columns tx + 16 c (c < D / 16).  Tiles sit in shared memory as float32,
// padded to D + 1 (and 65) so a warp's reads fall in distinct banks.
// Inputs, arithmetic and gradients are float32.
//
// What bounds it on an H100: operations.  Qwen3-14B's training shape (B 1,
// Hq 40, Hkv 8, S 4096, D 128, causal) needs five products of 2 S^2 D a
// head, halved by the mask: 429.5 GFLOP, 6.41 ms at the 67 TFLOP/s of
// float32 on the CUDA cores.  It runs seven products (P and dP are
// computed in both kernels).
//
// C interface: one function, loaded with ctypes.  It launches on the given
// stream, allocates nothing (Delta goes to a buffer the caller passes),
// and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kB = 64;  // rows of a query tile and of a key tile
constexpr int kThreads = 256;
constexpr int kLdP = kB + 1;


struct Strides {  // in elements; the last dim is contiguous
  long long b, h, s;
};

struct Args {
  int Hq, Hkv, group, Sq, Sk, causal;
  float scale;
  Strides q, k, v, o, dO;  // dq (B, Hq, Sq, D) and dk, dv (B, Hkv, Sk, D) are contiguous
};

template <int D>
constexpr size_t smem_bytes() {  // four (64, D + 1) tiles, two (64, 65) tiles, lse and Delta
  return static_cast<size_t>(4 * kB * (D + 1) + 2 * kB * kLdP + 2 * kB) * sizeof(float);
}

// Rows [row0, row0 + 64) of a (S, D) slice into a (64, D + 1) float tile;
// rows at or past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, long long ss,
                                          int row0, int S) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = row0 + r;
    dst[r * LD + c] = row < S ? src[row * ss + c] : 0.f;
  }
}

// lse and Delta of query rows [row0, row0 + 64) of (b, h); zero past Sq.
__device__ __forceinline__ void load_rows(float* sL, float* sD, const float* __restrict__ lse,
                                          const float* __restrict__ delta, size_t bh, int Sq,
                                          int row0) {
  if (threadIdx.x < kB) {
    const int row = row0 + threadIdx.x;
    const size_t at = bh * Sq + row;
    sL[threadIdx.x] = row < Sq ? lse[at] : 0.f;
    sD[threadIdx.x] = row < Sq ? delta[at] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_delta_kernel(const float* __restrict__ o,
                                                         const float* __restrict__ dO,
                                                         float* __restrict__ delta, Args a) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= a.Sq) return;
  const float* op = o + b * a.o.b + h * a.o.h + row * a.o.s;
  const float* gp = dO + b * a.dO.b + h * a.dO.h + row * a.dO.s;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(op[c], gp[c], acc);
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, sh);
  if (lane == 0) delta[(static_cast<size_t>(b) * a.Hq + h) * a.Sq + row] = acc;
}

template <int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dO, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, Args a) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kB * LD;
  float* sQ = sV + kB * LD;
  float* sG = sQ + kB * LD;  // dO
  float* sP = sG + kB * LD;  // P^T of the tile pair, (key, query)
  float* sS = sP + kB * kLdP;  // dS^T
  float* sL = sS + kB * kLdP;
  float* sD = sL + kB;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = kt * kB;
  const int offset = a.Sk - a.Sq;
  load_tile<D>(sK, k + b * a.k.b + hk * a.k.h, a.k.s, k0, a.Sk);
  load_tile<D>(sV, v + b * a.v.b + hk * a.v.h, a.v.s, k0, a.Sk);

  float gk[4][DC], gv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) gk[i][c] = gv[i][c] = 0.f;

  // the first query tile with a row that sees a key of this tile
  const int qt0 = a.causal ? max(0, k0 - offset) / kB : 0;
  const int nq = (a.Sq + kB - 1) / kB;
  for (int h = hk * a.group; h < (hk + 1) * a.group; ++h) {
    const size_t bh = static_cast<size_t>(b) * a.Hq + h;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // the previous pair is done with sQ, sG, sP, sS, sL, sD
      load_tile<D>(sQ, q + b * a.q.b + h * a.q.h, a.q.s, q0, a.Sq);
      load_tile<D>(sG, dO + b * a.dO.b + h * a.dO.h, a.dO.s, q0, a.Sq);
      load_rows(sL, sD, lse, delta, bh, a.Sq, q0);
      __syncthreads();

      // S^T and dP^T of the pair: key rows ty + 16 i, query columns tx + 16 j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], gv4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sK[(ty + 16 * i) * LD + d];
          vv[i] = sV[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = sQ[(tx + 16 * j) * LD + d];
          gv4[j] = sG[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gv4[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tx + 16 * j, row = q0 + qr;
          const bool ok = key < a.Sk && row < a.Sq && (!a.causal || key <= row + offset);
          const float p = ok ? expf(s[i][j] * a.scale - sL[qr]) : 0.f;
          sP[(ty + 16 * i) * kLdP + qr] = p;
          sS[(ty + 16 * i) * kLdP + qr] = p * (dp[i][j] - sD[qr]);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the 64 queries of the pair
#pragma unroll 4
      for (int qq = 0; qq < kB; ++qq) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sP[(ty + 16 * i) * kLdP + qq];
          sv[i] = sS[(ty + 16 * i) * kLdP + qq];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float g = sG[qq * LD + tx + 16 * c];
          const float x = sQ[qq * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            gv[i][c] = fmaf(pv[i], g, gv[i][c]);
            gk[i][c] = fmaf(sv[i], x, gk[i][c]);
          }
        }
      }
    }
  }

  const size_t base = (static_cast<size_t>(b) * a.Hkv + hk) * a.Sk * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key < a.Sk) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const size_t at = base + static_cast<size_t>(key) * D + tx + 16 * c;
        dk[at] = gk[i][c] * a.scale;
        dv[at] = gv[i][c];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dO, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, Args a) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + kB * LD;  // dO
  float* sK = sG + kB * LD;
  float* sV = sK + kB * LD;
  float* sS = sV + kB * LD;  // dS of the tile, (query, key)
  float* sL = sS + kB * kLdP;
  float* sD = sL + kB;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qt * kB;
  const int offset = a.Sk - a.Sq;
  const size_t bh = static_cast<size_t>(b) * a.Hq + h;
  load_tile<D>(sQ, q + b * a.q.b + h * a.q.h, a.q.s, q0, a.Sq);
  load_tile<D>(sG, dO + b * a.dO.b + h * a.dO.h, a.dO.s, q0, a.Sq);
  load_rows(sL, sD, lse, delta, bh, a.Sq, q0);

  float gq[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) gq[i][c] = 0.f;

  int nk = (a.Sk + kB - 1) / kB;
  if (a.causal) nk = min(nk, (min(q0 + kB, a.Sq) - 1 + offset) / kB + 1);
  const float* kb = k + b * a.k.b + hk * a.k.h;
  const float* vb = v + b * a.v.b + hk * a.v.h;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile is done with sK and sS
    load_tile<D>(sK, kb, a.k.s, k0, a.Sk);
    load_tile<D>(sV, vb, a.v.s, k0, a.Sk);
    __syncthreads();

    // S and dP of the tile: query rows ty + 16 i, key columns tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], gv4[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty + 16 * i) * LD + d];
        gv4[i] = sG[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * LD + d];
        vv[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv4[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty + 16 * i, row = q0 + qr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool ok = key < a.Sk && row < a.Sq && (!a.causal || key <= row + offset);
        const float p = ok ? expf(s[i][j] * a.scale - sL[qr]) : 0.f;
        sS[qr * kLdP + tx + 16 * j] = p * (dp[i][j] - sD[qr]);
      }
    }
    __syncthreads();

    // dQ += dS K over the 64 keys of the tile
#pragma unroll 4
    for (int kk = 0; kk < kB; ++kk) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sS[(ty + 16 * i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float x = sK[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) gq[i][c] = fmaf(sv[i], x, gq[i][c]);
      }
    }
  }

  float* out = dq + bh * a.Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < a.Sq) {
#pragma unroll
      for (int c = 0; c < DC; ++c)
        out[static_cast<size_t>(row) * D + tx + 16 * c] = gq[i][c] * a.scale;
    }
  }
}

template <typename Kern>
int allow_smem(Kern kern, size_t bytes, bool& done) {  // above 48 KB needs the opt-in, once
  if (done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;
  return 0;
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* o, const void* dO,
             const float* lse, float* delta, void* dq, void* dk, void* dv, int B,
             const Args& a, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  static bool kv_set = false, q_set = false;
  int err = allow_smem(fa_bwd_dkdv_kernel<D>, smem, kv_set);
  if (err == 0) err = allow_smem(fa_bwd_dq_kernel<D>, smem, q_set);
  if (err != 0) return err;
  const float* Q = static_cast<const float*>(q);
  const float* K = static_cast<const float*>(k);
  const float* V = static_cast<const float*>(v);
  const float* G = static_cast<const float*>(dO);
  const dim3 rows((a.Sq + kThreads / 32 - 1) / (kThreads / 32), a.Hq, B);
  fa_bwd_delta_kernel<D><<<rows, kThreads, 0, s>>>(static_cast<const float*>(o), G, delta, a);
  const dim3 keys((a.Sk + kB - 1) / kB, a.Hkv, B);
  fa_bwd_dkdv_kernel<D><<<keys, kThreads, smem, s>>>(Q, K, V, G, lse, delta,
                                                   static_cast<float*>(dk),
                                                 static_cast<float*>(dv), a);
  const dim3 queries((a.Sq + kB - 1) / kB, a.Hq, B);
  fa_bwd_dq_kernel<D><<<queries, kThreads, smem, s>>>(Q, K, V, G, lse, delta,
                                                    static_cast<float*>(dq), a);
  return 0;
}

int launch(int D, const void* q, const void* k, const void* v, const void* o, const void* dO,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, const Args& a,
           cudaStream_t s) {
#define REPRO_FAB_CASE(DD) \
  case DD:                 \
    return launch_d<DD>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, a, s);
  switch (D) {
    REPRO_FAB_CASE(16)
    REPRO_FAB_CASE(32)
    REPRO_FAB_CASE(48)
    REPRO_FAB_CASE(64)
    REPRO_FAB_CASE(80)
    REPRO_FAB_CASE(96)
    REPRO_FAB_CASE(112)
    REPRO_FAB_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FAB_CASE
}

}  // namespace

// float32 q, k, v, o, dO, dq, dk and dv.  dims holds 21 values: B, Hq,
// Hkv, Sq, Sk, D, then the (batch, head, seq) element strides of q, k, v,
// o and dO (the last dim contiguous).  lse is the forward's float32
// (B, Hq, Sq) log-sum-exp; delta a float32 (B, Hq, Sq) buffer this call
// fills.  dq (B, Hq, Sq, D) and dk, dv (B, Hkv, Sk, D) are written
// contiguous.  D a multiple of 16 in [16, 128]; Hq a multiple of Hkv;
// Sq, Sk >= 1; causal needs Sq <= Sk.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dO, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv,
                                         const long long* dims, float scale, int causal,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = static_cast<int>(dims[0]), D = static_cast<int>(dims[5]);
  Args a;
  a.Hq = static_cast<int>(dims[1]);
  a.Hkv = static_cast<int>(dims[2]);
  a.Sq = static_cast<int>(dims[3]);
  a.Sk = static_cast<int>(dims[4]);
  a.group = a.Hq / a.Hkv;
  a.causal = causal;
  a.scale = scale;
  Strides* st[5] = {&a.q, &a.k, &a.v, &a.o, &a.dO};
  for (int t = 0; t < 5; ++t) *st[t] = Strides{dims[6 + 3 * t], dims[7 + 3 * t], dims[8 + 3 * t]};
  if (B > 65535 || a.Hq > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const float* L = static_cast<const float*>(lse);
  float* De = static_cast<float*>(delta);
  const int err = launch(D, q, k, v, o, dO, L, De, dq, dk, dv, B, a, s);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
