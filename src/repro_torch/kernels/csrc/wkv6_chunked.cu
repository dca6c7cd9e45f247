// RWKV6 (Finch) WKV recurrence with data-dependent per-channel decay, for
// long sequences: the chunked form on the tensor cores.
//
//   y_t = r_t · (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// Replaces the TPU kernel `wkv6_pallas` (src/repro/kernels/wkv6.py, body
// `_kernel`) where a call has many steps: kernels/wkv6.py `wkv6_form` sends
// a sequence of CHUNKED_MIN_T steps or more here, a shorter one (the decode
// step, T = 1) to the serial kernel of wkv6.cu.  Both compute the same
// function under the same contract: y and the final float32 state from the
// same r/k/v/w/u/state, r/k/v/w as (B, H, T, D) views with any strides and
// stride 1 on D, y written (B, T, H, D), any T >= 1, the state optional and
// the final state possibly written over it.
//
// The serial kernel walks all T steps in order in one block a head: at
// RWKV6-7B's training shape (B 1, H 64, T 4096, D 64) 64 blocks on 132 SMs,
// 4096 dependent steps of CUDA-core work.  Here the sequence is cut into
// chunks of kChunk = 64 steps, and the work that is not a recurrence runs
// for every chunk at once, as products on the tensor cores; only a scan
// over the chunks stays sequential.  Three launches in order on one stream:
//
//   (1) wkv6c_chunk_kernel<kY = false>, a block a (b, h, chunk), all at
//       once (4096 blocks at the training shape): the chunk's state
//       increment dS_c, the state its steps leave from a zero state, and
//       its total decay W_c = prod_t w_t, into the caller's scratch;
//   (2) wkv6c_scan_kernel, a thread four elements (b, h, i, j..j+3) of the
//       state: S_c = W_c[i] S_{c-1} + dS_c over the chunks in order, each
//       chunk's starting state written over its increment, the final state
//       to sout.  The scratch is chunk-major, so at each chunk the threads
//       read and write one contiguous run of B H D^2 floats (laid out by
//       head, chunk after chunk, the same scan took 3 times as long at the
//       training shape).  Each thread reads its elements of s0 before it
//       writes those of sout, so sout may be s0;
//   (3) wkv6c_chunk_kernel<kY = true>, a block a (b, h, chunk) again: y of
//       the chunk's steps from its starting state.
//
// Inside a chunk a block walks its four sub-chunks of kSub = 16 steps (the
// M of one mma tile), carrying the (D, D) state in shared memory.  With
// P_t = prod of w_s over the sub-chunk's steps before t, Q_t = prod of w_s
// over its steps after t, and W = prod over all of them:
//
//   y_t   = (r_t * P_t) S + sum_{s <= t} A[t][s] v_s,
//   A[t][s] = sum_i r_t[i] k_s[i] prod_{s < x < t} w_x[i]   (s < t),
//   A[t][t] = sum_i r_t[i] u[i] k_t[i],
//   S    <- diag(W) S + (k * Q)^T v,
//
// S the state at the sub-chunk's start.  The products (r*P) S, A v and
// (k*Q)^T v are mma.sync m16n8k8 on TF32 operands with float32 sums:
// float32 inputs in split TF32 (each operand as hi = tf32(x), lo = tf32(x -
// hi), a b as a_lo b_hi + a_hi b_lo + a_hi b_hi, csrc/split_tf32.cuh's
// tf32_round), bfloat16 inputs in one TF32 product (their values are
// exact in TF32; the scaled operands keep 11 bits, more than the bf16
// output).  A, the pairs inside a sub-chunk, is taken on the CUDA cores in
// float32: a thread owns one s and a slice of the channels and walks t
// upwards, the decay between s and t a running product.
//
// Numerics.  w reaches 1e-12 and can be exactly 0 in bf16, so no decay is
// taken as a quotient: a decay from s to t as P_t / P_s, or as the
// quotient of cumulative products that the JAX package's `wkv6_chunked`
// takes (k / P), overflows or gives 0/0.  Every decay factor here is the
// product of the w's over exactly its own steps, multiplied in order, the
// way the recurrence takes it: P and Q anchored at the sub-chunk's ends,
// the pairs' running products anchored at s, W_c the product of the four
// sub-chunks' W.  So every factor lies in [0, 1], none overflows, and one
// that underflows stands for a decay below float32's range, which the
// serial recurrence loses too.  (Products are the exp of sums of log w
// without the log's and the exp's rounding, and need no transcendental.)
// No atomics, and every sum is taken in a fixed order: two launches give
// the same bits.
//
// What bounds it on an H100: at the training shape the function's bytes
// (wkv6_cost: r, k, v, w read and y written in bf16, the state read and
// written) take 0.051 ms at 3.35 TB/s, more than its 7 D^2 operations a
// head and step take at the TF32 tensor-core rate (0.015 ms; 0.112 ms at
// the CUDA cores' float32 rate); the chunked form moves more bytes
// than that function needs (the chunk states, B H ceil(T / 64) D^2 floats,
// 67 MB, are written by (1), read and written by (2) and read by (3)) and
// does about 4 D^2 TF32 operations a step on the tensor cores plus the
// pairs' 3 * 16 D on the CUDA cores.  The scan (2) is the only sequential
// part: ceil(T / 64) steps, parallel over B H D^2 elements.
//
// C interface: one function, loaded with ctypes.  It launches the three
// kernels on the given stream, allocates nothing (the chunk states and
// decays live in the caller's scratch, (nc, B H, D, D) and (nc, B H, D)),
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "split_tf32.cuh"

namespace {

constexpr int kChunk = 64;               // steps of a chunk
constexpr int kSub = 16;                 // steps of a sub-chunk: one mma tile's rows
constexpr int kSubs = kChunk / kSub;     // sub-chunks of a chunk
constexpr int kBlock = 128;              // threads of a chunk block
constexpr int kWarps = kBlock / 32;
constexpr int kSlices = kBlock / kSub;   // channel slices of the pairs' sums
constexpr int kScanBlock = 256;          // threads of a scan block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Element strides (batch, head, time) of r, k, v and w; D has stride 1.
struct Strides {
  long long r[3], k[3], v[3], w[3];
};

template <typename T>
struct In {
  const T *r, *k, *v, *w;
};

struct Args {
  int H, T, nc;        // heads, steps, chunks
  int BH;              // batch rows times heads
  const float* u;      // (H, D)
  const float* s0;     // (B, H, D, D) or null (a zero initial state)
  float* sout;         // (B, H, D, D); may be s0
  void* y;             // (B, T, H, D)
  float* states;       // (nc, B H, D, D): dS_c, then each chunk's starting state
  float* decays;       // (nc, B H, D): W_c
  Strides st;
};

// ---- the tensor cores: mma.sync m16n8k8, TF32 in, float32 sums ---------
// Fragments (g = lane / 4, q = lane % 4): A (16 x 8, row-major) a0 (g, q),
// a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4); B (8 x 8, k by n) b0
// (q, g), b1 (q + 4, g); C (16 x 8) c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8,
// 2q), c3 (g + 8, 2q + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x as TF32 operands: hi, and with kSplit lo = tf32(x - hi).
template <bool kSplit, int N>
__device__ __forceinline__ void to_tf32(const float (&x)[N], uint32_t (&hi)[N],
                                        uint32_t (&lo)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float h = tf32_round(x[e]);
    hi[e] = __float_as_uint(h);
    lo[e] = kSplit ? __float_as_uint(tf32_round(x[e] - h)) : 0u;
  }
}

// d += a b: three TF32 products, the small terms first (kSplit), or one.
template <bool kSplit>
__device__ __forceinline__ void mma_op(float (&d)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                       const uint32_t (&bl)[2]) {
  if (kSplit) {
    mma_tf32(d, al, bh);
    mma_tf32(d, ah, bl);
  }
  mma_tf32(d, ah, bh);
}

// ---- shared memory of a chunk block (floats) ----------------------------
// Leading dimensions keep each fragment load on 32 distinct banks: rows
// read as an A operand (r*P, A) are 4 floats off a multiple of 32, rows
// read down a column (k*Q as the transposed A operand, v and the state
// as B operands) 8 off.
template <int D>
struct Smem {
  static constexpr int kLdR = D + 4;     // r, then r * P
  static constexpr int kLdW = D + 4;     // w
  static constexpr int kLdK = D + 8;     // k, then k * Q
  static constexpr int kLdV = D + 8;     // v
  static constexpr int kLdS = D + 8;     // the state
  static constexpr int kLdA = kSub + 4;  // A
  static constexpr int kR = 0;
  static constexpr int kW = kR + kSub * kLdR;
  static constexpr int kK = kW + kSub * kLdW;
  static constexpr int kV = kK + kSub * kLdK;
  static constexpr int kS = kV + kSub * kLdV;
  static constexpr int kA = kS + D * kLdS;
  static constexpr int kU = kA + kSub * kLdA;
  static constexpr int kTot = kU + D;
  static constexpr int kFloats = kTot + D;
  static constexpr size_t kBytes = static_cast<size_t>(kFloats) * 4;
};

// The (kSub, D) slab of x at steps [t0, t0 + kSub), N values a thread
// (element idx = thread + n kBlock: step idx / D, channel idx % D, so a
// warp reads consecutive channels); steps past T give `pad`.
template <typename T, int D, int N>
__device__ __forceinline__ void load_sub(T (&out)[N], const T* base, long long ts, int t0,
                                         int T_steps, float pad) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int idx = threadIdx.x + n * kBlock, t = t0 + idx / D;
    out[n] = t < T_steps ? base[t * ts + idx % D] : T(pad);
  }
}
template <typename T, int D, int N>
__device__ __forceinline__ void store_sub(float* dst, int ld, const T (&in)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int idx = threadIdx.x + n * kBlock;
    dst[(idx / D) * ld + idx % D] = to_f(in[n]);
  }
}

// (1) with kY false: dS_c and W_c of each chunk.  (3) with kY true: y of
// each chunk from its starting state.  A block a (b, h, chunk), blockIdx.x
// = (b H + h) nc + chunk.
template <typename T, int D, bool kY>
__global__ void __launch_bounds__(kBlock) wkv6c_chunk_kernel(In<T> in, Args a) {
  using L = Smem<D>;
  constexpr bool kSplit = sizeof(T) == 4;  // float32 inputs: split TF32
  constexpr int N = kSub * D / kBlock;     // slab values a thread loads
  constexpr int NT = D / 8;                // n-tiles of 8 columns
  constexpr int NTW = NT >= kWarps ? NT / kWarps : 1;  // n-tiles of y a warp owns
  constexpr int MT = D / 16;               // m-tiles of 16 state rows
  constexpr int WPM = MT >= kWarps ? 1 : kWarps / MT;  // warps an m-tile of the update
  extern __shared__ float sm[];
  float* s_r = sm + L::kR;
  float* s_w = sm + L::kW;
  float* s_k = sm + L::kK;
  float* s_v = sm + L::kV;
  float* s_S = sm + L::kS;
  float* s_A = sm + L::kA;
  float* s_u = sm + L::kU;
  float* s_tot = sm + L::kTot;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int bh = blockIdx.x / a.nc, c = blockIdx.x % a.nc;
  const int b = bh / a.H, h = bh % a.H;
  const int t_chunk = c * kChunk;
  const size_t DD = static_cast<size_t>(D) * D;
  const size_t slot = static_cast<size_t>(c) * a.BH + bh;  // this chunk's scratch
  const T* rb = in.r + b * a.st.r[0] + h * a.st.r[1];
  const T* kb = in.k + b * a.st.k[0] + h * a.st.k[1];
  const T* vb = in.v + b * a.st.v[0] + h * a.st.v[1];
  const T* wb = in.w + b * a.st.w[0] + h * a.st.w[1];
  // sub-chunks that hold steps < T (padded steps: w 1, r k v 0)
  const int n_sub = min(kSubs, (a.T - t_chunk + kSub - 1) / kSub);

  T lr[N], lk[N], lv[N], lw[N];
  auto load = [&](int sc) {
    const int t0 = t_chunk + sc * kSub;
    if (kY) load_sub<T, D, N>(lr, rb, a.st.r[2], t0, a.T, 0.f);
    load_sub<T, D, N>(lk, kb, a.st.k[2], t0, a.T, 0.f);
    load_sub<T, D, N>(lv, vb, a.st.v[2], t0, a.T, 0.f);
    load_sub<T, D, N>(lw, wb, a.st.w[2], t0, a.T, 1.f);
  };
  load(0);
  {
    // the state at the chunk's start (3), or zero (1)
    const float* s_in = a.states + slot * DD;
    for (int e = tid; e < D * D; e += kBlock)
      s_S[(e / D) * L::kLdS + e % D] = kY ? s_in[e] : 0.f;
    if (kY)
      for (int i = tid; i < D; i += kBlock) s_u[i] = a.u[h * D + i];
  }
  float chunk_decay = 1.f;  // (1): W_c of channel tid, the sub-chunks' W multiplied

  for (int sc = 0; sc < n_sub; ++sc) {
    __syncthreads();  // the last sub-chunk's products are done with the buffers
    if (kY) store_sub<T, D, N>(s_r, L::kLdR, lr);
    store_sub<T, D, N>(s_k, L::kLdK, lk);
    store_sub<T, D, N>(s_v, L::kLdV, lv);
    store_sub<T, D, N>(s_w, L::kLdW, lw);
    __syncthreads();
    if (sc + 1 < n_sub) load(sc + 1);  // in flight while this sub-chunk is worked

    if (kY) {
      // A on the CUDA cores: thread (s, slice) sums over channels slice +
      // kSlices m, t > s in registers, the decay from s to t a running product
      const int s = tid / kSlices, sl = tid % kSlices;
      float acc[kSub], dg = 0.f;
#pragma unroll
      for (int t = 0; t < kSub; ++t) acc[t] = 0.f;
#pragma unroll 2
      for (int m = 0; m < D / kSlices; ++m) {
        const int i = sl + kSlices * m;
        const float ks = s_k[s * L::kLdK + i];
        dg = fmaf(s_r[s * L::kLdR + i] * s_u[i], ks, dg);
        float d = ks;  // k_s[i] times the decay from s to t
#pragma unroll
        for (int t = 1; t < kSub; ++t) {
          if (t > s) {
            acc[t] = fmaf(s_r[t * L::kLdR + i], d, acc[t]);
            d *= s_w[t * L::kLdW + i];
          }
        }
      }
      // sums over the slices (lanes tid % kSlices of one warp), in a fixed order
#pragma unroll
      for (int off = kSlices / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int t = 0; t < kSub; ++t) acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], off);
        dg += __shfl_xor_sync(0xffffffffu, dg, off);
      }
#pragma unroll
      for (int t = 0; t < kSub; ++t)
        if (t % kSlices == sl) s_A[t * L::kLdA + s] = t > s ? acc[t] : (t == s ? dg : 0.f);
      __syncthreads();  // A read r and k before they are scaled
    }

    // P, Q and W of each channel: r <- r * P, k <- k * Q
    if (tid < D) {
      const int i = tid;
      float p = 1.f;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const float wt = s_w[t * L::kLdW + i];
        if (kY) s_r[t * L::kLdR + i] *= p;
        p *= wt;
      }
      s_tot[i] = p;
      chunk_decay *= p;
      float qq = 1.f;
#pragma unroll
      for (int t = kSub - 1; t >= 0; --t) {
        s_k[t * L::kLdK + i] *= qq;
        qq *= s_w[t * L::kLdW + i];
      }
    }
    __syncthreads();

    if (kY) {
      // y (16 x D) = (r * P) S + A v; warp w owns n-tiles [w NTW, (w + 1) NTW)
      const int nt0 = warp * NTW;
      if (nt0 < NT) {
        float acc[NTW][4];
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 2
        for (int k0 = 0; k0 < D; k0 += 8) {
          const float af[4] = {s_r[g * L::kLdR + k0 + q], s_r[(g + 8) * L::kLdR + k0 + q],
                               s_r[g * L::kLdR + k0 + q + 4],
                               s_r[(g + 8) * L::kLdR + k0 + q + 4]};
          uint32_t ah[4], al[4];
          to_tf32<kSplit>(af, ah, al);
#pragma unroll
          for (int n = 0; n < NTW; ++n) {
            const int n0 = (nt0 + n) * 8;
            const float bf[2] = {s_S[(k0 + q) * L::kLdS + n0 + g],
                                 s_S[(k0 + q + 4) * L::kLdS + n0 + g]};
            uint32_t bh2[2], bl2[2];
            to_tf32<kSplit>(bf, bh2, bl2);
            mma_op<kSplit>(acc[n], ah, al, bh2, bl2);
          }
        }
#pragma unroll
        for (int k0 = 0; k0 < kSub; k0 += 8) {
          const float af[4] = {s_A[g * L::kLdA + k0 + q], s_A[(g + 8) * L::kLdA + k0 + q],
                               s_A[g * L::kLdA + k0 + q + 4],
                               s_A[(g + 8) * L::kLdA + k0 + q + 4]};
          uint32_t ah[4], al[4];
          to_tf32<kSplit>(af, ah, al);
#pragma unroll
          for (int n = 0; n < NTW; ++n) {
            const int n0 = (nt0 + n) * 8;
            const float bf[2] = {s_v[(k0 + q) * L::kLdV + n0 + g],
                                 s_v[(k0 + q + 4) * L::kLdV + n0 + g]};
            uint32_t bh2[2], bl2[2];
            to_tf32<kSplit>(bf, bh2, bl2);
            mma_op<kSplit>(acc[n], ah, al, bh2, bl2);
          }
        }
        // y is (B, T, H, D): step t of this head at ((b T + t) H + h) D
        T* yb = static_cast<T*>(a.y);
        const int t0 = t_chunk + sc * kSub;
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          const int j = (nt0 + n) * 8 + 2 * q;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t = t0 + g + 8 * half;
            if (t < a.T)
              store2(yb + ((static_cast<size_t>(b) * a.T + t) * a.H + h) * D + j,
                     acc[n][2 * half], acc[n][2 * half + 1]);
          }
        }
      }
    }

    // S <- diag(W) S + (k * Q)^T v (not after the chunk's last sub-chunk in (3))
    if (!kY || sc + 1 < n_sub) {
      if (kY) __syncthreads();  // y has read S
      // warp w: m-tile w % MT (and w + kWarps ...), every WPM-th n-tile
      for (int mt = warp % MT; mt < MT && warp / MT < WPM; mt += kWarps) {
        const int m0 = mt * 16;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int k0 = ks * 8;
          const float af[4] = {s_k[(k0 + q) * L::kLdK + m0 + g],
                               s_k[(k0 + q) * L::kLdK + m0 + g + 8],
                               s_k[(k0 + q + 4) * L::kLdK + m0 + g],
                               s_k[(k0 + q + 4) * L::kLdK + m0 + g + 8]};
          to_tf32<kSplit>(af, ah[ks], al[ks]);
        }
        const float d0 = s_tot[m0 + g], d1 = s_tot[m0 + g + 8];
#pragma unroll 2
        for (int nt = warp / MT; nt < NT; nt += WPM) {
          const int n0 = nt * 8;
          float* c0 = s_S + (m0 + g) * L::kLdS + n0 + 2 * q;
          float* c1 = c0 + 8 * L::kLdS;
          const float2 x0 = *reinterpret_cast<const float2*>(c0);
          const float2 x1 = *reinterpret_cast<const float2*>(c1);
          float acc[4] = {x0.x * d0, x0.y * d0, x1.x * d1, x1.y * d1};
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const int k0 = ks * 8;
            const float bf[2] = {s_v[(k0 + q) * L::kLdV + n0 + g],
                                 s_v[(k0 + q + 4) * L::kLdV + n0 + g]};
            uint32_t bh2[2], bl2[2];
            to_tf32<kSplit>(bf, bh2, bl2);
            mma_op<kSplit>(acc, ah[ks], al[ks], bh2, bl2);
          }
          *reinterpret_cast<float2*>(c0) = make_float2(acc[0], acc[1]);
          *reinterpret_cast<float2*>(c1) = make_float2(acc[2], acc[3]);
        }
      }
    }
  }

  if (!kY) {
    __syncthreads();
    float* out = a.states + slot * DD;
    for (int e = tid; e < D * D; e += kBlock) out[e] = s_S[(e / D) * L::kLdS + e % D];
    if (tid < D) a.decays[slot * D + tid] = chunk_decay;
  }
}

// (2) The scan over the chunks: a thread four elements (b, h, i, j..j+3)
// of the state, S <- W_c[i] S + dS_c, each chunk's starting state written
// over its increment.  The chunk states are chunk-major, so at each chunk
// the threads read and write one contiguous run of B H D^2 floats.  The
// increments and decays of kAhead chunks are loaded before any of them is
// written, so the loads do not wait on the stores.  kVec false: one
// element a thread, for a state or sout not 16-byte aligned.
template <int D, bool kVec>
__global__ void __launch_bounds__(kScanBlock) wkv6c_scan_kernel(Args a, long long n_threads) {
  constexpr int kAhead = 8;
  constexpr int V = kVec ? 4 : 1;  // elements a thread
  using Vec = typename std::conditional<kVec, float4, float>::type;
  const long long idx = static_cast<long long>(blockIdx.x) * kScanBlock + threadIdx.x;
  if (idx >= n_threads) return;
  const long long per_head = static_cast<long long>(D) * D / V;
  const long long bh = idx / per_head;
  const int i = static_cast<int>(idx % per_head) * V / D;
  const long long stride = static_cast<long long>(a.BH) * per_head;  // one chunk's states
  Vec S;
  if (a.s0) {
    S = reinterpret_cast<const Vec*>(a.s0)[idx];  // read before sout (which may be s0) is written
  } else {
    float* f = reinterpret_cast<float*>(&S);
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = 0.f;
  }
  Vec* st = reinterpret_cast<Vec*>(a.states) + idx;
  const float* dc = a.decays + bh * D + i;
  for (int c0 = 0; c0 < a.nc; c0 += kAhead) {
    Vec ds[kAhead];
    float wc[kAhead];
#pragma unroll
    for (int x = 0; x < kAhead; ++x) {
      if (c0 + x < a.nc) {
        ds[x] = st[(c0 + x) * stride];
        wc[x] = dc[static_cast<long long>(c0 + x) * a.BH * D];
      }
    }
#pragma unroll
    for (int x = 0; x < kAhead; ++x) {
      if (c0 + x < a.nc) {
        st[(c0 + x) * stride] = S;
        float* f = reinterpret_cast<float*>(&S);
        const float* g = reinterpret_cast<const float*>(&ds[x]);
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = fmaf(wc[x], f[e], g[e]);
      }
    }
  }
  reinterpret_cast<Vec*>(a.sout)[idx] = S;
}

template <typename T, int D>
int launch_d(const In<T>& in, const Args& a, cudaStream_t s) {
  using L = Smem<D>;
  static bool states_set = false, y_set = false;
  int err = allow_smem(wkv6c_chunk_kernel<T, D, false>, L::kBytes, states_set);
  if (err == 0) err = allow_smem(wkv6c_chunk_kernel<T, D, true>, L::kBytes, y_set);
  if (err != 0) return err;
  const long long blocks = static_cast<long long>(a.BH) * a.nc;
  // four elements a scan thread where the states are 16-byte aligned
  const bool vec = ((reinterpret_cast<uintptr_t>(a.s0) | reinterpret_cast<uintptr_t>(a.sout) |
                     reinterpret_cast<uintptr_t>(a.states)) & 15) == 0;
  const long long n_threads = static_cast<long long>(a.BH) * D * D / (vec ? 4 : 1);
  const long long scan_blocks = (n_threads + kScanBlock - 1) / kScanBlock;
  if (blocks > 0x7fffffffLL || scan_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  wkv6c_chunk_kernel<T, D, false><<<static_cast<unsigned>(blocks), kBlock, L::kBytes, s>>>(in, a);
  if (vec)
    wkv6c_scan_kernel<D, true><<<static_cast<unsigned>(scan_blocks), kScanBlock, 0, s>>>(
        a, n_threads);
  else
    wkv6c_scan_kernel<D, false><<<static_cast<unsigned>(scan_blocks), kScanBlock, 0, s>>>(
        a, n_threads);
  wkv6c_chunk_kernel<T, D, true><<<static_cast<unsigned>(blocks), kBlock, L::kBytes, s>>>(in, a);
  return 0;
}

template <typename T>
int launch(int D, const In<T>& in, const Args& a, cudaStream_t s) {
  switch (D) {
    case 16: return launch_d<T, 16>(in, a, s);
    case 32: return launch_d<T, 32>(in, a, s);
    case 64: return launch_d<T, 64>(in, a, s);
    case 128: return launch_d<T, 128>(in, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype of r/k/v/w/y: 0 = float32, 1 = bfloat16.  u (H, D) and the states
// (B, H, D, D) are float32 and contiguous; s0 may be null (zero initial
// state) and may equal sout.  dims holds 16 values: B, H, T, D, then the
// (batch, head, time) element strides of r, k, v and w.  y is (B, T, H, D),
// contiguous.  scratch is float32 of B H ceil(T / 64) (D^2 + D) elements:
// the chunk states, then the chunk decays, each chunk-major.  T >= 1, D in {16, 32, 64, 128}.
extern "C" int repro_wkv6_chunked(int dtype, const void* r, const void* k, const void* v,
                                  const void* w, const void* u, const void* s0, void* y,
                                  void* sout, void* scratch, const long long* dims,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = static_cast<int>(dims[0]), D = static_cast<int>(dims[3]);
  Args a;
  a.H = static_cast<int>(dims[1]);
  a.T = static_cast<int>(dims[2]);
  a.nc = (a.T + kChunk - 1) / kChunk;
  a.BH = B * a.H;
  for (int x = 0; x < 3; ++x) {
    a.st.r[x] = dims[4 + x];
    a.st.k[x] = dims[7 + x];
    a.st.v[x] = dims[10 + x];
    a.st.w[x] = dims[13 + x];
  }
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.sout = static_cast<float*>(sout);
  a.y = y;
  a.states = static_cast<float*>(scratch);
  a.decays = a.states + static_cast<size_t>(B) * a.H * a.nc * D * D;
  if (a.T < 1) return static_cast<int>(cudaErrorInvalidValue);
  int err;
  switch (dtype) {
    case 0:
      err = launch<float>(D, In<float>{static_cast<const float*>(r), static_cast<const float*>(k),
                                       static_cast<const float*>(v), static_cast<const float*>(w)},
                          a, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(
          D, In<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(r),
                               static_cast<const __nv_bfloat16*>(k),
                               static_cast<const __nv_bfloat16*>(v),
                               static_cast<const __nv_bfloat16*>(w)},
          a, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
