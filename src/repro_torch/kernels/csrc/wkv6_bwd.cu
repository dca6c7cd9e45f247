// Backward of the RWKV6 WKV recurrence (K5).  With P_t = S_{t-1} the state
// before step t (P_0 the initial state s0), the forward is
//
//   y_t[j] = sum_i r_t[i] (P_t[i,j] + u[i] k_t[i] v_t[j])
//   S_t    = diag(w_t) P_t + k_t v_t^T
//
// and, with G_t = dL/dS_t (G_{T-1} the final state's gradient, or 0):
//
//   dr_t[i] = sum_j P_t[i,j] dy_t[j] + u[i] k_t[i] (v_t . dy_t)
//   dk_t[i] = r_t[i] u[i] (v_t . dy_t) + sum_j G_t[i,j] v_t[j]
//   dv_t[j] = (sum_i r_t[i] u[i] k_t[i]) dy_t[j] + sum_i G_t[i,j] k_t[i]
//   dw_t[i] = sum_j G_t[i,j] P_t[i,j]
//   du[i]   = sum_t r_t[i] k_t[i] (v_t . dy_t)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   ds0 = G_{-1}
//
// The TPU kernel `wkv6_pallas` (src/repro/kernels/wkv6.py) has no backward:
// the JAX package differentiates through its XLA form (`wkv6_chunked`).
// The port's forward runs the hand-written K5 kernel (wkv6.cu), so training
// on the card needs this one.
//
// The trap is dw: it needs the forward state P_t and the backward state
// G_t at the same step, and the two run in opposite directions.  P_t cannot
// be recovered from S_t by undoing the recurrence, nor a decay between two
// steps as a quotient of cumulative products: that divides by w_t =
// exp(-exp(.)), far below 1e-10 in places.  Nothing here divides: every
// state is the recurrence's own product, step by step.
//
// Both recurrences act on the rows of a state through diag(w_t) and add a
// rank-one term, so each element (i, j) of P and of G evolves on its own,
// given the step's inputs.  The design uses that twice, in three phases
// launched in order on one stream by one C call (kChunk = C = 16 steps):
//   (a) wkv6_bwd_states_kernel, role 0: P at the start of every chunk,
//       walking the sequence forwards; (b) role 1: G after the last step
//       of every group of kGroup = 4 chunks, walking it backwards, and
//       ds0 = G_{-1} at its end.
//       Grid (B H, D / 16, 2): a block owns 16 columns of one head's state
//       (columns evolve apart), 2 D threads, a thread a row and 8 columns.
//       The inputs are staged in shared memory two chunks at a time, the
//       next two loaded into registers while the block walks these.
//       A warp-wide 16-byte load from shared memory is four transactions
//       even where lanes repeat an address, so in (c) a thread owns 8
//       elements, 2 lines by 4, one such load serving both lines.
//   (c) every group of chunks at once, grid (B H, T / (4 C), ...): a block
//       walks its group's chunks from the last, G carrying on from one to
//       the one before, each chunk from its P at the start, the next
//       chunk's loads in flight meanwhile:
//       * wkv6_bwd_rows_kernel: a block owns rows of a head's state (32 at
//         D 64), a thread 2 rows and 4 columns.  It recomputes P_t forward
//         through the chunk and takes dr_t, keeping the second half's
//         states of its 8 elements in registers (64 floats); walks G_t
//         backward through that half and takes dk_t and dw_t = sum_j G_t
//         P_t; then recomputes the first half's states from the chunk's
//         start and walks G back through it; and writes each row's du
//         over the chunk.  Sums over j go through shared memory, each
//         thread's partial once a step, summed after each pass.
//       * wkv6_bwd_cols_kernel: dv_t is a sum over i, so a block owns
//         columns of the state (32 at D 64), a thread 2 columns and 4
//         rows, and walks G_t backward through the chunk (G needs no P).
//   (d) wkv6_bwd_du_kernel: du, each (b, h) row's chunk sums added in
//       order (the caller sums over b).
// Each output element is written by one thread and every sum is taken in
// a fixed order: no atomics, so the result repeats bit for bit.
//
// Scratch, passed by the caller: P at the chunk boundaries, B H
// ceil(T / C) D^2 floats (268 MB at RWKV6-7B's training shape, B 1, H 64,
// T 4096, D 64); G at the group boundaries, a quarter of that; and the
// chunks' du, B H ceil(T / C) D.
//
// What bounds it on an H100: operations.  The recurrence's work is about
// 14 D^2 operations a head and step (the forward states again, G's
// recurrence, and dr, dk, dv, dw), 15.0 GFLOP at RWKV6-7B's training
// shape: 0.224 ms at the 67 TFLOP/s of float32, against 0.034 ms for its
// inputs' and gradients' bytes.  The boundary states add 0.74 GB of
// traffic (P written and read once, G written once and read twice),
// about 0.22 ms at 3.35 TB/s; a longer chunk would cut that, at twice
// the registers.  What limits this design in practice is shared memory:
// every step of every element reads its step's v_j or dy_j and w_i with
// k_i or r_i from it, and writes a partial sum, so the phases (c) are
// bound by its bandwidth (one 128-byte transaction a clock an SM), and
// the walks of (a) and (b), 4096 steps in order, by latency.  Products
// over chunks of steps on the tensor cores (the chunked form) would take
// both away; they need the decays between steps as exp of sums of logs.
//
// C interface: one function, loaded with ctypes.  It launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;  // C: steps of a chunk
constexpr int kGroup = 4;   // chunks a block of phase (c) walks, from the last

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element strides (batch, head, time) of r, k, v, w and dy; D has stride 1.
struct Strides {
  long long r[3], k[3], v[3], w[3], dy[3];
};

template <typename T>
struct In {
  const T *r, *k, *v, *w, *dy;
};

struct Args {
  int H, T, nc;  // heads, steps, chunks
  const float* u;     // (H, D)
  const float* s0;    // (B, H, D, D) or null
  const float* dsT;   // (B, H, D, D) or null
  void *dr, *dk, *dv, *dw;  // (B, T, H, D)
  float* ds0;         // (B, H, D, D)
  float* du_part;     // (B H, nc, D)
  float* du;          // (B, H, D)
  float* pstates;     // (B H, nc, D, D): P before each chunk's first step
  float* gstates;     // (B H, ng, D, D): G after each group's last (padded) step
  int ng;             // groups of kGroup chunks
  Strides st;
};

// ---- (a), (b): the states at the chunk boundaries ----------------------
// Steps staged at a time: two chunks (16 KB of rows at D 64).  A thread
// loads its share of the next stage into registers while the block walks
// the current one, so the walk waits on no load from device memory.
template <int D>
struct Stage {
  static constexpr int kSteps = 2 * kChunk;
  static constexpr int kThreads = 2 * D;
  static constexpr int kRows = kSteps * D / kThreads;  // w and k (or r) values a thread loads
  static constexpr int kCols = kSteps * 16 / kThreads;  // v (or dy) values a thread loads
};

template <typename T, int D>
__global__ void __launch_bounds__(2 * D) wkv6_bwd_states_kernel(In<T> in, Args a) {
  using L = Stage<D>;
  constexpr int SS = L::kSteps, NT = L::kThreads;
  __shared__ float s_w[SS][D], s_x[SS][D];  // w, and k (P) or r (G), every row
  __shared__ float s_y[SS][16];             // v (P) or dy (G), the block's 16 columns
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int j0 = blockIdx.y * 16;
  const bool fwd = blockIdx.z == 0;
  const int i = threadIdx.x / 2, jb = 8 * (threadIdx.x % 2);  // row i, columns j0 + jb + 0..7
  const size_t bh = static_cast<size_t>(b) * a.H + h;
  const size_t DD = static_cast<size_t>(D) * D;
  const int nc = a.nc;
  float* out = (fwd ? a.pstates + bh * nc * DD : a.gstates + bh * a.ng * DD) +
               static_cast<size_t>(i) * D + j0 + jb;
  const float* init = fwd ? a.s0 : a.dsT;
  // w, k (P) or r (G), v (P) or dy (G) of head (b, h), and their time strides
  const long long wt = a.st.w[2], xt = fwd ? a.st.k[2] : a.st.r[2];
  const long long yt = fwd ? a.st.v[2] : a.st.dy[2];
  const T* wb = in.w + b * a.st.w[0] + h * a.st.w[1];
  const T* xb = fwd ? in.k + b * a.st.k[0] + h * a.st.k[1] : in.r + b * a.st.r[0] + h * a.st.r[1];
  const T* yb = (fwd ? in.v + b * a.st.v[0] + h * a.st.v[1]
                     : in.dy + b * a.st.dy[0] + h * a.st.dy[1]) + j0;

  float S[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    S[e] = init ? init[bh * DD + static_cast<size_t>(i) * D + j0 + jb + e] : 0.f;

  // the steps to walk: forwards over chunks 0 .. nc - 2, backwards over
  // every group (steps past T padded); forwards stage sg covers
  // [sg SS, ...), backwards [n_steps - (sg + 1) SS, ...), whose first
  // steps may be < 0
  const int n_steps = fwd ? (nc - 1) * kChunk : a.ng * kGroup * kChunk;
  const int n_stages = (n_steps + SS - 1) / SS;
  auto first = [&](int sg) { return fwd ? sg * SS : n_steps - (sg + 1) * SS; };
  T rw[L::kRows], rx[L::kRows], ry[L::kCols];
  auto load = [&](int sg) {
    const int t0 = first(sg);
#pragma unroll
    for (int n = 0; n < L::kRows; ++n) {
      const int idx = threadIdx.x + n * NT, t = t0 + idx / D, e = idx % D;
      const bool ok = t >= 0 && t < a.T;
      rw[n] = ok ? wb[t * wt + e] : T(0.f);
      rx[n] = ok ? xb[t * xt + e] : T(0.f);
    }
#pragma unroll
    for (int n = 0; n < L::kCols; ++n) {
      const int idx = threadIdx.x + n * NT, t = t0 + idx / 16;
      ry[n] = t >= 0 && t < a.T ? yb[t * yt + idx % 16] : T(0.f);
    }
  };
  auto store = [&](int sg) {  // a padded step has w 1 and zeros
    const int t0 = first(sg);
#pragma unroll
    for (int n = 0; n < L::kRows; ++n) {
      const int idx = threadIdx.x + n * NT, t = t0 + idx / D;
      const bool ok = t >= 0 && t < a.T;
      s_w[idx / D][idx % D] = ok ? to_f(rw[n]) : 1.f;
      s_x[idx / D][idx % D] = ok ? to_f(rx[n]) : 0.f;
    }
#pragma unroll
    for (int n = 0; n < L::kCols; ++n) {
      const int idx = threadIdx.x + n * NT;
      s_y[idx / 16][idx % 16] = to_f(ry[n]);
    }
  };

  if (n_stages > 0) load(0);
  for (int sg = 0; sg < n_stages; ++sg) {
    __syncthreads();  // the last stage's walk is done with the buffers
    store(sg);
    __syncthreads();
    if (sg + 1 < n_stages) load(sg + 1);  // in flight during this stage's walk
    const int t0 = first(sg);
    for (int cc = 0; cc < SS / kChunk; ++cc) {
      // forwards the stage's chunks in order, backwards from its last
      const int c0 = fwd ? cc * kChunk : SS - (cc + 1) * kChunk;  // chunk start in the stage
      const int tc = t0 + c0;
      if (tc < 0 || tc >= n_steps) continue;
      // P before every chunk; G after the last chunk of every group
      if (fwd || (tc / kChunk) % kGroup == kGroup - 1) {
        float4* o = reinterpret_cast<float4*>(
            out + (fwd ? tc / kChunk : tc / (kChunk * kGroup)) * DD);
        o[0] = make_float4(S[0], S[1], S[2], S[3]);
        o[1] = make_float4(S[4], S[5], S[6], S[7]);
      }
#pragma unroll
      for (int n = 0; n < kChunk; ++n) {
        const int tt = fwd ? c0 + n : c0 + kChunk - 1 - n;
        const float wi = s_w[tt][i], xi = s_x[tt][i];
        const float4 y0 = *reinterpret_cast<const float4*>(&s_y[tt][jb]);
        const float4 y1 = *reinterpret_cast<const float4*>(&s_y[tt][jb + 4]);
        S[0] = fmaf(wi, S[0], xi * y0.x);
        S[1] = fmaf(wi, S[1], xi * y0.y);
        S[2] = fmaf(wi, S[2], xi * y0.z);
        S[3] = fmaf(wi, S[3], xi * y0.w);
        S[4] = fmaf(wi, S[4], xi * y1.x);
        S[5] = fmaf(wi, S[5], xi * y1.y);
        S[6] = fmaf(wi, S[6], xi * y1.z);
        S[7] = fmaf(wi, S[7], xi * y1.w);
      }
    }
  }
  // forwards: P before the last chunk; backwards: G_{-1}
  float4* o = reinterpret_cast<float4*>(
      fwd ? out + (nc - 1) * DD : a.ds0 + bh * DD + static_cast<size_t>(i) * D + j0 + jb);
  o[0] = make_float4(S[0], S[1], S[2], S[3]);
  o[1] = make_float4(S[4], S[5], S[6], S[7]);
}

// ---- (c): the gradients of every chunk ---------------------------------
// Threads of a chunk block.  Shared-memory bandwidth bounds these
// kernels (a warp's 16-byte load is four transactions even where lanes
// repeat an address), so a thread owns 8 elements: 2 lines of the state
// (rows in the rows kernel, columns in the columns kernel) and 4
// elements of each across them, one 16-byte load serving both lines.
// kLpr = D / 4 threads a pair of lines, kPairs pairs, kLines = 2 kPairs
// lines and kThreads threads a block (32 lines, 256 threads at D 64).
// A block walks the kGroup chunks of a group from the last: G carries on
// from one chunk to the one before, and while it works on a chunk the
// loads of the next are in flight, in registers.
template <int D>
struct Tile {
  static constexpr int kLpr = D / 4;
  static constexpr int kPairs = D / 2 < 256 / kLpr ? D / 2 : 256 / kLpr;
  static constexpr int kLines = 2 * kPairs;
  static constexpr int kThreads = kPairs * kLpr;
  static constexpr int kLd = kLpr + 1;  // padded: the sums' reads fall in distinct banks
  // bytes of shared memory: the rows kernel's r, k, w (C x lines), v, dy
  // (C x D), v.dy (C) and two partial-sum buffers (C x lines x kLd); the
  // columns kernel's r, k, w (C x D), dy (C x lines), r.u.k (C), G
  // (D x lines) and one partial-sum buffer
  static constexpr size_t kRowsBytes =
      4 * (3 * kChunk * kLines + 2 * kChunk * D + kChunk + 2 * kChunk * kLines * kLd);
  static constexpr size_t kColsBytes =
      4 * (3 * kChunk * D + kChunk * kLines + kChunk + D * kLines + kChunk * kLines * kLd);
};

// v_t . dy_t (rows kernel) or sum_i r_t u k_t (columns kernel) of each
// step of the chunk into out[C], a warp a step: x, y are (C, D) in shared
// memory, z (if not null) a (D) vector.
template <int D, int NT>
__device__ __forceinline__ void step_dots(float* out, const float* x, const float* y,
                                          const float* z) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kWarps = (NT + 31) / 32;
  for (int tt = warp; tt < kChunk; tt += kWarps) {
    float acc = 0.f;
    for (int e = lane; e < D; e += 32) {
      const float p = x[tt * D + e] * y[tt * D + e];
      acc = z ? fmaf(p, z[e], acc) : acc + p;
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, sh);
    if (lane == 0) out[tt] = acc;
  }
}

// The elements [e0, e0 + n) of a chunk's (C, W) slab of x (column offset
// c0 in the head), n per thread, loaded raw: element idx of the slab is
// step idx / W, column c0 + idx % W; steps past T (or idx past C W) give
// `pad`.
template <typename T, int W, int N, int NT>
__device__ __forceinline__ void load_slab(T (&out)[N], const T* x, const long long (&st)[3],
                                          int b, int h, int t0, int c0, int T_steps, float pad) {
  const T* base = x + b * st[0] + h * st[1] + c0;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int idx = threadIdx.x + n * NT, t = t0 + idx / W;
    out[n] = (idx < kChunk * W && t < T_steps) ? base[t * st[2] + idx % W] : T(pad);
  }
}
template <typename T, int W, int N, int NT>
__device__ __forceinline__ void store_slab(float* dst, const T (&in)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int idx = threadIdx.x + n * NT;
    if (idx < kChunk * W) dst[idx] = to_f(in[n]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Tile<D>::kThreads, 2) wkv6_bwd_rows_kernel(In<T> in, Args a) {
  using L = Tile<D>;
  constexpr int C = kChunk, RB = L::kLines, NP = L::kPairs, LPR = L::kLpr, LD = L::kLd;
  constexpr int NT = L::kThreads, H2 = C / 2;
  constexpr int NR = (C * RB + NT - 1) / NT, NV = C * D / NT;
  extern __shared__ float sm[];
  float* s_r = sm;               // (C, RB)
  float* s_k = s_r + C * RB;     // (C, RB)
  float* s_w = s_k + C * RB;     // (C, RB)
  float* s_v = s_w + C * RB;     // (C, D)
  float* s_dy = s_v + C * D;     // (C, D)
  float* s_vdy = s_dy + C * D;   // (C)
  float* red_a = s_vdy + C;      // (C, RB, LD): dr's partial sums, then dk's
  float* red_b = red_a + C * RB * LD;  // dw's

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, g = blockIdx.y;
  const int i0 = blockIdx.z * RB;
  // a thread owns rows i0 + rp and i0 + rp + NP, columns 4 q .. 4 q + 3
  const int q = threadIdx.x % LPR, rp = threadIdx.x / LPR;
  const int ra = rp, rb = rp + NP;
  const size_t bh = static_cast<size_t>(b) * a.H + h;
  const size_t DD = static_cast<size_t>(D) * D;
  const int c_first = g * kGroup, c_last = min(a.nc, c_first + kGroup) - 1;
  const float* u = a.u + h * D;
  const size_t ea = static_cast<size_t>(i0 + ra) * D + 4 * q;  // this thread's elements
  const size_t eb = static_cast<size_t>(i0 + rb) * D + 4 * q;

  // the next chunk's inputs (steps past T padded) and P at its start
  T lr[NR], lk[NR], lw[NR], lv[NV], ly[NV];
  float4 pa4, pb4;
  auto load = [&](int c) {
    const int t0 = c * C;
    load_slab<T, RB, NR, NT>(lr, in.r, a.st.r, b, h, t0, i0, a.T, 0.f);
    load_slab<T, RB, NR, NT>(lk, in.k, a.st.k, b, h, t0, i0, a.T, 0.f);
    load_slab<T, RB, NR, NT>(lw, in.w, a.st.w, b, h, t0, i0, a.T, 1.f);
    load_slab<T, D, NV, NT>(lv, in.v, a.st.v, b, h, t0, 0, a.T, 0.f);
    load_slab<T, D, NV, NT>(ly, in.dy, a.st.dy, b, h, t0, 0, a.T, 0.f);
    const float* ps = a.pstates + (bh * a.nc + c) * DD;
    pa4 = *reinterpret_cast<const float4*>(ps + ea);
    pb4 = *reinterpret_cast<const float4*>(ps + eb);
  };
  load(c_last);
  // G after the group's last step, carried backwards chunk to chunk
  float G[2][4];
  {
    const float* gs = a.gstates + (bh * a.ng + g) * DD;
    const float4 ga = *reinterpret_cast<const float4*>(gs + ea);
    const float4 gb = *reinterpret_cast<const float4*>(gs + eb);
    G[0][0] = ga.x; G[0][1] = ga.y; G[0][2] = ga.z; G[0][3] = ga.w;
    G[1][0] = gb.x; G[1][1] = gb.y; G[1][2] = gb.z; G[1][3] = gb.w;
  }

  // one step of P forwards: P = diag(w) P + k v^T on the thread's elements
  auto step_p = [&](float (&P)[2][4], int tt) {
    const float4 vv = *reinterpret_cast<const float4*>(s_v + tt * D + 4 * q);
    const float v4[4] = {vv.x, vv.y, vv.z, vv.w};
    const float wa = s_w[tt * RB + ra], wb = s_w[tt * RB + rb];
    const float ka = s_k[tt * RB + ra], kb = s_k[tt * RB + rb];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      P[0][e] = fmaf(wa, P[0][e], ka * v4[e]);
      P[1][e] = fmaf(wb, P[1][e], kb * v4[e]);
    }
  };
  // one step of G backwards with dk's and dw's partial sums: P the step's state
  auto step_g = [&](const float (&P)[2][4], int tt) {
    const float4 gy = *reinterpret_cast<const float4*>(s_dy + tt * D + 4 * q);
    const float4 vv = *reinterpret_cast<const float4*>(s_v + tt * D + 4 * q);
    const float y4[4] = {gy.x, gy.y, gy.z, gy.w}, v4[4] = {vv.x, vv.y, vv.z, vv.w};
    const int rows[2] = {ra, rb};
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      float sk = 0.f, sw = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sk = fmaf(G[x][e], v4[e], sk);
        sw = fmaf(G[x][e], P[x][e], sw);
      }
      red_a[(tt * RB + rows[x]) * LD + q] = sk;
      red_b[(tt * RB + rows[x]) * LD + q] = sw;
      const float wi = s_w[tt * RB + rows[x]], ri = s_r[tt * RB + rows[x]];
#pragma unroll
      for (int e = 0; e < 4; ++e) G[x][e] = fmaf(wi, G[x][e], ri * y4[e]);
    }
  };
  // the sums over j of the C steps' partials in buf, one (step, row) an
  // iteration, passed with the step and the row to out
  auto sums = [&](const float* buf, auto&& out) {
    for (int idx = threadIdx.x; idx < C * RB; idx += NT) {
      const float* x = buf + idx * LD;
      float sum = 0.f;
#pragma unroll 8
      for (int e = 0; e < LPR; ++e) sum += x[e];
      out(idx / RB, idx % RB, idx, sum);
    }
  };

  for (int c = c_last; c >= c_first; --c) {
    const int t0 = c * C;
    __syncthreads();  // the last chunk's sums are read
    store_slab<T, RB, NR, NT>(s_r, lr);
    store_slab<T, RB, NR, NT>(s_k, lk);
    store_slab<T, RB, NR, NT>(s_w, lw);
    store_slab<T, D, NV, NT>(s_v, lv);
    store_slab<T, D, NV, NT>(s_dy, ly);
    const float P0[2][4] = {{pa4.x, pa4.y, pa4.z, pa4.w}, {pb4.x, pb4.y, pb4.z, pb4.w}};
    __syncthreads();
    if (c > c_first) load(c - 1);  // in flight while this chunk is worked
    step_dots<D, NT>(s_vdy, s_v, s_dy, nullptr);

    // P_t forward through the chunk: dr's partial sums; the second half's
    // states kept (64 registers hold half a chunk of 8 elements)
    float hist[H2][2][4];
    {
      float P[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) P[x][e] = P0[x][e];
#pragma unroll
      for (int tt = 0; tt < C; ++tt) {
        const float4 gy = *reinterpret_cast<const float4*>(s_dy + tt * D + 4 * q);
        red_a[(tt * RB + ra) * LD + q] =
            fmaf(P[0][0], gy.x, fmaf(P[0][1], gy.y, fmaf(P[0][2], gy.z, P[0][3] * gy.w)));
        red_a[(tt * RB + rb) * LD + q] =
            fmaf(P[1][0], gy.x, fmaf(P[1][1], gy.y, fmaf(P[1][2], gy.z, P[1][3] * gy.w)));
        if (tt >= H2) {
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int e = 0; e < 4; ++e) hist[tt - H2][x][e] = P[x][e];
        }
        if (tt + 1 < C) step_p(P, tt);
      }
    }
    __syncthreads();
    sums(red_a, [&](int tt, int rr, int idx, float sum) {
      const int t = t0 + tt;
      if (t >= a.T) return;
      const int ii = i0 + rr;
      const size_t o = ((static_cast<size_t>(b) * a.T + t) * a.H + h) * D + ii;
      static_cast<T*>(a.dr)[o] = from_f<T>(fmaf(u[ii] * s_k[idx], s_vdy[tt], sum));
    });
    __syncthreads();  // red_a is free for dk's sums

    // G_t backward through the second half, then the first half's states
    // again from the chunk's start, and G backward through it
#pragma unroll
    for (int tt = C - 1; tt >= H2; --tt) step_g(hist[tt - H2], tt);
    {
      float P[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) P[x][e] = P0[x][e];
#pragma unroll
      for (int tt = 0; tt < H2; ++tt) {
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) hist[tt][x][e] = P[x][e];
        if (tt + 1 < H2) step_p(P, tt);
      }
    }
#pragma unroll
    for (int tt = H2 - 1; tt >= 0; --tt) step_g(hist[tt], tt);
    __syncthreads();

    // dk and dw; the u terms; (B, T, H, D) outputs
    sums(red_a, [&](int tt, int rr, int idx, float sum) {
      const int t = t0 + tt;
      if (t >= a.T) return;
      const int ii = i0 + rr;
      const size_t o = ((static_cast<size_t>(b) * a.T + t) * a.H + h) * D + ii;
      static_cast<T*>(a.dk)[o] = from_f<T>(fmaf(s_r[idx] * u[ii], s_vdy[tt], sum));
    });
    sums(red_b, [&](int tt, int rr, int, float sum) {
      const int t = t0 + tt;
      if (t >= a.T) return;
      const size_t o = ((static_cast<size_t>(b) * a.T + t) * a.H + h) * D + i0 + rr;
      static_cast<T*>(a.dw)[o] = from_f<T>(sum);
    });
    // du over the chunk, a row a thread (padded steps add 0)
    for (int rr = threadIdx.x; rr < RB; rr += NT) {
      float du = 0.f;
      for (int tt = 0; tt < C; ++tt)
        du = fmaf(s_r[tt * RB + rr] * s_k[tt * RB + rr], s_vdy[tt], du);
      a.du_part[(bh * a.nc + c) * D + i0 + rr] = du;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Tile<D>::kThreads) wkv6_bwd_cols_kernel(In<T> in, Args a) {
  using L = Tile<D>;
  constexpr int C = kChunk, CB = L::kLines, NP = L::kPairs, LPC = L::kLpr, LD = L::kLd;
  constexpr int NT = L::kThreads;
  constexpr int NV = C * D / NT, NY = (C * CB + NT - 1) / NT, NG = D * CB / NT;
  extern __shared__ float sm[];
  float* s_r = sm;               // (C, D)
  float* s_k = s_r + C * D;      // (C, D)
  float* s_w = s_k + C * D;      // (C, D)
  float* s_dy = s_w + C * D;     // (C, CB)
  float* s_ruk = s_dy + C * CB;  // (C)
  float* s_g = s_ruk + C;        // (D, CB): G at the group's end, the block's columns
  float* red = s_g + D * CB;     // (C, CB, LD)

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, g = blockIdx.y;
  const int j0 = blockIdx.z * CB;
  // a thread owns columns j0 + 2 pr, + 1 and rows 4 p .. 4 p + 3
  const int pr = threadIdx.x % NP, p = threadIdx.x / NP;
  const size_t bh = static_cast<size_t>(b) * a.H + h;
  const size_t DD = static_cast<size_t>(D) * D;
  const int c_first = g * kGroup, c_last = min(a.nc, c_first + kGroup) - 1;

  T lr[NV], lk[NV], lw[NV], ly[NY];
  auto load = [&](int c) {  // the next chunk's inputs (steps past T padded)
    const int t0 = c * C;
    load_slab<T, D, NV, NT>(lr, in.r, a.st.r, b, h, t0, 0, a.T, 0.f);
    load_slab<T, D, NV, NT>(lk, in.k, a.st.k, b, h, t0, 0, a.T, 0.f);
    load_slab<T, D, NV, NT>(lw, in.w, a.st.w, b, h, t0, 0, a.T, 1.f);
    load_slab<T, CB, NY, NT>(ly, in.dy, a.st.dy, b, h, t0, j0, a.T, 0.f);
  };
  load(c_last);
  {
    const float* gs = a.gstates + (bh * a.ng + g) * DD + j0;
    float lg[NG];
#pragma unroll
    for (int n = 0; n < NG; ++n) {  // coalesced along the columns
      const int idx = threadIdx.x + n * NT;
      lg[n] = gs[static_cast<size_t>(idx / CB) * D + idx % CB];
    }
#pragma unroll
    for (int n = 0; n < NG; ++n) s_g[threadIdx.x + n * NT] = lg[n];
  }
  __syncthreads();
  float G[4][2];  // G after the group's last step, carried backwards
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = *reinterpret_cast<const float2*>(s_g + (4 * p + e) * CB + 2 * pr);
    G[e][0] = x.x;
    G[e][1] = x.y;
  }

  for (int c = c_last; c >= c_first; --c) {
    const int t0 = c * C;
    __syncthreads();  // the last chunk's sums are read
    store_slab<T, D, NV, NT>(s_r, lr);
    store_slab<T, D, NV, NT>(s_k, lk);
    store_slab<T, D, NV, NT>(s_w, lw);
    store_slab<T, CB, NY, NT>(s_dy, ly);
    __syncthreads();
    if (c > c_first) load(c - 1);  // in flight while this chunk is worked
    step_dots<D, NT>(s_ruk, s_r, s_k, a.u + h * D);

#pragma unroll
    for (int tt = C - 1; tt >= 0; --tt) {
      const float4 kk = *reinterpret_cast<const float4*>(s_k + tt * D + 4 * p);
      const float4 ww = *reinterpret_cast<const float4*>(s_w + tt * D + 4 * p);
      const float4 rr = *reinterpret_cast<const float4*>(s_r + tt * D + 4 * p);
      const float2 gy = *reinterpret_cast<const float2*>(s_dy + tt * CB + 2 * pr);
      const float k4[4] = {kk.x, kk.y, kk.z, kk.w}, w4[4] = {ww.x, ww.y, ww.z, ww.w};
      const float r4[4] = {rr.x, rr.y, rr.z, rr.w}, g2[2] = {gy.x, gy.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[(tt * CB + 2 * pr + e) * LD + p] =
            fmaf(G[0][e], k4[0], fmaf(G[1][e], k4[1], fmaf(G[2][e], k4[2], G[3][e] * k4[3])));
#pragma unroll
        for (int x = 0; x < 4; ++x) G[x][e] = fmaf(w4[x], G[x][e], r4[x] * g2[e]);
      }
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < C * CB; idx += NT) {
      const int tt = idx / CB, cc = idx % CB, t = t0 + tt;
      if (t >= a.T) continue;
      const float* x = red + idx * LD;
      float sum = 0.f;
#pragma unroll 8
      for (int e = 0; e < LPC; ++e) sum += x[e];
      const size_t o = ((static_cast<size_t>(b) * a.T + t) * a.H + h) * D + j0 + cc;
      static_cast<T*>(a.dv)[o] = from_f<T>(fmaf(s_ruk[tt], s_dy[idx], sum));
    }
  }
}

// ---- (d): du, the chunks' sums in order --------------------------------
template <int D>
__global__ void __launch_bounds__(D) wkv6_bwd_du_kernel(Args a) {
  const size_t bh = blockIdx.x;
  const float* x = a.du_part + bh * a.nc * D + threadIdx.x;
  float s = 0.f;
  for (int c = 0; c < a.nc; ++c) s += x[static_cast<size_t>(c) * D];
  a.du[bh * D + threadIdx.x] = s;
}

template <typename Kern>
int allow_smem(Kern kern, size_t bytes, bool& done) {  // above 48 KB needs the opt-in, once
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;
  return 0;
}

template <typename T, int D>
int launch_d(const In<T>& in, const Args& a, int B, cudaStream_t s) {
  using L = Tile<D>;
  static bool rows_set = false, cols_set = false;
  int err = allow_smem(wkv6_bwd_rows_kernel<T, D>, L::kRowsBytes, rows_set);
  if (err == 0) err = allow_smem(wkv6_bwd_cols_kernel<T, D>, L::kColsBytes, cols_set);
  if (err != 0) return err;
  const unsigned bh = static_cast<unsigned>(B) * a.H;
  wkv6_bwd_states_kernel<T, D><<<dim3(bh, D / 16, 2), 2 * D, 0, s>>>(in, a);
  const dim3 groups(bh, a.ng, D / L::kLines);
  wkv6_bwd_rows_kernel<T, D><<<groups, L::kThreads, L::kRowsBytes, s>>>(in, a);
  wkv6_bwd_cols_kernel<T, D><<<groups, L::kThreads, L::kColsBytes, s>>>(in, a);
  wkv6_bwd_du_kernel<D><<<bh, D, 0, s>>>(a);
  return 0;
}

template <typename T>
int launch(int D, const In<T>& in, const Args& a, int B, cudaStream_t s) {
  switch (D) {
    case 16: return launch_d<T, 16>(in, a, B, s);
    case 32: return launch_d<T, 32>(in, a, B, s);
    case 64: return launch_d<T, 64>(in, a, B, s);
    case 128: return launch_d<T, 128>(in, a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype of r/k/v/w/dy and of dr/dk/dv/dw: 0 = float32, 1 = bfloat16.  dims
// holds 19 values: B, H, T, D, then the (batch, head, time) element
// strides of r, k, v, w and dy (D with stride 1).  u (H, D), s0 and dsT
// (B, H, D, D) are float32 and contiguous; s0 (zero initial state) and dsT
// (no gradient of the final state) may be null.  dr, dk, dv, dw are
// written (B, T, H, D), contiguous; du (B, H, D) per batch row and ds0
// (B, H, D, D) in float32.  pstates, gstates and du_part are float32
// scratch of B H ceil(T / 16) D^2, B H ceil(T / 64) D^2 and
// B H ceil(T / 16) D elements.
// T >= 1, D in {16, 32, 64, 128}.
extern "C" int repro_wkv6_bwd(int dtype, const void* r, const void* k, const void* v,
                              const void* w, const void* dy, const void* u, const void* s0,
                              const void* dsT, void* dr, void* dk, void* dv, void* dw, void* du,
                              void* ds0, void* pstates, void* gstates, void* du_part,
                              const long long* dims, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = static_cast<int>(dims[0]), D = static_cast<int>(dims[3]);
  Args a;
  a.H = static_cast<int>(dims[1]);
  a.T = static_cast<int>(dims[2]);
  a.nc = (a.T + kChunk - 1) / kChunk;
  a.ng = (a.nc + kGroup - 1) / kGroup;
  for (int x = 0; x < 3; ++x) {
    a.st.r[x] = dims[4 + x];
    a.st.k[x] = dims[7 + x];
    a.st.v[x] = dims[10 + x];
    a.st.w[x] = dims[13 + x];
    a.st.dy[x] = dims[16 + x];
  }
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.dsT = static_cast<const float*>(dsT);
  a.dr = dr;
  a.dk = dk;
  a.dv = dv;
  a.dw = dw;
  a.ds0 = static_cast<float*>(ds0);
  a.du_part = static_cast<float*>(du_part);
  a.du = static_cast<float*>(du);
  a.pstates = static_cast<float*>(pstates);
  a.gstates = static_cast<float*>(gstates);
  if (a.nc > 65535 || static_cast<long long>(B) * a.H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  switch (dtype) {
    case 0:
      err = launch<float>(D, In<float>{static_cast<const float*>(r), static_cast<const float*>(k),
                                       static_cast<const float*>(v), static_cast<const float*>(w),
                                       static_cast<const float*>(dy)},
                          a, B, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(
          D, In<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(r),
                               static_cast<const __nv_bfloat16*>(k),
                               static_cast<const __nv_bfloat16*>(v),
                               static_cast<const __nv_bfloat16*>(w),
                               static_cast<const __nv_bfloat16*>(dy)},
          a, B, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
