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
// be recovered from S_t by undoing the recurrence: that divides by w_t =
// exp(-exp(.)), far below 1e-10 in places.  So the kernel recomputes P:
// a first forward sweep from s0 stores the state at every kChunk-th step
// (checkpoints); then, chunk by chunk from the last, it recomputes the
// chunk's kChunk states from its checkpoint into a small buffer and walks
// the chunk backwards with G.  Scratch, passed by the caller: the
// checkpoints, B H ceil(T / kChunk) D^2 floats; the chunk buffer,
// B H kChunk D^2; and G between chunks, B H D^2.  At RWKV6-7B's training
// shape (B 1, H 64, T 4096, D 64) that is 268 MB + 16.8 MB + 1.0 MB,
// alive during the call only; the forward saves nothing but its inputs.
//
// Design: one launch, grid (B H, 2), D threads a block.
//   * blockIdx.y == 0, "rows": thread i owns row i of P and of G, so dr,
//     dk, dw and du (sums over j) are sums in one thread.  The states go
//     through global memory transposed, (j, i), so the D threads of a
//     block read and write one row of them per instruction, coalesced.
//     G lives in registers only while a chunk is walked and goes to the
//     scratch in between, so P and G never hold 2 D registers at once.
//   * blockIdx.y == 1, "columns": thread j owns column j of G, so dv (a sum
//     over i) is a sum in one thread; G's recurrence needs no P, so this
//     block walks t backwards once, as the forward kernel walks it
//     forwards, and writes ds0 at the end.
// Both roles stage a chunk's r, k, v, w and dy (kChunk x D each) in
// shared memory at once, so a step waits on no load from device memory.
// Each output element is written by one thread: no atomics; du is written
// per (b, h) and summed over b by the caller.
//
// What bounds it on an H100: operations.  The gradients need about
// 9 D^2 operations a head and step (dr, dk, dv and dw: 2 D^2 each; the
// G recurrence: D^2), 3 times the forward's; at RWKV6-7B's training
// shape that is 9 * 64 * 4096 * 64^2 = 9.7 GFLOP, 0.144 ms at 67 TFLOP/s,
// against 0.034 ms for its bytes.  This first version has B H blocks of
// D threads per role, far too few threads to fill the card, and walks
// the sequence one step at a time; a chunked form with products over
// chunks of steps is the way down, in a later version.
//
// C interface: one function, loaded with ctypes.  It launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;  // steps between checkpoints (<= every D taken)

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
struct In {  // the inputs of one (b, h) at element j of the head
  const T *r, *k, *v, *w, *dy;
  __device__ In(const T* R, const T* K, const T* V, const T* W, const T* DY, int b, int h, int j,
                const Strides& st)
      : r(R + b * st.r[0] + h * st.r[1] + j),
        k(K + b * st.k[0] + h * st.k[1] + j),
        v(V + b * st.v[0] + h * st.v[1] + j),
        w(W + b * st.w[0] + h * st.w[1] + j),
        dy(DY + b * st.dy[0] + h * st.dy[1] + j) {}
};

struct Out {
  void *dr, *dk, *dv, *dw;
  float *du, *ds0;
  float *ckpt, *chunk, *gsave;  // scratch
};

// A chunk's inputs in shared memory: step tt of the chunk, element j.
template <int D>
struct Stage {
  float r[kChunk][D], k[kChunk][D], v[kChunk][D], w[kChunk][D], dy[kChunk][D];
  float vdy[kChunk];
};

// Steps [t0, t0 + n) of the block's head into `sm`, thread j loading
// element j of each: n independent loads a tensor in flight at once.
template <typename T, int D>
__device__ __forceinline__ void stage(Stage<D>& sm, const In<T>& in, const Strides& st, int t0,
                                      int n) {
  const int j = threadIdx.x;
  __syncthreads();  // the previous chunk is done with sm
  for (int tt = 0; tt < n; ++tt) {
    const long long t = t0 + tt;
    sm.r[tt][j] = to_f(in.r[t * st.r[2]]);
    sm.k[tt][j] = to_f(in.k[t * st.k[2]]);
    sm.v[tt][j] = to_f(in.v[t * st.v[2]]);
    sm.w[tt][j] = to_f(in.w[t * st.w[2]]);
    sm.dy[tt][j] = to_f(in.dy[t * st.dy[2]]);
  }
  __syncthreads();
}

template <typename T, int D>
__device__ void rows(Stage<D>& sm, const In<T>& in, const float* __restrict__ u, const float* s0,
                     const float* dsT, const Out& out, int b, int h, int H, int T_steps,
                     const Strides& st) {
  const int i = threadIdx.x;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t DD = static_cast<size_t>(D) * D;
  const int n_chunks = (T_steps + kChunk - 1) / kChunk;
  float* ck = out.ckpt + bh * n_chunks * DD;
  float* cb = out.chunk + bh * kChunk * DD;
  float* gs = out.gsave + bh * DD;
  const float ui = u[h * D + i];

  // sweep 1: the state at the start of every chunk, row i stored (j, i)
  {
    float S[D];
#pragma unroll
    for (int j = 0; j < D; ++j) S[j] = s0 ? s0[bh * DD + static_cast<size_t>(i) * D + j] : 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int t0 = c * kChunk, n = min(kChunk, T_steps - t0);
#pragma unroll
      for (int j = 0; j < D; ++j) ck[c * DD + static_cast<size_t>(j) * D + i] = S[j];
      stage<T, D>(sm, in, st, t0, n);
      for (int tt = 0; tt < n; ++tt) {
        const float ki = sm.k[tt][i], wi = sm.w[tt][i];
#pragma unroll
        for (int j = 0; j < D; ++j) S[j] = fmaf(wi, S[j], ki * sm.v[tt][j]);
      }
    }
  }

  // G of the final state, row i stored (j, i)
#pragma unroll
  for (int j = 0; j < D; ++j)
    gs[static_cast<size_t>(j) * D + i] = dsT ? dsT[bh * DD + static_cast<size_t>(i) * D + j] : 0.f;

  float du = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n = min(kChunk, T_steps - t0);
    stage<T, D>(sm, in, st, t0, n);
    if (i < n) {  // v_t . dy_t of each step of the chunk (kChunk <= D)
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) a = fmaf(sm.v[i][j], sm.dy[i][j], a);
      sm.vdy[i] = a;
    }
    // the chunk's states P_t, recomputed from its checkpoint
    {
      float S[D];
#pragma unroll
      for (int j = 0; j < D; ++j) S[j] = ck[c * DD + static_cast<size_t>(j) * D + i];
      for (int tt = 0; tt < n; ++tt) {
#pragma unroll
        for (int j = 0; j < D; ++j) cb[tt * DD + static_cast<size_t>(j) * D + i] = S[j];
        const float ki = sm.k[tt][i], wi = sm.w[tt][i];
#pragma unroll
        for (int j = 0; j < D; ++j) S[j] = fmaf(wi, S[j], ki * sm.v[tt][j]);
      }
    }
    __syncthreads();  // vdy is written
    // the chunk backwards, G_t in registers
    float G[D];
#pragma unroll
    for (int j = 0; j < D; ++j) G[j] = gs[static_cast<size_t>(j) * D + i];
    for (int tt = n - 1; tt >= 0; --tt) {
      const int t = t0 + tt;
      const float ri = sm.r[tt][i], ki = sm.k[tt][i], wi = sm.w[tt][i];
      const float vdy = sm.vdy[tt];
      float dr = 0.f, dk = 0.f, dw = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float p = cb[tt * DD + static_cast<size_t>(j) * D + i];
        const float dyj = sm.dy[tt][j];
        dr = fmaf(p, dyj, dr);
        dw = fmaf(G[j], p, dw);
        dk = fmaf(G[j], sm.v[tt][j], dk);
        G[j] = fmaf(wi, G[j], ri * dyj);
      }
      const size_t at = ((static_cast<size_t>(b) * T_steps + t) * H + h) * D + i;  // (B, T, H, D)
      static_cast<T*>(out.dr)[at] = from_f<T>(fmaf(ui * ki, vdy, dr));
      static_cast<T*>(out.dk)[at] = from_f<T>(fmaf(ri * ui, vdy, dk));
      static_cast<T*>(out.dw)[at] = from_f<T>(dw);
      du = fmaf(ri * ki, vdy, du);
    }
#pragma unroll
    for (int j = 0; j < D; ++j) gs[static_cast<size_t>(j) * D + i] = G[j];
  }
  out.du[bh * D + i] = du;
}

template <typename T, int D>
__device__ void columns(Stage<D>& sm, const In<T>& in, const float* __restrict__ u,
                        const float* dsT, const Out& out, int b, int h, int H, int T_steps,
                        const Strides& st) {
  __shared__ float su[D];
  const int j = threadIdx.x;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t DD = static_cast<size_t>(D) * D;
  float G[D];  // column j of G
#pragma unroll
  for (int i = 0; i < D; ++i) G[i] = dsT ? dsT[bh * DD + static_cast<size_t>(i) * D + j] : 0.f;
  su[j] = u[h * D + j];
  const int n_chunks = (T_steps + kChunk - 1) / kChunk;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n = min(kChunk, T_steps - t0);
    stage<T, D>(sm, in, st, t0, n);  // its first barrier also publishes su
    for (int tt = n - 1; tt >= 0; --tt) {
      const float dyj = sm.dy[tt][j];
      float a = 0.f, acc = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float ki = sm.k[tt][i];
        a = fmaf(sm.r[tt][i] * su[i], ki, a);
        acc = fmaf(G[i], ki, acc);
        G[i] = fmaf(sm.w[tt][i], G[i], sm.r[tt][i] * dyj);
      }
      const size_t at = ((static_cast<size_t>(b) * T_steps + t0 + tt) * H + h) * D + j;
      static_cast<T*>(out.dv)[at] = from_f<T>(fmaf(a, dyj, acc));
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) out.ds0[bh * DD + static_cast<size_t>(i) * D + j] = G[i];
}

template <typename T, int D>
__global__ void __launch_bounds__(D) wkv6_bwd_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const T* __restrict__ dy, const float* __restrict__ u,
    const float* __restrict__ s0, const float* __restrict__ dsT, Out out, int H, int T_steps,
    Strides st) {
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  __shared__ Stage<D> sm;
  const In<T> in(r, k, v, w, dy, b, h, threadIdx.x, st);
  if (blockIdx.y == 0) {
    rows<T, D>(sm, in, u, s0, dsT, out, b, h, H, T_steps, st);
  } else {
    columns<T, D>(sm, in, u, dsT, out, b, h, H, T_steps, st);
  }
}

template <typename T>
int launch(int D, const void* r, const void* k, const void* v, const void* w, const void* dy,
           const float* u, const float* s0, const float* dsT, const Out& out, int B, int H,
           int T_steps, const Strides& st, cudaStream_t s) {
  const T* R = static_cast<const T*>(r);
  const T* K = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  const T* W = static_cast<const T*>(w);
  const T* DY = static_cast<const T*>(dy);
  const dim3 grid(B * H, 2);
#define REPRO_WKVB_CASE(DD)                                                                  \
  case DD:                                                                                   \
    wkv6_bwd_kernel<T, DD><<<grid, DD, 0, s>>>(R, K, V, W, DY, u, s0, dsT, out, H, T_steps, st); \
    break;
  switch (D) {
    REPRO_WKVB_CASE(16)
    REPRO_WKVB_CASE(32)
    REPRO_WKVB_CASE(64)
    REPRO_WKVB_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_WKVB_CASE
  return 0;
}

}  // namespace

// dtype of r/k/v/w/dy and of dr/dk/dv/dw: 0 = float32, 1 = bfloat16.  dims
// holds 19 values: B, H, T, D, then the (batch, head, time) element
// strides of r, k, v, w and dy (D with stride 1).  u (H, D), s0 and dsT
// (B, H, D, D) are float32 and contiguous; s0 (zero initial state) and dsT
// (no gradient of the final state) may be null.  dr, dk, dv, dw are
// written (B, T, H, D), contiguous; du (B, H, D) per batch row and ds0
// (B, H, D, D) in float32.  ckpt, chunk and gsave are float32 scratch of
// B H ceil(T / 16) D^2, B H 16 D^2 and B H D^2 elements.  T >= 1,
// D in {16, 32, 64, 128}.
extern "C" int repro_wkv6_bwd(int dtype, const void* r, const void* k, const void* v,
                              const void* w, const void* dy, const void* u, const void* s0,
                              const void* dsT, void* dr, void* dk, void* dv, void* dw, void* du,
                              void* ds0, void* ckpt, void* chunk, void* gsave,
                              const long long* dims, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = static_cast<int>(dims[0]), H = static_cast<int>(dims[1]);
  const int T_steps = static_cast<int>(dims[2]), D = static_cast<int>(dims[3]);
  Strides st;
  for (int a = 0; a < 3; ++a) {
    st.r[a] = dims[4 + a];
    st.k[a] = dims[7 + a];
    st.v[a] = dims[10 + a];
    st.w[a] = dims[13 + a];
    st.dy[a] = dims[16 + a];
  }
  Out out{dr, dk, dv, dw, static_cast<float*>(du), static_cast<float*>(ds0),
          static_cast<float*>(ckpt), static_cast<float*>(chunk), static_cast<float*>(gsave)};
  const float* U = static_cast<const float*>(u);
  const float* S0 = static_cast<const float*>(s0);
  const float* ST = static_cast<const float*>(dsT);
  int err;
  switch (dtype) {
    case 0: err = launch<float>(D, r, k, v, w, dy, U, S0, ST, out, B, H, T_steps, st, s); break;
    case 1:
      err = launch<__nv_bfloat16>(D, r, k, v, w, dy, U, S0, ST, out, B, H, T_steps, st, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
