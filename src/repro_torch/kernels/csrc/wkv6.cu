// RWKV6 (Finch) WKV recurrence with data-dependent per-channel decay.
//
//   y_t = r_t · (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// Replaces the TPU kernel `wkv6_pallas` (src/repro/kernels/wkv6.py, body
// `_kernel`) for short calls: kernels/wkv6.py `wkv6_form` sends a call of
// fewer than CHUNKED_MIN_T (128) steps here, the decode step (T = 1)
// among them, and a longer one to the chunked form of wkv6_chunked.cu,
// whose three launches cost more than this walk at small T.  The TPU
// kernel keeps the (D, D) state in VMEM scratch across a
// sequential time-block grid.  Hopper blocks run in no order, so here one
// thread block owns one (batch, head) and loops over all T steps itself;
// thread j keeps column j of the f32 state in registers for the whole
// call.  The state is stored (i, j) row-major, so the D threads of a block
// load and store one row of it per instruction, coalesced.  Per step the
// block stages r_t, k_t and w_t (and u once) in shared memory; each thread
// forms y_j = sum_i r_i (S_ij + u_i k_i v_j) from the old state, then
// updates S_ij <- w_i S_ij + k_i v_j, the order of the TPU body and of
// ref.wkv6_reference.  Any T >= 1 works; there is no time blocking.
//
// What bounds it on an H100: bytes, and at the decode shape (T = 1)
// latency.  The state is read and written once (2 * B*H*D*D*4 bytes,
// 8.4 MB for RWKV6-7B's 4 x 64 heads of 64), r/k/v/w read once and y
// written once; the arithmetic is about 7 D^2 operations per head and step.
// One block per head keeps the state traffic at that minimum.  At decode
// the device time is a few microseconds, so what is left to cut is the
// work around the launch; the contract is shaped for that:
//   * the final state may be written over the initial one (s0 == sout):
//     each thread reads only its own column of s0 before the loop and
//     writes only that column after it, so the engine's state buffer is
//     updated in place and no copy follows the kernel;
//   * r/k/v/w are (B, H, T, D) views with any strides on B, H and T (the
//     model's heads are a transpose of (B, T, H*D), never copied), D with
//     stride 1, so a block's D values at step t are contiguous either way;
//   * y is written (B, T, H, D), the layout the model merges heads from
//     without a copy;
//   * the shape and the strides come in one host array, so the call
//     passes few arguments.
//
// C interface: one function, loaded with ctypes.  It launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element strides (batch, head, time) of r, k, v and w; D has stride 1.
struct Strides {
  long long r[3], k[3], v[3], w[3];
};

// s0 and sout may be the same buffer (no __restrict__ on either): a
// thread touches only column j of both, reading it all before writing.
template <typename T, int D>
__global__ void __launch_bounds__(D) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const float* __restrict__ u, const float* s0,
    T* __restrict__ y, float* sout, int H, int T_steps, Strides st) {
  __shared__ float sr[D], sk[D], sw[D], su[D];
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh % H;
  const int j = threadIdx.x;
  const size_t sbase = static_cast<size_t>(bh) * D * D;

  float S[D];
#pragma unroll
  for (int i = 0; i < D; ++i) S[i] = s0 ? s0[sbase + static_cast<size_t>(i) * D + j] : 0.f;
  su[j] = u[h * D + j];

  const T* rp = r + b * st.r[0] + h * st.r[1] + j;
  const T* kp = k + b * st.k[0] + h * st.k[1] + j;
  const T* vp = v + b * st.v[0] + h * st.v[1] + j;
  const T* wp = w + b * st.w[0] + h * st.w[1] + j;
  // y is (B, T, H, D): step t of this head sits at ((b*T + t)*H + h)*D
  T* yp = y + (static_cast<size_t>(b) * T_steps * H + h) * D + j;
  const size_t y_step = static_cast<size_t>(H) * D;
  for (int t = 0; t < T_steps; ++t) {
    __syncthreads();  // the previous step has finished reading sr/sk/sw
    sr[j] = to_f(rp[t * st.r[2]]);
    sk[j] = to_f(kp[t * st.k[2]]);
    sw[j] = to_f(wp[t * st.w[2]]);
    const float vj = to_f(vp[t * st.v[2]]);
    __syncthreads();
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float kv = sk[i] * vj;
      acc += sr[i] * (S[i] + su[i] * kv);
      S[i] = sw[i] * S[i] + kv;
    }
    yp[t * y_step] = from_f<T>(acc);
  }
#pragma unroll
  for (int i = 0; i < D; ++i) sout[sbase + static_cast<size_t>(i) * D + j] = S[i];
}

template <typename T>
int launch(int D, const void* r, const void* k, const void* v, const void* w, const float* u,
           const float* s0, void* y, float* sout, int B, int H, int T_steps,
           const Strides& st, cudaStream_t s) {
  const T* R = static_cast<const T*>(r);
  const T* K = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  const T* W = static_cast<const T*>(w);
  T* Y = static_cast<T*>(y);
  const dim3 grid(B * H);
  switch (D) {
    case 16: wkv6_kernel<T, 16><<<grid, 16, 0, s>>>(R, K, V, W, u, s0, Y, sout, H, T_steps, st); break;
    case 32: wkv6_kernel<T, 32><<<grid, 32, 0, s>>>(R, K, V, W, u, s0, Y, sout, H, T_steps, st); break;
    case 64: wkv6_kernel<T, 64><<<grid, 64, 0, s>>>(R, K, V, W, u, s0, Y, sout, H, T_steps, st); break;
    case 128: wkv6_kernel<T, 128><<<grid, 128, 0, s>>>(R, K, V, W, u, s0, Y, sout, H, T_steps, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// dtype of r/k/v/w/y: 0 = float32, 1 = bfloat16.  u (H, D) and the states
// (B, H, D, D) are float32 and contiguous; s0 may be null (zero initial
// state) and may equal sout.  dims holds 16 values: B, H, T, D, then the
// (batch, head, time) element strides of r, k, v and w.  y is (B, T, H, D),
// contiguous.  D in {16, 32, 64, 128}.
extern "C" int repro_wkv6(int dtype, const void* r, const void* k, const void* v, const void* w,
                          const void* u, const void* s0, void* y, void* sout,
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
  }
  const float* U = static_cast<const float*>(u);
  const float* S0 = static_cast<const float*>(s0);
  float* SO = static_cast<float*>(sout);
  int err;
  switch (dtype) {
    case 0: err = launch<float>(D, r, k, v, w, U, S0, y, SO, B, H, T_steps, st, s); break;
    case 1: err = launch<__nv_bfloat16>(D, r, k, v, w, U, S0, y, SO, B, H, T_steps, st, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
