// Streaming softmax cross-entropy, forward and backward, for Hopper
// (sm_90a); logits f32 or bf16, labels int32.
//
// Replaces the TPU kernels of paddle_tpu/ops/fused_ops.py:
//   _xent_fwd_kernel -> xent_fwd_kernel: per row of logits x [N, V],
//       lse = m + log(max(s, 1e-30)) from a running max m and a running
//       sum s = sum exp(x - m), and loss = lse - x[label], both f32;
//   _xent_bwd_kernel -> xent_bwd_kernel:
//       dx = (exp(x - lse) - onehot(label)) * g, in the logits' dtype.
// A label outside [0, V) picks nothing (its picked logit is 0), as the
// TPU kernel's iota compare does.
//
// Bound: bytes. The forward reads N*V logits once (1.65 GB in f32 at the
// training shape N 8192, V 50304) for ~4 flops an element; the backward
// reads them once more and writes dx once. Design: the forward gives each
// row one block of 256 threads that walks the row with consecutive threads
// on consecutive addresses, each thread keeping its own running (m, s) and
// updating it with one exp per element; the 256 pairs are merged by warp
// butterflies and then across the 8 warps through shared memory. The
// backward is elementwise: a 2-D grid (row, vocab chunk), each thread four
// consecutive columns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;            // backward: columns per thread
constexpr float kNeg = -1e30f;
constexpr float kDenomEps = 1e-30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// merge running (m, s) pairs: s = s1*exp(m1 - m) + s2*exp(m2 - m)
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) xent_fwd_kernel(
    const T* __restrict__ x, const int* __restrict__ labels,
    float* __restrict__ loss, float* __restrict__ lse, int V) {
  __shared__ float red_m[kThreads / 32], red_s[kThreads / 32];
  __shared__ float picked;
  const size_t row = blockIdx.x;
  const T* xr = x + row * V;
  const int lab = labels[row];
  float m = kNeg, s = 0.f;
  for (int c = threadIdx.x; c < V; c += kThreads) {
    const float v = to_f32(xr[c]);
    if (v > m) {
      s = s * expf(m - v) + 1.f;
      m = v;
    } else {
      s += expf(v - m);
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  if (threadIdx.x == 0)
    picked = (lab >= 0 && lab < V) ? to_f32(xr[lab]) : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    float mm = red_m[0], ss = red_s[0];
    for (int w = 1; w < kThreads / 32; ++w) merge(mm, ss, red_m[w], red_s[w]);
    const float l = mm + logf(fmaxf(ss, kDenomEps));
    lse[row] = l;
    loss[row] = l - picked;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) xent_bwd_kernel(
    const T* __restrict__ x, const int* __restrict__ labels,
    const float* __restrict__ lse, const float* __restrict__ g,
    T* __restrict__ dx, int V) {
  const size_t row = blockIdx.x;
  const int c0 = (blockIdx.y * kThreads + threadIdx.x) * kPerThread;
  const int lab = labels[row];
  const float l = lse[row], gr = g[row];
  const T* xr = x + row * V;
  T* dr = dx + row * V;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = c0 + i;
    if (c < V) {
      const float p = expf(to_f32(xr[c]) - l);
      store(dr + c, (p - (c == lab ? 1.f : 0.f)) * gr);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (logits and dx). labels int32 [N];
// loss, lse and g f32 [N]. Each returns the cudaError_t of its launch.
extern "C" int xent_forward(const void* x, const int* labels, float* loss,
                            float* lse, int N, int V, int dtype, int device,
                            void* stream) {
  if (N < 1 || V < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    xent_fwd_kernel<float><<<N, kThreads, 0, st>>>(
        static_cast<const float*>(x), labels, loss, lse, V);
  else if (dtype == 1)
    xent_fwd_kernel<__nv_bfloat16><<<N, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), labels, loss, lse, V);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" int xent_backward(const void* x, const int* labels,
                             const float* lse, const float* g, void* dx,
                             int N, int V, int dtype, int device,
                             void* stream) {
  if (N < 1 || V < 1 || V > 65535 * kThreads * kPerThread)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N, (V + kThreads * kPerThread - 1) /
                         (kThreads * kPerThread));
  if (dtype == 0)
    xent_bwd_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), labels, lse, g, static_cast<float*>(dx),
        V);
  else if (dtype == 1)
    xent_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), labels, lse, g,
        static_cast<__nv_bfloat16*>(dx), V);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" const char* xent_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
