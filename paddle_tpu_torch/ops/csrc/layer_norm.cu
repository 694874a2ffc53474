// Row LayerNorm and RMSNorm forwards for Hopper (sm_90a), f32 and bf16.
//
// Replaces the TPU kernel `_ln_kernel` of paddle_tpu/ops/layer_norm.py:
// x [n, h] -> out [n, h] in x's dtype, with f32 statistics and the affine
// in f32 before the one cast:
//   mu = mean(x), var = mean((x - mu)^2), y = (x - mu) * rsqrt(var + eps),
//   out = cast(y * w + b).
// w and b are [h] in their own dtype (f32 or bf16), read as f32.
//
// Bound: bytes. One row of h = 2048 bf16 is 4 KB read and 4 KB written for
// ~8 flops an element, far left of the card's ops:bytes ridge. Design: one
// block of 256 threads per row; the row is read from device memory once
// into registers (h / 256 values a thread, h <= 8192), the two sums are
// block reductions (warp butterflies, then one value a warp through shared
// memory), and the output is written once. The two-pass variance (the JAX
// body's mean((x - mu)^2)) costs no extra read, since the row stays in
// registers.
//
// Replaces, by its sibling `rms_norm_kernel`, the TPU kernel `_rms_kernel`
// of the same file: var = mean(x^2) in f32, out = cast(x * rsqrt(var +
// eps) * w), one cast. The same design and bound (one read, one write, a
// single block reduction); a kernel of its own, so the LayerNorm
// instantiations compile as they did.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPer = 32;              // h <= kThreads * kMaxPer = 8192

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();                       // red is free (earlier sum read)
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  return t;
}

template <typename T, typename W, int PER>
__global__ void __launch_bounds__(kThreads) layer_norm_kernel(
    const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b,
    T* __restrict__ out, int h, float eps) {
  __shared__ float red[kThreads / 32];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * h;
  T* orow = out + static_cast<size_t>(blockIdx.x) * h;
  float v[PER];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * kThreads;
    v[i] = c < h ? to_f32(xr[c]) : 0.f;
    s += v[i];
  }
  const float mu = block_sum(s, red) / h;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const float dlt = c < h ? v[i] - mu : 0.f;
    sq = fmaf(dlt, dlt, sq);
  }
  const float var = block_sum(sq, red) / h;
  const float inv = 1.f / sqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < h)
      store(orow + c, (v[i] - mu) * inv * to_f32(w[c]) + to_f32(b[c]));
  }
}

template <typename T, typename W, int PER>
__global__ void __launch_bounds__(kThreads) rms_norm_kernel(
    const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
    int h, float eps) {
  __shared__ float red[kThreads / 32];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * h;
  T* orow = out + static_cast<size_t>(blockIdx.x) * h;
  float v[PER];
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * kThreads;
    v[i] = c < h ? to_f32(xr[c]) : 0.f;
    sq = fmaf(v[i], v[i], sq);
  }
  const float inv = 1.f / sqrtf(block_sum(sq, red) / h + eps);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < h) store(orow + c, v[i] * inv * to_f32(w[c]));
  }
}

// RMS: rms_norm_kernel (b unused), else layer_norm_kernel; the kernel
// instantiated for the smallest per-thread count that holds the row.
template <bool RMS, typename T, typename W>
cudaError_t dispatch(const void* x, const void* w, const void* b, void* out,
                     int n, int h, float eps, cudaStream_t st) {
  const int per = (h + kThreads - 1) / kThreads;
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const W* bp = static_cast<const W*>(b);
  T* op = static_cast<T*>(out);
#define NORM_CASE(P)                                                      \
  if (per <= P) {                                                         \
    if constexpr (RMS)                                                    \
      rms_norm_kernel<T, W, P><<<n, kThreads, 0, st>>>(xp, wp, op, h,     \
                                                       eps);              \
    else                                                                  \
      layer_norm_kernel<T, W, P><<<n, kThreads, 0, st>>>(xp, wp, bp, op,  \
                                                         h, eps);         \
    return cudaGetLastError();                                            \
  }
  NORM_CASE(1)
  NORM_CASE(2)
  NORM_CASE(4)
  NORM_CASE(8)
  NORM_CASE(16)
  NORM_CASE(kMaxPer)
#undef NORM_CASE
  return cudaErrorInvalidValue;
}

template <bool RMS>
int forward(const void* x, const void* w, const void* b, void* out, int n,
            int h, float eps, int dtype, int wdtype, int device,
            void* stream) {
  if (n < 1 || h < 1 || h > kThreads * kMaxPer)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && wdtype == 0)
    return dispatch<RMS, float, float>(x, w, b, out, n, h, eps, st);
  if (dtype == 0 && wdtype == 1)
    return dispatch<RMS, float, __nv_bfloat16>(x, w, b, out, n, h, eps, st);
  if (dtype == 1 && wdtype == 0)
    return dispatch<RMS, __nv_bfloat16, float>(x, w, b, out, n, h, eps, st);
  if (dtype == 1 && wdtype == 1)
    return dispatch<RMS, __nv_bfloat16, __nv_bfloat16>(x, w, b, out, n, h,
                                                       eps, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype / wdtype: 0 = float32, 1 = bfloat16 (x and out share dtype; w and b
// share wdtype). Returns the cudaError_t of the launch (0 = launched).
extern "C" int layer_norm_forward(const void* x, const void* w,
                                  const void* b, void* out, int n, int h,
                                  float eps, int dtype, int wdtype,
                                  int device, void* stream) {
  return forward<false>(x, w, b, out, n, h, eps, dtype, wdtype, device,
                        stream);
}

// RMSNorm: the same codes and return value, no bias.
extern "C" int rms_norm_forward(const void* x, const void* w, void* out,
                                int n, int h, float eps, int dtype,
                                int wdtype, int device, void* stream) {
  return forward<true>(x, w, nullptr, out, n, h, eps, dtype, wdtype, device,
                       stream);
}

extern "C" const char* layer_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
