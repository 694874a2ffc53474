// Dropout + residual + LayerNorm forward for Hopper (sm_90a), f32 and bf16.
//
// Replaces the TPU kernel `_dropout_res_ln_kernel` of
// paddle_tpu/ops/fused_ops.py: per row of x, r [n, h], in f32,
//   h   = where(bits <= thresh, x / (1 - p), 0) + r   (h = x + r at p = 0)
//   mu  = mean(h), var = mean((h - mu)^2)
//   out = (h - mu) * rsqrt(var + eps) * w + b
// and both out and h are written in x's dtype. thresh is int((1 - p) *
// (2^32 - 1)), the TPU kernel's keep rule. The TPU kernel draws its 32
// bits from the chip's hardware generator, which nothing else reproduces;
// this kernel takes them one of two ways:
//   * from the caller, a uint32 [n, h] tensor (the JAX op's interpret-mode
//     host bits), or
//   * computed here from the port's counter hash, the bits of
//     nn/functional.py `_hash_keep`: lowbias32((i * 0x9E3779B1) ^ (salt *
//     0x85EBCA77)) mod 2^32, with i = row * h + col the element's flat
//     index (mod 2^32) and salt = seed mod 2^31. The index is global, so
//     the mask does not depend on which block takes which row.
//
// Bound: bytes. An element reads x and r and writes out and h: 8 B at bf16
// (12 B with host bits) for ~15 flops. Design: the LayerNorm kernel's (one
// block of 256 threads per row, h / 256 values a thread held in registers,
// h <= 8192): the sum h is formed once in registers, the mean and the
// two-pass variance are block reductions over it, and each output is
// written once.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPer = 32;              // h <= kThreads * kMaxPer = 8192
constexpr uint32_t kRow = 0x9E3779B1u;
constexpr uint32_t kCol = 0x85EBCA77u;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// lowbias32, the finalizer of the JAX package's `_hash32`
__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
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

struct Drop {
  float keep_div;      // f32(1 - p): a kept x is divided by it
  uint32_t thresh;     // keep iff bits <= thresh
  uint32_t salt_col;   // salt * 0x85EBCA77 mod 2^32 (hash bits)
  int on;              // 0: no dropout (p = 0 or not training)
};

// BITS: the caller's uint32 bits are read; otherwise the hash is computed.
template <typename T, typename W, int PER, bool BITS>
__global__ void __launch_bounds__(kThreads) dropout_res_ln_kernel(
    const T* __restrict__ x, const T* __restrict__ r,
    const W* __restrict__ w, const W* __restrict__ b,
    const uint32_t* __restrict__ bits, T* __restrict__ out,
    T* __restrict__ hout, int h, float eps, Drop d) {
  __shared__ float red[kThreads / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * h;
  float v[PER];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * kThreads;
    float hv = 0.f;
    if (c < h) {
      float xv = to_f32(x[base + c]);
      if (d.on) {
        const uint32_t bv =
            BITS ? bits[base + c]
                 : hash32(static_cast<uint32_t>(base + c) * kRow ^
                          d.salt_col);
        xv = bv <= d.thresh ? __fdiv_rn(xv, d.keep_div) : 0.f;
      }
      hv = __fadd_rn(xv, to_f32(r[base + c]));
      store(hout + base + c, hv);
    }
    v[i] = hv;
    s += hv;
  }
  const float mu = block_sum(s, red) / h;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const float dlt = c < h ? v[i] - mu : 0.f;
    sq = fmaf(dlt, dlt, sq);
  }
  const float inv = 1.f / sqrtf(block_sum(sq, red) / h + eps);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < h)
      store(out + base + c,
            (v[i] - mu) * inv * to_f32(w[c]) + to_f32(b[c]));
  }
}

template <typename T, typename W, bool BITS>
cudaError_t dispatch(const void* x, const void* r, const void* w,
                     const void* b, const uint32_t* bits, void* out,
                     void* hout, int n, int h, float eps, const Drop& d,
                     cudaStream_t st) {
  const int per = (h + kThreads - 1) / kThreads;
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(r);
  const W* wp = static_cast<const W*>(w);
  const W* bp = static_cast<const W*>(b);
  T* op = static_cast<T*>(out);
  T* hp = static_cast<T*>(hout);
#define DRLN_CASE(P)                                                       \
  if (per <= P) {                                                          \
    dropout_res_ln_kernel<T, W, P, BITS><<<n, kThreads, 0, st>>>(          \
        xp, rp, wp, bp, bits, op, hp, h, eps, d);                          \
    return cudaGetLastError();                                             \
  }
  DRLN_CASE(1)
  DRLN_CASE(2)
  DRLN_CASE(4)
  DRLN_CASE(8)
  DRLN_CASE(16)
  DRLN_CASE(kMaxPer)
#undef DRLN_CASE
  return cudaErrorInvalidValue;
}

template <typename T, typename W>
cudaError_t by_bits(const void* x, const void* r, const void* w,
                    const void* b, const void* bits, void* out, void* hout,
                    int n, int h, float eps, const Drop& d, cudaStream_t st) {
  const uint32_t* bp = static_cast<const uint32_t*>(bits);
  if (bp)
    return dispatch<T, W, true>(x, r, w, b, bp, out, hout, n, h, eps, d, st);
  return dispatch<T, W, false>(x, r, w, b, bp, out, hout, n, h, eps, d, st);
}

}  // namespace

// dtype: x, r, out and h (0 = float32, 1 = bfloat16); wdtype: w and b.
// bits: null for the hash bits. dropout 0 skips the mask. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int dropout_res_ln_forward(
    const void* x, const void* r, const void* w, const void* b,
    const void* bits, void* out, void* hout, int n, int h, float eps,
    int dropout, float keep_div, unsigned int thresh, unsigned int salt,
    int dtype, int wdtype, int device, void* stream) {
  if (n < 1 || h < 1 || h > kThreads * kMaxPer)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Drop d{keep_div, thresh, salt * kCol, dropout};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && wdtype == 0)
    return by_bits<float, float>(x, r, w, b, bits, out, hout, n, h, eps, d,
                                 st);
  if (dtype == 0 && wdtype == 1)
    return by_bits<float, __nv_bfloat16>(x, r, w, b, bits, out, hout, n, h,
                                         eps, d, st);
  if (dtype == 1 && wdtype == 0)
    return by_bits<__nv_bfloat16, float>(x, r, w, b, bits, out, hout, n, h,
                                         eps, d, st);
  if (dtype == 1 && wdtype == 1)
    return by_bits<__nv_bfloat16, __nv_bfloat16>(x, r, w, b, bits, out, hout,
                                                 n, h, eps, d, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* dropout_res_ln_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
