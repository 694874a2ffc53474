// Hash dropout for Hopper (sm_90a), f32, bf16 and f16: F.dropout's mask and
// scale in one pass, forward and backward.
//
// It replaces no Pallas kernel: it is the counterpart of the JAX
// `_hash_keep` + `dropout` (paddle_tpu/nn/functional/common.py:42, :55),
// which XLA fuses on the TPU. On this card the same function in eager
// PyTorch is a chain of ~35 int64 launches over the whole tensor. For a
// contiguous x of n elements and the call's 31-bit salt, with c() a cast to
// x's dtype (round to nearest even) and counter_hash.cuh's bits:
//   keep_i = bits(i) >= min(int(p * 2^32), 2^32 - 1)
//   out_i  = keep_i ? c(f32(x_i) / f32(c(1 - p))) : 0   (upscale_in_train)
//   out_i  = keep_i ? x_i : 0                            (downscale_in_infer)
// i is the flat index mod 2^32, from a 64-bit counter. The divide is
// IEEE-rounded (no fast math), so out is a pure function of (x, salt, p),
// bit-equal to the plain version in ops/dropout.py. The backward is the
// same function of the gradient: the mask is recomputed from (salt, p, n),
// nothing is saved. A second entry writes the keep mask alone (bool, for
// F.dropout's `axis` form, whose mask is broadcast over x).
//
// Bound: bytes. An element reads 2 B and writes 2 B in bf16 for ~12 integer
// operations and one divide. Design: a grid-stride loop over 16-byte
// vectors (4 f32 or 8 bf16 / f16 a lane), two vectors a lane in flight,
// over a grid of the blocks resident on the card at once; salt * kCol and
// the threshold are worked out on the host. Elements past the last whole
// vector, and every element where x or out is not 16-byte aligned, take a
// scalar loop of the same arithmetic.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "counter_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;       // vectors a lane has in flight

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

struct Rule {
  uint32_t salt_col;   // salt * kCol mod 2^32
  uint32_t thresh;     // keep iff bits >= thresh
  float div;           // f32(c(1 - p)): a kept element is divided by it
};

template <typename T, bool UP>
__device__ __forceinline__ T drop1(T v, uint64_t i, const Rule& r) {
  const bool keep = counter_hash::element_bits(static_cast<uint32_t>(i),
                                               r.salt_col) >= r.thresh;
  if (!keep) return from_f32<T>(0.f);
  if constexpr (UP) return from_f32<T>(__fdiv_rn(to_f32(v), r.div));
  return v;
}

template <typename T, bool UP>
__global__ void __launch_bounds__(kThreads) hash_dropout_kernel(
    const T* __restrict__ x, T* __restrict__ out, uint64_t n, int vec,
    Rule r) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  const uint64_t tid = static_cast<uint64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  uint64_t done = 0;
  if (vec) {
    const uint64_t nvec = n / V;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (uint64_t j0 = tid; j0 < nvec; j0 += kUnroll * stride) {
      uint4 u[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const uint64_t j = j0 + k * stride;
        if (j < nvec) u[k] = xv[j];
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const uint64_t j = j0 + k * stride;
        if (j >= nvec) continue;
        const T* e = reinterpret_cast<const T*>(&u[k]);
        uint4 o;
        T* f = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int q = 0; q < V; ++q) f[q] = drop1<T, UP>(e[q], j * V + q, r);
        ov[j] = o;
      }
    }
    done = nvec * V;
  }
  for (uint64_t i = done + tid; i < n; i += stride)
    out[i] = drop1<T, UP>(x[i], i, r);
}

// The keep mask alone, one byte an element.
__global__ void __launch_bounds__(kThreads) hash_keep_kernel(
    uint8_t* __restrict__ keep, uint64_t n, Rule r) {
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       i < n; i += stride)
    keep[i] = counter_hash::element_bits(static_cast<uint32_t>(i),
                                         r.salt_col) >= r.thresh;
}

// Blocks of `kernel` resident on `device` at once (cached per device).
template <typename K>
cudaError_t resident(K kernel, int device, int (&cache)[8], int* blocks) {
  if (device >= 0 && device < 8 && cache[device]) {
    *blocks = cache[device];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  if (device >= 0 && device < 8) cache[device] = *blocks;
  return cudaSuccess;
}

// The grid: the resident blocks, or fewer where `work` items (one a
// thread) need fewer.
int grid_for(int blocks, uint64_t work) {
  const uint64_t need = (work + kThreads - 1) / kThreads;
  return need < static_cast<uint64_t>(blocks) ? static_cast<int>(need)
                                              : blocks;
}

template <typename T, bool UP>
cudaError_t launch(const void* x, void* out, uint64_t n, const Rule& r,
                   int device, cudaStream_t st) {
  static int cache[8];
  auto kernel = hash_dropout_kernel<T, UP>;
  int blocks = 0;
  cudaError_t err = resident(kernel, device, cache, &blocks);
  if (err != cudaSuccess) return err;
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const uint64_t work = vec ? (n / V + kUnroll - 1) / kUnroll + n % V : n;
  kernel<<<grid_for(blocks, work), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, vec, r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_mode(const void* x, void* out, uint64_t n, int upscale,
                    const Rule& r, int device, cudaStream_t st) {
  return upscale ? launch<T, true>(x, out, n, r, device, st)
                 : launch<T, false>(x, out, n, r, device, st);
}

Rule make_rule(double p, float div, unsigned int salt) {
  return Rule{salt * counter_hash::kCol, counter_hash::rate_thresh(p), div};
}

}  // namespace

// out = the dropout of x (n contiguous elements of dtype 0 = float32, 1 =
// bfloat16, 2 = float16) at rate p under `salt`; upscale 1 divides a kept
// element by `div` = f32(c(1 - p)), 0 keeps it as it is. The backward is
// the same call on the gradient. Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int hash_dropout(const void* x, void* out, long long n, double p,
                            float div, unsigned int salt, int upscale,
                            int dtype, int device, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Rule r = make_rule(p, div, salt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t m = static_cast<uint64_t>(n);
  if (dtype == 0) return by_mode<float>(x, out, m, upscale, r, device, st);
  if (dtype == 1)
    return by_mode<__nv_bfloat16>(x, out, m, upscale, r, device, st);
  if (dtype == 2) return by_mode<__half>(x, out, m, upscale, r, device, st);
  return cudaErrorInvalidValue;
}

// keep [n] (one byte an element, 1 = kept): F.dropout's keep mask of n
// elements at rate p under `salt`. Returns the cudaError_t of the launch.
extern "C" int hash_dropout_mask(void* keep, long long n, double p,
                                 unsigned int salt, int device,
                                 void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  static int cache[8];
  int blocks = 0;
  err = resident(hash_keep_kernel, device, cache, &blocks);
  if (err != cudaSuccess) return err;
  hash_keep_kernel<<<grid_for(blocks, static_cast<uint64_t>(n)), kThreads,
                     0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(keep), static_cast<uint64_t>(n),
      make_rule(p, 1.f, salt));
  return cudaGetLastError();
}

extern "C" const char* hash_dropout_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
