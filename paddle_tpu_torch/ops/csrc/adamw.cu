// One AdamW update of a flat tensor, in place, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_adamw_kernel` of paddle_tpu/ops/fused_ops.py.
// Per element, in f32:
//   g  = float(G(float(g) * s))          (only when a clip scale s is given)
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + ((1 - b2) * g) * g
//   p' = p - lr * ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd * p)
// then p', m' and v' are each cast to their own dtype and written over p,
// m and v: the update is in place, so a step allocates nothing (the TPU
// kernel writes new arrays). With an f32 master copy (multi_precision),
// p above is the master: it is read and written in f32, and the
// parameter, which is then bf16, gets its rounded value. The clip scale
// is read from device memory (the global-norm clip's 0-d f32 tensor), so
// the host never waits for the norm; multiplying and rounding the
// gradient to its own dtype here is what the clip's separate pass did.
//
// Types: p, g and the slots (m and v together) each f32 or bf16; the
// master is f32. All hyper-parameters are f32 kernel arguments; 1 - b1 and
// 1 - b2 are formed on the host in double, as the JAX kernel's Python
// constants are. Every product and sum is written with the _rn
// intrinsics, so nvcc contracts nothing into an FMA and the kernel rounds
// where the plain PyTorch version (one op at a time) does.
//
// Bound: bytes. At bf16 p, g, m and v an element reads 8 B and writes 6 B
// (14 B) for ~15 flops, far left of the card's ops:bytes ridge. Design:
// each thread takes 8 consecutive elements at a time in a grid-stride
// loop over any n, with 16-byte loads and stores where every pointer is
// 16-byte aligned (a bf16 tensor's 8 elements are one uint4, an f32
// tensor's two float4s), and element by element at the ragged tail or on
// unaligned tensors.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;
constexpr int kMaxBlocks = 132 * 16;       // 16 blocks on each of 132 SMs

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and read back: the clip's cast of g * s to g's dtype
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[kVec]) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&x)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T>
__device__ __forceinline__ void load_n(const T* p, int64_t i0, int64_t n,
                                       bool vec, float (&x)[kVec]) {
  if (vec) {
    load8(p + i0, x);
    return;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    x[k] = i0 + k < n ? to_f32(p[i0 + k]) : 0.f;
}
template <typename T>
__device__ __forceinline__ void store_n(T* p, int64_t i0, int64_t n,
                                        bool vec, const float (&x)[kVec]) {
  if (vec) {
    store8(p + i0, x);
    return;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    if (i0 + k < n) p[i0 + k] = from_f32<T>(x[k]);
}

// P: parameter, G: gradient, S: both moment slots; MASTER: an f32 master
// copy is the p of the update. ALIGNED: every pointer is 16-byte aligned.
template <typename P, typename G, typename S, bool MASTER, bool ALIGNED>
__global__ void __launch_bounds__(kThreads) adamw_kernel(
    P* __restrict__ p, const G* __restrict__ g, S* __restrict__ m,
    S* __restrict__ v, float* __restrict__ master,
    const float* __restrict__ scale, int64_t n, Hyper hp) {
  const bool clip = scale != nullptr;
  const float s = clip ? *scale : 1.f;
  const int64_t chunks = (n + kVec - 1) / kVec;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       c < chunks; c += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t i0 = c * kVec;
    const bool vec = ALIGNED && i0 + kVec <= n;
    float pv[kVec], gv[kVec], mv[kVec], vv[kVec];
    if (MASTER)
      load_n(master, i0, n, vec, pv);
    else
      load_n(p, i0, n, vec, pv);
    load_n(g, i0, n, vec, gv);
    load_n(m, i0, n, vec, mv);
    load_n(v, i0, n, vec, vv);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float gk = clip ? round_to<G>(__fmul_rn(gv[k], s)) : gv[k];
      const float mk = __fadd_rn(__fmul_rn(hp.b1, mv[k]),
                                 __fmul_rn(hp.omb1, gk));
      const float vk = __fadd_rn(__fmul_rn(hp.b2, vv[k]),
                                 __fmul_rn(__fmul_rn(hp.omb2, gk), gk));
      const float mhat = __fdiv_rn(mk, hp.bc1);
      const float vhat = __fdiv_rn(vk, hp.bc2);
      const float upd = __fadd_rn(
          __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), hp.eps)),
          __fmul_rn(hp.wd, pv[k]));
      pv[k] = __fsub_rn(pv[k], __fmul_rn(hp.lr, upd));
      mv[k] = mk;
      vv[k] = vk;
    }
    if (MASTER) store_n(master, i0, n, vec, pv);
    store_n(p, i0, n, vec, pv);
    store_n(m, i0, n, vec, mv);
    store_n(v, i0, n, vec, vv);
  }
}

template <typename P, typename G, typename S>
cudaError_t launch(void* p, const void* g, void* m, void* v, float* master,
                   const float* scale, int64_t n, const Hyper& hp,
                   bool aligned, cudaStream_t st) {
  const int64_t chunks = (n + kVec - 1) / kVec;
  const int blocks = static_cast<int>(
      chunks / kThreads + 1 < kMaxBlocks ? chunks / kThreads + 1
                                         : kMaxBlocks);
  P* pp = static_cast<P*>(p);
  const G* gp = static_cast<const G*>(g);
  S* mp = static_cast<S*>(m);
  S* vp = static_cast<S*>(v);
#define ADAMW_CASE(MA, AL)                                                 \
  if (static_cast<bool>(master) == MA && aligned == AL) {                  \
    adamw_kernel<P, G, S, MA, AL><<<blocks, kThreads, 0, st>>>(            \
        pp, gp, mp, vp, master, scale, n, hp);                             \
    return cudaGetLastError();                                             \
  }
  ADAMW_CASE(false, false)
  ADAMW_CASE(false, true)
  ADAMW_CASE(true, false)
  ADAMW_CASE(true, true)
#undef ADAMW_CASE
  return cudaErrorInvalidValue;
}

template <typename P, typename G>
cudaError_t by_slot(int sdtype, void* p, const void* g, void* m, void* v,
                    float* master, const float* scale, int64_t n,
                    const Hyper& hp, bool aligned, cudaStream_t st) {
  if (sdtype == 0)
    return launch<P, G, float>(p, g, m, v, master, scale, n, hp, aligned, st);
  if (sdtype == 1)
    return launch<P, G, __nv_bfloat16>(p, g, m, v, master, scale, n, hp,
                                       aligned, st);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (pdtype: p; gdtype: g; sdtype: m
// and v). master (f32) and scale (one f32) may be null. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int adamw_update(void* p, const void* g, void* m, void* v,
                            void* master, const void* scale, long long n,
                            float lr, float b1, float omb1, float b2,
                            float omb2, float eps, float wd, float bc1,
                            float bc2, int pdtype, int gdtype, int sdtype,
                            int device, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Hyper hp{lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2};
  const bool aligned = aligned16(p) && aligned16(g) && aligned16(m) &&
                       aligned16(v) && aligned16(master);
  float* mp = static_cast<float*>(master);
  const float* sp = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pdtype == 0 && gdtype == 0)
    return by_slot<float, float>(sdtype, p, g, m, v, mp, sp, n, hp, aligned,
                                 st);
  if (pdtype == 0 && gdtype == 1)
    return by_slot<float, __nv_bfloat16>(sdtype, p, g, m, v, mp, sp, n, hp,
                                         aligned, st);
  if (pdtype == 1 && gdtype == 0)
    return by_slot<__nv_bfloat16, float>(sdtype, p, g, m, v, mp, sp, n, hp,
                                         aligned, st);
  if (pdtype == 1 && gdtype == 1)
    return by_slot<__nv_bfloat16, __nv_bfloat16>(sdtype, p, g, m, v, mp, sp,
                                                 n, hp, aligned, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
