// Per-token LoRA delta of multi-LoRA serving, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX decoder computes `_lora_delta`
// (paddle_tpu/serving/decoder.py:284) as a per-token gather of the adapter
// bank and two f32 einsums, which XLA fuses on the TPU. Run eagerly on the
// card, the gather would write and read [T, R, 3*H*D] f32 of B and [T, h, R]
// of A a layer (~0.5 GB at a 1024-token prefill chunk, rank 16, gpt_1p3b),
// for a product whose real inputs are a few MB. This kernel reads the bank
// IN PLACE by adapter id:
//
//   qkv[t, :] = cast(qkv[t, :] + cast((y[t] . A[a_t]) . B[a_t], T))
//
// updated in place, with y [T, h] the post-ln1 activations and qkv [T, N]
// (N = 3*H*D) the qkv product in the compute dtype (f32 or bf16), A
// [n_a, h, R] and B [n_a, R, N] one layer's f32 bank (alpha/r folded into
// B, id 0 the exact zero bank), aids [T] int32. The rounding points are
// the JAX decoder's: the f32 delta is cast to the compute dtype, then added
// (for bf16: bf16(f32(q) + f32(bf16(d)))).
//
// Design (simple, row-local):
//   shrink: a grid over (token, h slice): `split` blocks a token, each over
//     ceil(h / split) of the h rows, so a decode tick's few tokens still
//     fill the card; thread (g, r) sums y[k] * A[a, k, r] over its slice's
//     k = g, g + G, ... (G = 256 / R groups, consecutive threads on
//     consecutive r, so the A row reads coalesce), the G partials are added
//     in group order by thread r into z[t, slice, :R], a small f32 scratch.
//   expand + add: a grid over (token, 256-column tile); the token's slices
//     are summed in slice order into z[t, :R], then thread n sums z[r] *
//     B[a, r, n] over r in order (B rows coalesce over n) and adds the
//     rounded delta to its qkv element.
// Every sum's order depends only on (h, R), never on T, on the token's place
// in the call or on the other tokens' adapters: a token's bits are the same
// alone and inside a 1024-token call. Rows with id 0 (and ids outside the
// bank, which the decoder refuses before it launches) are left untouched, so
// a bank-attached engine serving only id 0 writes the no-bank engine's bytes.
//
// Bound: bytes. y, each distinct adapter's A and B once, qkv read and
// written: at decode (T 16, 4 adapters, R 16, gpt_1p3b) ~2.5 MB, ~0.75 us
// at 3.35 TB/s; the operations (2 T R (h + N)) are negligible. This first
// design re-reads an adapter's A and B once per token (from L2 once they
// are resident), so it sits well above that bound at long chunks; PERF.md
// has its times.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // threads of either launch; also the max R
constexpr int kCols = 256;      // qkv columns of one expand block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lora_shrink_kernel(const T* __restrict__ y, const float* __restrict__ A,
                       const int* __restrict__ aids, float* __restrict__ z,
                       int h, int R, int n_adapters) {
  __shared__ float part[kThreads];
  const int t = blockIdx.x;
  const int a = aids[t];
  if (a <= 0 || a >= n_adapters) return;          // uniform over the block
  const int span = (h + gridDim.y - 1) / gridDim.y;
  const int lo = blockIdx.y * span;
  const int hi = min(h, lo + span);
  const int groups = kThreads / R;
  const int g = threadIdx.x / R;
  const int r = threadIdx.x % R;
  if (g < groups) {
    const T* yt = y + static_cast<int64_t>(t) * h;
    const float* Aa = A + static_cast<int64_t>(a) * h * R + r;
    float acc = 0.f;
#pragma unroll 4
    for (int k = lo + g; k < hi; k += groups)
      acc = fmaf(to_f32(yt[k]), Aa[static_cast<int64_t>(k) * R], acc);
    part[g * R + r] = acc;
  }
  __syncthreads();
  if (threadIdx.x < R) {
    float s = 0.f;
    for (int i = 0; i < groups; ++i) s += part[i * R + threadIdx.x];
    z[(static_cast<int64_t>(t) * gridDim.y + blockIdx.y) * R + threadIdx.x] =
        s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lora_expand_add_kernel(T* __restrict__ qkv, const float* __restrict__ B,
                           const int* __restrict__ aids,
                           const float* __restrict__ z, int R, int N,
                           int n_adapters, int split) {
  __shared__ float zs[kThreads];
  const int t = blockIdx.x;
  const int a = aids[t];
  if (a <= 0 || a >= n_adapters) return;          // uniform over the block
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const float* zt = z + static_cast<int64_t>(t) * split * R + r;
    float s = 0.f;
    for (int i = 0; i < split; ++i) s += zt[i * R];
    zs[r] = s;
  }
  __syncthreads();
  const int n = blockIdx.y * kCols + threadIdx.x;
  if (n >= N) return;
  const float* b = B + static_cast<int64_t>(a) * R * N + n;
  float d = 0.f;
  for (int r = 0; r < R; ++r)
    d = fmaf(zs[r], b[static_cast<int64_t>(r) * N], d);
  T* q = qkv + static_cast<int64_t>(t) * N + n;
  *q = from_f32<T>(to_f32(*q) + to_f32(from_f32<T>(d)));
}

template <typename T>
cudaError_t launch(void* qkv, const void* y, const float* A, const float* B,
                   const int* aids, float* z, int T_, int h, int R, int N,
                   int n_adapters, int split, cudaStream_t stream) {
  lora_shrink_kernel<T><<<dim3(T_, split), kThreads, 0, stream>>>(
      static_cast<const T*>(y), A, aids, z, h, R, n_adapters);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid(T_, (N + kCols - 1) / kCols);
  lora_expand_add_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(qkv), B, aids, z, R, N, n_adapters, split);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (qkv and y); z holds T * split * R floats
// (split: the shrink's h slices a token). Returns a cudaError_t.
extern "C" int lora_delta_forward(void* qkv, const void* y, const float* A,
                                  const float* B, const int* aids, float* z,
                                  int T, int h, int R, int N, int n_adapters,
                                  int split, int dtype, int device,
                                  void* stream) {
  if (T < 1 || h < 1 || R < 1 || R > kThreads || N < 1 || n_adapters < 1 ||
      split < 1 || split > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(qkv, y, A, B, aids, z, T, h, R, N, n_adapters,
                         split, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(qkv, y, A, B, aids, z, T, h, R, N,
                                 n_adapters, split, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* lora_delta_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
