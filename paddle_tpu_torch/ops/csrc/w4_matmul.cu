// Weight-only int4 matmul (W4A16) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_w4_kernel` of paddle_tpu/ops/w4_matmul.py
// (launched there by `w4_matmul`): out[S, N] = x[S, K] @ W[K, N], with x and
// out in f32 or bf16 and W stored as int4 nibbles with one f32 scale per
// output column. packed[K2, N] (K2 = ceil(K/2), bytes) holds rows 2i and
// 2i+1 of the integer weight in the low and the high nibble of byte row i,
// each with a +8 offset (1..15; an odd K's pad nibble is 8, i.e. 0), and
// W[k, n] = (nibble - 8) * scale[n]. The dot accumulates in f32.
//
// Design: S x N output tiles of BM x BN per block, 256 threads, each thread
// TM x TN outputs (rows ty + i*BM/TM, columns tx + j*BN/TN: neighbouring
// threads read neighbouring shared-memory words and write neighbouring
// output columns). K is walked in stages of BK through shared memory: x's
// tile is read once as f32, the weight's BK/2 packed rows are read as
// bytes and unpacked there into the exact integers -7..7 as f32, so the
// dequantized weight never exists in device memory. The products are f32
// FMAs on the CUDA cores; the per-column scale is constant along K, so it
// multiplies the finished sum once, in the epilogue. Every shape is taken
// (odd K, any S and N): edge tiles are bounds-checked and read zeros, and
// nothing is padded in device memory.
//
// Each output is one f32 FMA chain over k = 0..K-1 in order, then the
// scale: the same instruction sequence whatever S, the tile shape or the
// row's place in the batch, so a row's output does not depend on what else
// is in x (the serving path's schedule independence holds through it).
//
// Bound: at decode (S = 16) bytes: every weight byte is read once per call
// (K*N/2 + 4N bytes) for 2*S*K*N flops. At prefill (S in the thousands) the
// flops: this first design runs them in f32 FMA, well under the bf16 tensor
// cores' rate. A later design can feed the same integers -7..7, which bf16
// holds exactly, to mma/wgmma with bf16 x tiles and keep the f32 accumulator
// and the epilogue scale; the single-pass, no-split-K order above is what a
// faster kernel has to keep to stay schedule independent.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(kThreads) w4_matmul_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale, T* __restrict__ out, int S, int K,
    int N) {
  constexpr int TY = BM / TM;             // threads along S
  constexpr int TX = BN / TN;             // threads along N
  static_assert(TY * TX == kThreads, "one output block per 256 threads");
  static_assert(BK % 2 == 0, "a stage holds whole packed rows");
  __shared__ float xs[BK][BM + 1];        // x tile, k-major; +1: the k-fast
                                          // stores hit distinct banks
  __shared__ float ws[BK][BN];            // unpacked integer weights
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ty = threadIdx.x / TX;
  const int tx = threadIdx.x % TX;
  const int K2 = (K + 1) / 2;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += kThreads) {
      const int m = e / BK, kk = e % BK;
      const int gm = m0 + m, gk = k0 + kk;
      xs[kk][m] = (gm < S && gk < K)
                      ? to_f32(x[static_cast<size_t>(gm) * K + gk])
                      : 0.f;
    }
    for (int e = threadIdx.x; e < (BK / 2) * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int gr = k0 / 2 + r, gn = n0 + c;
      int lo = 0, hi = 0;
      if (gr < K2 && gn < N) {
        const int b = packed[static_cast<size_t>(gr) * N + gn];
        lo = (b & 0xF) - 8;
        hi = ((b >> 4) & 0xF) - 8;
      }
      ws[2 * r][c] = static_cast<float>(lo);
      ws[2 * r + 1][c] = static_cast<float>(hi);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();                      // the tiles are consumed
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= S) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn < N)
        store(out + static_cast<size_t>(gm) * N + gn, acc[i][j] * scale[gn]);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
cudaError_t launch(const void* x, const void* packed, const float* scale,
                   void* out, int S, int K, int N, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (S + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  w4_matmul_kernel<T, BM, BN, BK, TM, TN><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed), scale,
      static_cast<T*>(out), S, K, N);
  return cudaGetLastError();
}

// Decode rows (S <= 16) take 16 x 32 tiles and 128-deep stages: N/32
// blocks stream the weight, which is what bounds them, in few stages.
// Longer S takes 64 x 128 tiles, 32 outputs a thread, 32-deep stages, for
// the flops of a prefill chunk. Both walk k in the same order.
template <typename T>
cudaError_t dispatch(const void* x, const void* packed, const float* scale,
                     void* out, int S, int K, int N, cudaStream_t st) {
  if (S <= 16)
    return launch<T, 16, 32, 128, 1, 2>(x, packed, scale, out, S, K, N, st);
  return launch<T, 64, 128, 32, 4, 8>(x, packed, scale, out, S, K, N, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out share it). packed: [ceil(K/2),
// N] bytes; scale: [N] f32. Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int w4_matmul_forward(const void* x, const void* packed,
                                 const float* scale, void* out, int S, int K,
                                 int N, int dtype, int device, void* stream) {
  if (S < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, packed, scale, out, S, K, N, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, packed, scale, out, S, K, N, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* w4_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
