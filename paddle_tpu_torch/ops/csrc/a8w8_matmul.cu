// Int8 x int8 -> int32 linear (A8W8) for Hopper (sm_90a): the row quantize
// of the activations and an int8 tensor-core GEMM with the f32 epilogue.
//
// Replaces no Pallas kernel. The JAX package computes A8W8 as an XLA fusion
// (the quantize) and an XLA int8 dot with an int32 result in three places:
// the serving decoder's `_mm_heads` and `_mm` (paddle_tpu/serving/
// decoder.py:307, :330), dynamic per-row activation scales, and
// `QuantizedLinearA8W8.forward` (paddle_tpu/quantization.py:118), a static
// activation scale from calibration. Run eagerly on the card, the quantize
// alone is 6-8 launches a product, and `torch._int_mm` refuses the 16-row
// decode tick (it needs M > 16).
//
//   quantize:  sx[t] = max(amax_k |x[t, k]| / 127, 1e-8)   (f32; or given)
//              xq[t, k] = clamp(rn(x[t, k] / sx[t]), -127, 127)
//   GEMM:      acc[m, n] = sum_k xq[m, k] * wt[n, k]        (exact int32)
//              order 0 (decoder):  y = (f32(acc) * sx[m]) * sw[n] + b[n]
//              order 1 (PTQ/QAT):  y = f32(acc) * (sw[n] * sx) + b[n]
//              out[m, n] = cast(y) to x's dtype (f32, bf16 or f16)
//
// x [T, K] is f32, bf16 or f16; the weight wt [N, K] int8 is K-contiguous
// (the decoder stores each linear transposed once; `QuantizedLinearA8W8`
// keeps a transposed copy of its Paddle [in, out] buffer); sw [N] f32; b [N]
// in its stored dtype (f32, bf16 or f16), added in f32, or absent. Every
// rounding point is the plain version's: the division is a true division
// (`__fdiv_rn`), rn is round-half-to-even (`__float2int_rn`, as `torch.round`
// and `jnp.round`), f32(acc) rounds to nearest, and the epilogue is written
// with `__fmul_rn` / `__fadd_rn` so that nvcc cannot contract it into an FMA.
// The kernels equal the plain versions bit for bit.
//
// Schedule independence comes free: the int32 sum is exact (|acc| <= K *
// 127^2 < 2^31 for K <= 133144, which the wrapper checks), so its value does
// not depend on how K is cut or on the order of the partial sums, and the
// epilogue is elementwise. A row's bits are the same in a 1-row and in a
// 4096-row call, whichever body runs.
//
// Bounds, and what the design does about them:
//   quantize: bytes (x read, xq and sx written). One block of 256 threads
//     a row: each thread's 16-byte loads of the row stay in registers (a
//     row of K <= 8192 is read once), the absmax by shuffles and shared
//     memory, then the divide and round from registers. (The first design,
//     a warp a row reading it twice with dependent loads, was bound by
//     latency: 0.0113 ms at K 2048 and 0.0408 at K 8192, PERF.md.)
//   decode GEMM (M <= 16): bytes. The weight, N * K bytes, is read once for
//     2 M N K operations. `a8w8_gemm_decode_kernel`: one m16 tile holds every
//     row; a block owns 16 columns (two n8 tiles), and its 8 warps cut K into
//     8 slices, so N / 16 blocks (128-512 at gpt_1p3b) stream the weight. A
//     lane loads 16 contiguous bytes of x and of each weight row straight
//     into registers: since the integer sum does not depend on the order of
//     k, the lane's 16 bytes serve as its k-quarter of two k32 steps (the
//     same permutation of k for A and B), so every fragment is one 16-byte
//     load. The warps' int32 partials are added in shared memory.
//   prefill GEMM (M > 16): operations (2 M N K int8 ops at 1979 TOP/s
//     against N K + M K bytes). `a8w8_gemm_tile_kernel`: 128 x 128 output
//     tiles, 8 warps of 64 x 32, 64-byte K stages through a 3-stage cp.async
//     ring (48 KB), fragments read with 16-byte shared loads under the same
//     k permutation (a 64-byte row pitch is free of bank conflicts for
//     them). mma.sync reaches a fraction of the int8 peak; wgmma and TMA are
//     later work (PERF.md).
//   Rows that are not 16-byte aligned (K % 16, or a pointer off 16 bytes)
//   load byte by byte with zero fill into the same registers or tiles:
//   any M, N and K, nothing padded in device memory.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tc_tile.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

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
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// ------------------------------------------------------------ row quantize

constexpr int kQuantThreads = 256;  // one block a row
constexpr int kQuantVec = 4;        // 8-value vectors a thread keeps in
                                    // registers: rows up to K = 8192

// 8 consecutive values of a row as f32 (16-byte aligned: one or two loads).
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = to_f32(e[i]);
}

__device__ __forceinline__ int quant1(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return min(max(q, -127), 127);
}

__device__ __forceinline__ void store8(int8_t* p, const float (&v)[8],
                                       float s) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i >> 2] |= (static_cast<uint32_t>(quant1(v[i], s)) & 0xffu)
                 << (8 * (i & 3));
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// The row's absmax across the block (max is exact in any order).
__device__ __forceinline__ float block_max(float v) {
  __shared__ float part[kQuantThreads / 32];
#pragma unroll
  for (int o = 16; o; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = part[0];
#pragma unroll
  for (int i = 1; i < kQuantThreads / 32; ++i) v = fmaxf(v, part[i]);
  return v;
}

// One block a row: each thread loads its 16-byte vectors of the row once
// (up to kQuantVec of them stay in registers; a longer row reads its tail
// again), the absmax by shuffles and shared memory, then quantizes.
// kStatic: the scale is *sx_in for every row and sx is not written.
// vec: K % 8 == 0, x 16-byte and xq 8-byte aligned; otherwise element by
// element, reading the row twice.
template <typename T, bool kStatic>
__global__ void __launch_bounds__(kQuantThreads)
    a8w8_quantize_rows_kernel(const T* __restrict__ x,
                              int8_t* __restrict__ xq, float* __restrict__ sx,
                              const float* __restrict__ sx_in, int K,
                              int vec) {
  const int row = blockIdx.x;
  const T* xr = x + static_cast<int64_t>(row) * K;
  int8_t* qr = xq + static_cast<int64_t>(row) * K;
  constexpr int kStride = kQuantThreads * 8;
  float s = 0.f;
  if (vec) {
    float v[kQuantVec][8];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kQuantVec; ++i) {
      const int k = i * kStride + threadIdx.x * 8;
      if (k < K) {
        load8(xr + k, v[i]);
        if (!kStatic) {
#pragma unroll
          for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[i][j]));
        }
      }
    }
    if (!kStatic) {
      for (int k = kQuantVec * kStride + threadIdx.x * 8; k < K;
           k += kStride) {
        float t[8];
        load8(xr + k, t);
#pragma unroll
        for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(t[j]));
      }
      s = fmaxf(__fdiv_rn(block_max(amax), 127.f), 1e-8f);
    } else {
      s = *sx_in;
    }
#pragma unroll
    for (int i = 0; i < kQuantVec; ++i) {
      const int k = i * kStride + threadIdx.x * 8;
      if (k < K) store8(qr + k, v[i], s);
    }
    for (int k = kQuantVec * kStride + threadIdx.x * 8; k < K;
         k += kStride) {
      float t[8];
      load8(xr + k, t);
      store8(qr + k, t, s);
    }
  } else {
    if (kStatic) {
      s = *sx_in;
    } else {
      float amax = 0.f;
      for (int k = threadIdx.x; k < K; k += kQuantThreads)
        amax = fmaxf(amax, fabsf(to_f32(xr[k])));
      s = fmaxf(__fdiv_rn(block_max(amax), 127.f), 1e-8f);
    }
    for (int k = threadIdx.x; k < K; k += kQuantThreads)
      qr[k] = static_cast<int8_t>(quant1(to_f32(xr[k]), s));
  }
  if (!kStatic && threadIdx.x == 0) sx[row] = s;
}

// ------------------------------------------------------------------ GEMM

// d += A (16 x 32 s8) * B (32 x 8 s8), s32 accumulate. Fragments (lane =
// 4 g + t): a0 = (row g, logical k 4t..4t+3), a1 = (row g + 8, 4t..),
// a2 = (row g, 16 + 4t..), a3 = (row g + 8, 16 + 4t..); b0 = (k 4t..,
// col g), b1 = (k 16 + 4t.., col g); d0, d1 = (row g, cols 2t, 2t + 1),
// d2, d3 = (row g + 8, the same cols).
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The two k32 steps of a lane's 16 bytes: physical bytes [k, k + 16) of
// its rows, words w0..w3. Step 0 takes w0 as logical k 4t.. and w1 as 16 +
// 4t..; step 1 takes w2 and w3. The same map for A and B, so the product
// is the sum over the 64 bytes of a stage, in another order.
__device__ __forceinline__ void mma_k64(int (&d)[4], const uint4& alo,
                                        const uint4& ahi, const uint4& b) {
  mma_s8(d, alo.x, ahi.x, alo.y, ahi.y, b.x, b.y);
  mma_s8(d, alo.z, ahi.z, alo.w, ahi.w, b.z, b.w);
}

// 16 bytes of row `row` at byte k of a [rows, K] int8 matrix, zero past its
// edges; `aligned`: K % 16 == 0 and a 16-byte aligned base.
__device__ __forceinline__ uint4 load16(const int8_t* __restrict__ base,
                                        int row, int rows, int k, int K,
                                        bool aligned) {
  if (row >= rows || k >= K) return make_uint4(0u, 0u, 0u, 0u);
  const int8_t* p = base + static_cast<int64_t>(row) * K + k;
  if (aligned) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16 && k + i < K; ++i)
    w[i >> 2] |= (static_cast<uint32_t>(static_cast<uint8_t>(p[i])))
                 << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The epilogue of one output element, at the plain version's rounding
// points. bias_dtype: -1 none, 0 f32, 1 bf16, 2 f16.
template <int kOrder>
__device__ __forceinline__ float epilogue(int acc, float sxm, float swn,
                                          const void* bias, int bias_dtype,
                                          int n) {
  const float a = __int2float_rn(acc);
  float y = kOrder == 0 ? __fmul_rn(__fmul_rn(a, sxm), swn)
                        : __fmul_rn(a, __fmul_rn(swn, sxm));
  if (bias_dtype == 0)
    y = __fadd_rn(y, static_cast<const float*>(bias)[n]);
  else if (bias_dtype == 1)
    y = __fadd_rn(y, __bfloat162float(
                         static_cast<const __nv_bfloat16*>(bias)[n]));
  else if (bias_dtype == 2)
    y = __fadd_rn(y, __half2float(static_cast<const __half*>(bias)[n]));
  return y;
}

constexpr int kDecWarps = 8;        // K slices of a decode block
constexpr int kDecCols = 16;        // columns of a decode block

template <typename T, int kOrder>
__global__ void __launch_bounds__(kDecWarps * 32) a8w8_gemm_decode_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx,
    int sx_stride, const int8_t* __restrict__ wt,
    const float* __restrict__ sw, const void* __restrict__ bias,
    int bias_dtype, T* __restrict__ out, int M, int N, int K, int aligned) {
  __shared__ int red[kDecWarps][16][kDecCols + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kDecCols;
  const int nch = (K + 63) / 64;
  const int c0 = warp * nch / kDecWarps, c1 = (warp + 1) * nch / kDecWarps;
  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll 4
  for (int c = c0; c < c1; ++c) {
    const int k = c * 64 + t * 16;
    const uint4 alo = load16(xq, g, M, k, K, aligned);
    const uint4 ahi = load16(xq, g + 8, M, k, K, aligned);
    const uint4 b0 = load16(wt, n0 + g, N, k, K, aligned);
    const uint4 b1 = load16(wt, n0 + 8 + g, N, k, K, aligned);
    mma_k64(acc[0], alo, ahi, b0);
    mma_k64(acc[1], alo, ahi, b1);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    red[warp][g][j * 8 + 2 * t] = acc[j][0];
    red[warp][g][j * 8 + 2 * t + 1] = acc[j][1];
    red[warp][g + 8][j * 8 + 2 * t] = acc[j][2];
    red[warp][g + 8][j * 8 + 2 * t + 1] = acc[j][3];
  }
  __syncthreads();
  const int m = threadIdx.x / kDecCols, n = n0 + threadIdx.x % kDecCols;
  if (m >= M || n >= N) return;
  int s = 0;
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) s += red[w][m][threadIdx.x % kDecCols];
  out[static_cast<int64_t>(m) * N + n] = from_f32<T>(epilogue<kOrder>(
      s, sx[m * sx_stride], sw[n], bias, bias_dtype, n));
}

constexpr int kTileM = 128, kTileN = 128, kTileK = 64;   // bytes of K
constexpr int kStages = 3;          // 3 x (8 + 8) KB = 48 KB, static
constexpr int kTileThreads = 256;   // 8 warps: 2 along M x 4 along N

// One stage of a [rows, K] operand: rows r0..r0+127, bytes k0..k0+63, into
// a 128 x 64 tile (row pitch 64). cp.async with zero fill when aligned,
// byte loads otherwise.
__device__ __forceinline__ void load_tile(int8_t* __restrict__ dst,
                                          const int8_t* __restrict__ src,
                                          int r0, int rows, int k0, int K,
                                          bool aligned) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = threadIdx.x + i * kTileThreads;    // 512 chunks of 16 B
    const int r = e >> 2, ch = e & 3;
    const int gr = r0 + r, gk = k0 + ch * 16;
    int8_t* d = dst + r * kTileK + ch * 16;
    if (aligned) {
      const bool in = gr < rows && gk < K;
      tc::cp_async16(d, in ? src + static_cast<int64_t>(gr) * K + gk : src,
                     in ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(d) = load16(src, gr, rows, gk, K, false);
    }
  }
}

template <typename T, int kOrder>
__global__ void __launch_bounds__(kTileThreads) a8w8_gemm_tile_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ sx,
    int sx_stride, const int8_t* __restrict__ wt,
    const float* __restrict__ sw, const void* __restrict__ bias,
    int bias_dtype, T* __restrict__ out, int M, int N, int K, int aligned) {
  __shared__ __align__(128) int8_t as[kStages][kTileM * kTileK];
  __shared__ __align__(128) int8_t bs[kStages][kTileN * kTileK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;       // 64-row x 32-col warp tile
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int nk = (K + kTileK - 1) / kTileK;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      load_tile(as[s], xq, m0, M, s * kTileK, K, aligned);
      load_tile(bs[s], wt, n0, N, s * kTileK, K, aligned);
    }
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();                 // stage kt landed; kt - 1 is free
    const int pf = kt + kStages - 1;
    if (pf < nk) {
      load_tile(as[pf % kStages], xq, m0, M, pf * kTileK, K, aligned);
      load_tile(bs[pf % kStages], wt, n0, N, pf * kTileK, K, aligned);
    }
    tc::cp_async_commit();
    const int8_t* a = as[kt % kStages];
    const int8_t* b = bs[kt % kStages];
    uint4 bf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bf[j] = *reinterpret_cast<const uint4*>(
          b + (wn * 32 + j * 8 + g) * kTileK + t * 16);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm * 64 + i * 16 + g;
      const uint4 alo = *reinterpret_cast<const uint4*>(a + r * kTileK +
                                                        t * 16);
      const uint4 ahi = *reinterpret_cast<const uint4*>(
          a + (r + 8) * kTileK + t * 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_k64(acc[i][j], alo, ahi, bf[j]);
    }
  }
  tc::cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + g + 8 * h;
      if (m >= M) continue;
      const float sxm = sx[m * sx_stride];
      T* orow = out + static_cast<int64_t>(m) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + j * 8 + 2 * t + e;
          if (n < N)
            orow[n] = from_f32<T>(epilogue<kOrder>(
                acc[i][j][2 * h + e], sxm, sw[n], bias, bias_dtype, n));
        }
      }
    }
  }
}

template <typename T, int kOrder>
cudaError_t gemm(const int8_t* xq, const float* sx, int sx_stride,
                 const int8_t* wt, const float* sw, const void* bias,
                 int bias_dtype, void* out, int M, int N, int K, int aligned,
                 cudaStream_t stream, int* route) {
  if (M <= 16) {
    *route = 0;
    a8w8_gemm_decode_kernel<T, kOrder>
        <<<(N + kDecCols - 1) / kDecCols, kDecWarps * 32, 0, stream>>>(
            xq, sx, sx_stride, wt, sw, bias, bias_dtype, static_cast<T*>(out),
            M, N, K, aligned);
  } else {
    *route = 1;
    dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
    a8w8_gemm_tile_kernel<T, kOrder><<<grid, kTileThreads, 0, stream>>>(
        xq, sx, sx_stride, wt, sw, bias, bias_dtype, static_cast<T*>(out), M,
        N, K, aligned);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t gemm_order(int order, const int8_t* xq, const float* sx,
                       int sx_stride, const int8_t* wt, const float* sw,
                       const void* bias, int bias_dtype, void* out, int M,
                       int N, int K, int aligned, cudaStream_t stream,
                       int* route) {
  if (order == 0)
    return gemm<T, 0>(xq, sx, sx_stride, wt, sw, bias, bias_dtype, out, M, N,
                      K, aligned, stream, route);
  return gemm<T, 1>(xq, sx, sx_stride, wt, sw, bias, bias_dtype, out, M, N,
                    K, aligned, stream, route);
}

template <typename T>
cudaError_t quantize(const void* x, int8_t* xq, float* sx, const float* sx_in,
                     int rows, int K, cudaStream_t stream) {
  const int vec = K % 8 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(xq) % 8 == 0;
  if (sx_in)
    a8w8_quantize_rows_kernel<T, true><<<rows, kQuantThreads, 0, stream>>>(
        static_cast<const T*>(x), xq, sx, sx_in, K, vec);
  else
    a8w8_quantize_rows_kernel<T, false><<<rows, kQuantThreads, 0, stream>>>(
        static_cast<const T*>(x), xq, sx, sx_in, K, vec);
  return cudaGetLastError();
}

}  // namespace

// x [rows, K] (dtype: 0 f32, 1 bf16, 2 f16) -> xq [rows, K] int8 and, with
// sx_in null, sx [rows] f32; with sx_in (one f32 on the card) that scale
// for every row, sx unwritten. Returns a cudaError_t.
extern "C" int a8w8_quantize_rows(const void* x, int8_t* xq, float* sx,
                                  const float* sx_in, int rows, int K,
                                  int dtype, int device, void* stream) {
  if (rows < 1 || K < 1 || (!sx_in && !sx)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return quantize<float>(x, xq, sx, sx_in, rows, K, s);
  if (dtype == 1)
    return quantize<__nv_bfloat16>(x, xq, sx, sx_in, rows, K, s);
  if (dtype == 2) return quantize<__half>(x, xq, sx, sx_in, rows, K, s);
  return cudaErrorInvalidValue;
}

// out [M, N] (out_dtype 0 f32, 1 bf16, 2 f16) = the epilogue (order 0 or 1)
// of xq [M, K] int8 times wt [N, K] int8, sx[m * sx_stride] (stride 1: a
// scale a row; 0: one static scale), sw [N] f32, bias [N] (bias_dtype -1
// none, 0 f32, 1 bf16, 2 f16). *route: 0 the decode body, 1 the tile body.
extern "C" int a8w8_gemm(const int8_t* xq, const float* sx, int sx_stride,
                         const int8_t* wt, const float* sw, const void* bias,
                         int bias_dtype, void* out, int M, int N, int K,
                         int out_dtype, int order, int device, void* stream,
                         int* route) {
  if (M < 1 || N < 1 || K < 1 || K > 133144 || M > 65535 * kTileM ||
      (sx_stride != 0 && sx_stride != 1) || (order != 0 && order != 1) ||
      bias_dtype < -1 || bias_dtype > 2 || (bias_dtype >= 0 && !bias))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int aligned = K % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(wt) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return gemm_order<float>(order, xq, sx, sx_stride, wt, sw, bias,
                             bias_dtype, out, M, N, K, aligned, s, route);
  if (out_dtype == 1)
    return gemm_order<__nv_bfloat16>(order, xq, sx, sx_stride, wt, sw, bias,
                                     bias_dtype, out, M, N, K, aligned, s,
                                     route);
  if (out_dtype == 2)
    return gemm_order<__half>(order, xq, sx, sx_stride, wt, sw, bias,
                              bias_dtype, out, M, N, K, aligned, s, route);
  return cudaErrorInvalidValue;
}

extern "C" const char* a8w8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
