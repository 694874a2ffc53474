// Block-sparse (blocked-CSR) attention forward for Hopper (sm_90a), f32 and
// bf16 q/k/v [B, H, L, D], block sizes 8/16/32/64/128, any D <= 256.
//
// Replaces the TPU kernel `_bs_fwd_kernel` of
// paddle_tpu/ops/block_sparse_attention.py (launched there by `_bs_fwd`).
//
// Math (the JAX kernel): q-block row i of (b, h) reads the pattern
// g = b*H + h when the caller has one pattern per (b, h), else pattern 0,
// and walks block_cols[g, i, 0..count) in order. q is scaled before the
// dot (q * scale in f32). Each visited kv block c is one f32 online-softmax
// step over its bs keys: s = q.k over the block, m_new = max(m, row max s),
// alpha = exp(m - m_new), p = exp(s - m_new), l = l*alpha + sum p,
// acc = acc*alpha + p.V. The output is acc / max(l, 1e-30), cast to q's
// dtype, so a row with count 0 writes zeros. The walk stops at the count:
// the JAX kernel's padded slots (j >= count) give alpha = 1 and p = 0 and
// change no bit, so skipping them is exact. Column ids are clamped into
// [0, nk) so a bad id reads a block of the sequence.
//
// Bound: for BigBird-like patterns (~6 of 32 blocks a row at L 4096) the
// kernel is bound by operations, 4*bs*bs*D flops per visited block, and on
// bytes only when few blocks are visited. This first design does SIMT f32
// FMAs out of shared memory (no mma/wgmma yet), so it runs far above the
// tensor-core bound (see PERF.md). What it does about operations: a
// register micro-tile, so a thread's shared-memory loads are 2*RM per RM*RM
// FMAs (RM = bs/16 rows by as many keys, or head-dim columns, per thread:
// 8 x 8 at bs 128). What it does about bytes: each visited K/V block is
// read from device memory once per q block (the q block is re-read with it
// from L2, in 32-column chunks, to keep shared memory small).
//
// Layout: one thread block per (b, h, i), a TT x TT thread grid (TT = 16,
// or bs below 16). Thread (tr, tk) owns rows tr, tr+TT, ... of the q block,
// keys tk, tk+TT, ... of the kv block (scores in registers) and head-dim
// columns tk, tk+TT, ... of the accumulator. A block step: (1) S = (q *
// scale).K^T, staging q and K in 32-column chunks as f32 in shared memory
// and summing over d in order; (2) per row, the max and the sum of p over
// the TT threads of the row by xor shuffles (every thread ends with the
// same bits); (3) p to shared memory, then acc = acc*alpha + p.V, staging V
// 32 keys at a time and summing over keys in order. Shared-memory rows are
// padded by one float where a warp reads down a column.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kDenomEps = 1e-30f;
constexpr int kDK = 32;           // head-dim columns of a staged q/K chunk
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int BS>
struct Tile {
  static constexpr int TT = BS < 16 ? BS : 16;   // thread grid TT x TT
  static constexpr int NT = TT * TT;
  static constexpr int RM = BS / TT;              // rows (keys) a thread owns
  static constexpr int VT = BS < 32 ? BS : 32;    // keys of a staged V chunk
};

// Shared memory in floats: the q and K chunks (aliased by a V chunk), then
// p [BS][BS+1].
template <int BS>
__host__ __device__ constexpr size_t smem_floats(int D) {
  return (2 * BS * (kDK + 1) > Tile<BS>::VT * D ? 2 * BS * (kDK + 1)
                                                 : Tile<BS>::VT * D) +
         static_cast<size_t>(BS) * (BS + 1);
}

// BS: block size; DC: accumulator columns a thread owns (>= ceil(D/TT)).
template <typename T, int BS, int DC>
__global__ void __launch_bounds__(Tile<BS>::NT) block_sparse_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ cols, const int* __restrict__ counts,
    T* __restrict__ out, int H, int L, int D, int max_nnz, int per_head,
    float scale) {
  constexpr int TT = Tile<BS>::TT, NT = Tile<BS>::NT, RM = Tile<BS>::RM;
  constexpr int VT = Tile<BS>::VT, LDC = kDK + 1, LDP = BS + 1;
  extern __shared__ float smem[];
  float* qc = smem;                         // [BS][LDC]: q * scale chunk
  float* kc = smem + BS * LDC;              // [BS][LDC]: K chunk
  float* vc = smem;                         // [VT][D]:   V chunk (aliases)
  float* ps = smem + (smem_floats<BS>(D) - static_cast<size_t>(BS) * LDP);

  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nq = L / BS;
  const int tr = threadIdx.x / TT, tk = threadIdx.x % TT;
  const size_t head = (static_cast<size_t>(b) * H + h) * L * D;
  const int g = per_head ? b * H + h : 0;
  const int* rcols = cols + (static_cast<size_t>(g) * nq + i) * max_nnz;
  const int count = min(counts[static_cast<size_t>(g) * nq + i], max_nnz);
  const T* qblk = q + head + static_cast<size_t>(i) * BS * D;

  float m[RM], l[RM], acc[RM][DC];
#pragma unroll
  for (int x = 0; x < RM; ++x) {
    m[x] = kNeg;
    l[x] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[x][c] = 0.f;
  }

  for (int j = 0; j < count; ++j) {
    const int cb = min(max(rcols[j], 0), nq - 1);
    const T* kblk = k + head + static_cast<size_t>(cb) * BS * D;
    const T* vblk = v + head + static_cast<size_t>(cb) * BS * D;
    float s[RM][RM];
#pragma unroll
    for (int x = 0; x < RM; ++x)
#pragma unroll
      for (int y = 0; y < RM; ++y) s[x][y] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kDK) {
      const int dk = min(kDK, D - d0);
      __syncthreads();                      // the previous chunk is consumed
      for (int e = threadIdx.x; e < BS * dk; e += NT) {
        const int r = e / dk, dd = e - r * dk;
        const size_t off = static_cast<size_t>(r) * D + d0 + dd;
        qc[r * LDC + dd] = to_f32(qblk[off]) * scale;
        kc[r * LDC + dd] = to_f32(kblk[off]);
      }
      __syncthreads();
      for (int dd = 0; dd < dk; ++dd) {
        float a[RM], bk[RM];
#pragma unroll
        for (int x = 0; x < RM; ++x) {
          a[x] = qc[(tr + TT * x) * LDC + dd];
          bk[x] = kc[(tk + TT * x) * LDC + dd];
        }
#pragma unroll
        for (int x = 0; x < RM; ++x)
#pragma unroll
          for (int y = 0; y < RM; ++y) s[x][y] = fmaf(a[x], bk[y], s[x][y]);
      }
    }
#pragma unroll
    for (int x = 0; x < RM; ++x) {
      float mx = s[x][0];
#pragma unroll
      for (int y = 1; y < RM; ++y) mx = fmaxf(mx, s[x][y]);
#pragma unroll
      for (int o = TT / 2; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[x], mx);
      const float alpha = expf(m[x] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int y = 0; y < RM; ++y) {
        s[x][y] = expf(s[x][y] - m_new);
        sum += s[x][y];
      }
#pragma unroll
      for (int o = TT / 2; o; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      l[x] = l[x] * alpha + sum;
      m[x] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[x][c] *= alpha;
#pragma unroll
      for (int y = 0; y < RM; ++y)
        ps[(tr + TT * x) * LDP + tk + TT * y] = s[x][y];
    }
    for (int t0 = 0; t0 < BS; t0 += VT) {
      __syncthreads();                      // p is written; vc is free
      for (int e = threadIdx.x; e < VT * D; e += NT)
        vc[e] = to_f32(vblk[static_cast<size_t>(t0) * D + e]);
      __syncthreads();
      for (int tt = 0; tt < VT; ++tt) {
        float p[RM];
#pragma unroll
        for (int x = 0; x < RM; ++x) p[x] = ps[(tr + TT * x) * LDP + t0 + tt];
        const float* vrow = vc + tt * D;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = tk + TT * c;
          const float vv = d < D ? vrow[d] : 0.f;
#pragma unroll
          for (int x = 0; x < RM; ++x) acc[x][c] = fmaf(p[x], vv, acc[x][c]);
        }
      }
    }
  }
#pragma unroll
  for (int x = 0; x < RM; ++x) {
    const float denom = fmaxf(l[x], kDenomEps);
    T* orow = out + head + (static_cast<size_t>(i) * BS + tr + TT * x) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tk + TT * c;
      if (d < D) store(orow + d, acc[x][c] / denom);
    }
  }
}

template <typename T, int BS, int DC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* cols, const int* counts, void* out, int B,
                   int H, int L, int D, int max_nnz, int per_head,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<BS>(D);
  auto kernel = block_sparse_attention_kernel<T, BS, DC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(L / BS, H, B), Tile<BS>::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cols, counts, static_cast<T*>(out), H, L, D,
      max_nnz, per_head, scale);
  return cudaGetLastError();
}

// DC = ceil(Dmax / TT) for the head-dim class Dmax in 64 / 128 / 256.
template <typename T, int BS>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const int* cols, const int* counts, void* out, int B,
                       int H, int L, int D, int max_nnz, int per_head,
                       float scale, cudaStream_t s) {
  constexpr int TT = Tile<BS>::TT;
  if (D <= 64)
    return launch<T, BS, 64 / TT>(q, k, v, cols, counts, out, B, H, L, D,
                                  max_nnz, per_head, scale, s);
  if (D <= 128)
    return launch<T, BS, 128 / TT>(q, k, v, cols, counts, out, B, H, L, D,
                                   max_nnz, per_head, scale, s);
  return launch<T, BS, 256 / TT>(q, k, v, cols, counts, out, B, H, L, D,
                                 max_nnz, per_head, scale, s);
}

template <typename T>
cudaError_t dispatch_bs(int bs, const void* q, const void* k, const void* v,
                        const int* cols, const int* counts, void* out, int B,
                        int H, int L, int D, int max_nnz, int per_head,
                        float scale, cudaStream_t s) {
#define BSA_CASE(BS)                                                       \
  case BS:                                                                 \
    return dispatch_d<T, BS>(q, k, v, cols, counts, out, B, H, L, D,       \
                             max_nnz, per_head, scale, s)
  switch (bs) {
    BSA_CASE(8);
    BSA_CASE(16);
    BSA_CASE(32);
    BSA_CASE(64);
    BSA_CASE(128);
    default:
      return cudaErrorInvalidValue;
  }
#undef BSA_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). cols
// [G, L/bs, max_nnz] and counts [G, L/bs] int32; per_head != 0 when
// G == B*H. Returns the cudaError_t of the launch (0 = launched).
extern "C" int bsa_forward(const void* q, const void* k, const void* v,
                           const int* cols, const int* counts, void* out,
                           int B, int H, int L, int D, int bs, int max_nnz,
                           int per_head, float scale, int dtype, int device,
                           void* stream) {
  if (B < 1 || H < 1 || bs < 1 || L < bs || L % bs || D < 1 || D > 256 ||
      max_nnz < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bs<float>(bs, q, k, v, cols, counts, out, B, H, L, D,
                              max_nnz, per_head, scale, s);
  if (dtype == 1)
    return dispatch_bs<__nv_bfloat16>(bs, q, k, v, cols, counts, out, B, H,
                                      L, D, max_nnz, per_head, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* bsa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
