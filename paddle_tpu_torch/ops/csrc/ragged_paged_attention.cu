// Ragged paged attention for Hopper (sm_90a), f32 and bf16 pools.
//
// Replaces the TPU kernel `_ragged_kernel` of
// paddle_tpu/ops/ragged_paged_attention.py (launched there by
// `_ragged_kernel_call`, dense windows, and `_packed_kernel_call`, the
// packed token stream). One kernel serves both forms: q [N, W, H, D] with
// query w of item n at absolute position start[n] + w, reading page-table
// row row_of[n] (row_of == NULL: row n). The packed form is N = T, W = 1,
// row_of = row_ids, start = pos.
//
// Math (the JAX `_page_update`): each query walks its row's pages in page
// order j = 0, 1, ...; a page contributes logits q.k * scale masked to
// kpos <= qpos with -1e30, then one online-softmax step in f32
// (m_new = max(m, page max); p = exp(logit - m_new); corr = exp(m - m_new);
// s = s*corr + sum p; acc = acc*corr + p.V). Output acc / max(s, 1e-30),
// cast to q's dtype. Negative (and past-the-pool) table entries clamp into
// [0, P-1], as the TPU kernel's index map and the JAX gather do.
//
// Bound: bytes. A query at position qpos must read (qpos+1)*H*D*2*itemsize
// bytes of K and V and does ~4*D*(qpos+1) flops per head, so at any
// context the kernel is far below the card's ops:bytes ridge; its floor is
// K/V bytes over HBM bandwidth. What this first design does about it: each
// K/V page of a (row, head) is read from device memory once per group of
// four queries into shared memory and consumed there, and the walk stops at
// the query's last causal page instead of the table width (a fully masked
// page leaves m, s and acc unchanged bit for bit, so stopping changes
// nothing). No TMA, wgmma or multi-page pipelining yet: the page loads are
// not overlapped with compute, so the kernel is latency-bound at decode
// batch sizes (see PERF.md).
//
// Schedule independence: one thread block per (item, head); one warp per
// query; every query runs the same instruction sequence over the same pages
// whatever W, N, its place in the batch or the block launch order, so a
// token's output is bit-identical whether it is computed alone, inside a
// dense window or inside a packed stream. Per page: lane t < ps scores key t
// with a sequential dot over d; the page max and the page sum of p are warp
// butterflies (every lane ends with the same value: IEEE max and + are
// commutative); lane l owns head-dim elements l, l+32, ... and sums p.V over
// keys in order t = 0..ps-1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                 // queries in flight per block
constexpr int kThreads = kWarps * 32;
constexpr float kMask = -1e30f;
constexpr float kDenomEps = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// DPL = D / 32: head-dim elements each lane owns.
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ table,
    const int* __restrict__ row_of, const int* __restrict__ start,
    T* __restrict__ out, int W, int H, int ps, int MP, int P, int R,
    float scale) {
  constexpr int D = DPL * 32;
  extern __shared__ float smem[];
  float* ks = smem;                  // [ps][D + 1]: padded rows, so lane t
                                     // reading key t hits its own bank
  float* vs = ks + ps * (D + 1);     // [ps][D]
  float* qs = vs + ps * D;           // [kWarps][D]: each warp's query

  const int n = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int row = row_of ? row_of[n] : n;
  row = min(max(row, 0), R - 1);
  const int* trow = table + static_cast<size_t>(row) * MP;
  const int pos0 = start[n];
  float* qw = qs + warp * D;

  for (int g = 0; g < W; g += kWarps) {
    const int w = g + warp;
    const bool active = w < W;
    const int qpos = pos0 + w;
    const int my_pages = active ? min(MP, qpos / ps + 1) : 0;
    // positions rise with w, so the group's last query walks the most pages
    const int group_pages = min(MP, (pos0 + min(g + kWarps, W) - 1) / ps + 1);
    float m = kMask, s = 0.f, acc[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
    if (active) {
      const T* qrow = q + ((static_cast<size_t>(n) * W + w) * H + h) * D;
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        qw[lane + 32 * i] = to_f32(qrow[lane + 32 * i]) * scale;
    }
    __syncwarp();
    for (int j = 0; j < group_pages; ++j) {
      const int pid = min(max(trow[j], 0), P - 1);
      const size_t base = (static_cast<size_t>(pid) * ps * H + h) * D;
      __syncthreads();               // the previous page is consumed
      for (int e = threadIdx.x; e < ps * D; e += kThreads) {
        const int t = e / D, d = e % D;
        const size_t off = base + static_cast<size_t>(t) * H * D + d;
        ks[t * (D + 1) + d] = to_f32(k_pages[off]);
        vs[t * D + d] = to_f32(v_pages[off]);
      }
      __syncthreads();
      if (j >= my_pages) continue;   // warp-uniform: past this query's keys
      float logit = kMask;
      if (lane < ps) {
        const float* kr = ks + lane * (D + 1);
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qw[d], kr[d], dot);
        logit = (j * ps + lane <= qpos) ? dot : kMask;
      }
      float pmax = logit;
#pragma unroll
      for (int o = 16; o; o >>= 1)
        pmax = fmaxf(pmax, __shfl_xor_sync(kFull, pmax, o));
      const float m_new = fmaxf(m, pmax);
      const float p = lane < ps ? expf(logit - m_new) : 0.f;
      const float corr = expf(m - m_new);
      float psum = p;
#pragma unroll
      for (int o = 16; o; o >>= 1) psum += __shfl_xor_sync(kFull, psum, o);
      s = s * corr + psum;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        float pv = 0.f;
        for (int t = 0; t < ps; ++t)
          pv = fmaf(__shfl_sync(kFull, p, t), vs[t * D + lane + 32 * i], pv);
        acc[i] = acc[i] * corr + pv;
      }
      m = m_new;
    }
    if (active) {
      T* orow = out + ((static_cast<size_t>(n) * W + w) * H + h) * D;
      const float denom = fmaxf(s, kDenomEps);
#pragma unroll
      for (int i = 0; i < DPL; ++i) store(orow + lane + 32 * i, acc[i] / denom);
    }
    __syncwarp();                    // qw is rewritten by the next group
  }
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* table, const int* row_of, const int* start,
                   void* out, int N, int W, int H, int ps, int MP, int P,
                   int R, float scale, cudaStream_t stream) {
  constexpr int D = DPL * 32;
  const size_t smem = sizeof(float) * (ps * (D + 1) + ps * D + kWarps * D);
  auto kernel = ragged_paged_attention_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(N, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, row_of, start, static_cast<T*>(out),
      W, H, ps, MP, P, R, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* kp, const void* vp,
                       const int* table, const int* row_of, const int* start,
                       void* out, int N, int W, int H, int ps, int MP, int P,
                       int R, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 1>(q, kp, vp, table, row_of, start, out, N, W,
                                 H, ps, MP, P, R, scale, stream);
    case 64: return launch<T, 2>(q, kp, vp, table, row_of, start, out, N, W,
                                 H, ps, MP, P, R, scale, stream);
    case 128: return launch<T, 4>(q, kp, vp, table, row_of, start, out, N, W,
                                  H, ps, MP, P, R, scale, stream);
    case 256: return launch<T, 8>(q, kp, vp, table, row_of, start, out, N, W,
                                  H, ps, MP, P, R, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int rpa_forward(const void* q, const void* k_pages,
                           const void* v_pages, const int* table,
                           const int* row_of, const int* start, void* out,
                           int N, int W, int H, int D, int ps, int MP, int P,
                           int R, float scale, int dtype, int device,
                           void* stream) {
  if (ps < 1 || ps > 32 || N < 1 || W < 1 || MP < 1 || P < 1 || R < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k_pages, v_pages, table, row_of, start,
                             out, N, W, H, ps, MP, P, R, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k_pages, v_pages, table, row_of,
                                     start, out, N, W, H, ps, MP, P, R,
                                     scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* rpa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
