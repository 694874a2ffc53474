// Single-query paged decode attention for Hopper (sm_90a), f32 and bf16
// pages [P, ps, H, D], any page size, any D <= 256.
//
// Replaces the TPU kernel `_paged_kernel` of paddle_tpu/ops/paged_attention.py
// (launched there by `_paged_kernel_call`, the `use_kernel=True` path of
// `paged_attention`).
//
// Math (the JAX kernel): the query of (b, h), q [B, 1, H, D], walks the
// pages j = 0..max_pages-1 of table row b in order; a page id is clamped
// into [0, P-1] (-1, an unused slot, reads page 0). q is scaled before the
// dot. Position j*ps + t with t in the page gets the logit q.k, or -1e30
// when it is >= seq_lens[b] (masked, not skipped). One f32 online-softmax
// step a page: m_new = max(m, page max), p = exp(logit - m_new),
// corr = exp(m - m_new), s = s*corr + sum p, acc = acc*corr + p.V. The
// output is acc / max(s, 1e-30) in q's dtype. With seq_len 0 every logit is
// -1e30, so p = exp(0) = 1 everywhere and the output is the uniform mean of
// V over every slot of the table, as in the TPU kernel and the JAX
// reference; this kernel walks every page in that case. With seq_len > 0 it
// stops after the last page that holds a position < seq_len: a fully masked
// page after a real logit gives p = 0 and corr = 1 and changes no bit.
//
// Bound: bytes. A query reads seq_len*D keys and values (2*seq_len*D*itemsize
// bytes a head) and does ~4*D flops per key, far below the card's
// ops:bytes ridge; the floor is the K/V bytes over HBM bandwidth. What this
// first design does about it: every K and V element of a (b, h) is read
// once, with neighbouring threads on neighbouring head-dim elements
// (coalesced), and the walk stops at the last real page. A page step costs
// about two memory latencies (its keys, then its values), spread over a
// whole thread block. No cp.async/TMA prefetch of the next page yet, so at
// decode batch sizes the walk is latency-bound (see PERF.md).
//
// Layout: one block of kThreads threads per (b, h). Per page: warp w scores
// keys w, w+kWarps, ... (lane l holds q * scale for head-dim elements l,
// l+32, ...; the dot is summed by an xor butterfly) into shared memory;
// after a barrier every thread reads the page's logits, so every thread
// holds the same page max, p and sum of p (summed over keys in order);
// thread t accumulates p.V for head-dim elements t and t + kThreads over the
// page's keys in order, into a page sum that is then added to acc*corr, as
// the TPU kernel does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kDPT = 256 / kThreads;      // head-dim elements a thread owns
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

// DPL: head-dim elements a lane holds for scoring (D <= 32 * DPL).
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ table,
    const int* __restrict__ seq_lens, T* __restrict__ out, int H, int D,
    int ps, int MP, int P_, float scale) {
  extern __shared__ float lg[];             // the page's logits [ps]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x, h = blockIdx.y;
  const int len = seq_lens[b];
  const int* trow = table + static_cast<size_t>(b) * MP;
  const int pages = len > 0 ? min(MP, (len + ps - 1) / ps) : MP;

  const T* qrow = q + (static_cast<size_t>(b) * H + h) * D;
  float qv[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < D ? to_f32(qrow[d]) * scale : 0.f;
  }
  float m = kMask, s = 0.f, acc[kDPT];
#pragma unroll
  for (int c = 0; c < kDPT; ++c) acc[c] = 0.f;
  for (int j = 0; j < pages; ++j) {
    const int pid = min(max(trow[j], 0), P_ - 1);
    const size_t page = static_cast<size_t>(pid) * ps;
#pragma unroll 2
    for (int t = warp; t < ps; t += kWarps) {
      const T* krow = k_pages + ((page + t) * H + h) * D;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) dot = fmaf(qv[i], to_f32(krow[d]), dot);
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
      if (lane == 0) lg[t] = j * ps + t < len ? dot : kMask;
    }
    __syncthreads();                        // the page's logits are in lg
    float pmax = kMask;
    for (int t = 0; t < ps; ++t) pmax = fmaxf(pmax, lg[t]);
    const float m_new = fmaxf(m, pmax);
    const float corr = expf(m - m_new);
    float psum = 0.f, pv[kDPT];
#pragma unroll
    for (int c = 0; c < kDPT; ++c) pv[c] = 0.f;
#pragma unroll 4
    for (int t = 0; t < ps; ++t) {
      const float p = expf(lg[t] - m_new);
      psum += p;
      const T* vrow = v_pages + ((page + t) * H + h) * D;
#pragma unroll
      for (int c = 0; c < kDPT; ++c) {
        const int d = threadIdx.x + kThreads * c;
        if (d < D) pv[c] = fmaf(p, to_f32(vrow[d]), pv[c]);
      }
    }
    __syncthreads();                        // lg is rewritten next page
    s = s * corr + psum;
#pragma unroll
    for (int c = 0; c < kDPT; ++c) acc[c] = acc[c] * corr + pv[c];
    m = m_new;
  }
  const float denom = fmaxf(s, kDenomEps);
  T* orow = out + (static_cast<size_t>(b) * H + h) * D;
#pragma unroll
  for (int c = 0; c < kDPT; ++c) {
    const int d = threadIdx.x + kThreads * c;
    if (d < D) store(orow + d, acc[c] / denom);
  }
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* table, const int* lens, void* out, int B, int H,
                   int D, int ps, int MP, int P_, float scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(ps);
  auto kernel = paged_attention_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(B, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lens, static_cast<T*>(out), H, D, ps,
      MP, P_, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* kp, const void* vp,
                       const int* table, const int* lens, void* out, int B,
                       int H, int D, int ps, int MP, int P_, float scale,
                       cudaStream_t s) {
  if (D <= 32)
    return launch<T, 1>(q, kp, vp, table, lens, out, B, H, D, ps, MP, P_,
                        scale, s);
  if (D <= 64)
    return launch<T, 2>(q, kp, vp, table, lens, out, B, H, D, ps, MP, P_,
                        scale, s);
  if (D <= 128)
    return launch<T, 4>(q, kp, vp, table, lens, out, B, H, D, ps, MP, P_,
                        scale, s);
  return launch<T, 8>(q, kp, vp, table, lens, out, B, H, D, ps, MP, P_,
                      scale, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it). table
// [B, MP] and seq_lens [B] int32. Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int paged_forward(const void* q, const void* k_pages,
                             const void* v_pages, const int* table,
                             const int* seq_lens, void* out, int B, int H,
                             int D, int ps, int MP, int P, float scale,
                             int dtype, int device, void* stream) {
  if (B < 1 || H < 1 || H > 65535 || D < 1 || D > 256 || ps < 1 || MP < 1 ||
      P < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k_pages, v_pages, table, seq_lens, out, B, H,
                             D, ps, MP, P, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k_pages, v_pages, table, seq_lens,
                                     out, B, H, D, ps, MP, P, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* paged_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
