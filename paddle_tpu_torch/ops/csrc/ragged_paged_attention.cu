// Ragged paged attention for Hopper (sm_90a): f32 and bf16 pools, and the
// int8 and int4 quantized pools of the serving decoder.
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
// Pool layouts (template parameter L), the JAX kernel's `quant` modes:
//   kPlain: pages [P, ps, H, D] in q's dtype;
//   kInt8:  pages int8 [P, ps, H, D] + per-token f32 scales [P, ps] for K
//           and for V. The key scale multiplies the finished logit
//           (q.(k*s) == (q.k)*s), before the mask; V is dequantized
//           (v * s) before the PV dot: the JAX `_page_update` order;
//   kInt4:  nibble-packed uint8 pages [P, ps, PB] + per-group f32 scales
//           [P, ps, G]. Element e = h*D + d of a token is nibble e % 2
//           (low first) of byte e / 2, sign-extended from 4 bits, times the
//           scale of group e / (2*PB / G): the JAX `_dequant_page_int4`,
//           applied to K and V before both dots. A block reads only its own
//           head's slice of the packed page (D/2 bytes and D/group scales a
//           token); the JAX interpret-mode kernel re-reads the whole page
//           for each head, which costs time and changes no value.
// Each layout only changes how one page lands in shared memory (as f32) and,
// for int8, one multiply of the logit; the page walk, the online softmax and
// every reduction order are the same code for all three.
//
// Bound: bytes. A query at position qpos must read (qpos+1)*H*D*2*itemsize
// bytes of K and V (int8: itemsize 1 plus a 4-byte scale per token and
// plane; int4: 1/2 plus a 4-byte scale per group) and does ~4*D*(qpos+1)
// flops per head (plus the dequant multiplies), so at any
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

#include <cstdint>

namespace {

constexpr int kWarps = 4;                 // queries in flight per block
constexpr int kThreads = kWarps * 32;
constexpr float kMask = -1e30f;
constexpr float kDenomEps = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

enum Layout { kPlain = 0, kInt8 = 1, kInt4 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Sign-extended 4-bit value of nibble `e % 2` of byte `e / 2` of `row`.
__device__ __forceinline__ float nibble(const uint8_t* row, int e) {
  const int b = (row[e >> 1] >> ((e & 1) * 4)) & 0xF;
  return static_cast<float>(b >= 8 ? b - 16 : b);
}

// Load page `pid`'s keys and values of head h into shared memory as f32
// (keys into rows of D + 1, values into rows of D); for kInt8 also the
// page's key scales into kscale[ps].
template <int L, typename P, int D>
__device__ __forceinline__ void load_page(
    const P* __restrict__ k_pages, const P* __restrict__ v_pages,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    int pid, int h, int H, int ps, int PB, int G, float* ks, float* vs,
    float* kscale) {
  const size_t tok0 = static_cast<size_t>(pid) * ps;
  if constexpr (L == kInt4) {
    const int group = 2 * PB / G;
    for (int e = threadIdx.x; e < ps * D; e += kThreads) {
      const int t = e / D, d = e % D;
      const int el = h * D + d;
      const size_t tok = tok0 + t;
      const float* kg = k_scale + tok * G;
      const float* vg = v_scale + tok * G;
      ks[t * (D + 1) + d] = nibble(k_pages + tok * PB, el) * kg[el / group];
      vs[t * D + d] = nibble(v_pages + tok * PB, el) * vg[el / group];
    }
  } else {
    const size_t base = (tok0 * H + h) * D;
    for (int e = threadIdx.x; e < ps * D; e += kThreads) {
      const int t = e / D, d = e % D;
      const size_t off = base + static_cast<size_t>(t) * H * D + d;
      ks[t * (D + 1) + d] = to_f32(k_pages[off]);
      if constexpr (L == kInt8)
        vs[t * D + d] = to_f32(v_pages[off]) * v_scale[tok0 + t];
      else
        vs[t * D + d] = to_f32(v_pages[off]);
    }
    if constexpr (L == kInt8)
      if (threadIdx.x < ps) kscale[threadIdx.x] = k_scale[tok0 + threadIdx.x];
  }
}

// DPL = D / 32: head-dim elements each lane owns. T: q and out; P: the
// pool's element type (T, int8_t or uint8_t by layout L).
template <typename T, typename P, int L, int DPL>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pages,
    const P* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ row_of, const int* __restrict__ start,
    T* __restrict__ out, int W, int H, int ps, int MP, int P_, int R, int PB,
    int G, float scale) {
  constexpr int D = DPL * 32;
  extern __shared__ float smem[];
  float* ks = smem;                  // [ps][D + 1]: padded rows, so lane t
                                     // reading key t hits its own bank
  float* vs = ks + ps * (D + 1);     // [ps][D]
  float* qs = vs + ps * D;           // [kWarps][D]: each warp's query
  float* kscale = qs + kWarps * D;   // [32]: kInt8's per-token key scales

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
      const int pid = min(max(trow[j], 0), P_ - 1);
      __syncthreads();               // the previous page is consumed
      load_page<L, P, D>(k_pages, v_pages, k_scale, v_scale, pid, h, H, ps,
                         PB, G, ks, vs, kscale);
      __syncthreads();
      if (j >= my_pages) continue;   // warp-uniform: past this query's keys
      float logit = kMask;
      if (lane < ps) {
        const float* kr = ks + lane * (D + 1);
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qw[d], kr[d], dot);
        if constexpr (L == kInt8) dot *= kscale[lane];
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

template <typename T, typename P, int L, int DPL>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* table,
                   const int* row_of, const int* start, void* out, int N,
                   int W, int H, int ps, int MP, int P_, int R, int PB, int G,
                   float scale, cudaStream_t stream) {
  constexpr int D = DPL * 32;
  const size_t smem =
      sizeof(float) * (ps * (D + 1) + ps * D + kWarps * D + 32);
  auto kernel = ragged_paged_attention_kernel<T, P, L, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(N, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(kp),
      static_cast<const P*>(vp), ks, vs, table, row_of, start,
      static_cast<T*>(out), W, H, ps, MP, P_, R, PB, G, scale);
  return cudaGetLastError();
}

template <typename T, typename P, int L>
cudaError_t dispatch_d(int D, const void* q, const void* kp, const void* vp,
                       const float* ks, const float* vs, const int* table,
                       const int* row_of, const int* start, void* out, int N,
                       int W, int H, int ps, int MP, int P_, int R, int PB,
                       int G, float scale, cudaStream_t stream) {
#define RPA_CASE(DPL)                                                       \
  return launch<T, P, L, DPL>(q, kp, vp, ks, vs, table, row_of, start, out, \
                              N, W, H, ps, MP, P_, R, PB, G, scale, stream)
  switch (D) {
    case 32: RPA_CASE(1);
    case 64: RPA_CASE(2);
    case 128: RPA_CASE(4);
    case 256: RPA_CASE(8);
    default: return cudaErrorInvalidValue;
  }
#undef RPA_CASE
}

template <typename T>
cudaError_t dispatch_layout(int layout, int D, const void* q, const void* kp,
                            const void* vp, const float* ks, const float* vs,
                            const int* table, const int* row_of,
                            const int* start, void* out, int N, int W, int H,
                            int ps, int MP, int P_, int R, int PB, int G,
                            float scale, cudaStream_t s) {
  switch (layout) {
    case kPlain:
      return dispatch_d<T, T, kPlain>(D, q, kp, vp, ks, vs, table, row_of,
                                      start, out, N, W, H, ps, MP, P_, R, PB,
                                      G, scale, s);
    case kInt8:
      if (!ks || !vs) return cudaErrorInvalidValue;
      return dispatch_d<T, int8_t, kInt8>(D, q, kp, vp, ks, vs, table,
                                          row_of, start, out, N, W, H, ps, MP,
                                          P_, R, PB, G, scale, s);
    case kInt4:
      if (!ks || !vs || G < 1 || (2 * PB) % G || 2 * PB < H * D)
        return cudaErrorInvalidValue;
      return dispatch_d<T, uint8_t, kInt4>(D, q, kp, vp, ks, vs, table,
                                           row_of, start, out, N, W, H, ps,
                                           MP, P_, R, PB, G, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out share it; a kPlain pool too).
// layout: 0 plain, 1 int8 (k_scale/v_scale [P, ps]), 2 int4 (pages [P, ps,
// PB] uint8, k_scale/v_scale [P, ps, G]); PB and G are read for int4 only.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int rpa_forward(const void* q, const void* k_pages,
                           const void* v_pages, const float* k_scale,
                           const float* v_scale, const int* table,
                           const int* row_of, const int* start, void* out,
                           int N, int W, int H, int D, int ps, int MP, int P,
                           int R, int PB, int G, float scale, int dtype,
                           int layout, int device, void* stream) {
  if (ps < 1 || ps > 32 || N < 1 || W < 1 || MP < 1 || P < 1 || R < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_layout<float>(layout, D, q, k_pages, v_pages, k_scale,
                                  v_scale, table, row_of, start, out, N, W, H,
                                  ps, MP, P, R, PB, G, scale, s);
  if (dtype == 1)
    return dispatch_layout<__nv_bfloat16>(layout, D, q, k_pages, v_pages,
                                          k_scale, v_scale, table, row_of,
                                          start, out, N, W, H, ps, MP, P, R,
                                          PB, G, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* rpa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
