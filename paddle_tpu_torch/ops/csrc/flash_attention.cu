// Flash attention forward, dQ and dK/dV for Hopper (sm_90a), f32 and bf16.
//
// Replaces the three TPU kernels of paddle_tpu/ops/attention.py:
//   _fwd_kernel      -> flash_fwd_kernel      (out + f32 log-sum-exp)
//   _bwd_dq_kernel   -> flash_dq_kernel       (dQ, P recomputed from lse)
//   _bwd_dkv_kernel  -> flash_dkv_kernel      (dK, dV for one key tile)
// Layout is the JAX package's: q/out/dO [B, Lq, Hq, D], k/v [B, Lk, Hkv, D],
// with Hq % Hkv == 0 (query head h reads key/value head h / (Hq / Hkv), the
// repeat-interleave GQA of mha_reference). lse and delta are f32
// [B, Hq, Lq], which is the JAX kernels' folded [B, Hkv, G*Lq] in the same
// memory order.
//
// Math, as the TPU bodies do it, every dot in f32:
//   forward  s = (q*scale).k + bias, causal/ragged-masked to -1e30; online
//            softmax over key tiles (m, l, acc), masked p forced to 0; l
//            sums the undropped p, P.V takes p * keep / (1 - rate);
//            out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
//   dQ       s = (q.k)*scale + bias, p = exp(s - lse), dp = dO.v * keep /
//            (1 - rate), ds = p*(dp - delta)*scale, dq = sum_k ds.k
//   dK/dV    dv = sum_q (p * keep / (1 - rate)).dO, dk = sum_q ds.q over
//            every query head of the group and every query tile at or
//            after the key tile (causal).
// delta = sum(dO*out) per row is computed by the wrapper (a torch op), as
// the JAX wrapper computes it outside its kernels.
//
// The optional operands, each a template branch so that the plain
// instantiation (GPT) compiles as it did without them:
//   BIAS 1  kvb [Bm, Lk] f32, an additive bias per key (padding masks),
//           Bm in {1, B};
//   BIAS 2  fb [Bm, Hm, Lq, Lk] f32, a full additive bias, Hm in {1, Hq},
//           indexed by the query head directly (no GQA pre-fold);
//   DROP    dropout on the probabilities from the JAX counter hash:
//           salt = h32(seed ^ b*0xC2B2AE3D ^ h_kv*0x27D4EB2F),
//           keep = h32(frow*0x9E3779B1 ^ col*0x85EBCA77 ^ salt) >= thresh,
//           frow = (hq % G)*Lq + row, col the absolute key; uint32
//           wraparound throughout. The backward regenerates the mask.
// A bias is not a mask: BERT's -1e4 leaves p = exp(s - m) non-zero; only
// causal and ragged positions force p = 0.
//
// Ragged lengths: the JAX wrapper pads L to a multiple of 128 and masks the
// padded keys with a -1e30 bias; here the kernels mask keys >= Lk and skip
// query rows >= Lq themselves, which gives the same outputs (a padded key's
// p is 0; a padded query row's dO is 0, so it adds nothing to dK/dV). The
// dropout row counter folds over the real Lq, as mha_reference does.
//
// dQ and dK/dV are separate kernels with no atomics: every output element is
// summed by one thread in a fixed order, so gradients are identical from run
// to run.
//
// Bound: operations at GPT's training shape (B 8, L 1024, H 16, D 128,
// causal: 34 GFLOP over 0.1 GB), bytes at BERT's (B 32, L 512, H 12, D 64,
// 25.8 GFLOP over ~0.1 GB of bf16 q/k/v/out plus the bias). This first
// design does the dots on the CUDA cores in f32 (SIMT), not on the tensor
// cores: one 64x64 tile of scores per block, 256 threads as a 16x16 grid,
// each thread 4x4 scores and 4 rows x D/16 columns of the output tile,
// operands staged through shared memory (rows padded to D+1 floats so the
// 16 lanes that read 16 different rows hit 16 different banks). Causal
// tiles past the diagonal are skipped. So its ceiling is the f32 FMA rate
// (67 TFLOP/s), not the bf16 tensor-core rate (989); wgmma with TMA-fed
// tiles is later work (PERF.md). The hash costs ~12 integer ops a score.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // a 16 x 16 grid of threads
constexpr float kNeg = -1e30f;
constexpr float kDenomEps = 1e-30f;
constexpr int kNoBias = 0, kKvb = 1, kFb = 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// max / sum over the 16 lanes that share one score row (tx = lane % 16)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// lowbias32, the JAX _hash32
__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ uint32_t drop_salt(uint32_t seed, int b, int hk) {
  return hash32(seed ^ (static_cast<uint32_t>(b) * 0xC2B2AE3Du) ^
                (static_cast<uint32_t>(hk) * 0x27D4EB2Fu));
}
__device__ __forceinline__ bool drop_keep(uint32_t salt, int frow, int col,
                                          uint32_t thresh) {
  return hash32((static_cast<uint32_t>(frow) * 0x9E3779B1u) ^
                (static_cast<uint32_t>(col) * 0x85EBCA77u) ^ salt) >= thresh;
}

struct Dims {
  int B, Lq, Lk, Hq, Hkv, causal;
  float scale;
};

// The optional operands; kvb_b / fb_b / fb_h: the bias has a batch /
// head axis of its own (else it is broadcast).
struct Extra {
  const float* kvb;
  const float* fb;
  int kvb_b, fb_b, fb_h;
  uint32_t seed, thresh;
  float keep_scale;                  // f32 1 / (1 - rate)
};

// The bias rows of (batch b, query head hq): kvb [Lk], fb [Lq][Lk].
__device__ __forceinline__ const float* kvb_row(const Extra& ex,
                                                const Dims& dm, int b) {
  return ex.kvb + static_cast<size_t>(ex.kvb_b ? b : 0) * dm.Lk;
}
__device__ __forceinline__ const float* fb_plane(const Extra& ex,
                                                 const Dims& dm, int b,
                                                 int hq) {
  const int hm = ex.fb_h ? dm.Hq : 1;
  return ex.fb + (static_cast<size_t>(ex.fb_b ? b : 0) * hm +
                  (ex.fb_h ? hq : 0)) * dm.Lq * dm.Lk;
}

// The bias of score (qpos, kpos), 0 outside [Lq) x [Lk).
template <int BIAS>
__device__ __forceinline__ float bias_at(const float* kvb, const float* fb,
                                         const Dims& dm, int qpos, int kpos) {
  if (kpos >= dm.Lk) return 0.f;
  if (BIAS == kKvb) return kvb[kpos];
  return qpos < dm.Lq ? fb[static_cast<size_t>(qpos) * dm.Lk + kpos] : 0.f;
}

// Copy rows [r0, r0 + rows) of one head of a [B, L, H, D] tensor into a
// shared tile of row stride `ld` floats, times `mul`; rows past L read 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int b, int r0, int rows, int L,
                                          int H, int h, float mul) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D, row = r0 + r;
    float x = 0.f;
    if (row < L)
      x = to_f32(src[((static_cast<size_t>(b) * L + row) * H + h) * D + d]) *
          mul;
    dst[r * ld + d] = x;
  }
}

// TM: score rows (and columns) per thread; the tile is BT = 16*TM square.
template <typename T, int D, int TM, int BIAS, bool DROP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, Dims dm, Extra ex) {
  constexpr int BT = 16 * TM, DP = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                // [BT][DP] q * scale
  float* ks = qs + BT * DP;        // [BT][DP] k; then p [BT][BT + 1]
  float* vs = ks + BT * DP;        // [BT][D]
  float* ps = ks;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BT, hq = blockIdx.y, b = blockIdx.z;
  const int G = dm.Hq / dm.Hkv, hk = hq / G;
  const float* kvb = BIAS == kKvb ? kvb_row(ex, dm, b) : nullptr;
  const float* fb = BIAS == kFb ? fb_plane(ex, dm, b, hq) : nullptr;
  const uint32_t salt = DROP ? drop_salt(ex.seed, b, hk) : 0u;
  const int frow0 = (hq % G) * dm.Lq;

  load_tile<T, D>(qs, DP, q, b, q0, BT, dm.Lq, dm.Hq, hq, dm.scale);
  float m[TM], l[TM], acc[TM][DC];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int n_k = (dm.Lk + BT - 1) / BT;
  const int q_end = min(q0 + BT, dm.Lq);
  const int n_live = dm.causal ? min((q_end + BT - 1) / BT, n_k) : n_k;
  for (int kt = 0; kt < n_live; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();                         // p and v of the last tile used
    load_tile<T, D>(ks, DP, k, b, k0, BT, dm.Lk, dm.Hkv, hk, 1.f);
    load_tile<T, D>(vs, D, v, b, k0, BT, dm.Lk, dm.Hkv, hk, 1.f);
    __syncthreads();
    float s[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[TM], c[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < TM; ++j) c[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
    __syncthreads();                         // ks is rewritten as p below
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool valid[TM];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int kpos = k0 + tx + 16 * j;
        valid[j] = kpos < dm.Lk && (!dm.causal || qpos >= kpos);
        if (BIAS != kNoBias)
          s[i][j] += bias_at<BIAS>(kvb, fb, dm, qpos, kpos);
        if (!valid[j]) s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;                            // l sums the undropped p
        if (DROP)
          p = drop_keep(salt, frow0 + qpos, k0 + tx + 16 * j, ex.thresh)
                  ? p * ex.keep_scale : 0.f;
        ps[(ty + 16 * i) * (BT + 1) + tx + 16 * j] = p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float p = ps[(ty + 16 * i) * (BT + 1) + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= dm.Lq) continue;
    const float lsafe = fmaxf(l[i], kDenomEps);
    T* orow = out + ((static_cast<size_t>(b) * dm.Lq + row) * dm.Hq + hq) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(orow + tx + 16 * c, acc[i][c] / lsafe);
    if (tx == 0)
      lse[(static_cast<size_t>(b) * dm.Hq + hq) * dm.Lq + row] =
          m[i] + logf(lsafe);
  }
}

template <typename T, int D, int TM, int BIAS, bool DROP>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, Dims dm, Extra ex) {
  constexpr int BT = 16 * TM, DP = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                // [BT][DP]
  float* dos = qs + BT * DP;       // [BT][DP]
  float* ks = dos + BT * DP;       // [BT][DP]
  float* vs = ks + BT * DP;        // [BT][DP]; then ds [BT][BT + 1]
  float* dss = vs;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BT, hq = blockIdx.y, b = blockIdx.z;
  const int G = dm.Hq / dm.Hkv, hk = hq / G;
  const float* kvb = BIAS == kKvb ? kvb_row(ex, dm, b) : nullptr;
  const float* fb = BIAS == kFb ? fb_plane(ex, dm, b, hq) : nullptr;
  const uint32_t salt = DROP ? drop_salt(ex.seed, b, hk) : 0u;
  const int frow0 = (hq % G) * dm.Lq;

  load_tile<T, D>(qs, DP, q, b, q0, BT, dm.Lq, dm.Hq, hq, 1.f);
  load_tile<T, D>(dos, DP, dout, b, q0, BT, dm.Lq, dm.Hq, hq, 1.f);
  float lse_r[TM], delta_r[TM], acc[TM][DC];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty + 16 * i;
    const size_t at = (static_cast<size_t>(b) * dm.Hq + hq) * dm.Lq + row;
    lse_r[i] = row < dm.Lq ? lse[at] : 0.f;
    delta_r[i] = row < dm.Lq ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int n_k = (dm.Lk + BT - 1) / BT;
  const int q_end = min(q0 + BT, dm.Lq);
  const int n_live = dm.causal ? min((q_end + BT - 1) / BT, n_k) : n_k;
  for (int kt = 0; kt < n_live; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();                         // ds and k of the last tile used
    load_tile<T, D>(ks, DP, k, b, k0, BT, dm.Lk, dm.Hkv, hk, 1.f);
    load_tile<T, D>(vs, DP, v, b, k0, BT, dm.Lk, dm.Hkv, hk, 1.f);
    __syncthreads();
    float s[TM][TM], dp[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a[TM], g[TM], kc[TM], vc[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a[i] = qs[(ty + 16 * i) * DP + d];
        g[i] = dos[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        kc[j] = ks[(tx + 16 * j) * DP + d];
        vc[j] = vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          s[i][j] = fmaf(a[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vc[j], dp[i][j]);
        }
    }
    __syncthreads();                         // vs is rewritten as ds below
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = kpos < dm.Lk && (!dm.causal || qpos >= kpos);
        // the no-bias form is kept as one expression: it compiles to the
        // registers the plain kernel had (123 at D 128)
        float p;
        if (BIAS == kNoBias) {
          p = valid ? expf(s[i][j] * dm.scale - lse_r[i]) : 0.f;
        } else {
          const float sv = s[i][j] * dm.scale +
                           bias_at<BIAS>(kvb, fb, dm, qpos, kpos);
          p = valid ? expf(sv - lse_r[i]) : 0.f;
        }
        float dpv = dp[i][j];
        if (DROP)
          dpv *= drop_keep(salt, frow0 + qpos, kpos, ex.thresh)
                     ? ex.keep_scale : 0.f;
        dss[(ty + 16 * i) * (BT + 1) + tx + 16 * j] =
            p * (dpv - delta_r[i]) * dm.scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = ks[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float ds = dss[(ty + 16 * i) * (BT + 1) + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= dm.Lq) continue;
    T* orow = dq + ((static_cast<size_t>(b) * dm.Lq + row) * dm.Hq + hq) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(orow + tx + 16 * c, acc[i][c]);
  }
}

template <typename T, int D, int TM, int BIAS, bool DROP>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    Dims dm, Extra ex) {
  constexpr int BT = 16 * TM, DP = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;                // [BT][DP] this block's keys
  float* vs = ks + BT * DP;        // [BT][DP]
  float* qs = vs + BT * DP;        // [BT][DP] the current query tile
  float* dos = qs + BT * DP;       // [BT][DP]
  float* ps = dos + BT * DP;       // [BT keys][BT + 1 queries]
  float* dss = ps + BT * (BT + 1);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * BT, hk = blockIdx.y, b = blockIdx.z;
  const int G = dm.Hq / dm.Hkv;
  const float* kvb = BIAS == kKvb ? kvb_row(ex, dm, b) : nullptr;
  const uint32_t salt = DROP ? drop_salt(ex.seed, b, hk) : 0u;

  load_tile<T, D>(ks, DP, k, b, k0, BT, dm.Lk, dm.Hkv, hk, 1.f);
  load_tile<T, D>(vs, DP, v, b, k0, BT, dm.Lk, dm.Hkv, hk, 1.f);
  float dk_acc[TM][DC], dv_acc[TM][DC];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  const int n_q = (dm.Lq + BT - 1) / BT;
  // query tiles that end before this key tile starts are fully masked
  const int qt0 = dm.causal ? k0 / BT : 0;
  for (int g = 0; g < G; ++g) {
    const int hq = hk * G + g;
    const float* fb = BIAS == kFb ? fb_plane(ex, dm, b, hq) : nullptr;
    for (int qt = qt0; qt < n_q; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();                       // q, dO, p, ds of the last tile
      load_tile<T, D>(qs, DP, q, b, q0, BT, dm.Lq, dm.Hq, hq, 1.f);
      load_tile<T, D>(dos, DP, dout, b, q0, BT, dm.Lq, dm.Hq, hq, 1.f);
      float lse_c[TM], delta_c[TM];
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int row = q0 + tx + 16 * j;
        const size_t at = (static_cast<size_t>(b) * dm.Hq + hq) * dm.Lq + row;
        lse_c[j] = row < dm.Lq ? lse[at] : 0.f;
        delta_c[j] = row < dm.Lq ? delta[at] : 0.f;
      }
      __syncthreads();
      // s[i][j]: key ty + 16 i against query tx + 16 j
      float s[TM][TM], dp[TM][TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float kr[TM], vr[TM], qc[TM], gc[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          kr[i] = ks[(ty + 16 * i) * DP + d];
          vr[i] = vs[(ty + 16 * i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          qc[j] = qs[(tx + 16 * j) * DP + d];
          gc[j] = dos[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j) {
            s[i][j] = fmaf(qc[j], kr[i], s[i][j]);
            dp[i][j] = fmaf(gc[j], vr[i], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int kpos = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const int qpos = q0 + tx + 16 * j;
          const bool valid = kpos < dm.Lk && qpos < dm.Lq &&
                             (!dm.causal || qpos >= kpos);
          float p;                           // as in dQ (154 at D 128)
          if (BIAS == kNoBias) {
            p = valid ? expf(s[i][j] * dm.scale - lse_c[j]) : 0.f;
          } else {
            const float sv = s[i][j] * dm.scale +
                             bias_at<BIAS>(kvb, fb, dm, qpos, kpos);
            p = valid ? expf(sv - lse_c[j]) : 0.f;
          }
          float pd = p, dpv = dp[i][j];
          if (DROP) {
            const float f = drop_keep(salt, g * dm.Lq + qpos, kpos, ex.thresh)
                                ? ex.keep_scale : 0.f;
            pd = p * f;
            dpv *= f;
          }
          const int at = (ty + 16 * i) * (BT + 1) + tx + 16 * j;
          ps[at] = pd;
          dss[at] = p * (dpv - delta_c[j]) * dm.scale;
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int qq = 0; qq < BT; ++qq) {
        float qv[DC], gv[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          qv[c] = qs[qq * DP + tx + 16 * c];
          gv[c] = dos[qq * DP + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float p = ps[(ty + 16 * i) * (BT + 1) + qq];
          const float ds = dss[(ty + 16 * i) * (BT + 1) + qq];
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv_acc[i][c] = fmaf(p, gv[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(ds, qv[c], dk_acc[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= dm.Lk) continue;
    const size_t at = ((static_cast<size_t>(b) * dm.Lk + row) * dm.Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      store(dk + at + tx + 16 * c, dk_acc[i][c]);
      store(dv + at + tx + 16 * c, dv_acc[i][c]);
    }
  }
}

// The keep-mask [B, Hq, Lq, Lk] from the same device functions the kernels
// call, for holding the card's hash against the plain version's.
__global__ void dropout_keep_kernel(uint8_t* __restrict__ keep, int B, int Hq,
                                    int Hkv, int Lq, int Lk, uint32_t seed,
                                    uint32_t thresh) {
  const size_t n = static_cast<size_t>(B) * Hq * Lq * Lk;
  const int G = Hq / Hkv;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int col = static_cast<int>(e % Lk);
    const int row = static_cast<int>((e / Lk) % Lq);
    const int hq = static_cast<int>((e / (static_cast<size_t>(Lk) * Lq)) % Hq);
    const int b = static_cast<int>(e / (static_cast<size_t>(Lk) * Lq * Hq));
    keep[e] = drop_keep(drop_salt(seed, b, hq / G), (hq % G) * Lq + row, col,
                        thresh);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Args {
  const void *q, *k, *v, *dout;
  float* lse;
  const float* delta;
  void *o0, *o1;
};

// which: 0 forward, 1 dQ, 2 dK/dV
template <typename T, int D, int TM, int BIAS, bool DROP>
cudaError_t launch(int which, const Args& a, Dims dm, Extra ex,
                   cudaStream_t st) {
  constexpr int BT = 16 * TM, DP = D + 1;
  const T* qp = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const T* gp = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (which == 0) {
    const size_t smem = sizeof(float) * (2 * BT * DP + BT * D);
    auto kern = flash_fwd_kernel<T, D, TM, BIAS, DROP>;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<dim3((dm.Lq + BT - 1) / BT, dm.Hq, dm.B), kThreads, smem, st>>>(
        qp, kp, vp, static_cast<T*>(a.o0), a.lse, dm, ex);
  } else if (which == 1) {
    const size_t smem = sizeof(float) * 4 * BT * DP;
    auto kern = flash_dq_kernel<T, D, TM, BIAS, DROP>;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<dim3((dm.Lq + BT - 1) / BT, dm.Hq, dm.B), kThreads, smem, st>>>(
        qp, kp, vp, gp, a.lse, a.delta, static_cast<T*>(a.o0), dm, ex);
  } else {
    const size_t smem = sizeof(float) * (4 * BT * DP + 2 * BT * (BT + 1));
    auto kern = flash_dkv_kernel<T, D, TM, BIAS, DROP>;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<dim3((dm.Lk + BT - 1) / BT, dm.Hkv, dm.B), kThreads, smem, st>>>(
        qp, kp, vp, gp, a.lse, a.delta, static_cast<T*>(a.o0),
        static_cast<T*>(a.o1), dm, ex);
  }
  return cudaGetLastError();
}

template <typename T, int D, int TM>
cudaError_t dispatch_extra(int which, const Args& a, Dims dm, Extra ex,
                           int bias, bool drop, cudaStream_t st) {
  switch (bias * 2 + (drop ? 1 : 0)) {
    case 0: return launch<T, D, TM, kNoBias, false>(which, a, dm, ex, st);
    case 1: return launch<T, D, TM, kNoBias, true>(which, a, dm, ex, st);
    case 2: return launch<T, D, TM, kKvb, false>(which, a, dm, ex, st);
    case 3: return launch<T, D, TM, kKvb, true>(which, a, dm, ex, st);
    case 4: return launch<T, D, TM, kFb, false>(which, a, dm, ex, st);
    case 5: return launch<T, D, TM, kFb, true>(which, a, dm, ex, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int which, int D, const Args& a, Dims dm, Extra ex,
                     int bias, bool drop, cudaStream_t st) {
  switch (D) {
    case 64:
      return dispatch_extra<T, 64, 4>(which, a, dm, ex, bias, drop, st);
    case 128:
      return dispatch_extra<T, 128, 4>(which, a, dm, ex, bias, drop, st);
    case 256:
      return dispatch_extra<T, 256, 2>(which, a, dm, ex, bias, drop, st);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(int which, const Args& a, const float* kvb, const float* fb, int B,
        int Lq, int Lk, int Hq, int Hkv, int D, int causal, int kvb_b,
        int fb_b, int fb_h, float scale, uint32_t seed, uint32_t thresh,
        float keep_scale, int dtype, int device, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv ||
      B > 65535 || Hq > 65535 || (kvb && fb))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Dims dm{B, Lq, Lk, Hq, Hkv, causal ? 1 : 0, scale};
  const Extra ex{kvb, fb, kvb_b, fb_b, fb_h, seed, thresh, keep_scale};
  const int bias = kvb ? kKvb : fb ? kFb : kNoBias;
  const bool drop = thresh != 0u;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(which, D, a, dm, ex, bias, drop, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(which, D, a, dm, ex, bias, drop, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs share it).
// kvb / fb: null or the f32 bias (at most one); kvb_b, fb_b, fb_h: the bias
// has its own batch / head axis. thresh: the dropout keep threshold,
// min(int(rate * 2^32), 2^32 - 1), 0 for no dropout; keep_scale: f32
// 1 / (1 - rate); seed: the uint32 seed. Each returns the cudaError_t of
// its launch (0 = launched).
#define FLASH_TAIL                                                          \
  int B, int Lq, int Lk, int Hq, int Hkv, int D, int causal, int kvb_b,     \
      int fb_b, int fb_h, float scale, uint32_t seed, uint32_t thresh,      \
      float keep_scale, int dtype, int device, void* stream
#define FLASH_PASS                                                          \
  B, Lq, Lk, Hq, Hkv, D, causal, kvb_b, fb_b, fb_h, scale, seed, thresh,    \
      keep_scale, dtype, device, stream

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const float* kvb, const float* fb, void* out,
                         float* lse, FLASH_TAIL) {
  const Args a{q, k, v, nullptr, lse, nullptr, out, nullptr};
  return run(0, a, kvb, fb, FLASH_PASS);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const float* kvb,
                            const float* fb, void* dq, FLASH_TAIL) {
  const Args a{q, k, v, dout, const_cast<float*>(lse), delta, dq, nullptr};
  return run(1, a, kvb, fb, FLASH_PASS);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const float* kvb,
                             const float* fb, void* dk, void* dv,
                             FLASH_TAIL) {
  const Args a{q, k, v, dout, const_cast<float*>(lse), delta, dk, dv};
  return run(2, a, kvb, fb, FLASH_PASS);
}

extern "C" int flash_dropout_keep(uint8_t* keep, int B, int Hq, int Hkv,
                                  int Lq, int Lk, uint32_t seed,
                                  uint32_t thresh, int device, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || Hq % Hkv)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  dropout_keep_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      keep, B, Hq, Hkv, Lq, Lk, seed, thresh);
  return cudaGetLastError();
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
