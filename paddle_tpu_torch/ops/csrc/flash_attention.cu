// Flash attention forward, dQ and dK/dV for Hopper (sm_90a), f32 and bf16.
//
// Replaces the three TPU kernels of paddle_tpu/ops/attention.py:
//   _fwd_kernel      -> flash_fwd_tc_kernel   (bf16; out + f32 log-sum-exp)
//                       flash_fwd_kernel      (f32)
//   _bwd_dq_kernel   -> flash_dq_tc_kernel    (bf16, head_dim 64 and 128;
//                                              dQ, P recomputed from lse)
//                       flash_dq_kernel       (f32; bf16 at head_dim 256)
//   _bwd_dkv_kernel  -> flash_dkv_tc_kernel   (bf16, head_dim 64 and 128;
//                                              dK, dV for one key tile)
//                       flash_dkv_kernel      (f32; bf16 at head_dim 256)
// Layout is the JAX package's: q/out/dO [B, Lq, Hq, D], k/v [B, Lk, Hkv, D],
// with Hq % Hkv == 0 (query head h reads key/value head h / (Hq / Hkv), the
// repeat-interleave GQA of mha_reference). lse and delta are f32
// [B, Hq, Lq], which is the JAX kernels' folded [B, Hkv, G*Lq] in the same
// memory order.
//
// Math, as the TPU bodies do it, every dot in f32 (the f32 route):
//   forward  s = (q*scale).k + bias, causal/ragged-masked to -1e30; online
//            softmax over key tiles (m, l, acc), masked p forced to 0; l
//            sums the undropped p, P.V takes p * keep / (1 - rate);
//            out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
//   dQ       s = (q.k)*scale + bias, p = exp(s - lse), dp = dO.v * keep /
//            (1 - rate), ds = p*(dp - delta)*scale, dq = sum_k ds.k
//   dK/dV    dv = sum_q (p * keep / (1 - rate)).dO, dk = sum_q ds.q over
//            every query head of the group and every query tile at or
//            after the key tile (causal).
// The bf16 forward (`flash_fwd_tc_kernel`) runs on the tensor cores with
// these rounding points, which its plain version `_fwd_ref` follows for
// bf16 inputs (64-key tiles, as here):
//   1. s = (q.k)*scale: bf16 mma on q and k as stored (the products are
//      exact in f32, the sum is f32), the scale on the f32 score after
//      the dot, as dQ and dK/dV recompute s; so the lse it saves agrees
//      with their p up to the order of the f32 sums. q*scale is never
//      rounded to bf16.
//   2. p_use (p, or p * keep / (1 - rate)) is rounded to bf16 (nearest)
//      for P.V, which accumulates in f32; l sums the unrounded,
//      undropped f32 p. This is the one new rounding point; the JAX
//      `mha_reference` rounds its probabilities before P.V too.
//   3. Bias, the -1e30 mask, masked p forced to 0, the 1e-30 floor and the
//      dropout hash at (frow, col) are as above.
// The bf16 dQ and dK/dV (`flash_dq_tc_kernel`, `flash_dkv_tc_kernel`)
// run on the tensor cores with these rounding points, which their plain
// version `_bwd_ref` follows for bf16 inputs. p comes from the final
// lse, not a running max, so no rounding depends on how keys or queries
// are tiled:
//   1. s = (q.k)*scale: bf16 mma on q and k as stored, the scale on the
//      f32 score; p = exp(s + bias - lse) in f32.
//   2. dp = dO.v: bf16 mma on the stored values, an f32 sum, times
//      keep / (1 - rate).
//   3. dS = p*(dp - delta)*scale in f32, as the JAX body writes it, then
//      rounded to bf16 (nearest) for dS.K and dS^T.Q.
//   4. p_use = p * keep / (1 - rate), or p, rounded to bf16 for
//      p_use^T.dO.
//   5. Every product accumulates in f32, across key tiles (dQ) or across
//      query tiles and the group's query heads (dK, dV); the result is
//      rounded once at the store.
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
// summed by one thread (one lane's accumulator on the tensor cores) in a
// fixed order, so gradients are identical from run to run. That costs
// work: S and dP are computed in both kernels, 14 D flops a (query, key)
// pair against 10 D for a one-pass backward with an atomic dQ.
//
// Bound: operations. The forward at GPT's training shape (B 8, L 1024, H
// 16, D 128, causal) does 34 GFLOP over 0.1 GB, at BERT's (B 32, L 512, H
// 12, D 64) 25.8 GFLOP over ~0.1 GB of bf16 q/k/v/out plus the bias; dQ
// and dK/dV together 14 D flops a pair, 120 GFLOP at GPT's shape.
//
// The route is chosen by dtype, and for the backward by head_dim, in
// `launch` (a choice, not a fallback):
//   bf16 forward -> `flash_fwd_tc_kernel`, bf16 tensor cores: a block of
//     4 warps owns 64 query rows, each warp 16 (FA2's split): S = Q K^T
//     over a 64-key tile with mma.sync m16n8k16 (f32 accumulate) into 32
//     registers a lane, the online softmax on them (m and l per row in
//     registers, the 4 lanes of a quad sharing a row), then O += P V with
//     P taken from the score registers as bf16 A fragments (the C layout
//     of two n8 tiles is the A layout of one k16 step). K and V tiles
//     come through a 2-stage 16-byte cp.async ring into 128-byte-swizzled
//     shared memory (ldmatrix, .trans for V, without bank conflicts); Q
//     stays in shared memory. Tiles past the diagonal are skipped, and
//     only a tile that reaches past Lk or the diagonal is masked (a
//     warp-uniform test). At GPT's shape it runs at ~0.13 of the bf16
//     peak: 4 warps a block, each reading all of K and V from shared
//     memory for its 16 rows.
//   bf16 dQ -> `flash_dq_tc_kernel`, the forward's shape: 4 warps x 16
//     query rows, Q and dO in shared memory, K and V tiles of 64 keys
//     (and their kvb row, read from shared memory rather than held in
//     registers) through the 2-stage cp.async ring; S = Q K^T and dP =
//     dO V^T on mma.sync into 32 + 32 registers a lane, dS formed there
//     and fed to dQ += dS K as bf16 A fragments (K through ldmatrix
//     .trans); dQ takes 64 f32 a lane at D 128.
//   bf16 dK/dV -> `flash_dkv_tc_kernel`: a block owns 64 keys (16 a
//     warp) with K and V in shared memory and walks (query head of the
//     group, query tile) in order, Q, dO, lse and delta streaming through
//     a 2-stage cp.async ring; S^T = K Q^T and dP^T = V dO^T with keys as
//     rows, then dV += p_use^T dO and dK += dS^T Q from registers. The
//     registers set the query tile: dK + dV take 2 x 16 x D / 32 f32 a
//     lane (128 at D 128), so a tile is 32 queries at D 128 (S^T and dP^T
//     16 + 16) and 64 at D 64. In the transposed tiles the hash is still
//     drop_keep(salt, g*Lq + qpos, kpos) and fb is read at [qpos, kpos].
//   f32 forward, dQ and dK/dV, and bf16 dQ and dK/dV at head_dim 256 (a
//     route chosen by head_dim: the dK + dV accumulators, 256 f32 a lane
//     at 16 keys a warp, do not fit beside the scores) -> SIMT bodies on
//     the CUDA cores: one 64x64 tile of scores per block (32x32 at D
//     256), 256 threads as a 16x16 grid, each thread 4x4 scores and 4
//     rows x D/16 columns of the output tile, operands staged as f32
//     through shared memory (rows padded to D+1 floats so the 16 lanes
//     that read 16 different rows hit 16 different banks). Their ceiling
//     is the f32 FMA rate (67 TFLOP/s). The hash costs ~12 integer ops a
//     score.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_tile.cuh"

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

// ------------------------------------------------ bf16 forward: tensor cores

constexpr int kTcQ = 64;            // query rows a block (16 a warp)
constexpr int kTcK = 64;            // keys a tile (the plain walk's
                                    // `_TC_BLOCK`)
constexpr int kTcThreads = 128;

// Rows [r0, r0 + ROWS) of one head of a bf16 [B, L, H, D] tensor into a
// swizzled tile of D * 2-byte rows, with 16-byte cp.async; rows >= L are 0.
template <int D, int ROWS = kTcK>
__device__ __forceinline__ void tc_load_rows(unsigned char* dst,
                                             const __nv_bfloat16* src, int b,
                                             int r0, int L, int H, int h) {
  constexpr int CH = D / 8;                   // 16-byte chunks a row
  for (int c = threadIdx.x; c < ROWS * CH; c += kTcThreads) {
    const int r = c / CH, ch = c % CH, row = r0 + r;
    const bool ok = row < L;
    const __nv_bfloat16* g =
        ok ? src + ((static_cast<size_t>(b) * L + row) * H + h) * D + 8 * ch
           : src;
    tc::cp_async16(dst + tc::swz(r, ch, 2 * D), g, ok ? 16 : 0);
  }
}

// The bf16 A fragment of k16 step kk from the C fragments of two n8 tiles
// (rounded to nearest).
template <int N>
__device__ __forceinline__ void tc_a_frag(uint32_t (&a)[4],
                                          const float (&c)[N][4], int kk) {
  a[0] = tc::pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = tc::pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = tc::pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = tc::pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// acc[16 x D] += A (16 x 16, from registers) . X[16 rows from `r0`][D] of
// a swizzled shared tile (X read transposed: its rows are the k axis).
template <int D>
__device__ __forceinline__ void tc_mma_rows(float (&acc)[D / 8][4],
                                            const uint32_t (&a)[4],
                                            const unsigned char* x, int r0,
                                            int lane) {
#pragma unroll
  for (int dd = 0; dd < D / 16; ++dd) {
    uint32_t bb[4];
    tc::ldmatrix_x4_trans(bb, x + tc::swz(r0 + (lane & 7) +
                                              8 * ((lane >> 3) & 1),
                                          2 * dd + (lane >> 4), 2 * D));
    tc::mma_bf16(acc[2 * dd], a, bb[0], bb[1]);
    tc::mma_bf16(acc[2 * dd + 1], a, bb[2], bb[3]);
  }
}

// Each warp owns 16 query rows: S = Q K^T over a 64-key tile in registers
// (8 n8 tiles), the online softmax on them, then O += P V with P taken
// from the score registers as bf16 A fragments. K and V tiles come through
// a 2-stage cp.async ring; Q stays in shared memory.
template <int D, int BIAS, bool DROP>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, Dims dm, Extra ex) {
  constexpr int RB = 2 * D;                   // bytes a row
  constexpr int TILE = kTcK * RB;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* qs = tc_smem;                // [64][D]
  unsigned char* kvs = tc_smem + TILE;        // stage s: K, then V
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTcQ, hq = blockIdx.y, b = blockIdx.z;
  const int G = dm.Hq / dm.Hkv, hk = hq / G;
  const float* kvb = BIAS == kKvb ? kvb_row(ex, dm, b) : nullptr;
  const float* fb = BIAS == kFb ? fb_plane(ex, dm, b, hq) : nullptr;
  const uint32_t salt = DROP ? drop_salt(ex.seed, b, hk) : 0u;
  const int frow0 = (hq % G) * dm.Lq;
  const int n_k = (dm.Lk + kTcK - 1) / kTcK;
  const int q_end = min(q0 + kTcQ, dm.Lq);
  const int n_live = dm.causal ? min((q_end + kTcK - 1) / kTcK, n_k) : n_k;

  tc_load_rows<D>(qs, q, b, q0, dm.Lq, dm.Hq, hq);
  tc_load_rows<D>(kvs, k, b, 0, dm.Lk, dm.Hkv, hk);
  tc_load_rows<D>(kvs + TILE, v, b, 0, dm.Lk, dm.Hkv, hk);
  tc::cp_async_commit();

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};     // rows g and g + 8
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const int qrow[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};

  for (int kt = 0; kt < n_live; ++kt) {
    const int k0 = kt * kTcK;
    if (kt + 1 < n_live) {
      unsigned char* nxt = kvs + ((kt + 1) & 1) * 2 * TILE;
      tc_load_rows<D>(nxt, k, b, k0 + kTcK, dm.Lk, dm.Hkv, hk);
      tc_load_rows<D>(nxt + TILE, v, b, k0 + kTcK, dm.Lk, dm.Hkv, hk);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();                          // tile kt (and Q) landed
    const unsigned char* ks = kvs + (kt & 1) * 2 * TILE;
    const unsigned char* vs = ks + TILE;

    // s = q.k over the tile: n8 tile n holds keys k0 + 8n + 2t + {0, 1}
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int d = 0; d < D / 16; ++d) {
      uint32_t a[4];
      tc::ldmatrix_x4(a, qs + tc::swz(16 * warp + (lane & 15),
                                      2 * d + (lane >> 4), RB));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        tc::ldmatrix_x4(bb, ks + tc::swz(16 * np + (lane & 7) +
                                             8 * (lane >> 4),
                                         2 * d + ((lane >> 3) & 1), RB));
        tc::mma_bf16(s[2 * np], a, bb[0], bb[1]);
        tc::mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    // the online softmax of rows g (h 0) and g + 8 (h 1); the four lanes
    // of a quad share a row. Only a tile that reaches past Lk or (causal)
    // past the warp's first row needs the mask; the test is warp-uniform.
    const bool edge = k0 + kTcK > dm.Lk ||
                      (dm.causal && k0 + kTcK - 1 > q0 + 16 * warp);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = qrow[h];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = __fmul_rn(s[n][2 * h + e], dm.scale);   // (q.k)*scale
          if (BIAS != kNoBias)
            x += bias_at<BIAS>(kvb, fb, dm, qpos, k0 + 8 * n + 2 * t + e);
          s[n][2 * h + e] = x;
        }
      if (edge) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + 8 * n + 2 * t + e;
            if (kpos >= dm.Lk || (dm.causal && qpos < kpos))
              s[n][2 * h + e] = kNeg;
          }
      }
      float mx = kNeg;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          s[n][2 * h + e] = expf(s[n][2 * h + e] - m_new);
      if (edge) {                             // masked p is 0, not exp(0)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + 8 * n + 2 * t + e;
            if (kpos >= dm.Lk || (dm.causal && qpos < kpos))
              s[n][2 * h + e] = 0.f;
          }
      }
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = s[n][2 * h + e];
          sum += p;                           // l sums the undropped p
          if (DROP)
            s[n][2 * h + e] =
                drop_keep(salt, frow0 + qpos, k0 + 8 * n + 2 * t + e,
                          ex.thresh) ? __fmul_rn(p, ex.keep_scale) : 0.f;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = expf(m[h] - m_new);
      l[h] = __fmul_rn(l[h], corr) + sum;
      m[h] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * h] *= corr;
        o[n][2 * h + 1] *= corr;
      }
    }

    // o += p.v, p rounded to bf16 (round to nearest), f32 accumulate
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk) {
      uint32_t a[4];
      tc_a_frag(a, s, kk);
      tc_mma_rows<D>(o, a, vs, 16 * kk, lane);
    }
    __syncthreads();                          // this stage is free again
  }
  tc::cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qrow[h];
    if (row >= dm.Lq) continue;
    const float lsafe = fmaxf(l[h], kDenomEps);
    __nv_bfloat16* orow =
        out + ((static_cast<size_t>(b) * dm.Lq + row) * dm.Hq + hq) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
          tc::pack_bf16(o[n][2 * h] / lsafe, o[n][2 * h + 1] / lsafe);
    if (t == 0)
      lse[(static_cast<size_t>(b) * dm.Hq + hq) * dm.Lq + row] =
          m[h] + logf(lsafe);
  }
}

// ------------------------------------------ bf16 dQ and dK/dV: tensor cores

// One score of a C fragment, from s = q.k and dp = dO.v (f32 sums of the
// stored bf16 values) and the score's bias: s becomes p_use and dp becomes
// dS, each in f32 at the rounding points of the header (rounded to bf16
// by the caller's pack_bf16). A masked score (past Lk or Lq, or above the
// diagonal) has p = 0; `edge` is false where the tile holds no such score.
template <int BIAS, bool DROP>
__device__ __forceinline__ void tc_grad_point(
    float& s, float& dp, bool edge, float bias, const Dims& dm,
    const Extra& ex, uint32_t salt, int frow, int qpos, int kpos,
    float lse_v, float delta_v) {
  float x = __fmul_rn(s, dm.scale);                 // (q.k)*scale
  if (BIAS != kNoBias) x += bias;
  float p = expf(x - lse_v);
  if (edge && (kpos >= dm.Lk || qpos >= dm.Lq || (dm.causal && qpos < kpos)))
    p = 0.f;
  float pu = p, dpv = dp;
  if (DROP) {
    const bool keep = drop_keep(salt, frow, kpos, ex.thresh);
    pu = keep ? __fmul_rn(p, ex.keep_scale) : 0.f;
    dpv = keep ? __fmul_rn(dp, ex.keep_scale) : 0.f;
  }
  s = pu;
  dp = __fmul_rn(__fmul_rn(p, dpv - delta_v), dm.scale);
}

// s[16 x 8 NT] += A rows (16 from `ar0` of tile `a`) . B rows (8 NT from
// 0 of tile `bt`)^T, and dp likewise from tiles `a2`, `b2`, over all of D.
template <int D, int NT>
__device__ __forceinline__ void tc_scores(float (&s)[NT][4],
                                          float (&dp)[NT][4],
                                          const unsigned char* a,
                                          const unsigned char* bt,
                                          const unsigned char* a2,
                                          const unsigned char* b2, int ar0,
                                          int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
  for (int d = 0; d < D / 16; ++d) {
    uint32_t fa[4], fa2[4];
    const int at = tc::swz(ar0 + (lane & 15), 2 * d + (lane >> 4), 2 * D);
    tc::ldmatrix_x4(fa, a + at);
    tc::ldmatrix_x4(fa2, a2 + at);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t fb[4], fb2[4];
      const int bo = tc::swz(16 * np + (lane & 7) + 8 * (lane >> 4),
                             2 * d + ((lane >> 3) & 1), 2 * D);
      tc::ldmatrix_x4(fb, bt + bo);
      tc::ldmatrix_x4(fb2, b2 + bo);
      tc::mma_bf16(s[2 * np], fa, fb[0], fb[1]);
      tc::mma_bf16(s[2 * np + 1], fa, fb[2], fb[3]);
      tc::mma_bf16(dp[2 * np], fa2, fb2[0], fb2[1]);
      tc::mma_bf16(dp[2 * np + 1], fa2, fb2[2], fb2[3]);
    }
  }
}

// bytes of one ring stage of the dQ body: K and V tiles, and the tile's
// kvb row (read from shared memory, not held in registers)
template <int D, int BIAS>
constexpr int kDqStage = 2 * kTcK * 2 * D + (BIAS == kKvb ? kTcK * 4 : 0);

// dQ: the forward's shape. Each warp owns 16 query rows; S = Q K^T and
// dP = dO V^T over a 64-key tile in registers (8 n8 tiles each), dS formed
// there, then dQ += dS K with dS taken from the dP registers as bf16 A
// fragments. K and V tiles come through a 2-stage cp.async ring; Q and dO
// stay in shared memory.
template <int D, int BIAS, bool DROP>
__global__ void __launch_bounds__(kTcThreads) flash_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, Dims dm,
    Extra ex) {
  constexpr int TILE = kTcK * 2 * D, STAGE = kDqStage<D, BIAS>;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* qs = tc_smem;                // [64][D]
  unsigned char* dos = qs + TILE;             // [64][D]
  unsigned char* kvs = dos + TILE;            // stage: K, V, kvb [64]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTcQ, hq = blockIdx.y, b = blockIdx.z;
  const int G = dm.Hq / dm.Hkv, hk = hq / G;
  const float* kvb = BIAS == kKvb ? kvb_row(ex, dm, b) : nullptr;
  const float* fb = BIAS == kFb ? fb_plane(ex, dm, b, hq) : nullptr;
  const uint32_t salt = DROP ? drop_salt(ex.seed, b, hk) : 0u;
  const int frow0 = (hq % G) * dm.Lq;
  const int n_k = (dm.Lk + kTcK - 1) / kTcK;
  const int q_end = min(q0 + kTcQ, dm.Lq);
  const int n_live = dm.causal ? min((q_end + kTcK - 1) / kTcK, n_k) : n_k;

  // the key tile from k0 into stage `st`; kvb past Lk reads 0, as
  // bias_at does
  auto load = [&](int k0, unsigned char* st) {
    tc_load_rows<D>(st, k, b, k0, dm.Lk, dm.Hkv, hk);
    tc_load_rows<D>(st + TILE, v, b, k0, dm.Lk, dm.Hkv, hk);
    if (BIAS == kKvb) {
      float* kb = reinterpret_cast<float*>(st + 2 * TILE);
      for (int c = threadIdx.x; c < kTcK; c += kTcThreads) {
        const bool ok = k0 + c < dm.Lk;
        tc::cp_async4(kb + c, kvb + (ok ? k0 + c : 0), ok ? 4 : 0);
      }
    }
  };
  tc_load_rows<D>(qs, q, b, q0, dm.Lq, dm.Hq, hq);
  tc_load_rows<D>(dos, dout, b, q0, dm.Lq, dm.Hq, hq);
  load(0, kvs);
  tc::cp_async_commit();

  const int qrow[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = qrow[h] < dm.Lq;
    const size_t at =
        (static_cast<size_t>(b) * dm.Hq + hq) * dm.Lq + (ok ? qrow[h] : 0);
    lse_r[h] = ok ? lse[at] : 0.f;
    delta_r[h] = ok ? delta[at] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_live; ++kt) {
    const int k0 = kt * kTcK;
    if (kt + 1 < n_live) load(k0 + kTcK, kvs + ((kt + 1) & 1) * STAGE);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();                          // tile kt (and Q, dO) landed
    const unsigned char* ks = kvs + (kt & 1) * STAGE;
    const unsigned char* vs = ks + TILE;
    const float* kb = reinterpret_cast<const float*>(ks + 2 * TILE);

    // s = q.k and dp = dO.v: n8 tile n holds keys k0 + 8n + 2t + {0, 1}
    float s[8][4], dp[8][4];
    tc_scores<D, 8>(s, dp, qs, ks, dos, vs, 16 * warp, lane);
    // only a tile that reaches past Lk or Lq or (causal) past the warp's
    // first row holds a masked score; the test is warp-uniform
    const bool edge = k0 + kTcK > dm.Lk || q0 + kTcQ > dm.Lq ||
                      (dm.causal && k0 + kTcK - 1 > q0 + 16 * warp);
    // the lane's two rows innermost: on an H100 ~6% faster at GPT's shape
    // than rows outermost
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 8 * n + 2 * t + e, kpos = k0 + col;
          const float bias =
              BIAS == kKvb ? kb[col]
              : BIAS == kFb ? bias_at<kFb>(kvb, fb, dm, qrow[h], kpos)
                            : 0.f;
          tc_grad_point<BIAS, DROP>(s[n][2 * h + e], dp[n][2 * h + e], edge,
                                    bias, dm, ex, salt, frow0 + qrow[h],
                                    qrow[h], kpos, lse_r[h], delta_r[h]);
        }
    // dq += dS.k, dS rounded to bf16, f32 accumulate
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk) {
      uint32_t a[4];
      tc_a_frag(a, dp, kk);
      tc_mma_rows<D>(acc, a, ks, 16 * kk, lane);
    }
    __syncthreads();                          // this stage is free again
  }
  tc::cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qrow[h];
    if (row >= dm.Lq) continue;
    __nv_bfloat16* orow =
        dq + ((static_cast<size_t>(b) * dm.Lq + row) * dm.Hq + hq) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
          tc::pack_bf16(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

// Queries a streamed tile of the dK/dV body: 32 at head_dim 128 keeps
// the scores (16 + 16 f32 a lane) beside the dK and dV accumulators
// (64 + 64) within the register budget; 64 at head_dim 64.
template <int D>
constexpr int kDkvQ = D >= 128 ? 32 : 64;
// bytes of one ring stage: Q and dO tiles, lse and delta rows
template <int D>
constexpr int kDkvStage = 2 * kDkvQ<D> * 2 * D + 2 * kDkvQ<D> * 4;

// dK/dV: a block owns 64 keys, each warp 16, with K and V in shared
// memory. It walks (query head g of the group, query tile) in order, the
// Q, dO, lse and delta tiles streaming through a 2-stage cp.async ring:
// S^T = K Q^T and dP^T = V dO^T with keys as rows (in registers), p_use
// and dS formed there, then dV += p_use^T dO and dK += dS^T Q with both
// taken from registers as bf16 A fragments.
template <int D, int BIAS, bool DROP>
__global__ void __launch_bounds__(kTcThreads) flash_dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, Dims dm, Extra ex) {
  constexpr int QT = kDkvQ<D>, NT = QT / 8;
  constexpr int KTILE = kTcK * 2 * D, QTILE = QT * 2 * D;
  constexpr int STAGE = kDkvStage<D>;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* ks = tc_smem;                // [64][D] this block's keys
  unsigned char* vs = ks + KTILE;             // [64][D]
  unsigned char* ring = vs + KTILE;           // stage: Q, dO [QT][D],
                                              // lse, delta [QT]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kTcK, hk = blockIdx.y, b = blockIdx.z;
  const int G = dm.Hq / dm.Hkv;
  const float* kvb = BIAS == kKvb ? kvb_row(ex, dm, b) : nullptr;
  const uint32_t salt = DROP ? drop_salt(ex.seed, b, hk) : 0u;
  const int n_q = (dm.Lq + QT - 1) / QT;
  // query tiles that end before this key tile starts are fully masked
  const int qt0 = dm.causal ? min(k0 / QT, n_q) : 0;
  const int nq_live = n_q - qt0, n_it = G * nq_live;

  // step `it` of the walk: query head hk * G + it / nq_live, query tile
  // qt0 + it % nq_live
  auto load = [&](int it, unsigned char* st) {
    const int hq = hk * G + it / nq_live, q0 = (qt0 + it % nq_live) * QT;
    tc_load_rows<D, QT>(st, q, b, q0, dm.Lq, dm.Hq, hq);
    tc_load_rows<D, QT>(st + QTILE, dout, b, q0, dm.Lq, dm.Hq, hq);
    float* rows = reinterpret_cast<float*>(st + 2 * QTILE);
    const size_t base = (static_cast<size_t>(b) * dm.Hq + hq) * dm.Lq;
    for (int r = threadIdx.x; r < 2 * QT; r += kTcThreads) {
      const int row = q0 + r % QT;
      const bool ok = row < dm.Lq;
      const float* src = r < QT ? lse : delta;
      tc::cp_async4(rows + r, src + (ok ? base + row : 0), ok ? 4 : 0);
    }
  };
  tc_load_rows<D>(ks, k, b, k0, dm.Lk, dm.Hkv, hk);
  tc_load_rows<D>(vs, v, b, k0, dm.Lk, dm.Hkv, hk);
  if (n_it > 0) load(0, ring);
  tc::cp_async_commit();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const int krow[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  float kb[2] = {0.f, 0.f};                   // kvb of the lane's two keys
  if (BIAS == kKvb)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      kb[h] = bias_at<kKvb>(kvb, nullptr, dm, 0, krow[h]);

  for (int it = 0; it < n_it; ++it) {
    const int gi = it / nq_live, hq = hk * G + gi;
    const int q0 = (qt0 + it % nq_live) * QT;
    if (it + 1 < n_it) load(it + 1, ring + ((it + 1) & 1) * STAGE);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();                          // step it (and K, V) landed
    const unsigned char* qs = ring + (it & 1) * STAGE;
    const unsigned char* dos = qs + QTILE;
    const float* lse_s = reinterpret_cast<const float*>(qs + 2 * QTILE);
    const float* delta_s = lse_s + QT;
    const float* fb = BIAS == kFb ? fb_plane(ex, dm, b, hq) : nullptr;

    // s^T = k.q and dp^T = v.dO: rows are the warp's keys, n8 tile n
    // holds queries q0 + 8n + 2t + {0, 1}
    float st[NT][4], dpt[NT][4];
    tc_scores<D, NT>(st, dpt, ks, qs, vs, dos, 16 * warp, lane);
    const bool edge = k0 + 16 * warp + 16 > dm.Lk || q0 + QT > dm.Lq ||
                      (dm.causal && q0 < k0 + 16 * warp + 15);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * n + 2 * t + e;
          // the hash and the fb bias keep their (query, key) order
          const float bias =
              BIAS == kKvb ? kb[h]
              : BIAS == kFb ? bias_at<kFb>(kvb, fb, dm, q0 + col, krow[h])
                            : 0.f;
          tc_grad_point<BIAS, DROP>(st[n][2 * h + e], dpt[n][2 * h + e],
                                    edge, bias, dm, ex, salt,
                                    gi * dm.Lq + q0 + col, q0 + col, krow[h],
                                    lse_s[col], delta_s[col]);
        }
    // dv += p_use^T.dO and dk += dS^T.q, both rounded to bf16, f32
    // accumulate
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      uint32_t a[4];
      tc_a_frag(a, st, kk);
      tc_mma_rows<D>(dva, a, dos, 16 * kk, lane);
      tc_a_frag(a, dpt, kk);
      tc_mma_rows<D>(dka, a, qs, 16 * kk, lane);
    }
    __syncthreads();                          // this stage is free again
  }
  tc::cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = krow[h];
    if (row >= dm.Lk) continue;
    const size_t at =
        ((static_cast<size_t>(b) * dm.Lk + row) * dm.Hkv + hk) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * n + 2 * t) =
          tc::pack_bf16(dka[n][2 * h], dka[n][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * n + 2 * t) =
          tc::pack_bf16(dva[n][2 * h], dva[n][2 * h + 1]);
    }
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

// The tensor-core bodies copy 16-byte rows; the wrapper copies a view off
// that alignment to a fresh buffer first.
bool misaligned16(const Args& a) {
  return (reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
          reinterpret_cast<uintptr_t>(a.v) |
          reinterpret_cast<uintptr_t>(a.dout) |
          reinterpret_cast<uintptr_t>(a.o0) |
          reinterpret_cast<uintptr_t>(a.o1)) % 16;
}

// which: 0 forward, 1 dQ, 2 dK/dV; route: set to the body launched, 1 for
// a tensor-core body, 0 for a SIMT body
template <typename T, int D, int TM, int BIAS, bool DROP>
cudaError_t launch(int which, const Args& a, Dims dm, Extra ex,
                   cudaStream_t st, int& route) {
  constexpr int BT = 16 * TM, DP = D + 1;
  const T* qp = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  const T* gp = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (which == 0) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      // bf16: the tensor-core forward (Q, then K and V in 2 stages)
      if (misaligned16(a)) return cudaErrorMisalignedAddress;
      const size_t smem = static_cast<size_t>(5) * kTcK * D * 2;
      auto kern = flash_fwd_tc_kernel<D, BIAS, DROP>;
      if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
      route = 1;
      kern<<<dim3((dm.Lq + kTcQ - 1) / kTcQ, dm.Hq, dm.B), kTcThreads, smem,
             st>>>(qp, kp, vp, static_cast<T*>(a.o0), a.lse, dm, ex);
    } else {
      // f32: the SIMT forward
      const size_t smem = sizeof(float) * (2 * BT * DP + BT * D);
      auto kern = flash_fwd_kernel<T, D, TM, BIAS, DROP>;
      if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
      route = 0;
      kern<<<dim3((dm.Lq + BT - 1) / BT, dm.Hq, dm.B), kThreads, smem, st>>>(
          qp, kp, vp, static_cast<T*>(a.o0), a.lse, dm, ex);
    }
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value && D <= 128) {
    if (misaligned16(a)) return cudaErrorMisalignedAddress;
    route = 1;
    if (which == 1) {
      // bf16 dQ on the tensor cores (Q, dO, then K, V and kvb in 2
      // stages)
      const size_t smem =
          static_cast<size_t>(2) * kTcK * D * 2 + 2 * kDqStage<D, BIAS>;
      auto kern = flash_dq_tc_kernel<D, BIAS, DROP>;
      if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
      kern<<<dim3((dm.Lq + kTcQ - 1) / kTcQ, dm.Hq, dm.B), kTcThreads, smem,
             st>>>(qp, kp, vp, gp, a.lse, a.delta, static_cast<T*>(a.o0), dm,
                   ex);
    } else {
      // bf16 dK/dV on the tensor cores (K, V, then 2 streamed stages)
      const size_t smem =
          static_cast<size_t>(2) * kTcK * D * 2 + 2 * kDkvStage<D>;
      auto kern = flash_dkv_tc_kernel<D, BIAS, DROP>;
      if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
      kern<<<dim3((dm.Lk + kTcK - 1) / kTcK, dm.Hkv, dm.B), kTcThreads, smem,
             st>>>(qp, kp, vp, gp, a.lse, a.delta, static_cast<T*>(a.o0),
                   static_cast<T*>(a.o1), dm, ex);
    }
  } else if (which == 1) {
    // f32 (and bf16 at head_dim 256): the SIMT dQ
    const size_t smem = sizeof(float) * 4 * BT * DP;
    auto kern = flash_dq_kernel<T, D, TM, BIAS, DROP>;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
    route = 0;
    kern<<<dim3((dm.Lq + BT - 1) / BT, dm.Hq, dm.B), kThreads, smem, st>>>(
        qp, kp, vp, gp, a.lse, a.delta, static_cast<T*>(a.o0), dm, ex);
  } else {
    const size_t smem = sizeof(float) * (4 * BT * DP + 2 * BT * (BT + 1));
    auto kern = flash_dkv_kernel<T, D, TM, BIAS, DROP>;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
    route = 0;
    kern<<<dim3((dm.Lk + BT - 1) / BT, dm.Hkv, dm.B), kThreads, smem, st>>>(
        qp, kp, vp, gp, a.lse, a.delta, static_cast<T*>(a.o0),
        static_cast<T*>(a.o1), dm, ex);
  }
  return cudaGetLastError();
}

template <typename T, int D, int TM>
cudaError_t dispatch_extra(int which, const Args& a, Dims dm, Extra ex,
                           int bias, bool drop, cudaStream_t st, int& r) {
  switch (bias * 2 + (drop ? 1 : 0)) {
    case 0: return launch<T, D, TM, kNoBias, false>(which, a, dm, ex, st, r);
    case 1: return launch<T, D, TM, kNoBias, true>(which, a, dm, ex, st, r);
    case 2: return launch<T, D, TM, kKvb, false>(which, a, dm, ex, st, r);
    case 3: return launch<T, D, TM, kKvb, true>(which, a, dm, ex, st, r);
    case 4: return launch<T, D, TM, kFb, false>(which, a, dm, ex, st, r);
    case 5: return launch<T, D, TM, kFb, true>(which, a, dm, ex, st, r);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int which, int D, const Args& a, Dims dm, Extra ex,
                     int bias, bool drop, cudaStream_t st, int& r) {
  switch (D) {
    case 64:
      return dispatch_extra<T, 64, 4>(which, a, dm, ex, bias, drop, st, r);
    case 128:
      return dispatch_extra<T, 128, 4>(which, a, dm, ex, bias, drop, st, r);
    case 256:
      return dispatch_extra<T, 256, 2>(which, a, dm, ex, bias, drop, st, r);
    default:
      return cudaErrorInvalidValue;
  }
}

// route (may be null): set to the body `launch` launched, 1 for a
// tensor-core body (bf16; dQ and dK/dV at head_dim 64 and 128), 0 for a
// SIMT body.
int run(int which, const Args& a, const float* kvb, const float* fb, int B,
        int Lq, int Lk, int Hq, int Hkv, int D, int causal, int kvb_b,
        int fb_b, int fb_h, float scale, uint32_t seed, uint32_t thresh,
        float keep_scale, int dtype, int device, void* stream, int* route) {
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
  int body = 0;
  if (dtype == 0)
    err = dispatch<float>(which, D, a, dm, ex, bias, drop, st, body);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(which, D, a, dm, ex, bias, drop, st, body);
  else
    err = cudaErrorInvalidValue;
  if (route) *route = body;
  return err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs share it).
// kvb / fb: null or the f32 bias (at most one); kvb_b, fb_b, fb_h: the bias
// has its own batch / head axis. thresh: the dropout keep threshold,
// min(int(rate * 2^32), 2^32 - 1), 0 for no dropout; keep_scale: f32
// 1 / (1 - rate); seed: the uint32 seed; route (may be null): set to the
// body that ran, 1 tensor cores, 0 SIMT. Each returns the cudaError_t of
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
                         float* lse, int* route, FLASH_TAIL) {
  const Args a{q, k, v, nullptr, lse, nullptr, out, nullptr};
  return run(0, a, kvb, fb, FLASH_PASS, route);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const float* kvb,
                            const float* fb, void* dq, int* route,
                            FLASH_TAIL) {
  const Args a{q, k, v, dout, const_cast<float*>(lse), delta, dq, nullptr};
  return run(1, a, kvb, fb, FLASH_PASS, route);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const float* kvb,
                             const float* fb, void* dk, void* dv, int* route,
                             FLASH_TAIL) {
  const Args a{q, k, v, dout, const_cast<float*>(lse), delta, dk, dv};
  return run(2, a, kvb, fb, FLASH_PASS, route);
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
