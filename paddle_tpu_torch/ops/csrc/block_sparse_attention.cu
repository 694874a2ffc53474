// Block-sparse (blocked-CSR) attention forward for Hopper (sm_90a), f32 and
// bf16 q/k/v [B, H, L, D], block sizes 8/16/32/64/128, any D <= 256.
//
// Replaces the TPU kernel `_bs_fwd_kernel` of
// paddle_tpu/ops/block_sparse_attention.py (launched there by `_bs_fwd`).
//
// Math (the JAX kernel): q-block row i of (b, h) reads the pattern
// g = b*H + h when the caller has one pattern per (b, h), else pattern 0,
// and walks block_cols[g, i, 0..count) in order. Each visited kv block c
// is an f32 online-softmax step over its keys: s = q.k * scale, m_new =
// max(m, row max s), alpha = exp(m - m_new), p = exp(s - m_new), l =
// l*alpha + sum p, acc = acc*alpha + p.V. The output is acc / max(l,
// 1e-30), cast to q's dtype, so a row with count 0 writes zeros. The walk
// stops at the count: the JAX kernel's padded slots (j >= count) give
// alpha = 1 and p = 0 and change no bit, so skipping them is exact.
// Column ids are clamped into [0, nk) so a bad id reads a block of the
// sequence.
//
// Bound: for BigBird-like patterns (~6 of 32 blocks a row at L 4096) the
// kernel is bound by operations, 4*bs*bs*D flops per visited block, and on
// bytes only when few blocks are visited.
//
// Two bodies; the route is chosen in `dispatch`, in the branch that
// launches, and reported to the caller (a choice, not a fallback):
//
//   bf16 at bs 16, 32, 64, 128 and head_dim 64 or 128 ->
//   `bsa_fwd_tc_kernel`, bf16 tensor cores (mma.sync m16n8k16, f32
//   accumulate, tc_tile.cuh). One thread block per (b, h, q block) of
//   bs / 16 warps; a warp owns 16 query rows, whose q tile it keeps in
//   registers as A fragments for the whole walk. The row's kv blocks are
//   read in block_cols order in key tiles of min(bs, 64) keys through a
//   2-stage cp.async ring in 128-byte-swizzled shared memory (ldmatrix,
//   .trans for V, without bank conflicts); the column id of the block
//   after the next tile's is read one tile ahead, so the next tile's copy
//   is in flight while this one is scored. S = Q K^T of a tile lands in 32
//   registers a lane (at 64 keys), the online softmax runs on them (the
//   four lanes of a quad share a row), and their C fragments become P.V's
//   A fragments without passing through shared memory. Rounding points:
//     1. s = (q.k) * scale: the mma on q and k as stored (products exact
//        in f32, f32 sums), the scale on the f32 score; q * scale is
//        never formed (an f32 rounding away from the JAX kernel's q *
//        scale before the dot);
//     2. the online softmax steps once per key tile (64 keys, or the
//        block below that), m, l, alpha and p in f32; l sums the
//        unrounded p;
//     3. P.V = p_hi.V + p_lo.V, p_hi = bf16(p), p_lo = bf16(p - p_hi)
//        (p - p_hi is exact in f32): two products into one f32 sum, so p
//        carries ~16 bits into the product. p rounded to bf16 alone moves
//        an output whose terms cancel by many bf16 steps of it (the JAX
//        kernel keeps p in f32); the split keeps it within f32 noise;
//     4. out = acc / max(l, 1e-30), rounded once to bf16.
//   The split issues 6*bs*bs*D flops a visited block to the function's 4.
//
//   f32, bf16 at bs 8 or any other head_dim -> `block_sparse_attention_kernel`,
//   SIMT f32 FMAs out of shared memory: a TT x TT thread grid (TT = 16, or
//   bs below 16); thread (tr, tk) owns rows tr, tr+TT, ... of the q block,
//   keys tk, tk+TT, ... of the kv block (scores in registers) and
//   head-dim columns tk, tk+TT, ... of the accumulator (a register
//   micro-tile, 8 x 8 at bs 128). A block step: (1) S = (q * scale).K^T,
//   staging q and K in 32-column chunks as f32 in shared memory and
//   summing over d in order (q is scaled before the dot, as the JAX
//   kernel does); (2) per row, the max and the sum of p over the TT
//   threads of the row by xor shuffles; (3) p to shared memory, then acc
//   = acc*alpha + p.V, staging V 32 keys at a time and summing over keys
//   in order. Shared-memory rows are padded by one float where a warp
//   reads down a column. Its ceiling is the f32 FMA rate (67 TFLOP/s).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tc_tile.cuh"

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

// ------------------------------------------------ bf16: tensor cores

template <int BS>
struct TcTile {
  static constexpr int kWarps = BS / 16;         // 16 query rows a warp
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kKeys = BS < 64 ? BS : 64;  // keys a tile
  static constexpr int kTiles = BS / kKeys;        // tiles a kv block
};

// Shared memory in bytes: the q block [BS][D], then 2 stages of a K and a
// V tile [kKeys][D], all bf16.
template <int BS, int D>
constexpr size_t tc_smem_bytes() {
  return static_cast<size_t>(2) * D * (BS + 4 * TcTile<BS>::kKeys);
}

// ROWS consecutive rows of a bf16 [.., D] head, from `src`, into a
// swizzled tile of 2*D-byte rows, with 16-byte cp.async (NT threads).
template <int ROWS, int D, int NT>
__device__ __forceinline__ void tc_rows(unsigned char* dst,
                                        const __nv_bfloat16* src) {
  constexpr int CH = D / 8;                     // 16-byte chunks a row
  for (int c = threadIdx.x; c < ROWS * CH; c += NT) {
    const int r = c / CH, ch = c % CH;
    tc::cp_async16(dst + tc::swz(r, ch, 2 * D),
                   src + static_cast<size_t>(r) * D + 8 * ch, 16);
  }
}

// p_hi = bf16(x) and p_lo = bf16(x - p_hi) of two f32, packed (the lower
// in the low half); x - p_hi is exact in f32.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = tc::pack_bf16(__fsub_rn(x0, f.x), __fsub_rn(x1, f.y));
}

template <int BS, int D>
__global__ void __launch_bounds__(TcTile<BS>::kThreads) bsa_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ cols,
    const int* __restrict__ counts, __nv_bfloat16* __restrict__ out, int H,
    int L, int max_nnz, int per_head, float scale) {
  constexpr int NT = TcTile<BS>::kThreads, KT = TcTile<BS>::kKeys;
  constexpr int TPB = TcTile<BS>::kTiles;
  constexpr int RB = 2 * D;                     // bytes a row
  constexpr int TILE = KT * RB;
  extern __shared__ __align__(128) unsigned char bsa_smem[];
  unsigned char* qs = bsa_smem;                 // [BS][D]
  unsigned char* ring = bsa_smem + BS * RB;     // stage s: K, then V
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nq = L / BS;
  const size_t head = (static_cast<size_t>(b) * H + h) * L * D;
  const int pat = per_head ? b * H + h : 0;
  const int* rcols = cols + (static_cast<size_t>(pat) * nq + i) * max_nnz;
  const int count = min(counts[static_cast<size_t>(pat) * nq + i], max_nnz);
  const int n_tiles = count > 0 ? count * TPB : 0;
  const __nv_bfloat16* kh = k + head;
  const __nv_bfloat16* vh = v + head;
  auto col_at = [&](int j) { return min(max(rcols[j], 0), nq - 1); };

  if (n_tiles > 0) {
    const size_t row0 = static_cast<size_t>(col_at(0)) * BS;
    tc_rows<BS, D, NT>(qs, q + head + static_cast<size_t>(i) * BS * D);
    tc_rows<KT, D, NT>(ring, kh + row0 * D);
    tc_rows<KT, D, NT>(ring + TILE, vh + row0 * D);
  }
  tc::cp_async_commit();
  // the column id of tile u + 1's block, read one tile ahead
  int col_next = n_tiles > 1 ? col_at(1 / TPB) : 0;

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};    // rows g and g + 8
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  uint32_t qa[D / 16][4];                       // the q tile, A fragments

  for (int u = 0; u < n_tiles; ++u) {
    if (u + 1 < n_tiles) {
      unsigned char* nxt = ring + ((u + 1) & 1) * 2 * TILE;
      const size_t row0 =
          static_cast<size_t>(col_next) * BS + ((u + 1) % TPB) * KT;
      tc_rows<KT, D, NT>(nxt, kh + row0 * D);
      tc_rows<KT, D, NT>(nxt + TILE, vh + row0 * D);
    }
    tc::cp_async_commit();
    if (u + 2 < n_tiles) col_next = col_at((u + 2) / TPB);
    tc::cp_async_wait<1>();
    __syncthreads();                            // tile u (and q) landed
    if (u == 0) {
#pragma unroll
      for (int d = 0; d < D / 16; ++d)
        tc::ldmatrix_x4(qa[d], qs + tc::swz(16 * warp + (lane & 15),
                                            2 * d + (lane >> 4), RB));
    }
    const unsigned char* ks = ring + (u & 1) * 2 * TILE;
    const unsigned char* vs = ks + TILE;

    // s = q.k over the tile: n8 tile n holds keys 8n + 2t + {0, 1}
    float s[KT / 8][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int d = 0; d < D / 16; ++d) {
#pragma unroll
      for (int np = 0; np < KT / 16; ++np) {
        uint32_t bb[4];
        tc::ldmatrix_x4(bb, ks + tc::swz(16 * np + (lane & 7) +
                                             8 * (lane >> 4),
                                         2 * d + ((lane >> 3) & 1), RB));
        tc::mma_bf16(s[2 * np], qa[d], bb[0], bb[1]);
        tc::mma_bf16(s[2 * np + 1], qa[d], bb[2], bb[3]);
      }
    }

    // the online softmax of rows g (h 0) and g + 8 (h 1); the four lanes
    // of a quad share a row
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = kNeg;
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = __fmul_rn(s[n][2 * hh + e], scale);  // (q.k)*scale
          s[n][2 * hh + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[n][2 * hh + e] - m_new);
          s[n][2 * hh + e] = p;
          sum += p;                             // l sums the unrounded p
        }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      const float corr = expf(m[hh] - m_new);
      l[hh] = __fmul_rn(l[hh], corr) + sum;
      m[hh] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * hh] *= corr;
        o[n][2 * hh + 1] *= corr;
      }
    }

    // o += p_hi.v + p_lo.v: the score registers as two bf16 A fragments
    // a k16 step (the C layout of two n8 tiles is the A layout of one
    // k16 step), V through ldmatrix .trans, f32 accumulate
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t bb[4];
        tc::ldmatrix_x4_trans(bb, vs + tc::swz(16 * kk + (lane & 7) +
                                                   8 * ((lane >> 3) & 1),
                                               2 * dd + (lane >> 4), RB));
        tc::mma_bf16(o[2 * dd], hi, bb[0], bb[1]);
        tc::mma_bf16(o[2 * dd + 1], hi, bb[2], bb[3]);
        tc::mma_bf16(o[2 * dd], lo, bb[0], bb[1]);
        tc::mma_bf16(o[2 * dd + 1], lo, bb[2], bb[3]);
      }
    }
    __syncthreads();                            // this stage is free again
  }
  tc::cp_async_wait<0>();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float lsafe = fmaxf(l[hh], kDenomEps);
    __nv_bfloat16* orow =
        out + head +
        (static_cast<size_t>(i) * BS + 16 * warp + g + 8 * hh) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
          tc::pack_bf16(o[n][2 * hh] / lsafe, o[n][2 * hh + 1] / lsafe);
  }
}

// ------------------------------------------------------------- launches

struct Args {
  const void *q, *k, *v;
  const int *cols, *counts;
  void* out;
  int B, H, L, D, max_nnz, per_head;
  float scale;
};

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int BS, int DC>
cudaError_t launch_simt(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<BS>(a.D);
  auto kernel = block_sparse_attention_kernel<T, BS, DC>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.L / BS, a.H, a.B), Tile<BS>::NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.cols, a.counts, static_cast<T*>(a.out),
      a.H, a.L, a.D, a.max_nnz, a.per_head, a.scale);
  return cudaGetLastError();
}

template <int BS, int D>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<BS, D>();
  auto kernel = bsa_fwd_tc_kernel<BS, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.L / BS, a.H, a.B), TcTile<BS>::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.cols, a.counts,
      static_cast<__nv_bfloat16*>(a.out), a.H, a.L, a.max_nnz, a.per_head,
      a.scale);
  return cudaGetLastError();
}

// The SIMT body: DC = ceil(Dmax / TT) for the head-dim class Dmax in 64 /
// 128 / 256.
template <typename T, int BS>
cudaError_t dispatch_simt(const Args& a, cudaStream_t s) {
  constexpr int TT = Tile<BS>::TT;
  if (a.D <= 64) return launch_simt<T, BS, 64 / TT>(a, s);
  if (a.D <= 128) return launch_simt<T, BS, 128 / TT>(a, s);
  return launch_simt<T, BS, 256 / TT>(a, s);
}

bool misaligned16(const Args& a) {
  return (reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
          reinterpret_cast<uintptr_t>(a.v) |
          reinterpret_cast<uintptr_t>(a.out)) % 16;
}

// route: set to the body launched, 1 for the tensor-core body, 0 for SIMT
template <typename T, int BS>
cudaError_t dispatch(const Args& a, cudaStream_t s, int* route) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && BS >= 16) {
    if (a.D == 64 || a.D == 128) {
      if (misaligned16(a)) return cudaErrorMisalignedAddress;
      *route = 1;
      return a.D == 64 ? launch_tc<BS, 64>(a, s) : launch_tc<BS, 128>(a, s);
    }
  }
  *route = 0;
  return dispatch_simt<T, BS>(a, s);
}

template <typename T>
cudaError_t dispatch_bs(int bs, const Args& a, cudaStream_t s, int* route) {
  switch (bs) {
    case 8: return dispatch<T, 8>(a, s, route);
    case 16: return dispatch<T, 16>(a, s, route);
    case 32: return dispatch<T, 32>(a, s, route);
    case 64: return dispatch<T, 64>(a, s, route);
    case 128: return dispatch<T, 128>(a, s, route);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). cols
// [G, L/bs, max_nnz] and counts [G, L/bs] int32; per_head != 0 when
// G == B*H. *route is set to the body launched (1 tensor cores, 0 SIMT).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int bsa_forward(const void* q, const void* k, const void* v,
                           const int* cols, const int* counts, void* out,
                           int B, int H, int L, int D, int bs, int max_nnz,
                           int per_head, float scale, int dtype, int device,
                           void* stream, int* route) {
  *route = -1;
  if (B < 1 || H < 1 || bs < 1 || L < bs || L % bs || D < 1 || D > 256 ||
      max_nnz < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, cols, counts, out, B, H, L, D, max_nnz, per_head,
               scale};
  if (dtype == 0) return dispatch_bs<float>(bs, a, s, route);
  if (dtype == 1) return dispatch_bs<__nv_bfloat16>(bs, a, s, route);
  return cudaErrorInvalidValue;
}

extern "C" const char* bsa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
