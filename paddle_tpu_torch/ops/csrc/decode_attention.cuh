// Split decode attention over paged K/V for Hopper (sm_90a): the body that
// ragged_paged_attention.cu (f32/bf16, int8 and int4 pools) and
// paged_attention.cu (f32/bf16 pages, any page size, head_dim <= 256)
// instantiate in kernels of their own names.
//
// Bound: bytes. A query at position qpos reads (qpos + 1) keys and values
// of its head and does ~4 D flops a key, ~1 flop a byte read: far below the
// f32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/byte), so the
// floor is the K/V bytes over HBM bandwidth, and the arithmetic stays f32 on
// the CUDA cores (rounding a score or a dequantized value to bf16 for mma
// would add rounding points and buy nothing).
//
// The split. Each query's walk over its row's pages is cut at fixed
// absolute page indices into chunks of C pages (chunk c = pages [c C,
// (c + 1) C)), each walked from a fresh state (m = -1e30, s = 0, acc = 0);
// the chunks' (m_c, s_c, acc_c) are merged per query in chunk order with
// one formula: M = max_c m_c; w_c = exp(m_c - M); s = sum_c s_c w_c; acc =
// sum_c acc_c w_c; out = acc / max(s, 1e-30). No atomics: a query's bits
// depend only on its row's pages and its position.
//
// Work. A thread block serves one head h, one query tile and a set of
// chunks. A tile is up to kTileQ consecutive queries of the flattened
// [N * W] stream that read one table row at consecutive positions (a dense
// window, or a prefill chunk of the packed stream; a lone decode token is a
// tile of one); tiles start at every kTileQ-th query and wherever a run of
// (row, position + 1) breaks, and end at the next kTileQ-th query, so each
// query is in exactly one tile, the grid (N * W x Z x H blocks, the head
// fastest) is sized from shapes alone and a block whose query starts no
// tile exits at once. A split launch (Z = nch) gives block z chunk z and
// writes its partials to device-memory scratch, merged by a second
// kernel; an unsplit launch (Z = 1) walks all of a tile's chunks in one
// block and keeps their partials in shared memory, merged there (a table
// too wide for that takes the split launch). Chunks and pages past a
// query's causal range are not walked for it (a fully masked page after a
// real key changes no bit).
//
// A chunk's units (page j, key tile kt of up to KP = 16 or 32 keys) go in
// rounds of R = kWarps units, warp w owning unit w of the round. Each warp
// asks L1 for its unit's key and value rows (and scales) a round ahead
// (the first round before it reads q), so a round's K and V bytes are in
// flight together. (B) Each warp scores its unit for every query of the
// tile: lane l holds q * scale at head dims [l DPL,
// (l + 1) DPL) and loads the same dims of each key into registers (one
// vector load a key where the pool's alignment allows; all KP loads
// unguarded, so they go out at once), forms partial dots, and a
// reduce-scatter butterfly (halving the key set at each xor step) leaves
// lane l the whole dot of key l >> (5 - log2 KP); then the layout's scale
// (int8: the key scale multiplies the finished logit), the mask (kpos <=
// qpos, else -1e30) and the unit's max go to shared memory. (C) After a
// barrier, each warp takes the running max before its unit (the prefix
// max the serial walk would hold), and forms m_new = max(m, unit
// max), p = exp(logit - m_new), corr = exp(m - m_new), sum p (a butterfly)
// and sum_t p_t v_t (lanes over head dims, p_t by shuffle). (D) After a
// barrier, one warp a query applies s = s corr + sum p, acc = acc corr +
// p.V unit by unit in order. These are the serial online-softmax walk's
// operations on the same values, so every query gets the same bits in any
// tile, round shape or launch plan (split or not).
//
// Pool layouts (template L): kPlain pages [P, ps, H, D] in q's dtype;
// kInt8 int8 pages [P, ps, H, D] with f32 per-token scales [P, ps] for K
// and V (the key scale multiplies the finished logit, V dequantizes to
// v * s in f32 before P.V); kInt4 nibble-packed uint8 pages [P, ps, PB]
// (element e = h D + d is nibble e % 2 of byte e / 2, sign-extended) with
// f32 group scales [P, ps, G] (group e / (2 PB / G)), dequantized nibble *
// scale in f32 before both dots. A lane reads only its head dims of each
// token: D elements of the head (D / 2 bytes for int4) and their scales.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dattn {

constexpr float kMask = -1e30f;
constexpr float kDenomEps = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
// C: pages a chunk (the plain versions read this line for their own walk)
constexpr int kChunkPages = 8;
constexpr int kTileQ = 4;         // queries a tile at most
constexpr int kWarps = 8;         // warps a block: page units a round

enum Layout { kPlain = 0, kInt8 = 1, kInt4 = 2 };

// Everything a launch needs; the host fills it (`plan`).
struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  const int* row_of;    // null: query item n reads table row n
  const int* start;     // qpos = start[n] + w + pos_off
  void* out;
  float* scratch;       // split: the chunk partials
  int N, W, H, D, ps, MP, P, R, PB, G;
  int pos_off;
  float scale;
  int split;            // 1: a block a chunk, partials to `scratch`,
                        // merged by a 2nd kernel; 0: shared memory
  int nch;              // ceil(MP / C)
  int nkt;              // key tiles a page: ceil(ps / KP)
  int vec;              // 1: a lane's dims of a row load as one vector
  int group;            // int4: elements a scale group
};

template <int L, typename T>
struct PoolT { using type = T; };
template <typename T>
struct PoolT<kInt8, T> { using type = int8_t; };
template <typename T>
struct PoolT<kInt4, T> { using type = uint8_t; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Bytes a lane holds of one row: DPL elements (int4: DPL nibbles).
template <int L, typename T, int DPL>
struct Lane {
  static constexpr int kBytes = L == kInt4 ? (DPL + 1) / 2
      : L == kInt8 ? DPL : DPL * static_cast<int>(sizeof(T));
  static constexpr int kWords = (kBytes + 3) / 4;
};

// The raw bytes of a lane's head dims of one row (`row`: the head's slice
// of the token): one vector load when `vec`, else byte by byte with bytes
// past the row's D elements read as 0.
template <int L, typename T, int DPL>
__device__ __forceinline__ void load_raw(
    const unsigned char* row, int lane, bool vec, int D,
    uint32_t (&w)[Lane<L, T, DPL>::kWords]) {
  constexpr int B = Lane<L, T, DPL>::kBytes;
  if constexpr (L == kInt4 && DPL == 1) {   // half a byte: the pair's byte
    w[0] = row[lane >> 1];
    return;
  }
  const unsigned char* src = row + lane * B;
  if (vec) {
    if constexpr (B == 1) w[0] = src[0];
    else if constexpr (B == 2) w[0] = *reinterpret_cast<const uint16_t*>(src);
    else if constexpr (B == 4) w[0] = *reinterpret_cast<const uint32_t*>(src);
    else if constexpr (B == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(src);
      w[0] = v.x;
      w[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < B / 16; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(src)[i];
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    }
    return;
  }
  const int bytes = L == kInt4 ? D / 2
      : D * (L == kInt8 ? 1 : static_cast<int>(sizeof(T)));
#pragma unroll
  for (int i = 0; i < Lane<L, T, DPL>::kWords; ++i) w[i] = 0;
#pragma unroll
  for (int b = 0; b < B; ++b)
    if (lane * B + b < bytes)
      w[b / 4] |= static_cast<uint32_t>(src[b]) << (8 * (b % 4));
}

// Element e of a lane's raw bytes as f32 (int4: the nibble, unscaled).
template <int L, typename T, int DPL>
__device__ __forceinline__ float elem(const uint32_t* w, int e, int lane) {
  if constexpr (L == kInt4) {
    const int sh = DPL == 1 ? 4 * (lane & 1) : 4 * e;
    const int v = (w[sh / 32] >> (sh % 32)) & 0xF;
    return static_cast<float>(v >= 8 ? v - 16 : v);
  } else if constexpr (L == kInt8) {
    return static_cast<float>(
        static_cast<int8_t>((w[e / 4] >> (8 * (e % 4))) & 0xFF));
  } else if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[e]);
  } else {                          // bf16: the high half of an f32
    return __uint_as_float(e % 2 ? w[e / 2] & 0xFFFF0000u : w[e / 2] << 16);
  }
}

// One xor step of the reduce-scatter: N partial sums a lane -> N / 2, each
// lane keeping the half of the keys its bit selects and adding its
// partner's sums of that half; the next step takes the next lower bit.
template <int KP, int N>
__device__ __forceinline__ void halve(float (&part)[KP], int lane) {
  if constexpr (N >= 2) {
    constexpr int n = N / 2, o = n * (32 / KP);
    const bool up = lane & o;
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const float keep = up ? part[n + j] : part[j];
      const float send = up ? part[j] : part[n + j];
      part[j] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, o));
    }
    halve<KP, n>(part, lane);
  }
}

// After it, lane l holds the dot of key l >> (5 - log2 KP) summed over all
// 32 lanes (KP = 16: lanes 2k and 2k + 1 both hold key k).
template <int KP>
__device__ __forceinline__ float reduce_scatter(float (&part)[KP], int lane) {
  halve<KP, KP>(part, lane);
  if constexpr (KP == 16)
    return __fadd_rn(part[0], __shfl_xor_sync(kFull, part[0], 1));
  return part[0];
}

__device__ __forceinline__ int query_pages(int qpos, const Params& p) {
  return qpos < 0 ? p.MP : min(p.MP, qpos / p.ps + 1);
}

// The merge of one query's chunk partials (chunks 0..nc-1, `stride` floats
// apart: acc[DQ], m, s), written as q's dtype (file head note). Whole warp.
template <typename T, int DPL>
__device__ __forceinline__ void merge_query(const float* part, int stride,
                                            int nc, T* orow, int D,
                                            int lane) {
  constexpr int DQ = 32 * DPL;
  float M = -INFINITY;                  // max is exact in any order
  for (int c = lane; c < nc; c += 32) M = fmaxf(M, part[c * stride + DQ]);
#pragma unroll
  for (int o = 16; o; o >>= 1) M = fmaxf(M, __shfl_xor_sync(kFull, M, o));
  float s = 0.f, acc[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] = 0.f;
  for (int c0 = 0; c0 < nc; c0 += 32) {
    // lane k holds chunk c0 + k's weight and sum; the sums go in order
    float wl = 0.f, sl = 0.f;
    if (c0 + lane < nc) {
      const float* src = part + (c0 + lane) * stride;
      wl = expf(__fsub_rn(src[DQ], M));
      sl = src[DQ + 1];
    }
    const int n = min(32, nc - c0);
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float wc = __shfl_sync(kFull, wl, k);
      const float sc = __shfl_sync(kFull, sl, k);
      const float* src = part + (c0 + k) * stride + lane * DPL;
      s = __fadd_rn(s, __fmul_rn(sc, wc));
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        acc[e] = __fadd_rn(acc[e], __fmul_rn(src[e], wc));
    }
  }
  const float denom = fmaxf(s, kDenomEps);
#pragma unroll
  for (int e = 0; e < DPL; ++e) {
    const int d = lane * DPL + e;
    if (d < D) store(orow + d, __fdiv_rn(acc[e], denom));
  }
}

// Shared memory of a block: q * scale [kTileQ][DQ]; chunk partials
// [kTileQ][nch][SP] (unsplit only); the running state [kTileQ][SP]; per
// (query, unit of the round): logits [KP], unit max, running max after
// it, corr, sum p, and sum_t p_t v_t [DQ].
struct Smem {
  float *qs, *parts, *st, *lg, *pmax, *mnew, *corr, *psum, *pv;
};

// Carve `base` into the regions (or, with base null, count the bytes);
// `nparts`: chunk partials a query keeps in shared memory (0: split).
template <int DQ, int KP>
__host__ __device__ inline size_t carve(unsigned char* base, int nparts,
                                        Smem* sm) {
  constexpr int SP = DQ + 4, tq = kTileQ, R = kWarps;
  const size_t sizes[9] = {
      static_cast<size_t>(tq) * DQ * 4,
      static_cast<size_t>(tq) * nparts * SP * 4,
      static_cast<size_t>(tq) * SP * 4, static_cast<size_t>(tq) * R * KP * 4,
      static_cast<size_t>(tq) * R * 4, static_cast<size_t>(tq) * R * 4,
      static_cast<size_t>(tq) * R * 4, static_cast<size_t>(tq) * R * 4,
      static_cast<size_t>(tq) * R * DQ * 4};
  float* at[9];
  size_t off = 0;
  for (int i = 0; i < 9; ++i) {
    at[i] = reinterpret_cast<float*>(base + off);
    off += (sizes[i] + 15) / 16 * 16;
  }
  if (sm) *sm = Smem{at[0], at[1], at[2], at[3], at[4], at[5], at[6], at[7],
                     at[8]};
  return off;
}

template <typename T, int L, int DPL, int KP>
struct Walk {
  using P = typename PoolT<L, T>::type;
  using LaneT = Lane<L, T, DPL>;
  static constexpr int DQ = 32 * DPL;   // head dims the lanes cover
  static constexpr int SP = DQ + 4;     // a state / partial: acc, m, s
  static constexpr int kShift = KP == 32 ? 0 : 1;

  const Params& p;
  Smem sm;
  int lane, warp, h, R;
  const int* trow;      // the tile's table row
  const int* qpos;      // the tile's positions
  bool vec;
  int g_lo, sidx[DPL];  // int4: first group of head h, lane's scale index
  bool one_group;       // int4: the lane's dims share one group
  size_t tok_stride, head_off;

  __device__ __forceinline__ int page_of(int c, int i) const {
    return c * kChunkPages + (p.nkt == 1 ? i : i / p.nkt);
  }
  __device__ __forceinline__ int tile_of(int i) const {
    return p.nkt == 1 ? 0 : i % p.nkt;
  }
  // The first token of unit i of chunk c, and its key count.
  __device__ __forceinline__ size_t token0(int c, int i, int* nk) const {
    const int kt = tile_of(i);
    const int pid = min(max(trow[page_of(c, i)], 0), p.P - 1);
    *nk = min(KP, p.ps - kt * KP);
    return static_cast<size_t>(pid) * p.ps + kt * KP;
  }
  __device__ __forceinline__ const unsigned char* row(const void* pool,
                                                      size_t tok) const {
    return static_cast<const unsigned char*>(pool) + tok * tok_stride +
           head_off;
  }
  // Ask L1 for unit i of chunk c: its key and value rows of head h (and
  // their int8/int4 scales), so that the loads of phases B and C find them
  // there; issued a round ahead (the first round before q is read).
  __device__ __forceinline__ void prefetch(int c, int i) const {
    int nk;
    const size_t tok0 = token0(c, i, &nk);
    const int bytes = L == kInt4 ? p.D / 2
        : p.D * static_cast<int>(sizeof(P));
    const int lines = (bytes + 127) / 128;
    for (int e = lane; e < 2 * nk * lines; e += 32) {
      const int t = e / (2 * lines), r = e - t * 2 * lines;
      const void* pool = r < lines ? p.k_pages : p.v_pages;
      asm volatile("prefetch.global.L1 [%0];" ::"l"(
          row(pool, tok0 + t) + (r % lines) * 128));
    }
    if constexpr (L == kInt8)
      if (lane < 2)
        asm volatile("prefetch.global.L1 [%0];" ::"l"(
            (lane ? p.v_scale : p.k_scale) + tok0));
    if constexpr (L == kInt4)
      if (lane < 2 * nk)
        asm volatile("prefetch.global.L1 [%0];" ::"l"(
            (lane < nk ? p.k_scale : p.v_scale) +
            (tok0 + lane % nk) * p.G + g_lo));
  }
  // This warp's unit of the round starting at unit u0 of chunk c.
  __device__ __forceinline__ void prefetch_round(int c, int u0,
                                                 int nu) const {
    if (u0 + warp < nu) prefetch(c, u0 + warp);
  }

  // Element e of a lane's dims of token tok as f32, dequantized for int4
  // (nibble * its group scale; `sc` the scale of the lane's first dim,
  // read once a token when all its dims share that group).
  __device__ __forceinline__ float value(const uint32_t* w, int e,
                                         const float* scales, size_t tok,
                                         float sc) const {
    const float x = elem<L, T, DPL>(w, e, lane);
    if constexpr (L == kInt4)
      return __fmul_rn(x, one_group ? sc
                                    : scales[tok * p.G + g_lo + sidx[e]]);
    return x;
  }
  __device__ __forceinline__ float first_scale(const float* scales,
                                               size_t tok) const {
    return L == kInt4 ? scales[tok * p.G + g_lo + sidx[0]] : 1.f;
  }

  // (B) Score unit i of chunk c (slot `slot` of the round) for query g:
  // its logits and the unit's max to shared memory. Slots past nk re-read
  // the unit's last token (the loads stay unguarded, so all KP go out at
  // once); their dots are never used.
  __device__ __forceinline__ void score(int c, int i, int slot, int g) const {
    int nk;
    const size_t tok0 = token0(c, i, &nk);
    float qv[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) qv[e] = sm.qs[g * DQ + lane * DPL + e];
    float part[KP];
#pragma unroll
    for (int t = 0; t < KP; ++t) {
      const size_t tok = tok0 + min(t, nk - 1);
      uint32_t w[LaneT::kWords];
      load_raw<L, T, DPL>(row(p.k_pages, tok), lane, vec, p.D, w);
      const float sc = first_scale(p.k_scale, tok);
      part[t] = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        part[t] = __fmaf_rn(qv[e], value(w, e, p.k_scale, tok, sc), part[t]);
    }
    const float dot = reduce_scatter<KP>(part, lane);
    const int kk = lane >> kShift;
    float logit = -INFINITY;
    if (kk < nk) {
      const float x = L == kInt8 ? __fmul_rn(dot, p.k_scale[tok0 + kk]) : dot;
      logit = page_of(c, i) * p.ps + tile_of(i) * KP + kk <= qpos[g] ? x
                                                                      : kMask;
    }
    float pmax = logit;
#pragma unroll
    for (int o = 16; o; o >>= 1)
      pmax = fmaxf(pmax, __shfl_xor_sync(kFull, pmax, o));
    const int u = g * R + slot;
    if ((lane & kShift) == 0) sm.lg[u * KP + kk] = logit;
    if (lane == 0) sm.pmax[u] = pmax;
  }

  // (C) p, corr, sum p and P.V of unit i of chunk c (slot `slot`) for
  // query g; m_prev is the running max before the unit. As in `score`,
  // slots past nk re-read the last token, with p_t = 0.
  __device__ __forceinline__ void weigh(int c, int i, int slot, int g,
                                        float m_prev) const {
    int nk;
    const size_t tok0 = token0(c, i, &nk);
    const int u = g * R + slot;
    const int kk = lane >> kShift;
    const float m_new = fmaxf(m_prev, sm.pmax[u]);
    const float pr = kk < nk ? expf(__fsub_rn(sm.lg[u * KP + kk], m_new))
                             : 0.f;
    float psum = pr;
#pragma unroll
    for (int o = 16; o > kShift; o >>= 1)
      psum = __fadd_rn(psum, __shfl_xor_sync(kFull, psum, o));
    float pv[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) pv[e] = 0.f;
#pragma unroll
    for (int t = 0; t < KP; ++t) {
      const float pt = __shfl_sync(kFull, pr, t << kShift);
      const size_t tok = tok0 + min(t, nk - 1);
      uint32_t w[LaneT::kWords];
      load_raw<L, T, DPL>(row(p.v_pages, tok), lane, vec, p.D, w);
      const float vsc = L == kInt8 ? p.v_scale[tok]
                                   : first_scale(p.v_scale, tok);
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        float v = value(w, e, p.v_scale, tok, vsc);
        if constexpr (L == kInt8) v = __fmul_rn(v, vsc);
        pv[e] = __fmaf_rn(pt, v, pv[e]);
      }
    }
    float* dst = sm.pv + static_cast<size_t>(u) * DQ + lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) dst[e] = pv[e];
    if (lane == 0) {
      sm.mnew[u] = m_new;
      sm.corr[u] = expf(__fsub_rn(m_prev, m_new));
      sm.psum[u] = psum;
    }
  }
};

template <typename T, int L, int DPL, int KP>
__device__ __forceinline__ void decode_attention(const Params& p) {
  using W = Walk<T, L, DPL, KP>;
  using P = typename W::P;
  constexpr int DQ = W::DQ, SP = W::SP;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_qi[kTileQ], s_qpos[kTileQ], s_np[kTileQ];
  __shared__ int s_nq, s_row, s_pages;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // block b = (query q0, chunk group z, head h), head fastest: the heads of
  // one query's chunk run side by side and read the same tokens' rows
  const int Z = p.split ? p.nch : 1;
  const int h = blockIdx.x % p.H;
  const int zg = (blockIdx.x / p.H) % Z;
  const int q0 = blockIdx.x / (p.H * Z);

  __shared__ int s_rows[kTileQ + 1], s_pos[kTileQ + 1];
  const int total = p.N * p.W;
  // a tile ends at the next kTileQ-th query, where the next tile starts
  const int lo = q0 % kTileQ ? -1 : 0;
  const int hi = min(kTileQ - q0 % kTileQ, total - q0);
  if (static_cast<int>(threadIdx.x) < hi - lo) {   // one query a thread
    const int g = lo + threadIdx.x;
    const int n = (q0 + g) / p.W;
    const int r = p.row_of ? p.row_of[n] : n;
    s_rows[g + 1] = min(max(r, 0), p.R - 1);
    s_pos[g + 1] = p.start[n] + (q0 + g) % p.W + p.pos_off;
  }
  __syncthreads();
  if (threadIdx.x == 0) {         // the tile this block's query starts
    int nq = 0, pages = 0;
    if (lo == 0 || s_rows[0] != s_rows[1] || s_pos[0] + 1 != s_pos[1]) {
      for (int g = 0; g < hi; ++g) {
        if (g > 0 && (s_rows[g + 1] != s_rows[1] ||
                      s_pos[g + 1] != s_pos[1] + g))
          break;
        s_qi[g] = q0 + g;
        s_qpos[g] = s_pos[g + 1];
        s_np[g] = query_pages(s_pos[g + 1], p);
        pages = max(pages, s_np[g]);
        nq = g + 1;
      }
    }
    s_nq = nq;
    s_row = s_rows[1];
    s_pages = pages;
  }
  __syncthreads();
  const int nq = s_nq;
  const int tile_chunks = (s_pages + kChunkPages - 1) / kChunkPages;
  if (nq == 0 || zg >= tile_chunks) return;
  const int D = p.D, H = p.H;
  constexpr int R = kWarps;

  W w{p, {}, lane, warp, h, R,
      p.table + static_cast<size_t>(s_row) * p.MP, s_qpos, p.vec != 0};
  carve<DQ, KP>(smem, p.split ? 0 : p.nch, &w.sm);
  w.g_lo = 0;
  if constexpr (L == kInt4) {
    w.g_lo = (h * D) / p.group;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = min(lane * DPL + e, D - 1);
      w.sidx[e] = (h * D + d) / p.group - w.g_lo;
    }
    w.one_group = w.sidx[0] == w.sidx[DPL - 1];
  }
  w.tok_stride = L == kInt4 ? static_cast<size_t>(p.PB)
      : static_cast<size_t>(H) * D * sizeof(P);
  w.head_off = L == kInt4 ? static_cast<size_t>(h) * D / 2
      : static_cast<size_t>(h) * D * sizeof(P);

  const auto units = [&](int c) {
    return (min((c + 1) * kChunkPages, s_pages) - c * kChunkPages) * p.nkt;
  };
  w.prefetch_round(zg, 0, units(zg));   // K and V fly while q is read

  // q * scale for the tile, f32, zero past D
  for (int i = threadIdx.x; i < nq * DQ; i += blockDim.x) {
    const int g = i / DQ, d = i - g * DQ;
    const T* qrow = static_cast<const T*>(p.q) +
                    (static_cast<size_t>(s_qi[g]) * H + h) * D;
    w.sm.qs[i] = d < D ? __fmul_rn(to_f32(qrow[d]), p.scale) : 0.f;
  }

  for (int c = zg; c < tile_chunks; c += Z) {
    const int nu = units(c);
    for (int g = warp; g < nq; g += R) {   // a fresh state a chunk
      float* st = w.sm.st + g * SP;
#pragma unroll
      for (int e = 0; e < DPL; ++e) st[lane * DPL + e] = 0.f;
      if (lane == 0) {
        st[DQ] = kMask;
        st[DQ + 1] = 0.f;
      }
    }
    __syncthreads();                    // qs, the fresh states
    for (int u0 = 0; u0 < nu; u0 += R) {
      const int un = min(R, nu - u0);
      const int slot = warp;            // this warp's unit of the round
      if (slot < un)                                // (B)
        for (int g = 0; g < nq; ++g)
          if (w.page_of(c, u0 + slot) < s_np[g])
            w.score(c, u0 + slot, slot, g);
      if (u0 + R < nu) w.prefetch_round(c, u0 + R, nu);
      else if (c + Z < tile_chunks)
        w.prefetch_round(c + Z, 0, units(c + Z));
      __syncthreads();
      if (slot < un)                                // (C)
        for (int g = 0; g < nq; ++g) {
          if (w.page_of(c, u0 + slot) >= s_np[g]) continue;
          float m = w.sm.st[g * SP + DQ];
          for (int v = 0; v < slot; ++v) m = fmaxf(m, w.sm.pmax[g * R + v]);
          w.weigh(c, u0 + slot, slot, g, m);
        }
      __syncthreads();
      for (int g = warp; g < nq; g += R) {          // (D)
        float* st = w.sm.st + g * SP;
        float acc[DPL], s = st[DQ + 1], m = st[DQ];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[e] = st[lane * DPL + e];
        for (int v = 0; v < un; ++v) {
          if (w.page_of(c, u0 + v) >= s_np[g]) break;
          const int u = g * R + v;
          const float corr = w.sm.corr[u];
          const float* pv = w.sm.pv + static_cast<size_t>(u) * DQ +
                            lane * DPL;
          s = __fadd_rn(__fmul_rn(s, corr), w.sm.psum[u]);
#pragma unroll
          for (int e = 0; e < DPL; ++e)
            acc[e] = __fadd_rn(__fmul_rn(acc[e], corr), pv[e]);
          m = w.sm.mnew[u];
        }
        float* dst = st;
        if (u0 + R >= nu) {             // the chunk's last round
          if (c > (s_np[g] - 1) / kChunkPages) continue;
          dst = p.split
              ? p.scratch + ((static_cast<size_t>(s_qi[g]) * H + h) * p.nch +
                             c) * SP
              : w.sm.parts + (g * p.nch + c) * SP;
        }
#pragma unroll
        for (int e = 0; e < DPL; ++e) dst[lane * DPL + e] = acc[e];
        if (lane == 0) {
          dst[DQ] = m;
          dst[DQ + 1] = s;
        }
      }
      __syncthreads();                  // the round's buffers are free
    }
  }
  if (p.split) return;                  // the merge kernel merges

  for (int g = warp; g < nq; g += R)
    merge_query<T, DPL>(w.sm.parts + g * p.nch * SP, SP,
                        (s_np[g] - 1) / kChunkPages + 1,
                        static_cast<T*>(p.out) +
                            (static_cast<size_t>(s_qi[g]) * H + h) * D,
                        D, lane);
}

// The merge of a split launch: one warp per (query, head), the chunk
// partials from `scratch` merged in chunk order (merge_query).
template <typename T, int DPL>
__device__ __forceinline__ void merge_split(const Params& p) {
  constexpr int SP = 32 * DPL + 4;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (qi >= p.N * p.W) return;
  const int h = blockIdx.y;
  const int qpos = p.start[qi / p.W] + qi % p.W + p.pos_off;
  const int nc = (query_pages(qpos, p) - 1) / kChunkPages + 1;
  merge_query<T, DPL>(
      p.scratch + (static_cast<size_t>(qi) * p.H + h) * p.nch * SP, SP, nc,
      static_cast<T*>(p.out) + (static_cast<size_t>(qi) * p.H + h) * p.D,
      p.D, lane);
}

// Host side: let `kernel` take `smem` bytes of dynamic shared memory (set
// to `max_smem` once per device, in the caller's flags `set`, for each
// kernel that needs more than 48 KB).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t smem, size_t max_smem,
                              bool (&set)[64]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && set[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(max_smem));
  if (err == cudaSuccess && dev < 64) set[dev] = true;
  return err;
}

// Host side: the plan of a launch. Fills the derived fields of `p` and
// returns the dynamic shared memory bytes, or 0 when the block does not
// fit `max_smem` (an unsplit launch keeps kTileQ x nch chunk partials
// there: past ~90 chunks at head_dim 128, only the split launch fits).
template <int L, int DPL, int KP>
inline size_t plan(Params& p, size_t elem_bytes, size_t max_smem) {
  constexpr int DQ = 32 * DPL;
  p.nkt = (p.ps + KP - 1) / KP;
  p.nch = (p.MP + kChunkPages - 1) / kChunkPages;
  if (L == kInt4) p.group = 2 * p.PB / p.G;
  // a lane's dims of a row load as one vector when the pools, the token
  // stride and the head's slice keep the lane's bytes aligned
  const size_t lane_bytes = L == kInt4 ? (DPL + 1) / 2 : DPL * elem_bytes;
  const size_t row_bytes = L == kInt4 ? p.D / 2 : p.D * elem_bytes;
  const size_t stride = L == kInt4 ? p.PB : p.H * row_bytes;
  const uintptr_t align = reinterpret_cast<uintptr_t>(p.k_pages) |
                          reinterpret_cast<uintptr_t>(p.v_pages) | stride |
                          row_bytes;
  p.vec = p.D == DQ && align % lane_bytes == 0;
  const size_t total = carve<DQ, KP>(nullptr, p.split ? 0 : p.nch, nullptr);
  return total <= max_smem ? total : 0;
}

// Host side: plan and launch (the walk, then for a split launch the merge
// kernel), or with `scratch_floats` only report the scratch f32 a (query,
// head) the launch needs: the chunk partials of a split launch, 0 for an
// unsplit one, -1 when the block does not fit.
template <int L, int DPL, int KP, typename Kernel, typename Merge>
inline cudaError_t plan_and_launch(Params p, size_t elem_bytes,
                                   size_t max_smem, bool (&smem_set)[64],
                                   Kernel kernel, Merge merge,
                                   cudaStream_t stream,
                                   long* scratch_floats) {
  const size_t smem = plan<L, DPL, KP>(p, elem_bytes, max_smem);
  if (scratch_floats) {
    *scratch_floats = !smem ? -1
        : p.split ? static_cast<long>(p.nch) * (32 * DPL + 4) : 0;
    return smem ? cudaSuccess : cudaErrorInvalidValue;
  }
  if (!smem || (p.split && !p.scratch)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem, max_smem, smem_set);
  if (err != cudaSuccess) return err;
  const long blocks = static_cast<long>(p.N) * p.W * p.H *
                      (p.split ? p.nch : 1);
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || !p.split) return err;
  merge<<<dim3((p.N * p.W + 3) / 4, p.H), 128, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace dattn
