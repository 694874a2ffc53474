// Weight-only int4 matmul (W4A16) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_w4_kernel` of paddle_tpu/ops/w4_matmul.py
// (launched there by `w4_matmul`): out[S, N] = x[S, K] @ W[K, N], with x and
// out in bf16 or f32 and W stored as int4 nibbles with one f32 scale per
// output column. packed[K2, N] (K2 = ceil(K/2), bytes) holds rows 2i and
// 2i+1 of the integer weight in the low and the high nibble of byte row i,
// each with a +8 offset (1..15; an odd K's pad nibble is 8, i.e. 0), and
// W[k, n] = (nibble - 8) * scale[n]. The dot accumulates in f32; the
// per-column scale is constant along K, so it multiplies the finished sum
// once, in the epilogue (w * s is not exact in bf16, so it is never folded
// into the weight).
//
// Route, chosen by dtype in `dispatch` (a choice, not a fallback):
//   bf16 x -> the tensor cores. The integers -7..7 are exact in bf16 and a
//     bf16 x times one is exact in f32, so bf16 products with an f32
//     accumulator on x's stored values and the unpacked integers add no
//     rounding point against the plain version (`_w4_ref`: x in f32 times
//     the dequantized f32 weight); only the order of the f32 sums
//     differs. The nibbles are unpacked on chip, never in device memory:
//     a 32-bit word of 4 packed bytes (4 columns of one packed row)
//     becomes, by a byte permute and a mask, the bf16 pairs {128 + lo,
//     128 + hi} (0x4300 | nibble), and one bf16x2 subtract of 136 gives
//     {lo - 8, hi - 8} exactly.
//   f32 x -> the SIMT body (f32 FMA chains on the CUDA cores): f32 x has
//     no exact bf16 operand.
//
// Bound, and the tensor-core design's answer:
//   decode (S <= 16) is bound by bytes: the packed weight, K*N/2 bytes,
//     is read once for 2*S*K*N flops. `w4_matmul_tc_decode_kernel`: one
//     16-row mma.sync m16n8k16 tile takes the whole x; a block of 4 warps
//     owns 32 columns, and each warp streams 32 contiguous bytes of each
//     packed row of its own K slice with 16-byte cp.async through a
//     private 3-stage ring (no block barrier in the loop), so copies stay
//     in flight while the tensor cores work. The weight fragments are
//     unpacked in registers; warp columns are permuted so that this
//     works (mma column g of n8 tile j is weight column 4g + j: the 4
//     bytes a lane needs for 4 tiles are one word, and a lane's
//     accumulator covers 8 contiguous output columns). K is split into P
//     parts (`w4_parts`: the least power of two, at most 8, that starts
//     264 blocks, 2 per SM, for the product's N), one block each, the P
//     blocks of a column tile forming a thread block cluster; the parts'
//     f32 partials are summed through distributed shared memory.
//   prefill (S > 16) is bound by operations.
//     `w4_matmul_tc_prefill_kernel`: 128 x 128 output tiles, 2 warpgroups
//     of 64 x 128 on wgmma m64n128k16; x and the packed weight come in
//     64-deep stages through a cp.async ring, and each stage's packed
//     rows are unpacked once into a K-major bf16 tile in shared memory
//     that both warpgroups read; one stage's products stay in flight
//     while the next stage is unpacked. It runs at ~0.2 of the bf16
//     peak: the x tile is read again by every column block (128 columns
//     wide) from L2, and the unpack and the block barriers share the
//     warps that issue wgmma (PERF.md).
//   Shapes whose rows are not 16-byte aligned (K % 8, N % 16, or an
//   unaligned pointer) load element by element into the same tiles: any
//   S, odd K and any N, bounds-checked, nothing padded in device memory.
//
// Schedule independence (the serving invariant: a token's row comes out
// with the same bits whether its tick holds 16 rows or 2048): the
// summation tree of an output element may depend on K and N, never on S
// or on the row's place in x. So every S takes the same K walk: the same
// k16 steps in the same order, cut into the same Q = 4 * w4_parts(K, N)
// slices of 64-deep stages (slice q holds stages [q*n_st/Q, (q+1)*n_st/Q),
// n_st = ceil(K/64)); a slice is one accumulator chain over its steps,
// and the output is ((0 + slice 0) + slice 1) + ... in slice order, times
// the scale. The decode kernel gives each warp a slice and adds them in
// that order across the cluster; the prefill kernel walks all stages and
// adds its running slice into a second accumulator at each boundary. A
// row sits at row % 16 of its mma tile, and mma.sync and wgmma give the
// same bits for the same k16 step (the smoke checks rows at S 1, 16, 17,
// 64 and 300 against the same rows of a 2048-row call). The SIMT body
// (f32) is one FMA chain per output over k in order, independent of S.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tc_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;       // SIMT body

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(kThreads) w4_matmul_simt_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale, float* __restrict__ out, int S, int K,
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
                      ? x[static_cast<size_t>(gm) * K + gk]
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
        out[static_cast<size_t>(gm) * N + gn] = acc[i][j] * scale[gn];
    }
  }
}

// ------------------------------------------------------------ tensor cores

constexpr int kTargetBlocks = 264;  // 2 blocks on each of the H100's 132 SMs
constexpr int kMaxParts = 8;        // portable thread block cluster size
constexpr int kDecWarps = 4;        // decode: warps (K slices) a block
constexpr int kWarpN = 32;          // columns a warp owns (4 n8 tiles)
constexpr int kStageK = 64;         // k a stage (4 k16 steps); x row 128 B
constexpr int kStages = 3;          // cp.async ring depth, decode
constexpr int kPreStages = 4;       // cp.async ring depth, prefill
constexpr int kDecX = 16 * kStageK * 2;          // decode x stage bytes
constexpr int kDecW = (kStageK / 2) * kWarpN;    // decode weight stage bytes
constexpr int kDecWarpSmem = kStages * (kDecX + kDecW);
constexpr int kDecPart = 16 * kWarpN * 4;       // a warp's f32 partial
constexpr int kDecSmem = kDecWarps * (kDecWarpSmem + kDecPart);
static_assert(kDecSmem <= 48 * 1024, "decode launches without an opt-in");
constexpr int kPreM = 128, kPreN = 128, kPreThreads = 256;
constexpr int kPreX = kPreM * kStageK * 2;        // x: 128 rows of 128 B
constexpr int kPreP = (kStageK / 2) * kPreN;      // 32 packed rows of 128 B
constexpr int kPreStage = kPreX + kPreP;          // a multiple of 1024
constexpr int kPreB = kPreN * kStageK * 2;        // unpacked W^T, K-major
constexpr int kPreBufs = 3;         // unpacked weight tiles
constexpr int kPreSmem = kPreStages * kPreStage + kPreBufs * kPreB + 1024;

// K parts of a product: a function of (K, N) only, never of S.
int w4_parts(int K, int N) {
  const int nk = (K + 15) / 16, tiles = (N + kWarpN - 1) / kWarpN;
  int p = 1;
  while (p < kMaxParts && tiles * p < kTargetBlocks &&
         nk >= 4 * kDecWarps * 2 * p)   // a slice keeps >= 1 stage
    p *= 2;
  return p;
}

struct W4Args {
  const __nv_bfloat16* x;
  const uint8_t* packed;
  const float* scale;
  __nv_bfloat16* out;
  int S, K, N, K2, nk, Q;
  int n_st;                          // stages of 4 k16 steps: ceil(nk / 4)
  int vec;                           // 16-byte loads are aligned
};

// The first stage of slice q (slice q holds stages [q*n_st/Q,
// (q+1)*n_st/Q); an empty slice adds 0).
__device__ __forceinline__ int slice_begin(const W4Args& a, int q) {
  return static_cast<int>(static_cast<long long>(q) * a.n_st / a.Q);
}

// One stage of x: rows [m0, m0 + rows) x k [k0, k0 + 64) into a swizzled
// tile of 128-byte rows; rows >= S and k >= K read 0. `lane`/`nlanes`: this
// thread's place among the threads that share the copy.
__device__ __forceinline__ void load_x_stage(unsigned char* xs,
                                             const W4Args& a,
                                             int m0, int rows, int k0,
                                             int lane, int nlanes) {
  if (a.vec) {
    for (int c = lane; c < rows * 8; c += nlanes) {
      const int r = c >> 3, ch = c & 7, gm = m0 + r, gk = k0 + 8 * ch;
      const bool ok = gm < a.S && gk < a.K;
      tc::cp_async16(xs + tc::swz(r, ch, 128),
                     ok ? a.x + static_cast<size_t>(gm) * a.K + gk : a.x,
                     ok ? 16 : 0);
    }
  } else {
    for (int e = lane; e < rows * kStageK; e += nlanes) {
      const int r = e / kStageK, kk = e % kStageK, gm = m0 + r, gk = k0 + kk;
      const __nv_bfloat16 v = (gm < a.S && gk < a.K)
                                  ? a.x[static_cast<size_t>(gm) * a.K + gk]
                                  : __float2bfloat16_rn(0.f);
      *reinterpret_cast<__nv_bfloat16*>(xs + tc::swz(r, kk >> 3, 128) +
                                        2 * (kk & 7)) = v;
    }
  }
}

// One stage of the packed weight: packed rows [k0/2, k0/2 + 32) x columns
// [n0, n0 + cols) into rows of `stride` bytes; rows >= K2 and columns >= N
// read 0 (their products are never stored, or meet x = 0).
__device__ __forceinline__ void load_w_stage(unsigned char* ws,
                                             const W4Args& a, int n0,
                                             int cols, int stride, int k0,
                                             int lane, int nlanes) {
  const int r0 = k0 / 2, per_row = cols / 16;
  if (a.vec) {
    for (int c = lane; c < (kStageK / 2) * per_row; c += nlanes) {
      const int r = c / per_row, ch = c % per_row, gr = r0 + r,
                gn = n0 + 16 * ch;
      const bool ok = gr < a.K2 && gn < a.N;
      tc::cp_async16(ws + r * stride + 16 * ch,
                     ok ? a.packed + static_cast<size_t>(gr) * a.N + gn
                        : a.packed,
                     ok ? 16 : 0);
    }
  } else {
    for (int e = lane; e < (kStageK / 2) * cols; e += nlanes) {
      const int r = e / cols, c = e % cols, gr = r0 + r, gn = n0 + c;
      ws[r * stride + c] = (gr < a.K2 && gn < a.N)
                               ? a.packed[static_cast<size_t>(gr) * a.N + gn]
                               : 0;
    }
  }
}

// Four packed bytes (4 columns j of one packed row i) -> for each j the
// bf16 pair {q[2i], q[2i+1]} = {lo nibble - 8, hi nibble - 8}, exactly.
__device__ __forceinline__ void unpack4(uint32_t w, uint32_t (&out)[4]) {
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  const uint32_t lo = w & 0x0F0F0F0Fu;
  const uint32_t hi = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // byte 0 <- lo byte j, byte 2 <- hi byte j; bytes 1, 3 <- 0x43
    const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
    const uint32_t v = (__byte_perm(lo, hi, sel) & 0x00FF00FFu) | 0x43004300u;
    __nv_bfloat162 f = *reinterpret_cast<const __nv_bfloat162*>(&v);
    f = __hsub2(f, off);                         // 128 + n - 136 = n - 8
    out[j] = *reinterpret_cast<const uint32_t*>(&f);
  }
}

// The bf16 B fragments of 4 n8 tiles from one packed row word per k half:
// w0 = packed row t (k 2t, 2t+1), w1 = packed row t + 4 (k 2t+8, 2t+9) of
// the k16 step, bytes j = 0..3 the columns 4g + j. b[j][0..1] feed tile j.
__device__ __forceinline__ void unpack_w4(uint32_t w0, uint32_t w1,
                                          uint32_t (&b)[4][2]) {
  uint32_t u0[4], u1[4];
  unpack4(w0, u0);
  unpack4(w1, u1);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b[j][0] = u0[j];
    b[j][1] = u1[j];
  }
}

// One k16 step of a warp: 16 x 32 (one m16 tile) += x[16 x 16] W[16 x 32].
// xs: the stage's x tile (128-byte swizzled rows, `row0` the warp's first
// row in it); ws: the stage's weight rows (`stride` bytes, `col0` the
// warp's first byte); i: the step within the stage.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const unsigned char* xs,
                                       int row0, int i, int lane) {
  tc::ldmatrix_x4(a,
                  xs + tc::swz(row0 + (lane & 15), 2 * i + (lane >> 4), 128));
}
__device__ __forceinline__ void load_b(uint32_t (&b)[4][2],
                                       const unsigned char* ws, int stride,
                                       int col0, int i, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const unsigned char* base = ws + (8 * i + t) * stride + col0 + 4 * g;
  unpack_w4(*reinterpret_cast<const uint32_t*>(base),
            *reinterpret_cast<const uint32_t*>(base + 4 * stride), b);
}

__device__ __forceinline__ void store_out(const W4Args& a, int row, int col,
                                          float v) {
  if (row < a.S && col < a.N)
    a.out[static_cast<size_t>(row) * a.N + col] =
        __float2bfloat16_rn(v * a.scale[col]);
}

// Decode: grid (ceil(N/32), P), clusters of (1, P, 1). Block p of column
// tile n0 = 32 blockIdx.x; its warp w sums slice q = 4p + w into a 16 x 32
// partial; after a cluster barrier each block adds up 1/P of the tile's
// outputs over all Q partials, in slice order, through distributed shared
// memory.
__global__ void __launch_bounds__(kDecWarps * 32) w4_matmul_tc_decode_kernel(
    W4Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int p = static_cast<int>(cluster.block_rank());
  const int P = static_cast<int>(cluster.num_blocks());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kWarpN;
  unsigned char* ring = smem + warp * kDecWarpSmem;
  float* part = reinterpret_cast<float*>(smem + kDecWarps * kDecWarpSmem);

  const int q = p * kDecWarps + warp;
  const int st0 = slice_begin(a, q);
  const int n_st = slice_begin(a, q + 1) - st0;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  auto stage_x = [&](int st) {
    return ring + (st % kStages) * (kDecX + kDecW);
  };
  auto load = [&](int st) {
    unsigned char* xs = stage_x(st);
    const int k0 = kStageK * (st0 + st);
    load_x_stage(xs, a, 0, 16, k0, lane, 32);
    load_w_stage(xs + kDecX, a, n0, kWarpN, kWarpN, k0, lane, 32);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_st) load(st);
    tc::cp_async_commit();
  }
  for (int st = 0; st < n_st; ++st) {
    tc::cp_async_wait<kStages - 2>();
    __syncwarp();                    // stage st landed; st - 1 was consumed
    if (st + kStages - 1 < n_st) load(st + kStages - 1);
    tc::cp_async_commit();
    const unsigned char* xs = stage_x(st);
    const int steps = min(4, a.nk - 4 * (st0 + st));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= steps) break;
      uint32_t af[4], bf[4][2];
      load_a(af, xs, 0, i, lane);
      load_b(bf, xs + kDecX, kWarpN, 0, i, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) tc::mma_bf16(acc[j], af, bf[j][0], bf[j][1]);
    }
  }
  // the warp's partial: mma column c of tile j is tile column 4c + j
  float* mine = part + warp * 16 * kWarpN;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mine[g * kWarpN + 8 * t + j] = acc[j][0];
    mine[g * kWarpN + 8 * t + 4 + j] = acc[j][1];
    mine[(g + 8) * kWarpN + 8 * t + j] = acc[j][2];
    mine[(g + 8) * kWarpN + 8 * t + 4 + j] = acc[j][3];
  }
  cluster.sync();
  const int per = (16 * kWarpN) / P;
  for (int e = p * per + static_cast<int>(threadIdx.x); e < (p + 1) * per;
       e += kDecWarps * 32) {
    const int row = e / kWarpN, col = e % kWarpN;
    if (row >= a.S || n0 + col >= a.N) continue;
    float v[kMaxParts][kDecWarps];   // every load in flight, then the sum
#pragma unroll
    for (int pp = 0; pp < kMaxParts; ++pp) {
      if (pp < P) {
        const float* rp = cluster.map_shared_rank(part, pp);
#pragma unroll
        for (int w = 0; w < kDecWarps; ++w) v[pp][w] = rp[w * 16 * kWarpN + e];
      }
    }
    float total = 0.f;
#pragma unroll
    for (int pp = 0; pp < kMaxParts; ++pp)
      if (pp < P) {
#pragma unroll
        for (int w = 0; w < kDecWarps; ++w) total += v[pp][w];
      }
    store_out(a, row, n0 + col, total);
  }
  cluster.sync();                    // the partials stay until all have read
}

// Prefill, packed stage: packed rows [k0/2, k0/2 + 32) x columns [n0,
// n0 + 128) into 128-byte swizzled rows; rows >= K2, columns >= N read 0.
__device__ __forceinline__ void load_p_stage(unsigned char* ps,
                                             const W4Args& a, int n0,
                                             int k0) {
  const int r0 = k0 / 2;
  if (a.vec) {
    const int r = threadIdx.x >> 3, ch = threadIdx.x & 7;
    const int gr = r0 + r, gn = n0 + 16 * ch;
    const bool ok = gr < a.K2 && gn < a.N;
    tc::cp_async16(ps + tc::swz(r, ch, 128),
                   ok ? a.packed + static_cast<size_t>(gr) * a.N + gn
                      : a.packed,
                   ok ? 16 : 0);
  } else {
    for (int e = threadIdx.x; e < (kStageK / 2) * kPreN; e += kPreThreads) {
      const int r = e / kPreN, c = e % kPreN, gr = r0 + r, gn = n0 + c;
      ps[tc::swz(r, c >> 4, 128) + (c & 15)] =
          (gr < a.K2 && gn < a.N)
              ? a.packed[static_cast<size_t>(gr) * a.N + gn]
              : 0;
    }
  }
}

// Prefill, unpack: the stage's packed rows -> W^T [128 columns][64 k] bf16,
// K-major in 128-byte swizzled rows (the wgmma B tile). Thread: packed row
// r = lane, 16 columns 16 * warp..; reads and writes are free of bank
// conflicts.
__device__ __forceinline__ void unpack_stage(unsigned char* bt,
                                             const unsigned char* ps) {
  const int r = threadIdx.x & 31, c16 = threadIdx.x >> 5;
  const uint4 w = *reinterpret_cast<const uint4*>(ps + tc::swz(r, c16, 128));
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t u[4];
    unpack4(words[q], u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 16 * c16 + 4 * q + j;
      *reinterpret_cast<uint32_t*>(bt + tc::swz(n, r >> 2, 128) +
                                   4 * (r & 3)) = u[j];
    }
  }
}

// The end of a slice: total += acc (total starts at 0). An empty slice
// adds nothing (adding its +0 would not change a total that is never -0).
__device__ __forceinline__ void flush(const float (&acc)[64],
                                      float (&total)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] += acc[i];
}

// Prefill: grid (ceil(N/128), ceil(S/128)), 2 warpgroups of 64 rows x 128
// columns on wgmma m64n128k16. x and the packed weight come through a
// 4-stage cp.async ring; each stage's packed rows are unpacked once into
// a K-major bf16 tile (two of them, so that unpacking stage st + 1
// overlaps the asynchronous wgmma of stage st) shared by both warpgroups.
// `acc` is the running slice, `total` the sum of the finished ones.
__global__ void __launch_bounds__(kPreThreads, 1) w4_matmul_tc_prefill_kernel(
    W4Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* btile = smem + kPreStages * kPreStage;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kPreM, n0 = blockIdx.x * kPreN;
  const int n_st = a.n_st;
  float acc[64], total[64];           // acc: written by wgmma alone
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] = 0.f;

  auto stage = [&](int st) { return smem + (st % kPreStages) * kPreStage; };
  auto btile_of = [&](int st) { return btile + (st % kPreBufs) * kPreB; };
  auto load = [&](int st) {
    unsigned char* xs = stage(st);
    const int k0 = kStageK * st;
    load_x_stage(xs, a, m0, kPreM, k0, threadIdx.x, kPreThreads);
    load_p_stage(xs + kPreX, a, n0, k0);
  };
  // copies run 2 stages ahead; the products of stage st stay in flight
  // while stage st + 1 is unpacked and stage st + 1's products issue
  for (int st = 0; st < 2; ++st) {
    if (st < n_st) load(st);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<1>();
  __syncthreads();
  unpack_stage(btile_of(0), stage(0) + kPreX);
  tc::fence_proxy_async();
  __syncthreads();

  // slice q holds stages [slice_begin(q), slice_begin(q + 1)); `open`: the
  // running slice has products in acc
  int q = 0, next = slice_begin(a, 1);
  bool open = false;
  for (int st = 0; st < n_st; ++st) {
    if (st >= next) {
      tc::wgmma_wait<0>();
      tc::fence_regs(acc);
      while (st >= next) {           // slice boundaries (empty slices too)
        if (open) flush(acc, total);
        open = false;
        ++q;
        next = slice_begin(a, q + 1);
      }
    }
    // this stage's products, asynchronously; a slice's first one starts
    // the sum
    const uint64_t da = tc::sw128_desc(stage(st) + wg * 64 * 128);
    const uint64_t db = tc::sw128_desc(btile_of(st));
    const int steps = min(4, a.nk - 4 * st);
    tc::fence_regs(acc);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kk < steps)
        tc::wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk,
                             open || kk > 0);
    open = true;
    tc::wgmma_commit();
    // meanwhile: stage st + 2's copies (its slots were read by the
    // products of st - 2, done), stage st + 1's weight unpacked
    if (st + 2 < n_st) load(st + 2);
    tc::cp_async_commit();
    if (st + 1 < n_st) {
      tc::cp_async_wait<1>();
      __syncthreads();
      unpack_stage(btile_of(st + 1), stage(st + 1) + kPreX);
      tc::fence_proxy_async();
    }
    tc::wgmma_wait<1>();             // the products of st - 1 are done
    tc::fence_regs(acc);
    __syncthreads();
  }
  tc::wgmma_wait<0>();
  tc::fence_regs(acc);
  if (open) flush(acc, total);       // the last slice; any after it are empty

  // d[i]: n8 tile i / 4, row g + 8 ((i / 2) % 2), column 2t + i % 2
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = m0 + 64 * wg + 16 * warp + g + 8 * ((i >> 1) & 1);
    const int col = n0 + 8 * (i >> 2) + 2 * t;
    if (row >= a.S) continue;
    if (a.vec && col + 1 < a.N) {
      *reinterpret_cast<uint32_t*>(a.out + static_cast<size_t>(row) * a.N +
                                   col) =
          tc::pack_bf16(total[i] * a.scale[col],
                        total[i + 1] * a.scale[col + 1]);
    } else {
      store_out(a, row, col, total[i]);
      store_out(a, row, col + 1, total[i + 1]);
    }
  }
}

// Allow the prefill kernel its dynamic shared memory, once a device, so
// that later launches can also be captured in a CUDA graph.
cudaError_t set_prefill_smem_once() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(w4_matmul_tc_prefill_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kPreSmem);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// route: 1 = tensor cores, decode kernel; 2 = tensor cores, prefill kernel.
cudaError_t launch_tc(const void* x, const void* packed, const float* scale,
                      void* out, int S, int K, int N, cudaStream_t st,
                      int* route) {
  W4Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.packed = static_cast<const uint8_t*>(packed);
  a.scale = scale;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.S = S;
  a.K = K;
  a.N = N;
  a.K2 = (K + 1) / 2;
  a.nk = (K + 15) / 16;
  a.n_st = (a.nk + 3) / 4;
  const int P = w4_parts(K, N);
  a.Q = kDecWarps * P;
  a.vec = K % 8 == 0 && N % 16 == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaError_t err;
  if (S <= 16) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((N + kWarpN - 1) / kWarpN, P, 1);
    cfg.blockDim = dim3(kDecWarps * 32, 1, 1);
    cfg.dynamicSmemBytes = kDecSmem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = P;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (route) *route = 1;
    err = cudaLaunchKernelEx(&cfg, w4_matmul_tc_decode_kernel, a);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  const dim3 grid((N + kPreN - 1) / kPreN, (S + kPreM - 1) / kPreM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if ((err = set_prefill_smem_once()) != cudaSuccess) return err;
  if (route) *route = 2;
  w4_matmul_tc_prefill_kernel<<<grid, kPreThreads, kPreSmem, st>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------------------ f32: SIMT

template <int BM, int BN, int BK, int TM, int TN>
cudaError_t launch_simt(const void* x, const void* packed, const float* scale,
                        void* out, int S, int K, int N, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (S + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  w4_matmul_simt_kernel<BM, BN, BK, TM, TN><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(packed),
      scale, static_cast<float*>(out), S, K, N);
  return cudaGetLastError();
}

// The route by dtype: bf16 x to the tensor cores (decode tiles for S <= 16,
// prefill tiles above; the same K slices, so the same bits, for every S),
// f32 x to the SIMT body (decode rows take 16 x 32 tiles with 128-deep
// stages, longer S 64 x 128 tiles; both walk k in the same order). route:
// 0 = SIMT.
cudaError_t dispatch(const void* x, const void* packed, const float* scale,
                     void* out, int S, int K, int N, int dtype,
                     cudaStream_t st, int* route) {
  if (dtype == 1)
    return launch_tc(x, packed, scale, out, S, K, N, st, route);
  if (dtype != 0) return cudaErrorInvalidValue;
  if (route) *route = 0;
  if (S <= 16)
    return launch_simt<16, 32, 128, 1, 2>(x, packed, scale, out, S, K, N, st);
  return launch_simt<64, 128, 32, 4, 8>(x, packed, scale, out, S, K, N, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out share it). packed: [ceil(K/2),
// N] bytes; scale: [N] f32. route (may be null): set to the body that was
// launched, 0 SIMT, 1 tensor-core decode, 2 tensor-core prefill. Returns
// the cudaError_t of the launch (0 = launched).
extern "C" int w4_matmul_forward(const void* x, const void* packed,
                                 const float* scale, void* out, int S, int K,
                                 int N, int dtype, int device, void* stream,
                                 int* route) {
  if (S < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return dispatch(x, packed, scale, out, S, K, N, dtype,
                  static_cast<cudaStream_t>(stream), route);
}

extern "C" const char* w4_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
