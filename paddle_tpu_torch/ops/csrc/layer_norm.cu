// Row LayerNorm and RMSNorm for Hopper (sm_90a), f32 and bf16: the two
// forwards and dropout + residual + LayerNorm on one row walk, and
// LayerNorm's backward.
//
// Forwards. They replace the TPU kernels `_ln_kernel` and `_rms_kernel` of
// paddle_tpu/ops/layer_norm.py and `_dropout_res_ln_kernel` of
// paddle_tpu/ops/fused_ops.py: x [n, h] -> out [n, h] in x's dtype, f32
// statistics, the affine in f32 before the one cast.
//   LayerNorm: mu = mean(x), var = mean((x - mu)^2) (two passes over the
//     row in registers), rstd = 1 / sqrt(var + eps),
//     out = cast((x - mu) * rstd * w + b); each row's mu and rstd are
//     written too ([n] f32 each) for the backward.
//   RMSNorm: rstd = 1 / sqrt(mean(x^2) + eps), out = cast(x * rstd * w).
//   Dropout + residual + LayerNorm: as the row is loaded, in f32,
//     v = (bits <= thresh ? x / f32(1 - p) : 0) + r   (v = x + r at p 0),
//     with thresh = int((1 - p) * (2^32 - 1)), the TPU kernel's keep rule;
//     cast(v) is written as h [n, h], and LayerNorm runs on v (mean and
//     rstd not written). The TPU kernel draws its bits from the chip's
//     generator, which nothing else reproduces; the bits here are the
//     caller's uint32 [n, h] or counter_hash.cuh's hash of the flat index
//     row * h + col and the salt (seed mod 2^31), so the mask does not
//     depend on which warp takes which row.
// w and b are [h] in their own dtype (f32 or bf16), read as f32.
// Bound: bytes (h = 2048 bf16 is 4 KB read and 4 KB written a row for ~8
// flops an element, far left of the card's ridge; the dropout mode reads
// and writes twice that, with ~12 integer operations an element for the
// hash and an IEEE divide). Design: a row belongs to a group of `wpr`
// warps: one warp where the row fits 8 vectors a lane
// (h <= 2048 in bf16, 1024 in f32), more above. A lane loads its part of
// the row in 16-byte vectors (8 bf16 or 4 f32), neighbouring lanes on
// neighbouring vectors, and keeps them in registers for both passes and
// the output. Sums are warp butterflies; only a group of several warps
// adds one partial a warp through shared memory, behind its own named
// barrier. A block of up to 8 warps copies w and b into shared memory
// once, and its groups then walk rows with the grid's stride; the grid is
// the blocks resident on the card at once, so w and b leave device memory
// once a block, not once a row.
//
// Backward. It replaces no Pallas kernel: it is the counterpart of the
// JAX `_ln_bwd`, a custom VJP over the jnp reference `_ln_ref` that XLA
// fuses on the TPU. On this card PyTorch autograd of the same reference is
// a chain of eager launches, each reading and writing whole [n, h] tensors
// (1.35 ms of device time at [8192, 2048] bf16, tools/kernel_ab.py); this
// kernel reads x and g once and writes dx once. It computes
// the vjp of `_ln_ref` (normalise, cast, then scale and shift in x's
// dtype) at that function's rounding points, with c() a cast to x's dtype
// and xhat = (x - mu) * rstd in f32 from the forward's saved mu and rstd:
//   dxh = f32(c(g * c(w)))
//   dx  = c(rstd * (dxh - mean(dxh) - xhat * mean(dxh * xhat)))
//   dw  = c_w(c(sum over rows of f32(c(g * c(xhat)))))
//   db  = c_w(c(sum over rows of f32(g)))
// c_w casts to w's dtype. Bound: bytes, 3 n h s (s = x's element size)
// plus the partials below. Design: a group of warps per row, each lane
// owning 8 values of the row's columns (one bf16 or two f32 vectors) for
// the whole walk, so c(w) and the lane's column sums of dw and db stay in
// registers (16 values a lane, or two rows at a time, ran slower at GPT's
// and BERT's rows: fewer warps fit an SM). Each row is read into
// registers once: a first pass sums
// mean(dxh) and mean(dxh * xhat) over the row (butterflies, then the
// group's partials as in the forward) and adds to the column sums, a
// second recomputes xhat and dxh from the registers and writes dx. At the
// end a block adds its groups' column sums in group order in shared
// memory and writes one f32 partial row of dw and one of db ([2, grid,
// h]); a second, small launch sums the partials in block order and casts.
// No float atomics: the bits are equal from run to run. They depend on the
// grid, which is the number of blocks resident on the card at once
// (`layer_norm_backward_grid`).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "counter_hash.cuh"

namespace {

constexpr int kMaxH = 8192;
constexpr int kFwdWarps = 8;      // warps a forward block, at most
constexpr int kFwdVecs = 8;       // row vectors a lane holds in the forward
constexpr int kBwdWarps = 16;     // warps a backward block, at most
constexpr int kBwdVals = 8;       // row columns a lane owns in the backward
constexpr int kFinishSlices = 8;  // warps summing one column's partials
constexpr unsigned kFull = 0xffffffffu;

// Elements of T in one 16-byte vector.
template <typename T>
struct Vec {
  static constexpr int kN = 16 / static_cast<int>(sizeof(T));
};

__device__ __forceinline__ float lo_bf16(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// x rounded to T (the cast c() of the header), as f32.
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// K values of T from p as f32: 16-byte loads (8-byte for 4 bf16).
template <int K>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < K / 4; ++i) {
    const float4 u = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = u.x;
    v[4 * i + 1] = u.y;
    v[4 * i + 2] = u.z;
    v[4 * i + 3] = u.w;
  }
}
template <int K>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* v) {
  if constexpr (K % 8 == 0) {
#pragma unroll
    for (int i = 0; i < K / 8; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[8 * i + 2 * j] = lo_bf16(w[j]);
        v[8 * i + 2 * j + 1] = hi_bf16(w[j]);
      }
    }
  } else {
    static_assert(K == 4, "4 or a multiple of 8 bf16 values");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = lo_bf16(u.x);
    v[1] = hi_bf16(u.x);
    v[2] = lo_bf16(u.y);
    v[3] = hi_bf16(u.y);
  }
}

// One 16-byte vector of T, kept packed in registers, to f32 and back.
__device__ __forceinline__ void unpack(uint4 u, float* v, float*) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float* v, __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = lo_bf16(w[j]);
    v[2 * j + 1] = hi_bf16(w[j]);
  }
}
__device__ __forceinline__ uint4 pack(const float* v, float*) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float* v, __nv_bfloat16*) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Each of v[0..K) summed over the `wpr` warps of a row group: butterflies
// in the warp (every lane ends with the same bits), then, for wpr > 1, one
// partial a warp through `red` (the group's K * wpr floats of the slot the
// caller alternates between calls, so no write meets a slower warp's read
// of the call before), read back in warp order behind the group's named
// barrier (id 1 + group; 0 is __syncthreads').
template <int K>
__device__ __forceinline__ void group_sum(float (&v)[K], float* red, int wpr,
                                          int grp, int sub, int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v[k] += __shfl_xor_sync(kFull, v[k], o);
  }
  if (wpr == 1) return;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[sub * K + k] = v[k];
  }
  named_sync(1 + grp, wpr * 32);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t = 0.f;
    for (int j = 0; j < wpr; ++j) t += red[j * K + k];
    v[k] = t;
  }
}

// The forwards' modes.
enum Mode : int { kLayer = 0, kRms = 1, kDropRes = 2 };

// The dropout + residual mode's rule (unused in the other modes).
struct DropRule {
  float keep_div;          // f32(1 - p): a kept x is divided by it
  uint32_t thresh;         // keep iff bits <= thresh
  uint32_t salt_col;       // salt * kCol mod 2^32 (the hash bits)
  int on;                  // 0: no dropout (p 0 or not training)
};

// The dropout + residual mode's operands and rule as the host passes
// them; the kernel takes the pointers as restrict parameters, so that it
// may load a row's next vectors before it stores h.
struct Drop {
  const void* r;           // residual [n, h], x's dtype
  const uint32_t* bits;    // the caller's bits [n, h], or null: the hash
  void* hout;              // h = dropout(x) + r [n, h], x's dtype
  DropRule rule;
};

// The forward row walk: LayerNorm, RMSNorm (b, mean, rstd unused) or
// dropout + residual + LayerNorm (mean, rstd unused). N vectors of T a
// lane; a lane's k-th vector is (k * wpr + warp in group) * 32 + lane, so
// a warp reads 512 contiguous bytes at each k.
template <int MODE, typename T, typename W, int N>
__global__ void __launch_bounds__(kFwdWarps * 32, 2) norm_fwd_kernel(
    const T* __restrict__ x, const W* __restrict__ w,
    const W* __restrict__ b, T* __restrict__ out, float* __restrict__ mean,
    float* __restrict__ rstd, int n, int h, int wpr, float eps,
    const T* __restrict__ r, const uint32_t* __restrict__ bits,
    T* __restrict__ hout, DropRule d) {
  constexpr int V = Vec<T>::kN;
  constexpr bool kRmsMode = MODE == kRms;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2 * kFwdWarps];
  W* ws = reinterpret_cast<W*>(smem);
  W* bs = ws + h;
  const int chunks = h * static_cast<int>(sizeof(W)) / 16;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    reinterpret_cast<uint4*>(ws)[i] = reinterpret_cast<const uint4*>(w)[i];
    if constexpr (!kRmsMode)
      reinterpret_cast<uint4*>(bs)[i] = reinterpret_cast<const uint4*>(b)[i];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = blockDim.x / 32 / wpr;
  const int grp = warp / wpr, sub = warp % wpr;
  const int nvec = h / V;
  int slot = 0;
  for (int row = blockIdx.x * groups + grp; row < n;
       row += gridDim.x * groups) {
    const size_t at = static_cast<size_t>(row) * h;
    float v[N][V];
    float s[1] = {0.f};
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int c = (k * wpr + sub) * 32 + lane;
      if (c < nvec) {
        load_f32<V>(x + at + c * V, v[k]);
        if constexpr (MODE == kDropRes) {
          float rv[V];
          load_f32<V>(r + at + c * V, rv);
          if (d.on) {
            uint32_t kb[V];
            if (bits) {
#pragma unroll
              for (int j = 0; j < V; j += 4) {
                const uint4 u =
                    *reinterpret_cast<const uint4*>(bits + at + c * V + j);
                kb[j] = u.x;
                kb[j + 1] = u.y;
                kb[j + 2] = u.z;
                kb[j + 3] = u.w;
              }
            } else {
#pragma unroll
              for (int j = 0; j < V; ++j)
                kb[j] = counter_hash::element_bits(
                    static_cast<uint32_t>(at + c * V + j), d.salt_col);
            }
#pragma unroll
            for (int j = 0; j < V; ++j)
              v[k][j] = kb[j] <= d.thresh ? __fdiv_rn(v[k][j], d.keep_div)
                                          : 0.f;
          }
#pragma unroll
          for (int j = 0; j < V; ++j) v[k][j] = __fadd_rn(v[k][j], rv[j]);
          *reinterpret_cast<uint4*>(hout + at + c * V) =
              pack(v[k], static_cast<T*>(nullptr));
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) v[k][j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) s[0] += v[k][j];
    }
    float mu = 0.f;
    if constexpr (!kRmsMode) {
      group_sum(s, red + slot * kFwdWarps + grp * wpr, wpr, grp, sub, lane);
      slot ^= 1;
      mu = s[0] / h;
    }
    float q[1] = {0.f};
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if ((k * wpr + sub) * 32 + lane < nvec) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float dl = v[k][j] - mu;
          q[0] = fmaf(dl, dl, q[0]);
        }
      }
    }
    group_sum(q, red + slot * kFwdWarps + grp * wpr, wpr, grp, sub, lane);
    slot ^= 1;
    const float inv = 1.f / sqrtf(q[0] / h + eps);
    T* orow = out + at;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int c = (k * wpr + sub) * 32 + lane;
      if (c >= nvec) continue;
      float wv[V], o[V];
      load_f32<V>(ws + c * V, wv);
      if constexpr (kRmsMode) {
#pragma unroll
        for (int j = 0; j < V; ++j) o[j] = v[k][j] * inv * wv[j];
      } else {
        float bv[V];
        load_f32<V>(bs + c * V, bv);
#pragma unroll
        for (int j = 0; j < V; ++j) o[j] = (v[k][j] - mu) * inv * wv[j] + bv[j];
      }
      *reinterpret_cast<uint4*>(orow + c * V) = pack(o, static_cast<T*>(nullptr));
    }
    if constexpr (MODE == kLayer) {
      if (sub == 0 && lane == 0) {
        mean[row] = mu;
        rstd[row] = inv;
      }
    }
  }
}

// The block's column sums `acc` (this lane's N vectors of columns) added
// over its groups in group order through `comb` [h], the last group's
// sums written to `dst` [h]; every thread of the block calls it.
template <int N, int V>
__device__ __forceinline__ void combine_groups(const float (&acc)[N][V],
                                               float* comb, float* dst,
                                               int groups, int grp, int wpr,
                                               int sub, int lane, int nvec) {
  for (int gi = 0; gi < groups; ++gi) {
    if (grp == gi) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int c = (k * wpr + sub) * 32 + lane;
        if (c >= nvec) continue;
        float t[V];
#pragma unroll
        for (int j = 0; j < V; ++j) t[j] = acc[k][j];
        if (gi) {
          float prev[V];
          load_f32<V>(comb + c * V, prev);
#pragma unroll
          for (int j = 0; j < V; ++j) t[j] = prev[j] + t[j];
        }
        float* to = gi == groups - 1 ? dst : comb;
#pragma unroll
        for (int j = 0; j < V; j += 4)
          *reinterpret_cast<float4*>(to + c * V + j) =
              make_float4(t[j], t[j + 1], t[j + 2], t[j + 3]);
      }
    }
    __syncthreads();
  }
}

// LayerNorm's backward (see the header). N vectors of T a lane; part [2,
// gridDim.x, h] takes the block's column sums of dw's and db's terms.
template <typename T, typename W, int N>
__global__ void __launch_bounds__(kBwdWarps * 32) layer_norm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const W* __restrict__ w, const float* __restrict__ mean,
    const float* __restrict__ rstd, T* __restrict__ dx,
    float* __restrict__ part, int n, int h, int wpr) {
  constexpr int V = Vec<T>::kN;
  T* const tag = nullptr;
  extern __shared__ __align__(16) float comb[];
  __shared__ float red[2 * kBwdWarps * 2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = blockDim.x / 32 / wpr;
  const int grp = warp / wpr, sub = warp % wpr;
  const int nvec = h / V;
  uint4 wc[N];                  // c(w) of the lane's columns, packed as T
  float adw[N][V], adb[N][V];   // the lane's column sums
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int c = (k * wpr + sub) * 32 + lane;
    float t[V];
    if (c < nvec) {
      load_f32<V>(w + c * V, t);
#pragma unroll
      for (int j = 0; j < V; ++j) t[j] = rnd<T>(t[j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) t[j] = 0.f;
    }
    wc[k] = pack(t, tag);
#pragma unroll
    for (int j = 0; j < V; ++j) adw[k][j] = adb[k][j] = 0.f;
  }
  int slot = 0;
  for (int row = blockIdx.x * groups + grp; row < n;
       row += gridDim.x * groups) {
    const float mu = mean[row], rs = rstd[row];
    uint4 xr[N], gr[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int c = (k * wpr + sub) * 32 + lane;
      if (c < nvec) {
        const size_t at = static_cast<size_t>(row) * h + c * V;
        xr[k] = *reinterpret_cast<const uint4*>(x + at);
        gr[k] = *reinterpret_cast<const uint4*>(g + at);
      } else {
        xr[k] = gr[k] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float sums[2] = {0.f, 0.f};   // sum(dxh), sum(dxh * xhat)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float xv[V], gv[V], wv[V];
      unpack(xr[k], xv, tag);
      unpack(gr[k], gv, tag);
      unpack(wc[k], wv, tag);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        // off the row: zero g and w give zero terms and sums
        const float xhat = (xv[j] - mu) * rs;
        const float d = rnd<T>(gv[j] * wv[j]);
        adw[k][j] += rnd<T>(gv[j] * rnd<T>(xhat));
        adb[k][j] += gv[j];
        sums[0] += d;
        sums[1] += d * xhat;
      }
    }
    group_sum(sums, red + slot * (kBwdWarps * 2) + grp * wpr * 2, wpr, grp,
              sub, lane);
    slot ^= 1;
    const float m1 = sums[0] / h, m2 = sums[1] / h;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int c = (k * wpr + sub) * 32 + lane;
      if (c >= nvec) continue;
      float xv[V], gv[V], wv[V], o[V];
      unpack(xr[k], xv, tag);
      unpack(gr[k], gv, tag);
      unpack(wc[k], wv, tag);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xhat = (xv[j] - mu) * rs;
        const float d = rnd<T>(gv[j] * wv[j]);
        o[j] = rs * (d - m1 - xhat * m2);
      }
      *reinterpret_cast<uint4*>(dx + static_cast<size_t>(row) * h + c * V) =
          pack(o, tag);
    }
  }
  float* pdw = part + static_cast<size_t>(blockIdx.x) * h;
  float* pdb = part + (static_cast<size_t>(gridDim.x) + blockIdx.x) * h;
  combine_groups(adw, comb, pdw, groups, grp, wpr, sub, lane, nvec);
  combine_groups(adb, comb, pdb, groups, grp, wpr, sub, lane, nvec);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// dw (blockIdx.y 0) and db (1): each of the block's 32 columns summed over
// the `blocks` partial rows, warp s taking rows s, s + 8, ... and the 8
// warps' sums added in warp order; rounded to x's dtype, then stored in
// w's.
template <typename T, typename W>
__global__ void __launch_bounds__(kFinishSlices * 32) layer_norm_bwd_finish(
    const float* __restrict__ part, W* __restrict__ dw, W* __restrict__ db,
    int blocks, int h) {
  __shared__ float red[kFinishSlices][32];
  const int lane = threadIdx.x % 32, slice = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  const float* p = part + static_cast<size_t>(blockIdx.y) * blocks * h + col;
  float s = 0.f;
#pragma unroll 4
  for (int i = slice; i < blocks; i += kFinishSlices)
    s += p[static_cast<size_t>(i) * h];
  red[slice][lane] = s;
  __syncthreads();
  if (slice) return;
  float t = 0.f;
#pragma unroll
  for (int j = 0; j < kFinishSlices; ++j) t += red[j][lane];
  store1((blockIdx.y ? db : dw) + col, rnd<T>(t));
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Warps a row takes (at most `per` vectors of T a lane) and the vectors a
// lane then holds.
template <typename T>
void row_split(int h, int per, int* wpr, int* nv) {
  const int nvec = h / Vec<T>::kN;
  *wpr = (nvec + 32 * per - 1) / (32 * per);
  *nv = (nvec + 32 * *wpr - 1) / (32 * *wpr);
}

// Blocks of `kernel` (`threads`, `smem` dynamic bytes) resident on the
// device at once, cached per device and width by the caller.
template <typename K>
cudaError_t resident(K kernel, int threads, size_t smem, int device, int h,
                     int (&cache)[8][kMaxH / 128 + 1], int* blocks) {
  const int i = h / 128;
  if (device >= 0 && device < 8 && cache[device][i]) {
    *blocks = cache[device][i];
    return cudaSuccess;
  }
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  if (device >= 0 && device < 8) cache[device][i] = *blocks;
  return cudaSuccess;
}

template <int MODE, typename T, typename W, int N>
cudaError_t launch_fwd(const void* x, const void* w, const void* b,
                       void* out, float* mean, float* rstd, int n, int h,
                       int wpr, float eps, const Drop& d, int device,
                       cudaStream_t st) {
  static int cache[8][kMaxH / 128 + 1];
  auto kernel = norm_fwd_kernel<MODE, T, W, N>;
  const int groups = kFwdWarps / wpr, threads = groups * wpr * 32;
  const size_t smem =
      static_cast<size_t>(h) * sizeof(W) * (MODE == kRms ? 1 : 2);
  int blocks = 0;
  cudaError_t err = resident(kernel, threads, smem, device, h, cache, &blocks);
  if (err != cudaSuccess) return err;
  const int grid = blocks < (n + groups - 1) / groups
                       ? blocks : (n + groups - 1) / groups;
  kernel<<<grid, threads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const W*>(b), static_cast<T*>(out), mean, rstd, n, h, wpr,
      eps, static_cast<const T*>(d.r), d.bits, static_cast<T*>(d.hout),
      d.rule);
  return cudaGetLastError();
}

// The forward for x of T and weights of W: the instantiation of the
// smallest vectors-a-lane count that holds the lane's part of the row.
template <int MODE, typename T, typename W>
cudaError_t dispatch_fwd(const void* x, const void* w, const void* b,
                         void* out, float* mean, float* rstd, int n, int h,
                         float eps, const Drop& d, int device,
                         cudaStream_t st) {
  int wpr, nv;
  row_split<T>(h, kFwdVecs, &wpr, &nv);
#define FWD_CASE(P)                                                        \
  if (nv <= P)                                                             \
    return launch_fwd<MODE, T, W, P>(x, w, b, out, mean, rstd, n, h, wpr,  \
                                     eps, d, device, st);
  FWD_CASE(1)
  FWD_CASE(2)
  FWD_CASE(3)
  FWD_CASE(4)
  FWD_CASE(6)
  FWD_CASE(8)
#undef FWD_CASE
  return cudaErrorInvalidValue;
}

template <int MODE>
int forward(const void* x, const void* w, const void* b, void* out,
            float* mean, float* rstd, int n, int h, float eps, int dtype,
            int wdtype, const Drop& d, int device, void* stream) {
  if (n < 1 || h < 128 || h > kMaxH || h % 128 || !aligned16(x) ||
      !aligned16(w) || !aligned16(out) || (MODE != kRms && !aligned16(b)))
    return cudaErrorInvalidValue;
  if (MODE == kDropRes && (!aligned16(d.r) || !aligned16(d.hout) ||
                           (d.bits && !aligned16(d.bits))))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD_TYPES(C, WC, TT, WT)                                           \
  if (dtype == C && wdtype == WC)                                          \
    return dispatch_fwd<MODE, TT, WT>(x, w, b, out, mean, rstd, n, h, eps, \
                                      d, device, st);
  FWD_TYPES(0, 0, float, float)
  FWD_TYPES(0, 1, float, __nv_bfloat16)
  FWD_TYPES(1, 0, __nv_bfloat16, float)
  FWD_TYPES(1, 1, __nv_bfloat16, __nv_bfloat16)
#undef FWD_TYPES
  return cudaErrorInvalidValue;
}

// The backward's launch shape for x of T at width h: warps a row, vectors
// a lane, the block's threads, rows a block takes at once. A lane owns
// kBwdVals values, or twice or four times that where a row would
// otherwise need more than a block's kBwdWarps warps (h > 4096).
template <typename T>
void bwd_shape(int h, int* wpr, int* nv, int* threads, int* rows) {
  int per = kBwdVals / Vec<T>::kN;
  while (h / Vec<T>::kN > 32 * kBwdWarps * per) per *= 2;
  row_split<T>(h, per, wpr, nv);
  *rows = kBwdWarps / *wpr;
  *threads = *rows * *wpr * 32;
}

// grid == 0: only the grid (into *grid_out); else launch both kernels.
template <typename T, typename W, int N>
cudaError_t run_bwd(const void* x, const void* g, const void* w,
                    const float* mean, const float* rstd, void* dx, void* dw,
                    void* db, float* part, int grid, int* grid_out, int n,
                    int h, int wpr, int threads, int rows, int device,
                    cudaStream_t st) {
  static int cache[8][kMaxH / 128 + 1];
  auto kernel = layer_norm_bwd_kernel<T, W, N>;
  const size_t smem = static_cast<size_t>(h) * sizeof(float);
  if (!grid) {
    int blocks = 0;
    cudaError_t err =
        resident(kernel, threads, smem, device, h, cache, &blocks);
    if (err != cudaSuccess) return err;
    const int need = (n + rows - 1) / rows;
    *grid_out = blocks < need ? blocks : need;
    return cudaSuccess;
  }
  kernel<<<grid, threads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const W*>(w), mean, rstd, static_cast<T*>(dx), part, n, h,
      wpr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  layer_norm_bwd_finish<T, W><<<dim3(h / 32, 2), kFinishSlices * 32, 0, st>>>(
      part, static_cast<W*>(dw), static_cast<W*>(db), grid, h);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t dispatch_bwd(const void* x, const void* g, const void* w,
                         const float* mean, const float* rstd, void* dx,
                         void* dw, void* db, float* part, int grid,
                         int* grid_out, int n, int h, int device,
                         cudaStream_t st) {
  int wpr, nv, threads, rows;
  bwd_shape<T>(h, &wpr, &nv, &threads, &rows);
#define BWD_CASE(P)                                                        \
  if (nv <= P)                                                             \
    return run_bwd<T, W, P>(x, g, w, mean, rstd, dx, dw, db, part, grid,   \
                            grid_out, n, h, wpr, threads, rows, device, st);
  BWD_CASE(1)
  BWD_CASE(2)
  if constexpr (sizeof(T) == 4) {
    BWD_CASE(3)
    BWD_CASE(4)
  }
#undef BWD_CASE
  return cudaErrorInvalidValue;
}

int backward(const void* x, const void* g, const void* w, const float* mean,
             const float* rstd, void* dx, void* dw, void* db, float* part,
             int grid, int* grid_out, int n, int h, int dtype, int wdtype,
             int device, void* stream) {
  if (n < 1 || h < 128 || h > kMaxH || h % 128 || grid < 0)
    return cudaErrorInvalidValue;
  if (grid && (!aligned16(x) || !aligned16(g) || !aligned16(w) ||
               !aligned16(dx) || !aligned16(part)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BWD_TYPES(C, WC, TT, WT)                                           \
  if (dtype == C && wdtype == WC)                                          \
    return dispatch_bwd<TT, WT>(x, g, w, mean, rstd, dx, dw, db, part,     \
                                grid, grid_out, n, h, device, st);
  BWD_TYPES(0, 0, float, float)
  BWD_TYPES(0, 1, float, __nv_bfloat16)
  BWD_TYPES(1, 0, __nv_bfloat16, float)
  BWD_TYPES(1, 1, __nv_bfloat16, __nv_bfloat16)
#undef BWD_TYPES
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype / wdtype: 0 = float32, 1 = bfloat16 (x and out share dtype; w and b
// share wdtype). h % 128 == 0, h <= 8192; x, w, b, out 16-byte aligned.
// mean and rstd ([n] f32) take each row's statistics. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int layer_norm_forward(const void* x, const void* w,
                                  const void* b, void* out, float* mean,
                                  float* rstd, int n, int h, float eps,
                                  int dtype, int wdtype, int device,
                                  void* stream) {
  return forward<kLayer>(x, w, b, out, mean, rstd, n, h, eps, dtype, wdtype,
                         Drop{}, device, stream);
}

// RMSNorm: the same codes, shapes and return value, no bias or statistics.
extern "C" int rms_norm_forward(const void* x, const void* w, void* out,
                                int n, int h, float eps, int dtype,
                                int wdtype, int device, void* stream) {
  return forward<kRms>(x, w, nullptr, out, nullptr, nullptr, n, h, eps,
                       dtype, wdtype, Drop{}, device, stream);
}

// Dropout + residual + LayerNorm: out = LN(h) and h = dropout(x) + r, both
// [n, h] in x's dtype, from x and r [n, h] (x's dtype) and w, b [h]; the
// same codes and shapes as layer_norm_forward, r, hout and bits 16-byte
// aligned too. bits: the caller's uint32 [n, h], or null for the hash of
// `salt` (seed mod 2^31); p <= 0 skips the mask. Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int dropout_res_ln_forward(const void* x, const void* r,
                                      const void* w, const void* b,
                                      const void* bits, void* out,
                                      void* hout, int n, int h, float eps,
                                      double p, unsigned int salt, int dtype,
                                      int wdtype, int device, void* stream) {
  const bool on = p > 0.0;
  const Drop d{r, static_cast<const uint32_t*>(bits), hout,
               DropRule{static_cast<float>(1.0 - p),
                        on ? counter_hash::keep_thresh(p) : 0u,
                        salt * counter_hash::kCol, on}};
  return forward<kDropRes>(x, w, b, out, nullptr, nullptr, n, h, eps, dtype,
                           wdtype, d, device, stream);
}

// The grid of LayerNorm's backward for [n, h] on `device` (the blocks
// resident at once, or fewer for small n), for sizing its partials
// [2, grid, h] f32. Returns the cudaError_t of the query (0 = ok).
extern "C" int layer_norm_backward_grid(int n, int h, int dtype, int wdtype,
                                        int device, int* grid) {
  return backward(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, 0, grid, n, h, dtype, wdtype,
                  device, nullptr);
}

// LayerNorm's backward: dx [n, h] (x's dtype), dw and db [h] (w's dtype)
// from x and g [n, h], w [h] and the forward's mean and rstd [n], through
// `part` [2, grid, h] f32, `grid` from layer_norm_backward_grid. Two
// launches; returns the cudaError_t (0 = launched).
extern "C" int layer_norm_backward(const void* x, const void* g,
                                   const void* w, const float* mean,
                                   const float* rstd, void* dx, void* dw,
                                   void* db, float* part, int grid, int n,
                                   int h, int dtype, int wdtype, int device,
                                   void* stream) {
  if (grid < 1) return cudaErrorInvalidValue;
  return backward(x, g, w, mean, rstd, dx, dw, db, part, grid, nullptr, n, h,
                  dtype, wdtype, device, stream);
}

extern "C" const char* layer_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
