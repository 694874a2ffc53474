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
//   forward  s = (q*scale).k, causal/ragged-masked to -1e30; online softmax
//            over key tiles (m, l, acc), masked p forced to 0;
//            out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
//   dQ       s = (q.k)*scale, p = exp(s - lse), dp = dO.v,
//            ds = p*(dp - delta)*scale, dq = sum_k ds.k
//   dK/dV    dv = sum_q p.dO, dk = sum_q ds.q over every query head of the
//            group and every query tile at or after the key tile (causal).
// delta = sum(dO*out) per row is computed by the wrapper (a torch op), as
// the JAX wrapper computes it outside its kernels.
//
// Ragged lengths: the JAX wrapper pads L to a multiple of 128 and masks the
// padded keys with a -1e30 bias; here the kernels mask keys >= Lk and skip
// query rows >= Lq themselves, which gives the same outputs (a padded key's
// p is 0; a padded query row's dO is 0, so it adds nothing to dK/dV).
//
// dQ and dK/dV are separate kernels with no atomics: every output element is
// summed by one thread in a fixed order, so gradients are identical from run
// to run.
//
// Bound: operations. At the training shape (B 8, L 1024, H 16, D 128,
// causal) the forward does 4*B*H*L^2*D/2 = 34 GFLOP over 0.1 GB of q/k/v/out,
// far right of the card's ops:bytes ridge. This first design does the dots
// on the CUDA cores in f32 (SIMT), not on the tensor cores: one 64x64 tile
// of scores per block, 256 threads as a 16x16 grid, each thread 4x4 scores
// and 4 rows x D/16 columns of the output tile, operands staged through
// shared memory (rows padded to D+1 floats so the 16 lanes that read 16
// different rows hit 16 different banks). Causal tiles past the diagonal are
// skipped. So its ceiling is the f32 FMA rate (67 TFLOP/s), not the bf16
// tensor-core rate (989); wgmma with TMA-fed tiles is later work (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // a 16 x 16 grid of threads
constexpr float kNeg = -1e30f;
constexpr float kDenomEps = 1e-30f;

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

struct Dims {
  int B, Lq, Lk, Hq, Hkv, causal;
  float scale;
};

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
template <typename T, int D, int TM>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, Dims dm) {
  constexpr int BT = 16 * TM, DP = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                // [BT][DP] q * scale
  float* ks = qs + BT * DP;        // [BT][DP] k; then p [BT][BT + 1]
  float* vs = ks + BT * DP;        // [BT][D]
  float* ps = ks;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BT, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (dm.Hq / dm.Hkv);

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
        if (!valid[j]) s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
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

template <typename T, int D, int TM>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, Dims dm) {
  constexpr int BT = 16 * TM, DP = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                // [BT][DP]
  float* dos = qs + BT * DP;       // [BT][DP]
  float* ks = dos + BT * DP;       // [BT][DP]
  float* vs = ks + BT * DP;        // [BT][DP]; then ds [BT][BT + 1]
  float* dss = vs;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BT, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (dm.Hq / dm.Hkv);

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
        const float p = valid ? expf(s[i][j] * dm.scale - lse_r[i]) : 0.f;
        dss[(ty + 16 * i) * (BT + 1) + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]) * dm.scale;
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

template <typename T, int D, int TM>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    Dims dm) {
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
          const float p = valid ? expf(s[i][j] * dm.scale - lse_c[j]) : 0.f;
          const int at = (ty + 16 * i) * (BT + 1) + tx + 16 * j;
          ps[at] = p;
          dss[at] = p * (dp[i][j] - delta_c[j]) * dm.scale;
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

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// which: 0 forward, 1 dQ, 2 dK/dV
template <typename T, int D, int TM>
cudaError_t launch(int which, const void* q, const void* k, const void* v,
                   const void* dout, float* lse, const float* delta,
                   void* o0, void* o1, Dims dm, cudaStream_t st) {
  constexpr int BT = 16 * TM, DP = D + 1;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dout);
  cudaError_t err;
  if (which == 0) {
    const size_t smem = sizeof(float) * (2 * BT * DP + BT * D);
    auto kern = flash_fwd_kernel<T, D, TM>;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<dim3((dm.Lq + BT - 1) / BT, dm.Hq, dm.B), kThreads, smem, st>>>(
        qp, kp, vp, static_cast<T*>(o0), lse, dm);
  } else if (which == 1) {
    const size_t smem = sizeof(float) * 4 * BT * DP;
    auto kern = flash_dq_kernel<T, D, TM>;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<dim3((dm.Lq + BT - 1) / BT, dm.Hq, dm.B), kThreads, smem, st>>>(
        qp, kp, vp, gp, lse, delta, static_cast<T*>(o0), dm);
  } else {
    const size_t smem = sizeof(float) * (4 * BT * DP + 2 * BT * (BT + 1));
    auto kern = flash_dkv_kernel<T, D, TM>;
    if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<dim3((dm.Lk + BT - 1) / BT, dm.Hkv, dm.B), kThreads, smem, st>>>(
        qp, kp, vp, gp, lse, delta, static_cast<T*>(o0), static_cast<T*>(o1),
        dm);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int which, int D, const void* q, const void* k,
                     const void* v, const void* dout, float* lse,
                     const float* delta, void* o0, void* o1, Dims dm,
                     cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<T, 64, 4>(which, q, k, v, dout, lse, delta, o0, o1, dm, st);
    case 128:
      return launch<T, 128, 4>(which, q, k, v, dout, lse, delta, o0, o1, dm,
                               st);
    case 256:
      return launch<T, 256, 2>(which, q, k, v, dout, lse, delta, o0, o1, dm,
                               st);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(int which, const void* q, const void* k, const void* v,
        const void* dout, float* lse, const float* delta, void* o0, void* o1,
        int B, int Lq, int Lk, int Hq, int Hkv, int D, int causal, float scale,
        int dtype, int device, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv ||
      B > 65535 || Hq > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Dims dm{B, Lq, Lk, Hq, Hkv, causal ? 1 : 0, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(which, D, q, k, v, dout, lse, delta, o0, o1, dm,
                           st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(which, D, q, k, v, dout, lse, delta, o0,
                                   o1, dm, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs share it).
// Each returns the cudaError_t of its launch (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int Lq, int Lk, int Hq,
                         int Hkv, int D, int causal, float scale, int dtype,
                         int device, void* stream) {
  return run(0, q, k, v, nullptr, lse, nullptr, out, nullptr, B, Lq, Lk, Hq,
             Hkv, D, causal, scale, dtype, device, stream);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int B, int Lq,
                            int Lk, int Hq, int Hkv, int D, int causal,
                            float scale, int dtype, int device, void* stream) {
  return run(1, q, k, v, dout, const_cast<float*>(lse), delta, dq, nullptr, B,
             Lq, Lk, Hq, Hkv, D, causal, scale, dtype, device, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int B,
                             int Lq, int Lk, int Hq, int Hkv, int D,
                             int causal, float scale, int dtype, int device,
                             void* stream) {
  return run(2, q, k, v, dout, const_cast<float*>(lse), delta, dk, dv, B, Lq,
             Lk, Hq, Hkv, D, causal, scale, dtype, device, stream);
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
