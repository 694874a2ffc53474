// AdamW updates of a list of flat tensors, in place, in one launch, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_adamw_kernel` of paddle_tpu/ops/fused_ops.py
// (one pallas_call a tensor). Per element, in f32:
//   g  = float(G(float(g) * s))          (only when a clip scale s is given)
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + ((1 - b2) * g) * g
//   p' = p - lr * ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd * p)
// then p', m' and v' are each cast to their own dtype and written over p,
// m and v: the update is in place, so a step allocates nothing (the TPU
// kernel writes new arrays). With an f32 master copy (multi_precision),
// p above is the master: it is read and written in f32, and the
// parameter, which is then bf16, gets its rounded value. The clip scale
// is read from device memory (the global-norm clip's 0-d f32 tensor), so
// the host never waits for the norm; multiplying and rounding the
// gradient to its own dtype here is what the clip's separate pass did.
//
// Types: p, g and the slots (m and v together) each f32 or bf16; the
// master is f32. All hyper-parameters are f32 kernel arguments; 1 - b1 and
// 1 - b2 are formed on the host in double, as the JAX kernel's Python
// constants are. Every product and sum is written with the _rn
// intrinsics (the division and square root exact, IEEE round to
// nearest), so nvcc contracts nothing into an FMA and the kernel rounds
// where the plain PyTorch version (one op at a time) does: every element
// has the same bits whichever list, launch or position it is updated in.
//
// Bound: bytes. At bf16 p, g, m and v an element reads 8 B and writes 6 B
// (14 B) for ~15 flops, far left of the card's ops:bytes ridge.
//
// The loop (adamw.cuh): one launch updates a group of tensors that share
// their dtypes, the list travelling as a kernel parameter, up to
// adamw_capacity() tensors a launch.
#include "adamw.cuh"

namespace {

using adamw::Hyper;

// One element's update, with the exact _rn chain above.
struct Exact {
  template <typename G>
  static __device__ __forceinline__ void apply(float& p, float g, float& m,
                                               float& v, bool clip, float s,
                                               const Hyper& hp) {
    const float gk = clip ? adamw::round_to<G>(__fmul_rn(g, s)) : g;
    const float mk = __fadd_rn(__fmul_rn(hp.b1, m), __fmul_rn(hp.omb1, gk));
    const float vk = __fadd_rn(__fmul_rn(hp.b2, v),
                               __fmul_rn(__fmul_rn(hp.omb2, gk), gk));
    const float mhat = __fdiv_rn(mk, hp.bc1);
    const float vhat = __fdiv_rn(vk, hp.bc2);
    const float ratio = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), hp.eps));
    const float upd = __fadd_rn(ratio, __fmul_rn(hp.wd, p));
    p = __fsub_rn(p, __fmul_rn(hp.lr, upd));
    m = mk;
    v = vk;
  }
};

template <typename P, typename G, typename S>
cudaError_t by_master(bool master, const adamw::Group& grp,
                      const float* scale, const Hyper& hp, int device,
                      cudaStream_t st, int* launches) {
  if (master)
    return adamw::launch<Exact, P, G, S, true>(grp, scale, hp, device, st,
                                               launches);
  return adamw::launch<Exact, P, G, S, false>(grp, scale, hp, device, st,
                                              launches);
}

template <typename P, typename G>
cudaError_t by_slot(int sdtype, bool master, const adamw::Group& grp,
                    const float* scale, const Hyper& hp, int device,
                    cudaStream_t st, int* launches) {
  if (sdtype == 0)
    return by_master<P, G, float>(master, grp, scale, hp, device, st,
                                  launches);
  if (sdtype == 1)
    return by_master<P, G, __nv_bfloat16>(master, grp, scale, hp, device, st,
                                          launches);
  return cudaErrorInvalidValue;
}

}  // namespace

// One AdamW update of `count` tensors that share their dtypes, in as few
// launches as the parameter space allows (one up to adamw_capacity()
// tensors). ptrs: [count][5] host array of p, g, m, v and the f32 master
// (null for all, or for none, as `has_master` says); numels: [count].
// dtype codes: 0 = float32, 1 = bfloat16 (pdtype: p; gdtype: g; sdtype:
// m and v). scale (one f32 on the card) may be null. *launches is set to
// the number of launches made. Returns the cudaError_t of the launches (0
// = launched).
extern "C" int adamw_update_multi(const void* const* ptrs,
                                  const long long* numels, int count,
                                  const void* scale, float lr, float b1,
                                  float omb1, float b2, float omb2, float eps,
                                  float wd, float bc1, float bc2, int pdtype,
                                  int gdtype, int sdtype, int has_master,
                                  int device, void* stream, int* launches) {
  *launches = 0;
  if (count < 0) return cudaErrorInvalidValue;
  if (count == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Hyper hp{lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2};
  const adamw::Group grp{ptrs, numels, count};
  const float* sp = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ma = has_master != 0;
  if (pdtype == 0 && gdtype == 0)
    return by_slot<float, float>(sdtype, ma, grp, sp, hp, device, st,
                                 launches);
  if (pdtype == 0 && gdtype == 1)
    return by_slot<float, __nv_bfloat16>(sdtype, ma, grp, sp, hp, device, st,
                                         launches);
  if (pdtype == 1 && gdtype == 0)
    return by_slot<__nv_bfloat16, float>(sdtype, ma, grp, sp, hp, device, st,
                                         launches);
  if (pdtype == 1 && gdtype == 1)
    return by_slot<__nv_bfloat16, __nv_bfloat16>(sdtype, ma, grp, sp, hp,
                                                 device, st, launches);
  return cudaErrorInvalidValue;
}

// The most tensors one launch of adamw_update_multi takes.
extern "C" int adamw_capacity() { return adamw::kCap; }

extern "C" const char* adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
