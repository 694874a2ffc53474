// Two measurement probes of the AdamW kernel's loop (adamw.cuh), never
// used for results and never loaded by the port: chip_smoke.py times them
// beside the kernel at one bf16 tensor (p, g, m, v, no master) to tell
// the loop's byte ceiling and what the exact arithmetic costs on top of
// it.
//   mode 1: the update with the divisions and the square root made cheap
//           (approximate);
//   mode 2: a copy of the same traffic (8 B read, 6 B written an element).
#include "adamw.cuh"

namespace {

using adamw::Hyper;

struct CheapDivision {
  template <typename G>
  static __device__ __forceinline__ void apply(float& p, float g, float& m,
                                               float& v, bool clip, float s,
                                               const Hyper& hp) {
    const float gk = clip ? adamw::round_to<G>(__fmul_rn(g, s)) : g;
    const float mk = __fadd_rn(__fmul_rn(hp.b1, m), __fmul_rn(hp.omb1, gk));
    const float vk = __fadd_rn(__fmul_rn(hp.b2, v),
                               __fmul_rn(__fmul_rn(hp.omb2, gk), gk));
    const float vhat = vk * __frcp_rn(hp.bc2);
    const float ratio = __fdividef(mk * __frcp_rn(hp.bc1),
                                   vhat * rsqrtf(vhat + 1e-30f) + hp.eps);
    const float upd = __fadd_rn(ratio, __fmul_rn(hp.wd, p));
    p = __fsub_rn(p, __fmul_rn(hp.lr, upd));
    m = mk;
    v = vk;
  }
};

struct Copy {
  template <typename G>
  static __device__ __forceinline__ void apply(float& p, float g, float& m,
                                               float& v, bool, float,
                                               const Hyper&) {
    const float m0 = m;
    p = p + g;
    m = v;
    v = m0;
  }
};

}  // namespace

// One probe launch over one bf16 tensor of n elements: mode 1 cheap
// divisions, mode 2 a copy of the same traffic. Returns the cudaError_t.
extern "C" int adamw_probe(int mode, void* p, const void* g, void* m,
                           void* v, const void* scale, long long n, float lr,
                           float b1, float omb1, float b2, float omb2,
                           float eps, float wd, float bc1, float bc2,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* ptrs[5] = {p, g, m, v, nullptr};
  const adamw::Group grp{ptrs, &n, 1};
  const Hyper hp{lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2};
  const float* sp = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  int launches = 0;
  if (mode == 1)
    return adamw::launch<CheapDivision, B, B, B, false>(grp, sp, hp, device,
                                                        st, &launches);
  if (mode == 2)
    return adamw::launch<Copy, B, B, B, false>(grp, sp, hp, device, st,
                                               &launches);
  return cudaErrorInvalidValue;
}

extern "C" const char* adamw_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
