// The multi-tensor loop of the AdamW kernel (adamw.cu) for Hopper
// (sm_90a), generic over the per-element update `Op`: adamw.cu
// instantiates it with the exact update; adamw_probe.cu, built only for
// measurement, with two probes of the same loop.
//
// Design: one launch updates a group of tensors that share their dtypes
// (and whether they have a master copy), the template arguments. The
// group travels as a kernel parameter (`Table`, read through
// __grid_constant__, so nothing is copied to local memory): each tensor's
// pointers and size, and a prefix sum of its work items, kItem elements
// each. A toolkit of CUDA 12.1 or later takes parameters of up to 32,764
// bytes on this card, ~600 tensors a launch (an older one 4,096 bytes,
// ~70); a longer list is cut into several launches. No device table, no
// allocation, no host sync. The grid is the number of blocks resident at
// once (the occupancy of the kernel times the SMs), each taking work
// items blockIdx.x, + gridDim.x, ...; a binary search over the prefix
// sum finds an item's tensor. Inside an item each thread takes 8
// consecutive elements, neighbouring threads on neighbouring 16-byte runs
// (16-byte loads and stores where the tensor's pointers are 16-byte
// aligned, element by element at a ragged tail or on an unaligned
// tensor). The loaded runs stay packed as loaded (`Raw8`: a bf16 run is
// four registers) and are unpacked one element at a time: the loop is
// bound by how many warps an SM holds (the exact divisions and square
// root take tens of instructions an element), and packed runs keep it at
// 44-64 registers, four or five blocks of 256 threads an SM. Unpacking
// every run into f32 arrays up front, two runs a thread, or loading the
// next item's run before this one's arithmetic each raise the register
// count, and each ran slower on the card; an even spread of items over
// the grid, and the two divisions by the bias corrections done as a
// multiply by their reciprocal and one correction (Markstein, bit-equal),
// gained too little to keep.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace adamw {

constexpr int kThreads = 256;
constexpr int kVec = 8;
constexpr int kItem = kThreads * kVec;     // elements a work item
#if CUDART_VERSION >= 12010
constexpr int kParamBytes = 32764;
#else
constexpr int kParamBytes = 4096;
#endif

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2;
};

struct Entry {
  void* p;
  const void* g;
  void* m;
  void* v;
  float* master;
  long long n;
};

// the most tensors a launch whose other parameters (the clip pointer, the
// hyper-parameters) take 64 bytes
constexpr int kCap =
    (kParamBytes - 64 - 2 * static_cast<int>(sizeof(int))) /
    static_cast<int>(sizeof(Entry) + sizeof(int) + 1);

// A group of tensors for one launch: tensor t owns work items
// [first[t], first[t + 1]); vec[t] != 0 when its pointers are 16-byte
// aligned.
struct Table {
  Entry e[kCap];
  int first[kCap + 1];
  unsigned char vec[kCap];
  int count;
};
static_assert(sizeof(Table) + 64 <= kParamBytes,
              "the table does not fit the kernel-parameter space");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and read back: the clip's cast of g * s to g's dtype
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Eight consecutive elements of a T tensor held as loaded (a bf16 run is
// one uint4, four registers; an f32 run eight), read and written one
// element at a time as f32: the loaded values take no more registers
// than their bytes.
template <typename T> struct Raw8;
template <> struct Raw8<__nv_bfloat16> {
  uint32_t w[4];
  __device__ __forceinline__ void load16(const __nv_bfloat16* p) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  }
  __device__ __forceinline__ void store16(__nv_bfloat16* p) const {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ void load1(int k, const __nv_bfloat16* p) {
    put(k, __bfloat16_as_ushort(*p));
  }
  __device__ __forceinline__ void store1(int k, __nv_bfloat16* p) const {
    *p = __ushort_as_bfloat16(bits(k));
  }
  __device__ __forceinline__ float get(int k) const {
    return __uint_as_float(static_cast<uint32_t>(bits(k)) << 16);
  }
  __device__ __forceinline__ void set(int k, float x) {
    put(k, __bfloat16_as_ushort(__float2bfloat16_rn(x)));
  }
  __device__ __forceinline__ unsigned short bits(int k) const {
    return static_cast<unsigned short>(k & 1 ? w[k >> 1] >> 16
                                             : w[k >> 1] & 0xffffu);
  }
  __device__ __forceinline__ void put(int k, unsigned short b) {
    w[k >> 1] = k & 1 ? (w[k >> 1] & 0xffffu) | (uint32_t(b) << 16)
                      : (w[k >> 1] & 0xffff0000u) | b;
  }
};
template <> struct Raw8<float> {
  float f[8];
  __device__ __forceinline__ void load16(const float* p) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  __device__ __forceinline__ void store16(float* p) const {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  __device__ __forceinline__ void load1(int k, const float* p) { f[k] = *p; }
  __device__ __forceinline__ void store1(int k, float* p) const { *p = f[k]; }
  __device__ __forceinline__ float get(int k) const { return f[k]; }
  __device__ __forceinline__ void set(int k, float x) { f[k] = x; }
};

// Elements [i0, i0 + 8) of p into r (one 16-byte load where `vec`, else
// the elements below n, one at a time), and back.
template <typename T>
__device__ __forceinline__ void raw_load(Raw8<T>& r, const T* p, int64_t i0,
                                         int64_t n, bool vec) {
  if (vec) {
    r.load16(p + i0);
    return;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    if (i0 + k < n) r.load1(k, p + i0 + k); else r.set(k, 0.f);
}
template <typename T>
__device__ __forceinline__ void raw_store(const Raw8<T>& r, T* p, int64_t i0,
                                          int64_t n, bool vec) {
  if (vec) {
    r.store16(p + i0);
    return;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    if (i0 + k < n) r.store1(k, p + i0 + k);
}

// One thread's run of 8 elements of one work item: where it lies, and its
// operands as loaded. P: parameter, G: gradient, S: both moment slots;
// MASTER: an f32 master copy is the p of the update.
template <typename P, typename G, typename S, bool MASTER>
struct Run {
  Raw8<P> pr;
  Raw8<float> mas;
  Raw8<G> gr;
  Raw8<S> mr, vr;
  P* p;
  float* master;
  S* m;
  S* v;
  int64_t i0, n;
  bool vec, live;

  // Finds item `it`'s tensor (a binary search over the prefix sum) and
  // issues the loads of this thread's run of it.
  __device__ __forceinline__ void load(const Table& tab, int it) {
    int lo = 0, hi = tab.count - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tab.first[mid] <= it) lo = mid; else hi = mid - 1;
    }
    const Entry& e = tab.e[lo];
    n = e.n;
    i0 = static_cast<int64_t>(it - tab.first[lo]) * kItem +
         static_cast<int64_t>(threadIdx.x) * kVec;
    live = i0 < n;
    if (!live) return;
    vec = tab.vec[lo] != 0 && i0 + kVec <= n;
    p = static_cast<P*>(e.p);
    master = e.master;
    m = static_cast<S*>(e.m);
    v = static_cast<S*>(e.v);
    if (MASTER)
      raw_load(mas, master, i0, n, vec);
    else
      raw_load(pr, p, i0, n, vec);
    raw_load(gr, static_cast<const G*>(e.g), i0, n, vec);
    raw_load(mr, m, i0, n, vec);
    raw_load(vr, v, i0, n, vec);
  }

  // Op's update of the run, written back.
  template <typename Op>
  __device__ __forceinline__ void finish(bool clip, float s,
                                         const Hyper& hp) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      float pk = MASTER ? mas.get(k) : pr.get(k);
      float mk = mr.get(k), vk = vr.get(k);
      Op::template apply<G>(pk, gr.get(k), mk, vk, clip, s, hp);
      if (MASTER) mas.set(k, pk);
      pr.set(k, pk);
      mr.set(k, mk);
      vr.set(k, vk);
    }
    if (MASTER) raw_store(mas, master, i0, n, vec);
    raw_store(pr, p, i0, n, vec);
    raw_store(mr, m, i0, n, vec);
    raw_store(vr, v, i0, n, vec);
  }
};

// Op: a struct with `template <typename G> static __device__ void
// apply(float& p, float g, float& m, float& v, bool clip, float s, const
// Hyper&)`, one element's update in place.
template <typename Op, typename P, typename G, typename S, bool MASTER>
__global__ void __launch_bounds__(kThreads) adamw_kernel(
    const __grid_constant__ Table tab, const float* __restrict__ scale,
    const Hyper hp) {
  const bool clip = scale != nullptr;
  const float s = clip ? *scale : 1.f;
  const int items = tab.first[tab.count];
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    Run<P, G, S, MASTER> r;
    r.load(tab, it);
    if (r.live) r.template finish<Op>(clip, s, hp);
  }
}

inline bool aligned16(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// The blocks of `kernel` resident at once on `device`: the grid of every
// launch. `cache` is the caller's, one per kernel.
template <typename K>
int resident_blocks(K kernel, int device, int (&cache)[64]) {
  if (device >= 0 && device < 64 && cache[device]) return cache[device];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, 0) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  const int blocks = per_sm * sms;
  if (device >= 0 && device < 64) cache[device] = blocks;
  return blocks;
}

struct Group {
  const void* const* ptrs;     // [count][5]: p, g, m, v, master (or null)
  const long long* numels;     // [count]
  int count;
};

// Launches of adamw_kernel<Op, ...> over the group's tensors, kCap at a
// time; `launches` counts them.
template <typename Op, typename P, typename G, typename S, bool MASTER>
cudaError_t launch(const Group& grp, const float* scale, const Hyper& hp,
                   int device, cudaStream_t st, int* launches) {
  auto kernel = adamw_kernel<Op, P, G, S, MASTER>;
  static int cache[64] = {};
  const int grid_max = resident_blocks(kernel, device, cache);
  if (grid_max < 1) return cudaErrorInvalidConfiguration;
  int t0 = 0;
  while (t0 < grp.count) {
    Table tab;
    tab.count = 0;
    tab.first[0] = 0;
    long long items = 0;
    for (; t0 < grp.count && tab.count < kCap; ++t0) {
      const void* const* q = grp.ptrs + 5 * static_cast<size_t>(t0);
      const long long n = grp.numels[t0];
      if (n < 1) continue;
      if ((q[4] != nullptr) != MASTER) return cudaErrorInvalidValue;
      const long long next = items + (n + kItem - 1) / kItem;
      if (next > 0x7fffffffLL) break;         // the next launch takes it
      Entry& e = tab.e[tab.count];
      e.p = const_cast<void*>(q[0]);
      e.g = q[1];
      e.m = const_cast<void*>(q[2]);
      e.v = const_cast<void*>(q[3]);
      e.master = static_cast<float*>(const_cast<void*>(q[4]));
      e.n = n;
      tab.vec[tab.count] = aligned16(q[0]) && aligned16(q[1]) &&
                           aligned16(q[2]) && aligned16(q[3]) &&
                           aligned16(q[4]);
      items = next;
      tab.first[++tab.count] = static_cast<int>(items);
    }
    if (tab.count == 0) {
      if (t0 < grp.count) return cudaErrorInvalidValue;   // too large
      break;
    }
    const int grid = static_cast<int>(items < grid_max ? items : grid_max);
    kernel<<<grid, kThreads, 0, st>>>(tab, scale, hp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  return cudaSuccess;
}

}  // namespace adamw
