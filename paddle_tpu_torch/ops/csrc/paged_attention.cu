// Single-query paged decode attention for Hopper (sm_90a), f32 and bf16
// pages [P, ps, H, D], any page size, any D <= 256.
//
// Replaces the TPU kernel `_paged_kernel` of paddle_tpu/ops/paged_attention.py
// (launched there by `_paged_kernel_call`, the `use_kernel=True` path of
// `paged_attention`).
//
// Math (the JAX kernel): the query of (b, h), q [B, 1, H, D], walks the
// pages of table row b in order; a page id is clamped into [0, P-1] (-1, an
// unused slot, reads page 0). q is scaled before the dot. Position p gets
// the logit q.k, or -1e30 when p >= seq_lens[b] (masked, not skipped): the
// ragged kernel's rule kpos <= qpos with qpos = seq_len - 1. One f32
// online-softmax step a page (pages of more than 32 tokens: a step per 32
// keys, as `_paged_ref` walks them); the output is acc / max(s, 1e-30) in
// q's dtype. With seq_len 0 every logit is -1e30, so every p is 1 and the
// output is the uniform mean of V over every slot of the table, as in the
// TPU kernel and the JAX reference: qpos -1 makes the walk cover all MP
// pages. With seq_len > 0 it stops after the last page that holds a
// position < seq_len (a fully masked page after a real logit changes no
// bit).
//
// Bound: bytes. A query reads seq_len D keys and values a head (2 seq_len D
// itemsize bytes) and does ~4 D flops a key, far below the f32 ridge; the
// floor is the K/V bytes over 3.35 TB/s (0.019-0.022 ms at the entry shape,
// B 16 x 16 heads x 128, 52 pages of 16).
//
// Design (the earlier design walked a sequence's pages one at a time in
// one block per (b, h), two memory latencies a page): the ragged kernel's
// body (decode_attention.cuh) with W = 1, no row map, start = seq_lens and
// a position offset of -1. The split: chunks of C = kChunkPages (8) pages
// at fixed absolute page indices, each (b, chunk, h) a block of its own at
// the entry shape (a second kernel merges; batches of more than the
// wrapper's `SPLIT_MAX_ROWS` (b, h) pairs merge in the block); the merge: per query, chunks in order (M = max m_c, s = sum s_c
// exp(m_c - M), acc likewise); the loads: one page a warp a round, each
// token's head slice straight into registers with vector loads where the
// pool's alignment allows (element loads otherwise, dims past D read as
// 0), values asked of L1 before the keys are scored; the dots: lanes over
// head_dim and a reduce-scatter butterfly, no idle lanes at page size 16 or
// 32 (pages over 32 tokens: a step a 32-key tile). The grid stays (b, h)
// times the chunk groups: one block per decode query, chunk and head.
#include "decode_attention.cuh"

namespace {

using dattn::Params;

// No __launch_bounds__: with the 256-thread bound ptxas spills a few
// registers to raise occupancy; without it none spill.
template <typename T, int DPL, int KP>
__global__ void paged_attention_kernel(Params p) {
  dattn::decode_attention<T, dattn::kPlain, DPL, KP>(p);
}

template <typename T, int DPL>
__global__ void __launch_bounds__(128) paged_attention_merge_kernel(Params p) {
  dattn::merge_split<T, DPL>(p);
}

constexpr size_t kMaxSmem = 232448 - 1024;   // 227 KB less the static part

template <typename T, int DPL, int KP>
cudaError_t launch(const Params& p, cudaStream_t stream,
                   long* scratch_floats) {
  static bool smem_set[64] = {};     // per kernel and device
  return dattn::plan_and_launch<dattn::kPlain, DPL, KP>(
      p, sizeof(T), kMaxSmem, smem_set, paged_attention_kernel<T, DPL, KP>,
      paged_attention_merge_kernel<T, DPL>, stream, scratch_floats);
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t s, long* scratch_floats) {
#define PA_CASE(DPL)                                            \
  return p.ps <= 16 ? launch<T, DPL, 16>(p, s, scratch_floats)  \
                    : launch<T, DPL, 32>(p, s, scratch_floats)
  if (p.D <= 32) PA_CASE(1);
  if (p.D <= 64) PA_CASE(2);
  if (p.D <= 128) PA_CASE(4);
  PA_CASE(8);
#undef PA_CASE
}

int run(const void* q, const void* k_pages, const void* v_pages,
        const int* table, const int* seq_lens, void* out, float* scratch,
        int B, int H, int D, int ps, int MP, int P, float scale, int split,
        int dtype, int device, void* stream, long* scratch_floats) {
  if (B < 1 || H < 1 || H > 65535 || D < 1 || D > 256 || ps < 1 || MP < 1 ||
      P < 1)
    return cudaErrorInvalidValue;
  Params p{q, k_pages, v_pages, nullptr, nullptr, table, nullptr, seq_lens,
           out, scratch, B, 1, H, D, ps, MP, P, B, 0, 0, -1, scale,
           split != 0};
  if (!scratch_floats) {
    int cur = -1;
    cudaError_t err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, s, scratch_floats);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, s, scratch_floats);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it). table
// [B, MP] and seq_lens [B] int32. split: walk each chunk in a block of its
// own and merge in a second kernel (else a query's chunks in one block,
// merged in shared memory). scratch: [B, H, paged_scratch_floats(...)] f32
// for the chunk partials of a split launch, or NULL. Returns the
// cudaError_t of the launches (0 = launched).
extern "C" int paged_forward(const void* q, const void* k_pages,
                             const void* v_pages, const int* table,
                             const int* seq_lens, void* out, float* scratch,
                             int B, int H, int D, int ps, int MP, int P,
                             float scale, int split, int dtype, int device,
                             void* stream) {
  return run(q, k_pages, v_pages, table, seq_lens, out, scratch, B, H, D, ps,
             MP, P, scale, split, dtype, device, stream, nullptr);
}

// Scratch f32 a (query, head) a launch needs for its chunk partials: 0
// for an unsplit launch, -1 when its block does not fit shared memory.
// Host only.
extern "C" long paged_scratch_floats(int H, int D, int ps, int MP, int split,
                                     int dtype) {
  static const int dummy[1] = {0};
  long floats = -1;
  int rc = run(dummy, dummy, dummy, dummy, dummy, nullptr, nullptr, 1, H, D,
               ps, MP, 1, 1.f, split, dtype, 0, nullptr, &floats);
  return rc ? -1 : floats;
}

extern "C" const char* paged_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
