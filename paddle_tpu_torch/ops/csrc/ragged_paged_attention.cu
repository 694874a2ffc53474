// Ragged paged attention for Hopper (sm_90a): f32 and bf16 pools, and the
// int8 and int4 quantized pools of the serving decoder.
//
// Replaces the TPU kernel `_ragged_kernel` of
// paddle_tpu/ops/ragged_paged_attention.py (launched there by
// `_ragged_kernel_call`, dense windows, and `_packed_kernel_call`, the
// packed token stream). One kernel serves both forms: q [N, W, H, D] with
// query w of item n at absolute position start[n] + w, reading page-table
// row row_of[n] (row_of == NULL: row n). The packed form is N = T, W = 1,
// row_of = row_ids, start = pos. head_dim 32/64/128/256, page size <= 32.
//
// Math (the JAX `_page_update`, per page): logits q.k * scale masked to
// kpos <= qpos with -1e30, one f32 online-softmax step (m, s, acc); output
// acc / max(s, 1e-30) in q's dtype. Table ids clamp into [0, P-1]. The
// int8 key scale multiplies the finished logit before the mask, the int8
// value dequantizes (v * s, f32) before P.V, an int4 element is nibble *
// group scale in f32 before both dots: the JAX order.
//
// Bound: bytes. A query at qpos reads (qpos + 1) H D keys and values
// (bf16 2 bytes an element; int8 1 plus a 4-byte scale a token and plane;
// int4 1/2 plus a 4-byte scale a group) and does ~4 D flops a key and head:
// ~1 flop a byte, far below the f32 ridge; the floor is the K/V bytes over
// 3.35 TB/s (0.0123 / 0.0062 / 0.0039 ms at the serving decode shape:
// packed T 16, mean context 314, 16 x 128 heads).
//
// Design (decode_attention.cuh, the body shared with paged_attention.cu;
// the earlier design walked a row's pages one at a time in one block per
// (token, head), so the longest row set the time alone):
//   - the split: chunks of C = kChunkPages (8) pages at fixed absolute
//     page indices; in a split launch (the wrapper's choice for launches
//     of at most `SPLIT_MAX_ROWS` (query, head) pairs: decode ticks) each
//     (query tile, chunk, head) is a block of its own, so the 52-page row
//     of the decode shape spreads over 7 blocks per head, and a second
//     kernel merges; wider launches walk a tile's chunks in one block and
//     merge them in shared memory;
//   - the merge: per query, chunks in order: M = max m_c, s = sum s_c
//     exp(m_c - M), acc likewise, out = acc / max(s, 1e-30);
//   - the loads: 8 warps a block, one page a warp a round, every key's
//     head slice loaded straight into registers (8 bytes a lane at bf16 D
//     128, one 256-byte row a warp instruction), the round's values asked
//     of L1 before the keys are scored; the grid puts the heads of one
//     (query, chunk) side by side, so they read the same tokens' rows;
//   - the dots: the whole warp on each key (lanes over head_dim, a
//     reduce-scatter butterfly); P.V with lanes over head_dim;
//   - shared pages: consecutive queries of one row at consecutive positions
//     (a dense window, a prefill chunk in the packed stream) form tiles of
//     up to kTileQ (4) that score every loaded page (the later queries
//     read it from L1); each query's arithmetic is the same in a tile as
//     alone, so a token's bits depend only on its row's pages and its
//     position (W = 1 == any window == any packed stream).
#include "decode_attention.cuh"

namespace {

using dattn::Params;

// No __launch_bounds__: with the 256-thread bound ptxas spills a few
// registers to raise occupancy; without it none spill.
template <typename T, int L, int DPL, int KP>
__global__ void ragged_paged_attention_kernel(Params p) {
  dattn::decode_attention<T, L, DPL, KP>(p);
}

template <typename T, int DPL>
__global__ void __launch_bounds__(128)
    ragged_paged_attention_merge_kernel(Params p) {
  dattn::merge_split<T, DPL>(p);
}

constexpr size_t kMaxSmem = 232448 - 1024;   // 227 KB less the static part

template <typename T, int L, int DPL, int KP>
cudaError_t launch(const Params& p, cudaStream_t stream,
                   long* scratch_floats) {
  using P = typename dattn::PoolT<L, T>::type;
  static bool smem_set[64] = {};     // per kernel and device
  return dattn::plan_and_launch<L, DPL, KP>(
      p, sizeof(P), kMaxSmem, smem_set,
      ragged_paged_attention_kernel<T, L, DPL, KP>,
      ragged_paged_attention_merge_kernel<T, DPL>, stream, scratch_floats);
}

template <typename T, int L>
cudaError_t dispatch(const Params& p, cudaStream_t s, long* scratch_floats) {
#define RPA_CASE(DPL)                                              \
  return p.ps <= 16 ? launch<T, L, DPL, 16>(p, s, scratch_floats)  \
                    : launch<T, L, DPL, 32>(p, s, scratch_floats)
  switch (p.D) {
    case 32: RPA_CASE(1);
    case 64: RPA_CASE(2);
    case 128: RPA_CASE(4);
    case 256: RPA_CASE(8);
    default: return cudaErrorInvalidValue;
  }
#undef RPA_CASE
}

template <typename T>
cudaError_t dispatch_layout(int layout, const Params& p, cudaStream_t s,
                            long* scratch_floats) {
  switch (layout) {
    case dattn::kPlain:
      return dispatch<T, dattn::kPlain>(p, s, scratch_floats);
    case dattn::kInt8:
      return dispatch<T, dattn::kInt8>(p, s, scratch_floats);
    case dattn::kInt4:
      if (p.G < 1 || (2 * p.PB) % p.G || 2 * p.PB < p.H * p.D)
        return cudaErrorInvalidValue;
      return dispatch<T, dattn::kInt4>(p, s, scratch_floats);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(const void* q, const void* k_pages, const void* v_pages,
        const float* k_scale, const float* v_scale, const int* table,
        const int* row_of, const int* start, void* out, float* scratch,
        int N, int W, int H, int D, int ps, int MP, int P, int R, int PB,
        int G, float scale, int split, int dtype, int layout, int device,
        void* stream, long* scratch_floats) {
  if (ps < 1 || ps > 32 || N < 1 || W < 1 || MP < 1 || P < 1 || R < 1 ||
      H < 1 || H > 65535 || static_cast<long>(N) * W > 0x7fffffffL ||
      (layout != dattn::kPlain && (!k_scale || !v_scale)))
    return cudaErrorInvalidValue;
  Params p{q, k_pages, v_pages, k_scale, v_scale, table, row_of, start,
           out, scratch, N, W, H, D, ps, MP, P, R, PB, G, 0, scale,
           split != 0};
  if (!scratch_floats) {
    int cur = -1;
    cudaError_t err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_layout<float>(layout, p, s, scratch_floats);
  if (dtype == 1)
    return dispatch_layout<__nv_bfloat16>(layout, p, s, scratch_floats);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out share it; a plain pool too).
// layout: 0 plain, 1 int8 (k_scale/v_scale [P, ps]), 2 int4 (pages [P, ps,
// PB] uint8, k_scale/v_scale [P, ps, G]); PB and G are read for int4 only.
// split: walk each chunk in a block of its own and merge in a second
// kernel (else a tile's chunks in one block, merged in shared memory).
// scratch: [N * W, H, rpa_scratch_floats(...)] f32 for the chunk partials
// of a split launch, or NULL. Returns the cudaError_t of the launches (0 =
// launched).
extern "C" int rpa_forward(const void* q, const void* k_pages,
                           const void* v_pages, const float* k_scale,
                           const float* v_scale, const int* table,
                           const int* row_of, const int* start, void* out,
                           float* scratch, int N, int W, int H, int D, int ps,
                           int MP, int P, int R, int PB, int G, float scale,
                           int split, int dtype, int layout, int device,
                           void* stream) {
  return run(q, k_pages, v_pages, k_scale, v_scale, table, row_of, start,
             out, scratch, N, W, H, D, ps, MP, P, R, PB, G, scale, split,
             dtype, layout, device, stream, nullptr);
}

// Scratch f32 a (query, head) a launch needs for its chunk partials: 0
// for an unsplit launch, -1 when its block does not fit shared memory.
// Host only.
extern "C" long rpa_scratch_floats(int H, int D, int ps, int MP, int PB,
                                   int G, int split, int dtype, int layout) {
  static const int dummy[1] = {0};
  long floats = -1;
  const float one[1] = {1.f};
  int rc = run(dummy, dummy, dummy, one, one, dummy, nullptr, dummy, nullptr,
               nullptr, 1, 1, H, D, ps, MP, 1, 1, PB, G, 1.f, split, dtype,
               layout, 0, nullptr, &floats);
  return rc ? -1 : floats;
}

extern "C" const char* rpa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
