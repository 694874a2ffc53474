// The port's counter hash: 32 random bits for element i of a tensor under a
// 31-bit salt, with no state and no order, so any thread computes any
// element's bits. It is the JAX package's dropout hash (paddle_tpu/nn/
// functional/common.py `_hash_keep`, paddle_tpu/ops/attention.py `_hash32`):
//   bits(i) = hash32((i * kRow) ^ (salt * kCol)), all mod 2^32,
// with i the flat index mod 2^32 (JAX's uint32 iota wraps there). The hash
// dropout kernel (hash_dropout.cu) and the dropout + residual + LayerNorm
// row walk (layer_norm.cu) include it; the flash kernels keep their own
// copy beside their per-(batch, head) salt.
#pragma once

#include <cstdint>

namespace counter_hash {

constexpr uint32_t kRow = 0x9E3779B1u;
constexpr uint32_t kCol = 0x85EBCA77u;

// lowbias32, the finalizer of the JAX `_hash32`
__host__ __device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// The bits of flat element i, with salt_col = salt * kCol (mod 2^32)
// worked out once on the host.
__device__ __forceinline__ uint32_t element_bits(uint32_t i,
                                                 uint32_t salt_col) {
  return hash32(i * kRow ^ salt_col);
}

// F.dropout's rule (the JAX `_rate_thresh`): keep iff bits >= this, which
// is min(int(p * 2^32), 2^32 - 1).
inline uint32_t rate_thresh(double p) {
  const double t = p * 4294967296.0;
  if (t <= 0.0) return 0u;
  return t >= 4294967295.0 ? 0xFFFFFFFFu : static_cast<uint32_t>(t);
}

// The JAX `_dropout_res_ln_kernel`'s rule: keep iff bits <= this, which is
// int((1 - p) * (2^32 - 1)), for 0 < p <= 1.
inline uint32_t keep_thresh(double p) {
  return static_cast<uint32_t>((1.0 - p) * 4294967295.0);
}

}  // namespace counter_hash
