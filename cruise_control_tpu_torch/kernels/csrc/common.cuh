// Shared helpers of the package's CUDA kernels.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define CC_EXPORT extern "C" __attribute__((visibility("default")))

// A model generation's values that the engine's kernels read from the
// device, one fixed block an engine keeps across generations and each
// rebind rewrites (kernels/move_delta.py `Generation`, field for field):
// a captured graph bakes its launches' arguments, so what a generation
// changes is data here, never an argument.  The inv_ words are the f32
// reciprocals the engine's PyTorch ops multiply by on CUDA; no kernel
// reads them.
struct GenParams {
  float w_cap_tc[4];       // capacity weight / total alive capacity
  float w_cap_host_tc[4];  // the same, host resources only
  float total_cap_nw_out;
  float inv_total_cap_nw_out;
  float n_valid;
  float inv_n_valid;
  float n_alive;
  float inv_n_alive;
  float total_disk_cap;
  float inv_total_disk_cap;
  int n_source;      // replica slots uniform source draws cover
  int n_dest;        // real entries at the head of dest_ids
  int n_brokers;     // valid brokers (clips the CDF search)
  int shared_hosts;  // a host in range holds more than one broker
};
constexpr int kGenWords = sizeof(GenParams) / sizeof(int);
static_assert(kGenWords == 20, "GenParams must match kernels/move_delta.py GEN_WORDS");

static inline unsigned int cc_blocks(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

// max(x, 0) that passes NaN through, as torch.clamp and jnp.maximum do
__device__ __forceinline__ float cc_relu(float x) { return (x != x || x > 0.0f) ? x : 0.0f; }

// threefry2x32 under key (k0, k1) of the counter words (x0, x1), in place:
// jax.random's hash with jax_threefry_partitionable=True (the JAX
// package's draw stream).
__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

#define TF_ROUND(r)      \
  {                      \
    x0 += x1;            \
    x1 = rotl32(x1, r);  \
    x1 ^= x0;            \
  }

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

// The f32 uniform in [0, 1) of draw i of a key: the top 23 bits of the
// xor of the two output words of counter i (split into hi, lo words) as
// the mantissa of a number in [1, 2), minus one.
__device__ __forceinline__ float cc_unit_float(uint32_t k0, uint32_t k1, unsigned long long i) {
  uint32_t x0 = (uint32_t)(i >> 32);
  uint32_t x1 = (uint32_t)i;
  threefry2x32(k0, k1, x0, x1);
  const uint32_t bits = x0 ^ x1;
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// The engine's _uniform_idx: min(int(u * bound), bound - 1), bound >= 1.
__device__ __forceinline__ int cc_uniform_idx(float u, int bound) {
  const int v = __float2int_rz(__fmul_rn(u, (float)bound));
  return v < bound - 1 ? v : bound - 1;
}

// jax.random.uniform's tail: max(minval, u * span + minval).
__device__ __forceinline__ float cc_uniform_in(float u, float minval, float span) {
  const float v = __fadd_rn(__fmul_rn(u, span), minval);
  return v > minval ? v : minval;
}
