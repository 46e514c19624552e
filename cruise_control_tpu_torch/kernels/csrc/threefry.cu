// threefry2x32 uniform draws, bit-identical to jax.random under
// jax_threefry_partitionable=True (the JAX package's draw stream).
//
// Element i of a draw of n values hashes the 64-bit counter i, split into
// (hi, lo) 32-bit words, under the key; its 32 random bits are the xor of
// the two output words.  A float in [0, 1) takes the top 23 bits as the
// mantissa of a number in [1, 2) minus one.  The bytes written bound this
// kernel (4 per draw); the hash is ~80 integer operations per draw.
#include "common.cuh"

// out_i != nullptr: indices min(int(u * bound), bound - 1) (the engine's
// _uniform_idx); otherwise floats max(minval, u * span + minval).
__global__ void threefry_uniform_kernel(uint32_t k0, uint32_t k1, long long n, float minval,
                                        float span, int bound, float* __restrict__ out_f,
                                        int* __restrict__ out_i) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float u = cc_unit_float(k0, k1, (unsigned long long)i);
  if (out_i != nullptr) {
    out_i[i] = cc_uniform_idx(u, bound);
  } else {
    out_f[i] = cc_uniform_in(u, minval, span);
  }
}

CC_EXPORT int cc_threefry_uniform(uint32_t k0, uint32_t k1, long long n, float minval, float span,
                                  int bound, void* out_f, void* out_i, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  threefry_uniform_kernel<<<cc_blocks(n, threads), threads, 0, (cudaStream_t)stream>>>(
      k0, k1, n, minval, span, bound, (float*)out_f, (int*)out_i);
  return (int)cudaGetLastError();
}
