// move_delta: objective delta of each of K candidate moves, one thread per
// candidate.  The arithmetic follows move_delta_plain() in
// kernels/move_delta.py term for term: four broker lanes (src/dst x
// old/new), the host-capacity terms, and the dispersion tiebreak
// (terms.cuh).  The engine's step runs the fused candidates kernel
// (candidates.cu), which evaluates the same terms; this one stays as a
// standalone check of them.  A generation's values come from its block
// (`GenParams`), read by each thread before its candidate's loads.
#include "terms.cuh"

__global__ void move_delta_kernel(
    int K, MDParams p, const GenParams* __restrict__ gen, const float* __restrict__ g,
    const int* __restrict__ src, const int* __restrict__ dst, const float* __restrict__ dload_src,
    const float* __restrict__ dload_dst, const int* __restrict__ dcount,
    const int* __restrict__ dlcount, const float* __restrict__ dpot,
    const float* __restrict__ dlbin, const float* __restrict__ dlbin_src,
    const float* __restrict__ broker_load, const int* __restrict__ rcount,
    const int* __restrict__ lcount, const float* __restrict__ bpot,
    const float* __restrict__ blbin, const float* __restrict__ capacity,
    const bool* __restrict__ alive, const int* __restrict__ broker_host,
    const bool* __restrict__ host_multi, const float* __restrict__ host_load,
    const float* __restrict__ host_cap, float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const GenParams q = *gen;
  const int s = src[k];
  const int d = dst[k];
  float ls[4], ld[4], ls2[4], ld2[4], cap_s[4], cap_d[4];
  for (int r = 0; r < 4; ++r) {
    ls[r] = broker_load[s * 4 + r];
    ld[r] = broker_load[d * 4 + r];
    ls2[r] = ls[r] + dload_src[k * 4 + r];
    ld2[r] = ld[r] + dload_dst[k * 4 + r];
    cap_s[r] = capacity[s * 4 + r];
    cap_d[r] = capacity[d * 4 + r];
  }
  const bool a_s = alive[s], a_d = alive[d];
  const int h_s = broker_host[s], h_d = broker_host[d];
  const bool single_s = !host_multi[h_s], single_d = !host_multi[h_d];
  const int dc = dcount[k], dlc = dlcount[k];
  const float dp = dpot[k];

  const float t0 = broker_terms(p, q, g, cap_s, a_s, single_s, ls, rcount[s], lcount[s], bpot[s],
                                blbin[s]);
  const float t1 = broker_terms(p, q, g, cap_d, a_d, single_d, ld, rcount[d], lcount[d], bpot[d],
                                blbin[d]);
  const float t2 = broker_terms(p, q, g, cap_s, a_s, single_s, ls2, rcount[s] - dc, lcount[s] - dlc,
                                bpot[s] - dp, blbin[s] - dlbin_src[k]);
  const float t3 = broker_terms(p, q, g, cap_d, a_d, single_d, ld2, rcount[d] + dc, lcount[d] + dlc,
                                bpot[d] + dp, blbin[d] + dlbin[k]);
  float delta = (t2 + t3) - (t0 + t1);

  // host-granularity capacity (same-host moves cancel)
  if (h_s != h_d) {
    float hl_s[4], hl_d[4], hl_s2[4], hl_d2[4], hc_s[4], hc_d[4];
    for (int r = 0; r < 4; ++r) {
      hl_s[r] = host_load[h_s * 4 + r];
      hl_d[r] = host_load[h_d * 4 + r];
      hl_s2[r] = hl_s[r] + dload_src[k * 4 + r];
      hl_d2[r] = hl_d[r] + dload_dst[k * 4 + r];
      hc_s[r] = host_cap[h_s * 4 + r];
      hc_d[r] = host_cap[h_d * 4 + r];
    }
    const bool m_s = host_multi[h_s], m_d = host_multi[h_d];
    const float th0 = host_terms(p, q, m_s, hl_s2, hc_s);
    const float th1 = host_terms(p, q, m_s, hl_s, hc_s);
    const float th2 = host_terms(p, q, m_d, hl_d2, hc_d);
    const float th3 = host_terms(p, q, m_d, hl_d, hc_d);
    delta = delta + (((th0 - th1) + th2) - th3);
  } else {
    delta = delta + 0.0f;
  }

  // dispersion tiebreaker via sufficient statistics
  const float as = a_s ? 1.0f : 0.0f, ad = a_d ? 1.0f : 0.0f;
  float s_new[4], sq_new[4], s_old[4], sq_old[4];
  for (int r = 0; r < 4; ++r) {
    const float cs = cap_s[r] + 1e-12f, cd = cap_d[r] + 1e-12f;
    const float p_s = ls[r] / cs, p_d = ld[r] / cd;
    const float p_s2 = ls2[r] / cs, p_d2 = ld2[r] / cd;
    const float dsum = as * (p_s2 - p_s) + ad * (p_d2 - p_d);
    const float dsumsq = as * (p_s2 * p_s2 - p_s * p_s) + ad * (p_d2 * p_d2 - p_d * p_d);
    s_old[r] = g[G_PCT_SUM + r];
    sq_old[r] = g[G_PCT_SUMSQ + r];
    s_new[r] = s_old[r] + dsum;
    sq_new[r] = sq_old[r] + dsumsq;
  }
  delta = delta + (tie_term(p, q, s_new, sq_new) - tie_term(p, q, s_old, sq_old));
  out[k] = delta;
}

CC_EXPORT int cc_move_delta(int K, MDParams p, const void* gen, const void* g, const void* src,
                            const void* dst, const void* dload_src, const void* dload_dst,
                            const void* dcount,
                            const void* dlcount, const void* dpot, const void* dlbin,
                            const void* dlbin_src, const void* broker_load, const void* rcount,
                            const void* lcount, const void* bpot, const void* blbin,
                            const void* capacity, const void* alive, const void* broker_host,
                            const void* host_multi, const void* host_load, const void* host_cap,
                            void* out, void* stream) {
  if (K <= 0) return 0;
  const int threads = 128;
  move_delta_kernel<<<cc_blocks(K, threads), threads, 0, (cudaStream_t)stream>>>(
      K, p, (const GenParams*)gen, (const float*)g, (const int*)src, (const int*)dst,
      (const float*)dload_src, (const float*)dload_dst, (const int*)dcount, (const int*)dlcount,
      (const float*)dpot,
      (const float*)dlbin, (const float*)dlbin_src, (const float*)broker_load,
      (const int*)rcount, (const int*)lcount, (const float*)bpot, (const float*)blbin,
      (const float*)capacity, (const bool*)alive, (const int*)broker_host,
      (const bool*)host_multi, (const float*)host_load, (const float*)host_cap, (float*)out);
  return (int)cudaGetLastError();
}
