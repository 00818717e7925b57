// EI log-likelihood-ratio scoring of continuous TPE candidates on Hopper.
//
// Replaces the TPU kernel hyperopt_tpu/ops/pallas_kernels.py:97-215
// (_gmm_rows_kernel behind gmm_logpdf_rows, and ei_scores = below - above).
// For candidates x[B, Dg, S] (natural space) of Dg unquantized continuous
// dims it writes
//
//   llr[b, d, s] = logpdf(x | below mixture of d) - logpdf(x | above mixture of d)
//
// with logpdf = c1max + log(sum_k exp((c1[k] - c1max) - 0.5 z_k^2)) - jac,
// z_k = lat * inv_s[k] - mu_inv_s[k], lat = log(max(x, 1e-30)) on log-space
// dims (jac = lat) and x otherwise (jac = 0).  A sum that underflows
// (sum > 1e-38 fails) falls back to the largest shifted term, as the
// reference's gmm_logpdf_cont_pre does.  Zero-weight components have
// c1 = -inf and add exactly nothing.
//
// Bound: seven FP32 operations and one exp per (candidate, component) term;
// exp goes to the special-function units (16/clock/SM), which bound the
// kernel.  Design (simple first): grid (tiles of B*S, Dg); each block
// stages its dim's constants through shared memory in chunks of KCHUNK
// components, and each thread scores one candidate against both mixtures,
// reading x once.  Built with -fmad=false so each term rounds as the plain
// PyTorch version does.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 512;

// log-density of one candidate under one mixture, minus c1max and before
// the Jacobian: log(sum_k exp(t_k)) or, on underflow, max_k t_k.
__device__ float mixture_ll(float lat, const float* __restrict__ c1,
                            const float* __restrict__ inv_s,
                            const float* __restrict__ mu_inv_s, float c1max,
                            int k, float* s_cd, float* s_is, float* s_mis) {
  float sm = 0.0f;
  float mx = -CUDART_INF_F;
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    const int n = min(kChunk, k - k0);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      s_cd[j] = c1[k0 + j] - c1max;
      s_is[j] = inv_s[k0 + j];
      s_mis[j] = mu_inv_s[k0 + j];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float z = lat * s_is[j] - s_mis[j];
      const float t = s_cd[j] - 0.5f * z * z;
      sm += expf(t);
      mx = fmaxf(mx, t);
    }
  }
  return sm > 1e-38f ? logf(fmaxf(sm, 1e-38f)) : mx;
}

__global__ void __launch_bounds__(kThreads)
gmm_llr_kernel(const float* __restrict__ x, const uint8_t* __restrict__ logspace,
               const float* __restrict__ c1_b, const float* __restrict__ inv_s_b,
               const float* __restrict__ mu_inv_s_b, const float* __restrict__ c1max_b,
               int k_b,
               const float* __restrict__ c1_a, const float* __restrict__ inv_s_a,
               const float* __restrict__ mu_inv_s_a, const float* __restrict__ c1max_a,
               int k_a,
               float* __restrict__ out, int batch, int n_dims, int n_samples) {
  __shared__ float s_cd[kChunk];
  __shared__ float s_is[kChunk];
  __shared__ float s_mis[kChunk];

  const int d = blockIdx.y;
  const long long per_dim = (long long)batch * n_samples;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = e < per_dim;  // the ragged edge is masked, not padded
  long long idx = 0;
  float lat = 0.0f;
  float jac = 0.0f;
  if (live) {
    const long long b = e / n_samples;
    const long long s = e - b * n_samples;
    idx = (b * n_dims + d) * n_samples + s;
    const float xv = x[idx];
    if (logspace[d]) {
      lat = logf(fmaxf(xv, 1e-30f));
      jac = lat;
    } else {
      lat = xv;
    }
  }
  // every thread joins the staging loops (they synchronize the block)
  const float cb = c1max_b[d];
  const float ca = c1max_a[d];
  const float ll_b = mixture_ll(lat, c1_b + (long long)d * k_b, inv_s_b + (long long)d * k_b,
                                mu_inv_s_b + (long long)d * k_b, cb, k_b, s_cd, s_is, s_mis);
  const float ll_a = mixture_ll(lat, c1_a + (long long)d * k_a, inv_s_a + (long long)d * k_a,
                                mu_inv_s_a + (long long)d * k_a, ca, k_a, s_cd, s_is, s_mis);
  if (live) {
    out[idx] = (cb + ll_b - jac) - (ca + ll_a - jac);
  }
}

}  // namespace

extern "C" int gmm_llr_f32(const float* x, const uint8_t* logspace,
                           const float* c1_b, const float* inv_s_b,
                           const float* mu_inv_s_b, const float* c1max_b, int k_b,
                           const float* c1_a, const float* inv_s_a,
                           const float* mu_inv_s_a, const float* c1max_a, int k_a,
                           float* out, int batch, int n_dims, int n_samples,
                           void* stream) {
  const long long per_dim = (long long)batch * n_samples;
  const dim3 grid((unsigned)((per_dim + kThreads - 1) / kThreads), (unsigned)n_dims);
  gmm_llr_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, logspace, c1_b, inv_s_b, mu_inv_s_b, c1max_b, k_b,
      c1_a, inv_s_a, mu_inv_s_a, c1max_a, k_a, out, batch, n_dims, n_samples);
  return (int)cudaGetLastError();
}
