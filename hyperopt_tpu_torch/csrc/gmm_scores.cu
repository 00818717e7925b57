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
// What bounds it: one exp per (candidate, component) term, on the
// special-function units (SFU), 16 per SM per clock.  The SM issues 4 warp
// instructions per clock (128 thread-instructions), so a warp's MUFU.EX2
// costs the SFU as much time as 8 issued instructions: the kernel can
// reach its SFU bound only if its inner loop issues at most 8 instructions
// per term, the MUFU included.  The bytes (x read once, llr written once,
// the [Dg, K] constants) take under 3% of that time.
//
// Design, aimed at that budget:
// - One term is 7 instructions.  cd2 = 2 (c1 - c1max) is staged, so
//     z = lat * inv_s - mu_inv_s     FMUL FADD
//     u = cd2 - z * z                FMUL FADD   (u = 2t exactly)
//     e = ex2.approx.ftz(u * log2(e)/2)  FMUL MUFU.EX2
//     sum += e                       FADD
//   The file is built with -fmad=false and without fast-math, so z and t
//   round as the plain PyTorch version's separate ops do ((0.5 z) z is
//   the float z z / 2, and doubling is exact); the exp's argument is
//   t * log2(e) rounded once, as __expf rounds it.
// - Each component's three constants sit in one float4 in shared memory
//   (one LDS.128), shared by the R candidates a thread scores, with one
//   independent accumulator per candidate; the loop takes 8 components a
//   turn, so loads and loop control add under one instruction per term
//   for R >= 2.  Both mixtures are staged once per block when they fit
//   (kStageCap components), else in chunks.
// - Split-K: the G lanes of a candidate group take the components
//   k = kl, kl + G, ... in turn, and their partial sums meet in a fixed
//   xor-shuffle butterfly (offsets 1, 2, ..., G/2).  The shift by c1max is
//   static, so partials add with no rescaling.  No atomics: the same
//   inputs give the same bits on every launch.  Small batches take a large
//   G, so the sequential ask's 1,536 candidates still make hundreds of
//   blocks; the wrapper (ops/gmm_scores.py) picks (G, R) from the shape.
// - The max and the subnormals leave the hot loop.  ex2.approx.ftz flushes
//   terms below 2^-126, so the hot sum is exact only where it is large:
//   it lost at most K 2^-126, under 2^-26 of a sum of at least K 2^-100.
//   A candidate whose sum falls below that takes a second pass over K (the
//   block takes it, over both mixtures, if any candidate needs it) that sums
//   2^(a + 64) instead, scales back by 2^-64 into a float that may be
//   subnormal, as the plain version's sum is, and keeps the largest term
//   for the fallback.
// - No TMA and no wgmma: the SFU and the issue slots bound the kernel, not
//   bytes or multiply-adds.  The quadratic could be a rank-3 product on the
//   tensor cores, but the exp stays one MUFU per term, so that would gain
//   nothing and lose float32 rounding; the few KB of constants are one
//   LDS.128 each from shared memory.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStageCap = 2048;  // components staged at once: 32 KB
constexpr float kHalfLog2e = 0.72134752044448170368f;  // log2(e) / 2

__device__ __forceinline__ float ex2_ftz(float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

// one mixture's constants as the wrapper passes them: [Dg, K] rows and
// c1max [Dg]
struct MixtureArgs {
  const float* c1;
  const float* inv_s;
  const float* mu_inv_s;
  const float* c1max;
  int k;
};

// the same, for one dim d
struct Mixture {
  const float* c1;
  const float* inv_s;
  const float* mu_inv_s;
  float c1max;
  int k;
};

__device__ __forceinline__ Mixture of_dim(const MixtureArgs& a, int d) {
  const long long off = (long long)d * a.k;
  return Mixture{a.c1 + off, a.inv_s + off, a.mu_inv_s + off, a.c1max[d], a.k};
}

__device__ void stage(float4* __restrict__ s, const Mixture& m, int k0, int n) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    s[j] = make_float4(2.0f * (m.c1[k0 + j] - m.c1max), m.inv_s[k0 + j],
                       m.mu_inv_s[k0 + j], 0.0f);
  }
}

// the hot loop: this lane's components of s[0, n), summed per candidate
template <int G, int R>
__device__ __forceinline__ void accumulate(const float4* __restrict__ s, int n, int kl,
                                           const float (&lat)[R], float (&acc)[R]) {
#pragma unroll 8
  for (int k = kl; k < n; k += G) {
    const float4 c = s[k];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float z = lat[j] * c.y - c.z;
      const float u = c.x - z * z;
      acc[j] += ex2_ftz(u * kHalfLog2e);
    }
  }
}

// the far-tail pass: sums 2^(a + 64) and keeps the largest u = 2t; left
// rolled, since few blocks take it
template <int G, int R>
__device__ __forceinline__ void accumulate_tail(const float4* __restrict__ s, int n, int kl,
                                                const float (&lat)[R], float (&acc)[R],
                                                float (&mx)[R]) {
#pragma unroll 1
  for (int k = kl; k < n; k += G) {
    const float4 c = s[k];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float z = lat[j] * c.y - c.z;
      const float u = c.x - z * z;
      mx[j] = fmaxf(mx[j], u);
      acc[j] += ex2_ftz(u * kHalfLog2e + 64.0f);
    }
  }
}

template <int G>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int G>
__device__ __forceinline__ float lane_max(float v) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Each candidate's sum_k 2^(a_k) under one mixture, this lane's share.
// Every thread of the block calls it.  With `staged` the mixture already
// sits in s[0, m.k); otherwise it is staged here in chunks of kStageCap
// (a multiple of G, so each lane's order of components does not depend
// on the chunking).
template <int G, int R>
__device__ __forceinline__ void mixture_sum(float4* __restrict__ s, bool staged, const Mixture& m,
                                            int kl, const float (&lat)[R], float (&acc)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = 0.0f;
  if (staged) {
    accumulate<G, R>(s, m.k, kl, lat, acc);
    return;
  }
  for (int k0 = 0; k0 < m.k; k0 += kStageCap) {
    const int n = min(kStageCap, m.k - k0);
    __syncthreads();  // the previous chunk is no longer read
    stage(s, m, k0, n);
    __syncthreads();
    accumulate<G, R>(s, n, kl, lat, acc);
  }
}

// the far-tail pass over one mixture: where a candidate's hot sum `acc`
// fell below `exact_above`, ll becomes log of the rescaled sum, or the
// largest term where that fails > 1e-38.  Every thread calls it.
template <int G, int R>
__device__ __forceinline__ void mixture_tail(float4* __restrict__ s, bool staged, const Mixture& m,
                                             int kl, const float (&lat)[R], const float (&acc)[R],
                                             float exact_above, float (&ll)[R]) {
  float sum[R], mx[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    sum[j] = 0.0f;
    mx[j] = -CUDART_INF_F;
  }
  if (staged) {
    accumulate_tail<G, R>(s, m.k, kl, lat, sum, mx);
  } else {
    for (int k0 = 0; k0 < m.k; k0 += kStageCap) {
      const int n = min(kStageCap, m.k - k0);
      __syncthreads();
      stage(s, m, k0, n);
      __syncthreads();
      accumulate_tail<G, R>(s, n, kl, lat, sum, mx);
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float sm = lane_sum<G>(sum[j]) * 0x1p-64f;  // may be subnormal
    const float top = 0.5f * lane_max<G>(mx[j]);
    if (acc[j] < exact_above) ll[j] = sm > 1e-38f ? logf(sm) : top;
  }
}

// Block: kWarps warps over a tile of one dim's B*S candidates.  In a warp,
// lane = cl * G + kl: 32/G candidate lanes times G component lanes, and a
// thread scores candidates cl + j * 32/G (j < R) of its warp's tile.
template <int G, int R>
__global__ void __launch_bounds__(kThreads)
gmm_llr_kernel(const float* __restrict__ x, const uint8_t* __restrict__ logspace,
               MixtureArgs below_args, MixtureArgs above_args, float* __restrict__ out, int n_dims,
               int n_samples, long long per_dim) {
  extern __shared__ float4 s_c[];
  constexpr int kLanes = 32 / G;
  constexpr int kPerWarp = kLanes * R;
  const int d = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kl = lane % G;
  const long long e0 = (long long)blockIdx.x * (kPerWarp * kWarps) + warp * kPerWarp + lane / G;
  const bool ls = logspace[d] != 0;

  float lat[R], jac[R];
  bool live[R];
  long long idx[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const long long e = e0 + j * kLanes;
    live[j] = e < per_dim;  // the ragged edge is masked, not padded
    lat[j] = 0.0f;
    jac[j] = 0.0f;
    idx[j] = 0;
    if (live[j]) {
      const long long b = e / n_samples;
      idx[j] = (b * n_dims + d) * n_samples + (e - b * n_samples);
      const float xv = x[idx[j]];
      lat[j] = ls ? logf(fmaxf(xv, 1e-30f)) : xv;
      jac[j] = ls ? lat[j] : 0.0f;
    }
  }

  const Mixture below = of_dim(below_args, d);
  const Mixture above = of_dim(above_args, d);
  const bool staged = below.k + above.k <= kStageCap;
  if (staged) {
    stage(s_c, below, 0, below.k);
    stage(s_c + below.k, above, 0, above.k);
    __syncthreads();
  }
  float4* const s_a = staged ? s_c + below.k : s_c;
  float acc_b[R], acc_a[R];
  mixture_sum<G, R>(s_c, staged, below, kl, lat, acc_b);
  mixture_sum<G, R>(s_a, staged, above, kl, lat, acc_a);
  // the sums are exact where they reach K 2^-100 (flushed terms lost at
  // most K 2^-126); below it, the block takes the far-tail pass
  const float exact_b = (float)below.k * 0x1p-100f;
  const float exact_a = (float)above.k * 0x1p-100f;
  float ll_b[R], ll_a[R];
  bool tail = false;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    acc_b[j] = lane_sum<G>(acc_b[j]);
    acc_a[j] = lane_sum<G>(acc_a[j]);
    ll_b[j] = logf(acc_b[j]);
    ll_a[j] = logf(acc_a[j]);
    tail |= live[j] && (acc_b[j] < exact_b || acc_a[j] < exact_a);
  }
  if (__syncthreads_or(tail)) {
    mixture_tail<G, R>(s_c, staged, below, kl, lat, acc_b, exact_b, ll_b);
    mixture_tail<G, R>(s_a, staged, above, kl, lat, acc_a, exact_a, ll_a);
  }
  if (kl == 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (live[j]) {
        out[idx[j]] = (below.c1max + ll_b[j] - jac[j]) - (above.c1max + ll_a[j] - jac[j]);
      }
    }
  }
}

template <int G, int R>
int launch(const float* x, const uint8_t* logspace, const MixtureArgs& below,
           const MixtureArgs& above, float* out, int batch, int n_dims, int n_samples,
           cudaStream_t stream) {
  constexpr int kPerBlock = 32 / G * R * kWarps;
  const long long per_dim = (long long)batch * n_samples;
  const long long tiles = (per_dim + kPerBlock - 1) / kPerBlock;
  if (tiles > 0x7fffffffLL || n_dims > 65535) return (int)cudaErrorInvalidValue;
  const int staged = below.k + above.k;
  const size_t smem = sizeof(float4) * (size_t)(staged <= kStageCap ? staged : kStageCap);
  gmm_llr_kernel<G, R><<<dim3((unsigned)tiles, (unsigned)n_dims), kThreads, smem, stream>>>(
      x, logspace, below, above, out, n_dims, n_samples, per_dim);
  return (int)cudaGetLastError();
}

}  // namespace

// k_lanes (G) and rows (R) choose the split: G lanes share each
// candidate's components, and each thread scores R candidates.  The pairs
// compiled are the ones ops/gmm_scores.py may pick.
extern "C" int gmm_llr_f32(const float* x, const uint8_t* logspace,
                           const float* c1_b, const float* inv_s_b,
                           const float* mu_inv_s_b, const float* c1max_b, int k_b,
                           const float* c1_a, const float* inv_s_a,
                           const float* mu_inv_s_a, const float* c1max_a, int k_a,
                           float* out, int batch, int n_dims, int n_samples,
                           int k_lanes, int rows, void* stream) {
  const MixtureArgs below{c1_b, inv_s_b, mu_inv_s_b, c1max_b, k_b};
  const MixtureArgs above{c1_a, inv_s_a, mu_inv_s_a, c1max_a, k_a};
  const cudaStream_t st = (cudaStream_t)stream;
#define GMM_LLR_CASE(G, R)                                                              \
  if (k_lanes == G && rows == R)                                                      \
    return launch<G, R>(x, logspace, below, above, out, batch, n_dims, n_samples, st);
  GMM_LLR_CASE(1, 4)
  GMM_LLR_CASE(2, 2)
  GMM_LLR_CASE(32, 1)
#undef GMM_LLR_CASE
  return (int)cudaErrorInvalidValue;
}
