// Native host-side TPE math of the PyTorch port: truncated/quantized
// (log)GMM log-densities and the adaptive-Parzen fit.
//
// The host TPE (hyperopt_tpu_torch/tpe_host.py) spends its time in these
// loops; this library serves them on the host (the card's TPE never calls
// it).  Deterministic functions only: sampling stays in numpy, so seeded
// streams are unchanged.  The results match the numpy oracle of
// tpe_host.py within float tolerance (tests/test_torch_native.py).
//
// Build: g++ -O3 -march=native -shared -fPIC tpe_math.cpp -o libtpe_math.so
// (driven by hyperopt_tpu_torch/native/__init__.py; ctypes binding).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kEps = 1e-12;
constexpr double kTiny = 1e-300;
constexpr double kLogSqrt2Pi = 0.918938533204672741780329736406;
const double kSqrt2 = std::sqrt(2.0);

inline double normal_cdf(double x, double mu, double sigma) {
  double s = std::max(sigma, kEps);
  return 0.5 * (1.0 + std::erf((x - mu) / (s * kSqrt2)));
}

inline double log_sum_exp_pair(double acc, double term) {
  // acc, term in log space
  if (term == -INFINITY) return acc;
  if (acc == -INFINITY) return term;
  double m = std::max(acc, term);
  return m + std::log(std::exp(acc - m) + std::exp(term - m));
}

}  // namespace

extern "C" {

// out[s] = log p(x_s) under the truncated / quantized / (log-space) GMM.
// low/high are latent-space bounds (+-inf accepted); q <= 0 means
// unquantized; logspace != 0 means lognormal mixture (x in natural space).
void ht_gmm_lpdf(const double* x, int64_t S, const double* w,
                 const double* mu, const double* sigma, int64_t K,
                 double low, double high, double q, int32_t logspace,
                 double* out) {
  // Per-component constants hoisted out of the S*K loops; the former
  // running pairwise log-sum-exp paid 2 exp + 1 log PER TERM, which is
  // why numpy's vectorized single-max pass overtook this path at large
  // K (measured: 0.83x at 2,500 obs).  Continuous: c1 folds every
  // additive term, inner loop is one fused z^2 (pass 1) + one exp
  // (pass 2).  Quantized: weights/mass accumulate in LINEAR space
  // (masses are non-negative), one log per sample.
  std::vector<double> logw(K), log_mass(K), inv_sig(K), c1(K), wmass(K);
  double wsum = 0.0;
  for (int64_t k = 0; k < K; ++k) wsum += w[k];
  if (wsum <= 0.0) wsum = 1.0;
  for (int64_t k = 0; k < K; ++k) {
    double wk = w[k] / wsum;
    logw[k] = std::log(std::max(wk, kTiny));
    double a = std::isinf(low) ? 0.0 : normal_cdf(low, mu[k], sigma[k]);
    double b = std::isinf(high) ? 1.0 : normal_cdf(high, mu[k], sigma[k]);
    double mass_k = std::max(b - a, kEps);
    log_mass[k] = std::log(mass_k);
    inv_sig[k] = 1.0 / std::max(sigma[k], kEps);
    c1[k] = logw[k] + std::log(inv_sig[k]) - kLogSqrt2Pi - log_mass[k];
    wmass[k] = wk / mass_k;
  }

  std::vector<double> t(K);
  for (int64_t s = 0; s < S; ++s) {
    if (q <= 0.0) {
      double lat = logspace ? std::log(std::max(x[s], kTiny)) : x[s];
      double jac = logspace ? lat : 0.0;
      double m = -INFINITY;
      for (int64_t k = 0; k < K; ++k) {  // pass 1: terms + max (no exp)
        double z = (lat - mu[k]) * inv_sig[k];
        double tk = c1[k] - 0.5 * z * z;
        t[k] = tk;
        if (tk > m) m = tk;
      }
      if (m == -INFINITY) {
        out[s] = -INFINITY;
        continue;
      }
      double sum = 0.0;
      for (int64_t k = 0; k < K; ++k) sum += std::exp(t[k] - m);
      out[s] = m + std::log(sum) - jac;
    } else {
      double ub = x[s] + q / 2.0, lb = x[s] - q / 2.0;
      double ub_lat = logspace ? std::log(std::max(ub, kEps)) : ub;
      double lb_lat = logspace ? std::log(std::max(lb, kEps)) : lb;
      if (!std::isinf(high)) ub_lat = std::min(ub_lat, high);
      if (!std::isinf(low)) lb_lat = std::max(lb_lat, low);
      double p = 0.0;
      for (int64_t k = 0; k < K; ++k) {
        double mass = normal_cdf(ub_lat, mu[k], sigma[k]) -
                      normal_cdf(lb_lat, mu[k], sigma[k]);
        // per-component kEps floor: exact numpy-oracle parity
        // (GMM1_lpdf_numpy clamps each bin mass at EPS before the log)
        p += wmass[k] * std::max(mass, kEps);
      }
      out[s] = std::log(std::max(p, kTiny));
    }
  }
}

// Adaptive-Parzen fit (tpe_host.adaptive_parzen_normal semantics).
// mus: n time-ordered observations.  Outputs have n+1 entries (sorted,
// prior inserted).  Returns the prior's position.
int64_t ht_adaptive_parzen(const double* mus, int64_t n, double prior_weight,
                           double prior_mu, double prior_sigma, int64_t lf,
                           double* w_out, double* mu_out, double* sig_out) {
  int64_t m = n + 1;
  if (n == 0) {
    w_out[0] = 1.0;
    mu_out[0] = prior_mu;
    sig_out[0] = prior_sigma;
    return 0;
  }

  // forgetting weights in time order
  std::vector<double> tw(n, 1.0);
  if (lf > 0 && lf < n) {
    int64_t ramp_len = n - lf;
    double lo = 1.0 / static_cast<double>(n);
    for (int64_t i = 0; i < ramp_len; ++i) {
      tw[i] = ramp_len > 1
                  ? lo + static_cast<double>(i) * (1.0 - lo) /
                             static_cast<double>(ramp_len - 1)
                  : lo;
    }
  }

  // argsort of the observations
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return mus[a] < mus[b];
  });

  // prior insertion position (searchsorted-left on sorted mus)
  int64_t prior_pos = 0;
  while (prior_pos < n && mus[order[prior_pos]] < prior_mu) ++prior_pos;

  for (int64_t i = 0; i < m; ++i) {
    if (i < prior_pos) {
      mu_out[i] = mus[order[i]];
      w_out[i] = tw[order[i]];
    } else if (i == prior_pos) {
      mu_out[i] = prior_mu;
      w_out[i] = prior_weight;
    } else {
      mu_out[i] = mus[order[i - 1]];
      w_out[i] = tw[order[i - 1]];
    }
  }

  // neighbor-gap sigmas on the prior-inserted sorted array
  if (m == 1) {
    sig_out[0] = prior_sigma;
  } else if (m == 2) {
    double gap = std::max(std::abs(mu_out[1] - mu_out[0]), kEps);
    sig_out[0] = gap;
    sig_out[1] = gap;
  } else {
    for (int64_t i = 1; i + 1 < m; ++i) {
      sig_out[i] =
          std::max(mu_out[i] - mu_out[i - 1], mu_out[i + 1] - mu_out[i]);
    }
    sig_out[0] = mu_out[1] - mu_out[0];
    sig_out[m - 1] = mu_out[m - 1] - mu_out[m - 2];
  }
  double maxsigma = prior_sigma;
  double minsigma =
      prior_sigma / std::min(100.0, 1.0 + static_cast<double>(n));
  for (int64_t i = 0; i < m; ++i) {
    sig_out[i] = std::clamp(sig_out[i], minsigma, maxsigma);
  }
  sig_out[prior_pos] = prior_sigma;

  double wsum = 0.0;
  for (int64_t i = 0; i < m; ++i) wsum += w_out[i];
  for (int64_t i = 0; i < m; ++i) w_out[i] /= wsum;
  return prior_pos;
}

}  // extern "C"
