#include "autotune.h"

#include <algorithm>
#include <cmath>
#include <cstdio>

namespace hvd {

namespace {
constexpr int64_t kMaxFusion = 64ll << 20;
constexpr double kMinCycleS = 0.0005;
constexpr double kMaxCycleS = 0.025;

double NormalCdf(double z) { return 0.5 * (1.0 + std::erf(z / M_SQRT2)); }
double NormalPdf(double z) {
  return std::exp(-0.5 * z * z) / std::sqrt(2.0 * M_PI);
}
}  // namespace

// ---------------------------------------------------------------------------
// GaussianProcess
// ---------------------------------------------------------------------------

double GaussianProcess::Kernel(const std::vector<double>& a,
                               const std::vector<double>& b) const {
  double d2 = 0;
  for (size_t i = 0; i < a.size(); ++i) d2 += (a[i] - b[i]) * (a[i] - b[i]);
  return sv_ * std::exp(-0.5 * d2 / (ls_ * ls_));
}

double GaussianProcess::Factor(const std::vector<std::vector<double>>& x,
                               const std::vector<double>& yn) {
  const size_t n = x.size();
  // K + σ²I, then Cholesky (plain row-major; n is tens at most).
  std::vector<double> k(n * n);
  for (size_t i = 0; i < n; ++i)
    for (size_t j = 0; j < n; ++j)
      k[i * n + j] = Kernel(x[i], x[j]) + (i == j ? nv_ : 0.0);
  chol_.assign(n * n, 0.0);
  for (size_t i = 0; i < n; ++i) {
    for (size_t j = 0; j <= i; ++j) {
      double s = k[i * n + j];
      for (size_t m = 0; m < j; ++m) s -= chol_[i * n + m] * chol_[j * n + m];
      if (i == j)
        chol_[i * n + i] = std::sqrt(std::max(s, 1e-12));
      else
        chol_[i * n + j] = s / chol_[j * n + j];
    }
  }
  // alpha = K⁻¹ yn via two triangular solves.
  std::vector<double> tmp(n);
  for (size_t i = 0; i < n; ++i) {
    double s = yn[i];
    for (size_t m = 0; m < i; ++m) s -= chol_[i * n + m] * tmp[m];
    tmp[i] = s / chol_[i * n + i];
  }
  alpha_.assign(n, 0.0);
  for (size_t ii = n; ii-- > 0;) {
    double s = tmp[ii];
    for (size_t m = ii + 1; m < n; ++m) s -= chol_[m * n + ii] * alpha_[m];
    alpha_[ii] = s / chol_[ii * n + ii];
  }
  // lml = -1/2 ynᵀα − Σ log L_ii − n/2 log 2π
  double lml = 0;
  for (size_t i = 0; i < n; ++i) lml += yn[i] * alpha_[i];
  lml *= -0.5;
  for (size_t i = 0; i < n; ++i) lml -= std::log(chol_[i * n + i]);
  lml -= 0.5 * n * std::log(2.0 * M_PI);
  return lml;
}

void GaussianProcess::Fit(const std::vector<std::vector<double>>& x,
                          const std::vector<double>& y) {
  const size_t n = x.size();
  x_ = x;
  y_mean_ = 0;
  for (double v : y) y_mean_ += v;
  y_mean_ /= n;
  double var = 0;
  for (double v : y) var += (v - y_mean_) * (v - y_mean_);
  y_std_ = n > 1 ? std::sqrt(var / n) : 1.0;
  if (y_std_ == 0) y_std_ = 1.0;
  std::vector<double> yn(n);
  for (size_t i = 0; i < n; ++i) yn[i] = (y[i] - y_mean_) / y_std_;

  if (fit_ls_ && n >= 3) {
    // Type-II MLE over a log grid of length-scales (0.05 → 2.0, 24
    // points) — dense evaluation instead of the reference's L-BFGS
    // line search, exact at these sample counts.
    const int kGrid = 24;
    double best_ls = ls_, best_lml = -1e300;
    for (int g = 0; g < kGrid; ++g) {
      ls_ = 0.05 * std::pow(2.0 / 0.05, g / (kGrid - 1.0));
      double lml = Factor(x, yn);
      if (lml > best_lml) {
        best_lml = lml;
        best_ls = ls_;
      }
    }
    ls_ = best_ls;
  }
  Factor(x, yn);
}

void GaussianProcess::Predict(const std::vector<double>& x, double* mean,
                              double* stddev) const {
  const size_t n = x_.size();
  if (n == 0) {
    *mean = y_mean_;
    *stddev = std::sqrt(sv_);
    return;
  }
  std::vector<double> ks(n);
  for (size_t i = 0; i < n; ++i) ks[i] = Kernel(x, x_[i]);
  double m = 0;
  for (size_t i = 0; i < n; ++i) m += ks[i] * alpha_[i];
  // v = L⁻¹ ks;  var = k(x,x) − ‖v‖²
  std::vector<double> v(n);
  for (size_t i = 0; i < n; ++i) {
    double s = ks[i];
    for (size_t mm = 0; mm < i; ++mm) s -= chol_[i * n + mm] * v[mm];
    v[i] = s / chol_[i * n + i];
  }
  double var = sv_;
  for (size_t i = 0; i < n; ++i) var -= v[i] * v[i];
  var = std::max(var, 1e-12);
  *mean = m * y_std_ + y_mean_;
  *stddev = std::sqrt(var) * y_std_;
}

// ---------------------------------------------------------------------------
// BayesianOptimization
// ---------------------------------------------------------------------------

void BayesianOptimization::AddSample(const std::vector<double>& x, double y) {
  xs_.push_back(x);
  ys_.push_back(y);
  gp_.Fit(xs_, ys_);
}

std::vector<double> BayesianOptimization::Best() const {
  if (ys_.empty()) return {};
  size_t best = std::max_element(ys_.begin(), ys_.end()) - ys_.begin();
  return xs_[best];
}

double BayesianOptimization::ExpectedImprovement(
    const std::vector<double>& x) const {
  double mean, sd;
  gp_.Predict(x, &mean, &sd);
  double best = ys_.empty() ? 0.0 : *std::max_element(ys_.begin(), ys_.end());
  // Standardized scale, so the xi exploration bonus is meaningful at any
  // raw score magnitude (bytes/sec is ~1e8).
  double y_std = gp_.y_std();
  double imp = (mean - best) / y_std - xi_;
  double sds = sd / y_std;
  double z = imp / sds;
  return imp * NormalCdf(z) + sds * NormalPdf(z);
}

std::vector<double> BayesianOptimization::NextSample() {
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  if (ys_.empty()) {
    std::vector<double> x(dim_);
    for (auto& v : x) v = uni(rng_);
    return x;
  }
  std::normal_distribution<double> local(0.0, 0.1);
  auto best = Best();
  std::vector<double> best_x;
  double best_ei = -1;
  for (int c = 0; c < n_candidates_ + n_candidates_ / 4; ++c) {
    std::vector<double> x(dim_);
    if (c < n_candidates_) {
      for (auto& v : x) v = uni(rng_);
    } else {
      for (int i = 0; i < dim_; ++i)
        x[i] = std::min(1.0, std::max(0.0, best[i] + local(rng_)));
    }
    double ei = ExpectedImprovement(x);
    if (ei > best_ei) {
      best_ei = ei;
      best_x = x;
    }
  }
  return best_x;
}

// ---------------------------------------------------------------------------
// ParameterManager
// ---------------------------------------------------------------------------

ParameterManager::ParameterManager(const TunedParams& initial,
                                   const Options& opts)
    : current_(initial),
      opts_(opts),
      bo_(1),
      warmup_left_(opts.warmup_samples) {
  if (opts_.tune_fusion) dims_.push_back("fusion");
  if (opts_.tune_cycle) dims_.push_back("cycle");
  if (opts_.tune_cache) dims_.push_back("cache");
  if (opts_.tune_hier_allreduce) dims_.push_back("hier_ar");
  if (opts_.tune_hier_allgather) dims_.push_back("hier_ag");
  bo_ = BayesianOptimization(std::max<int>(1, dims_.size()));
  current_x_ = ParamsToX(initial);
  if (!opts_.log_path.empty()) {
    FILE* f = std::fopen(opts_.log_path.c_str(), "w");
    if (f)
      std::fprintf(f,
                   "sample,score_bytes_per_s,fusion_threshold,"
                   "cycle_time_ms,cache_enabled,hierarchical_allreduce,"
                   "hierarchical_allgather\n");
    log_file_ = f;
  }
}

ParameterManager::~ParameterManager() {
  if (log_file_) std::fclose(static_cast<FILE*>(log_file_));
}

std::vector<double> ParameterManager::ParamsToX(const TunedParams& p) const {
  std::vector<double> x;
  for (auto& d : dims_) {
    if (d == "fusion")
      x.push_back(double(p.fusion_threshold) / kMaxFusion);
    else if (d == "cycle")
      x.push_back((p.cycle_time_s - kMinCycleS) / (kMaxCycleS - kMinCycleS));
    else if (d == "hier_ar")
      x.push_back(p.hierarchical_allreduce ? 1.0 : 0.0);
    else if (d == "hier_ag")
      x.push_back(p.hierarchical_allgather ? 1.0 : 0.0);
    else
      x.push_back(p.cache_enabled ? 1.0 : 0.0);
  }
  if (x.empty()) x.push_back(0.0);
  return x;
}

TunedParams ParameterManager::XToParams(const std::vector<double>& x) const {
  TunedParams p = current_;
  for (size_t i = 0; i < dims_.size(); ++i) {
    double v = std::min(1.0, std::max(0.0, x[i]));
    if (dims_[i] == "fusion")
      p.fusion_threshold =
          int64_t(std::llround(v * kMaxFusion / (1 << 20))) << 20;
    else if (dims_[i] == "cycle")
      p.cycle_time_s = kMinCycleS + v * (kMaxCycleS - kMinCycleS);
    else if (dims_[i] == "hier_ar")
      p.hierarchical_allreduce = v >= 0.5;
    else if (dims_[i] == "hier_ag")
      p.hierarchical_allgather = v >= 0.5;
    else
      p.cache_enabled = v >= 0.5;
  }
  return p;
}

void ParameterManager::Log(int sample, double score) {
  if (!log_file_) return;
  FILE* f = static_cast<FILE*>(log_file_);
  if (sample < 0)  // settled row, mirroring the Python tuner's format
    std::fprintf(f, "final,,%lld,%.3f,%d,%d,%d\n",
                 static_cast<long long>(current_.fusion_threshold),
                 current_.cycle_time_s * 1e3, current_.cache_enabled ? 1 : 0,
                 current_.hierarchical_allreduce ? 1 : 0,
                 current_.hierarchical_allgather ? 1 : 0);
  else
    std::fprintf(f, "%d,%.1f,%lld,%.3f,%d,%d,%d\n", sample, score,
                 static_cast<long long>(current_.fusion_threshold),
                 current_.cycle_time_s * 1e3, current_.cache_enabled ? 1 : 0,
                 current_.hierarchical_allreduce ? 1 : 0,
                 current_.hierarchical_allgather ? 1 : 0);
  std::fflush(f);
}

bool ParameterManager::RecordBytes(int64_t nbytes, double now_s,
                                   TunedParams* out) {
  if (done_) return false;
  if (sample_start_s_ < 0) sample_start_s_ = now_s;
  bytes_ += nbytes;
  double elapsed = now_s - sample_start_s_;
  if (elapsed > 5 * opts_.sample_duration_s) {
    // Idle gap (eval, checkpointing, …): the window measures the pause,
    // not the knobs — discard it instead of scoring the incumbent ~0.
    bytes_ = nbytes;
    sample_start_s_ = now_s;
    return false;
  }
  if (elapsed < opts_.sample_duration_s || bytes_ <= 0) return false;

  double score = double(bytes_) / elapsed;
  bytes_ = 0;
  sample_start_s_ = now_s;

  if (warmup_left_ > 0) {
    --warmup_left_;
    return false;
  }

  ++samples_;
  bo_.AddSample(current_x_, score);
  Log(samples_, score);

  if (samples_ >= opts_.max_samples) {
    current_ = XToParams(bo_.Best());
    done_ = true;
    Log(-1, 0.0);
    *out = current_;
    return true;
  }
  current_x_ = bo_.NextSample();
  current_ = XToParams(current_x_);
  *out = current_;
  return true;
}

}  // namespace hvd
