// Autotuning of coordination-loop knobs: GP regression + expected
// improvement over (fusion threshold, cycle time, cache on/off), scored
// by allreduced bytes/sec.
//
// Role parity: horovod/common/parameter_manager.cc/.h +
// optim/bayesian_optimization.cc + optim/gaussian_process.cc (there:
// Eigen + L-BFGS; here: hand-rolled Cholesky + candidate sweep — sample
// counts are tens, dimensions ≤ 3).  The Python twin
// (horovod_tpu_torch/autotune/) is the executable spec; only rank 0 runs the
// tuner, so the two implementations never need bit-identical decisions.
#pragma once

#include <cstdint>
#include <random>
#include <string>
#include <vector>

namespace hvd {

// GP posterior over f: [0,1]^d -> R, RBF kernel.  The length-scale is
// selected per Fit by maximum marginal likelihood over a log grid
// (parity: the reference's L-BFGS MLE, gaussian_process.cc:44+; twin of
// the python engine's autotune/gaussian_process.py) — pass a positive
// length_scale to pin it instead.
class GaussianProcess {
 public:
  GaussianProcess(double length_scale = 0.0, double signal_variance = 1.0,
                  double noise_variance = 1e-4)
      : fit_ls_(length_scale <= 0.0),
        ls_(length_scale <= 0.0 ? 0.25 : length_scale),
        sv_(signal_variance), nv_(noise_variance) {}

  void Fit(const std::vector<std::vector<double>>& x,
           const std::vector<double>& y);
  // Posterior mean and stddev at one point (de-standardized).
  void Predict(const std::vector<double>& x, double* mean,
               double* stddev) const;
  // Scale of the standardized targets (1.0 before the first Fit).
  double y_std() const { return y_std_; }

 private:
  double Kernel(const std::vector<double>& a,
                const std::vector<double>& b) const;
  // Cholesky + weights for the current ls_; returns the log marginal
  // likelihood (GPML eq. 2.30).  Always finite: a near-non-PD kernel is
  // clamped (diagonal floored at 1e-12), which naturally scores badly
  // against better-conditioned candidates rather than needing a
  // sentinel.
  double Factor(const std::vector<std::vector<double>>& x,
                const std::vector<double>& yn);

  bool fit_ls_;
  double ls_, sv_, nv_;
  std::vector<std::vector<double>> x_;
  std::vector<double> alpha_;
  std::vector<double> chol_;  // lower triangular, row-major n×n
  double y_mean_ = 0, y_std_ = 1;
};

class BayesianOptimization {
 public:
  explicit BayesianOptimization(int dim, double xi = 0.01,
                                uint32_t seed = 0, int n_candidates = 512)
      : dim_(dim), xi_(xi), rng_(seed), n_candidates_(n_candidates) {}

  void AddSample(const std::vector<double>& x, double y);
  std::vector<double> Best() const;
  std::vector<double> NextSample();
  double ExpectedImprovement(const std::vector<double>& x) const;
  bool empty() const { return ys_.empty(); }

 private:
  int dim_;
  double xi_;
  std::mt19937 rng_;
  int n_candidates_;
  std::vector<std::vector<double>> xs_;
  std::vector<double> ys_;
  GaussianProcess gp_;
};

struct TunedParams {
  int64_t fusion_threshold = 64 << 20;
  double cycle_time_s = 0.005;
  bool cache_enabled = true;
  bool hierarchical_allreduce = false;
  bool hierarchical_allgather = false;
  int64_t ring_segment_bytes = 0;
};

// Rank-0 tuner: feed allreduced bytes, get knob updates to broadcast.
class ParameterManager {
 public:
  struct Options {
    bool tune_fusion = true;
    bool tune_cycle = true;
    bool tune_cache = true;
    // Only meaningful on hierarchical topologies; the engine gates these
    // on local_size>1 && cross_size>1 before constructing the manager.
    bool tune_hier_allreduce = false;
    bool tune_hier_allgather = false;
    int warmup_samples = 3;
    int max_samples = 20;
    double sample_duration_s = 0.5;
    std::string log_path;
  };

  ParameterManager(const TunedParams& initial, const Options& opts);
  ~ParameterManager();

  // Returns true when *out holds new params to apply + broadcast.
  bool RecordBytes(int64_t nbytes, double now_s, TunedParams* out);
  bool done() const { return done_; }
  const TunedParams& current() const { return current_; }

 private:
  std::vector<double> ParamsToX(const TunedParams& p) const;
  TunedParams XToParams(const std::vector<double>& x) const;
  void Log(int sample, double score);

  TunedParams current_;
  Options opts_;
  std::vector<std::string> dims_;
  BayesianOptimization bo_;
  std::vector<double> current_x_;
  int warmup_left_;
  int samples_ = 0;
  int64_t bytes_ = 0;
  double sample_start_s_ = -1;
  bool done_ = false;
  void* log_file_ = nullptr;  // FILE*
};

}  // namespace hvd
