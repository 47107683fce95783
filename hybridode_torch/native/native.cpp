// Native host-side numerics for hybridode_torch (its own copy of the JAX package's native.cpp).
//
// The reference leans on Fortran inside SciPy for two host-side jobs:
//   * ODEPACK LSODA for per-patient ground-truth generation
//     (reference dataloader.py:151-161), and
//   * Lawson-Hanson NNLS for ensemble weights
//     (run_simulation_ensemble.py:135).
// This library is the framework's native replacement: a float64
// Dormand-Prince 5(4) integrator specialized to the hybrid Roche field
// (expert PK/PD + tanh-linear remainder) and a dense active-set NNLS.
// Exposed via a C ABI for ctypes.
//
// Built at first use by hybridode_torch/native/__init__.py:
//   g++ -O3 -march=native -shared -fPIC native.cpp -o .torch_ext_build/native-<hash>.so

#include <cmath>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

constexpr int kExpert = 4;

struct RocheParams {
  double HillCure, HillPatho, ec50_patho, emax_patho, k_dexa;
  double k_discure_immunereact, k_discure_immunity, k_disprog;
  double k_immune_disease, k_immune_feedback, k_immune_off, k_immunity, kel;
};

// dy/dt of the hybrid Roche field for one patient (see hybridode_torch/fields/roche.py;
// reference dynamics at model.py:527-544, ml remainder at model.py:551-553).
void roche_rhs(double t, const double* y, double* dy, int D,
               const RocheParams& p, const double* dose_times, int n_dose,
               double dose_amount, const double* ml_coef, int ml_dim) {
  const double Disease = y[0], ImmuneReact = y[1], Immunity = y[2], Dose2 = y[3];

  double dose = 0.0;
  for (int j = 0; j < n_dose; ++j) {
    if (t >= dose_times[j]) dose += std::exp(p.kel * (dose_times[j] - t));
  }
  dose *= dose_amount;

  dy[0] = Disease * p.k_disprog
        - Disease * std::pow(std::fabs(Immunity), p.HillCure) * p.k_discure_immunity
        - Disease * ImmuneReact * p.k_discure_immunereact;

  const double irh = std::pow(std::fabs(ImmuneReact), p.HillPatho);
  dy[1] = Disease * p.k_immune_disease
        - ImmuneReact * p.k_immune_off
        + Disease * ImmuneReact * p.k_immune_feedback
        + irh * p.emax_patho / (std::pow(p.ec50_patho, p.HillPatho) + irh)
        - Dose2 * ImmuneReact * p.k_dexa;

  dy[2] = ImmuneReact * p.k_immunity;
  dy[3] = p.kel * dose - p.kel * Dose2;

  // ml remainder: dml = tanh(y . ml_coef), ml_coef is (D, ml_dim) row-major.
  for (int k = 0; k < ml_dim; ++k) {
    double acc = 0.0;
    for (int d = 0; d < D; ++d) acc += y[d] * ml_coef[d * ml_dim + k];
    dy[kExpert + k] = std::tanh(acc);
  }
}

// Dormand-Prince 5(4) tableau (Hairer I).
const double kC[7] = {0., 1. / 5, 3. / 10, 4. / 5, 8. / 9, 1., 1.};
const double kA[7][6] = {
    {},
    {1. / 5},
    {3. / 40, 9. / 40},
    {44. / 45, -56. / 15, 32. / 9},
    {19372. / 6561, -25360. / 2187, 64448. / 6561, -212. / 729},
    {9017. / 3168, -355. / 33, 46732. / 5247, 49. / 176, -5103. / 18656},
    {35. / 384, 0., 500. / 1113, 125. / 192, -2187. / 6784, 11. / 84}};
const double kE[7] = {71. / 57600, 0., -71. / 16695, 71. / 1920,
                      -17253. / 339200, 22. / 525, -1. / 40};
const double kD[7] = {-12715105075. / 11282082432, 0., 87487479700. / 32700410799,
                      -10690763975. / 1880347072, 701980252875. / 199316789632,
                      -1453857185. / 822651844, 69997945. / 29380423};

struct Work {
  std::vector<double> k[7], ytmp, y, err, r1, r2, r3, r4, r5;
  explicit Work(int D) : ytmp(D), y(D), err(D), r1(D), r2(D), r3(D), r4(D), r5(D) {
    for (auto& ki : k) ki.resize(D);
  }
};

double rms_scaled(const double* e, const double* y0, const double* y1, int D,
                  double rtol, double atol) {
  double acc = 0.0;
  for (int d = 0; d < D; ++d) {
    double sc = atol + rtol * std::max(std::fabs(y0[d]), std::fabs(y1[d]));
    double r = e[d] / sc;
    acc += r * r;
  }
  return std::sqrt(acc / D);
}

}  // namespace

extern "C" {

// Integrate one patient over the grid ts (length T); out is (T, D) row-major.
// Returns 0 on success, 1 on step-budget exhaustion / non-finite state.
int ho_roche_dopri5_single(const double* y0, int D, const double* dose_times,
                           int n_dose, double dose_amount, const double* params13,
                           const double* ml_coef, int ml_dim, const double* ts,
                           int T, double rtol, double atol, int max_steps,
                           double* out) {
  RocheParams p;
  std::memcpy(&p, params13, sizeof(double) * 13);
  Work w(D);
  std::memcpy(w.y.data(), y0, sizeof(double) * D);
  std::memcpy(out, y0, sizeof(double) * D);

  double t = ts[0];
  const double t_final = ts[T - 1];
  int next_out = 1;

  auto rhs = [&](double tt, const double* yy, double* dd) {
    roche_rhs(tt, yy, dd, D, p, dose_times, n_dose, dose_amount, ml_coef, ml_dim);
  };

  rhs(t, w.y.data(), w.k[0].data());

  // Hairer initial step selection (simplified).
  double d0 = 0, d1 = 0;
  for (int d = 0; d < D; ++d) {
    double sc = atol + rtol * std::fabs(w.y[d]);
    d0 += (w.y[d] / sc) * (w.y[d] / sc);
    d1 += (w.k[0][d] / sc) * (w.k[0][d] / sc);
  }
  d0 = std::sqrt(d0 / D);
  d1 = std::sqrt(d1 / D);
  double h = (std::min(d0, d1) < 1e-5) ? 1e-6 : 0.01 * d0 / std::max(d1, 1e-30);
  h = std::min(h, t_final - t);

  for (int step = 0; step < max_steps && next_out < T; ++step) {
    bool last = h >= t_final - t;
    double h_eff = last ? (t_final - t) : h;

    for (int i = 1; i < 7; ++i) {
      for (int d = 0; d < D; ++d) {
        double acc = 0.0;
        for (int j = 0; j < i; ++j) acc += kA[i][j] * w.k[j][d];
        w.ytmp[d] = w.y[d] + h_eff * acc;
      }
      rhs(t + kC[i] * h_eff, w.ytmp.data(), w.k[i].data());
    }
    // 5th-order solution is stage-7's evaluation point.
    std::vector<double>& y1 = w.ytmp;
    for (int d = 0; d < D; ++d) {
      double acc = 0.0;
      for (int j = 0; j < 6; ++j) acc += kA[6][j] * w.k[j][d];
      y1[d] = w.y[d] + h_eff * acc;
      double e = 0.0;
      for (int j = 0; j < 7; ++j) e += kE[j] * w.k[j][d];
      w.err[d] = h_eff * e;
    }

    double norm = rms_scaled(w.err.data(), w.y.data(), y1.data(), D, rtol, atol);
    bool accept = std::isfinite(norm) && norm <= 1.0;

    if (accept) {
      double t_new = last ? t_final : t + h_eff;
      // dense output coefficients (Hairer DOPRI5 continuous extension)
      for (int d = 0; d < D; ++d) {
        double dy = y1[d] - w.y[d];
        double bspl = h_eff * w.k[0][d] - dy;
        w.r1[d] = w.y[d];
        w.r2[d] = dy;
        w.r3[d] = bspl;
        w.r4[d] = dy - h_eff * w.k[6][d] - bspl;
        double acc = 0.0;
        for (int j = 0; j < 7; ++j) acc += kD[j] * w.k[j][d];
        w.r5[d] = h_eff * acc;
      }
      while (next_out < T && ts[next_out] <= t_new + 1e-12) {
        double th = std::min(std::max((ts[next_out] - t) / std::max(h_eff, 1e-30), 0.0), 1.0);
        double th1 = 1.0 - th;
        double* o = out + (size_t)next_out * D;
        for (int d = 0; d < D; ++d) {
          o[d] = w.r1[d] + th * (w.r2[d] + th1 * (w.r3[d] + th * (w.r4[d] + th1 * w.r5[d])));
        }
        ++next_out;
      }
      t = t_new;
      std::swap(w.y, y1);
      std::swap(w.k[0], w.k[6]);  // FSAL
    }

    double factor = (norm == 0.0) ? 10.0
                                  : std::min(10.0, std::max(0.2, 0.9 * std::pow(norm, -0.2)));
    if (!accept) factor = std::min(1.0, factor);
    if (!std::isfinite(norm)) factor = 0.2;
    h = h_eff * factor;
  }
  return next_out >= T ? 0 : 1;
}

// Batched cohort integration: y0 (B, D), dose_times (B, n_dose),
// dose_amounts (B,), out (T, B, D). Returns number of failed patients.
int ho_roche_dopri5_batch(const double* y0, int B, int D, const double* dose_times,
                          int n_dose, const double* dose_amounts,
                          const double* params13, const double* ml_coef, int ml_dim,
                          const double* ts, int T, double rtol, double atol,
                          int max_steps, double* out) {
  std::vector<double> traj((size_t)T * D);
  int failures = 0;
  for (int b = 0; b < B; ++b) {
    int rc = ho_roche_dopri5_single(y0 + (size_t)b * D, D, dose_times + (size_t)b * n_dose,
                                    n_dose, dose_amounts[b], params13, ml_coef, ml_dim,
                                    ts, T, rtol, atol, max_steps, traj.data());
    failures += rc;
    for (int tt = 0; tt < T; ++tt) {
      std::memcpy(out + ((size_t)tt * B + b) * D, traj.data() + (size_t)tt * D,
                  sizeof(double) * D);
    }
  }
  return failures;
}

// Dense Lawson-Hanson NNLS: minimize ||A x - b||, x >= 0.
// A is (m, n) row-major. Returns 0 on success.
int ho_nnls(const double* A, const double* b, int m, int n, double* x,
            double* rnorm) {
  std::vector<char> passive(n, 0);
  std::vector<double> w(n), s(n), resid(m);
  std::fill(x, x + n, 0.0);

  auto compute_w = [&]() {
    for (int i = 0; i < m; ++i) {
      double ax = 0.0;
      for (int j = 0; j < n; ++j) ax += A[(size_t)i * n + j] * x[j];
      resid[i] = b[i] - ax;
    }
    for (int j = 0; j < n; ++j) {
      double acc = 0.0;
      for (int i = 0; i < m; ++i) acc += A[(size_t)i * n + j] * resid[i];
      w[j] = acc;
    }
  };

  // Least squares on the passive set via normal equations + Cholesky
  // (n is small in practice: the ensemble solves n=2).
  auto solve_passive = [&](std::vector<double>& sol) -> bool {
    std::vector<int> P;
    for (int j = 0; j < n; ++j)
      if (passive[j]) P.push_back(j);
    int k = (int)P.size();
    if (k == 0) return true;
    std::vector<double> G((size_t)k * k, 0.0), c(k, 0.0);
    for (int a = 0; a < k; ++a) {
      for (int bb = a; bb < k; ++bb) {
        double acc = 0.0;
        for (int i = 0; i < m; ++i)
          acc += A[(size_t)i * n + P[a]] * A[(size_t)i * n + P[bb]];
        G[(size_t)a * k + bb] = G[(size_t)bb * k + a] = acc;
      }
      double acc = 0.0;
      for (int i = 0; i < m; ++i) acc += A[(size_t)i * n + P[a]] * b[i];
      c[a] = acc;
    }
    // Cholesky
    for (int a = 0; a < k; ++a) {
      for (int bb = 0; bb <= a; ++bb) {
        double acc = G[(size_t)a * k + bb];
        for (int q = 0; q < bb; ++q) acc -= G[(size_t)a * k + q] * G[(size_t)bb * k + q];
        if (a == bb) {
          if (acc <= 0) return false;
          G[(size_t)a * k + a] = std::sqrt(acc);
        } else {
          G[(size_t)a * k + bb] = acc / G[(size_t)bb * k + bb];
        }
      }
    }
    for (int a = 0; a < k; ++a) {
      double acc = c[a];
      for (int q = 0; q < a; ++q) acc -= G[(size_t)a * k + q] * c[q];
      c[a] = acc / G[(size_t)a * k + a];
    }
    for (int a = k - 1; a >= 0; --a) {
      double acc = c[a];
      for (int q = a + 1; q < k; ++q) acc -= G[(size_t)q * k + a] * c[q];
      c[a] = acc / G[(size_t)a * k + a];
    }
    std::fill(sol.begin(), sol.end(), 0.0);
    for (int a = 0; a < k; ++a) sol[P[a]] = c[a];
    return true;
  };

  const int max_iter = 3 * n + 10;
  double tol = 1e-12;
  {
    double a1 = 0.0;
    for (size_t i = 0; i < (size_t)m * n; ++i) a1 = std::max(a1, std::fabs(A[i]));
    tol = 1e-12 * a1 * m;
  }

  for (int outer = 0; outer < max_iter; ++outer) {
    compute_w();
    int jmax = -1;
    double wmax = tol;
    for (int j = 0; j < n; ++j) {
      if (!passive[j] && w[j] > wmax) {
        wmax = w[j];
        jmax = j;
      }
    }
    if (jmax < 0) break;
    passive[jmax] = 1;

    for (int inner = 0; inner < max_iter; ++inner) {
      if (!solve_passive(s)) {
        passive[jmax] = 0;
        break;
      }
      bool ok = true;
      for (int j = 0; j < n; ++j)
        if (passive[j] && s[j] <= tol) ok = false;
      if (ok) {
        std::copy(s.begin(), s.end(), x);
        break;
      }
      double alpha = 1.0;
      for (int j = 0; j < n; ++j) {
        if (passive[j] && s[j] <= tol && x[j] != s[j]) {
          alpha = std::min(alpha, x[j] / (x[j] - s[j]));
        }
      }
      for (int j = 0; j < n; ++j) x[j] += alpha * (s[j] - x[j]);
      for (int j = 0; j < n; ++j)
        if (passive[j] && x[j] <= tol) passive[j] = 0;
    }
  }

  double acc = 0.0;
  for (int i = 0; i < m; ++i) {
    double ax = 0.0;
    for (int j = 0; j < n; ++j) ax += A[(size_t)i * n + j] * x[j];
    double r = ax - b[i];
    acc += r * r;
  }
  *rnorm = std::sqrt(acc);
  return 0;
}

}  // extern "C"
