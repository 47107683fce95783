// The real track's explicit-Adams solve of roche_real_field, one warp a row: the solve, the same solve recording the
// state at each substep, and the discrete adjoint of a recorded solve.
//
// Replaces no TPU kernel: the JAX package runs this solve through XLA
// (hybridode/solvers/fixed_step.py), and so does the port's plain path,
// `odeint_fixed(roche_real_field, ..., method="explicit_adams")`
// (hybridode_torch/solvers/fixed_step.py, fields/real.py). Captured in the
// training step's CUDA graph, that path is some 40 small kernels a field
// evaluation forward and twice that backward: ~19,700 of the step graph's
// ~20,800 nodes at two substeps an hour over the cell's 73-hour grid, and the
// replay is bound by its node count (~2 us a node). Here one launch solves
// every row, and one launch runs its adjoint.
//
// What it computes, in odeint_fixed's order: over each grid interval
// [ts[i], ts[i+1]], n_sub substeps of dt = (ts[i+1] - ts[i]) / n_sub at
// t = ts[i] + dt s; RK4 (`_rk_step`) on the first three substeps of the
// solve, AB4 (y + dt (55 f_n - 59 f_{n-1} + 37 f_{n-2} - 9 f_{n-3}) / 24)
// after; y at each grid point. The field is roche_real_field: the depot
// sum_j a_j exp(kel (j - t)) [t >= j] over the Ta hours of the action
// sequence (fields/dose.py `exp_decay_dose_seq`), two tanh MLPs of H hidden
// units over the expert states, the closed-form immunity and depot terms, and
// the D - 4 wide GRU remainder. Float32 throughout; expf, tanhf and division
// are the accurate ones (no --use_fast_math); the time grid and the stage sums
// are rounded as PyTorch rounds them (__fmul_rn, __fadd_rn); the field's
// dot products use FMAs and sum in another order than PyTorch's matrix
// products, so the outputs equal the plain route's to rounding, not bit for
// bit.
//
// With gradients (ops/roche_real_ab4.py `roche_real_ab4_grad`, one
// torch.autograd.Function): the forward also writes the state at the start of
// each substep (B x N x D floats for N substeps, 1.2 MB at the cell's shape);
// the backward walks the substeps in reverse: the cotangent of y_{n+1} passes
// to y_n and, for an AB4 substep, dt AB4[q] times it to f_{n-q}; once every
// later substep has added to f_n's cotangent (four registers a state held in
// turn), the vector-Jacobian product of the field at the recorded (t_n, y_n)
// gives the cotangent of y_n and the weights' partial gradients. An RK4
// substep is recomputed from its recorded state and its four stages walked in
// reverse. The gradients are discretize-then-optimize, autograd's through
// odeint_fixed to rounding (ops/roche_real_ab4.py `backward_recurrence` is
// the same recurrence in PyTorch). Each row writes its own partial gradient
// of every weight; the wrapper sums the rows in a fixed order: no float
// atomics, so two backward launches agree bit for bit.
//
// What bounds it on an H100: neither bytes nor FLOPs (~2,700 FLOP a field
// evaluation a row; ~1.2 MB recorded) but one row's serial chain of ~155
// field evaluations forward (146 substeps, three of them RK4) and as many
// vector-Jacobian products backward. The cell's batch of 100 rows fills 100 of
// the 132 SMs with one warp each, so the launch lasts as long as one row's
// chain. The design shortens the chain:
// - A row's field is spread over the 32 lanes of a warp: lane d holds state
//   component d (and its AB4 history and cotangents); the MLPs' hidden units
//   and the GRU's columns are split over the lanes. The MLPs' outputs are
//   summed by a butterfly of shuffles, which leaves the same sum, in the same
//   order, in every lane; a vector the next stage needs whole (the state,
//   r * h, the GRU's pre-activation cotangents) is gathered through the row's
//   shared memory between two __syncwarp().
// - The depot and its derivative in kel depend on the time alone: before the
//   solve, the lanes compute them at each of the N + 6 times the solve
//   evaluates the field (each substep's, RK4's middles and ends), a table in
//   the row's shared memory, so the 97-term sum leaves the serial chain. Timed
//   with parts of the field taken out (PERF.md §6), the depot inside the chain
//   was 28 % of the forward and 21 % of the backward.
// - The weights, the GRU's transposed weights (so that a row of them is read
//   without bank conflicts), the grid and the row's actions are staged in
//   shared memory once. Each lane's partial gradients live in registers.
// - Blocks of one warp, one row each, so the rows spread over the SMs.
// PERF.md §6 has this design timed against one thread a row at the cell's
// shape.
//
// Nothing reads the host and nothing is allocated: a CUDA graph captures both
// launches. With `rows`, the forward adds the rows it solves to rows[0] and
// rows[1] (rows solved by the kernel, rows decoded), one atomic a block.

#include <cuda_runtime.h>

// The file is compiled once a width, with -DROCHE_REAL_AB4_DIM=D -DROCHE_REAL_AB4_HIDDEN=H (ops/build.py): D the
// latent state (4 expert states and a D - 4 wide GRU), H the MLPs' hidden units.
#if !defined(ROCHE_REAL_AB4_DIM) || !defined(ROCHE_REAL_AB4_HIDDEN)
#error "compile with -DROCHE_REAL_AB4_DIM=<D> -DROCHE_REAL_AB4_HIDDEN=<H> (ops/build.py)"
#endif

namespace {

constexpr int kDim = ROCHE_REAL_AB4_DIM;
constexpr int kHidden = ROCHE_REAL_AB4_HIDDEN;
constexpr int kLanes = 32;  // a block is one warp, and solves one row
static_assert(kDim >= 4 && kHidden >= 1, "D >= 4 states, H >= 1 hidden units");

// The packed weights (ops/roche_real_ab4.py `field_leaves`): dx1_net's (3, H) and (H,), (H, 1) and (1,); dx2_net's
// (2, H) and (H,), (H, 1) and (1,); k_immunity, kel, kel2; lin_hr, lin_hz, lin_hh (ML, ML) each, ML = D - 4.
template <int D, int H>
struct Layout {
  static constexpr int ML = D - 4;
  static constexpr int W11 = 0, B11 = W11 + 3 * H, W12 = B11 + H, B12 = W12 + H;
  static constexpr int W21 = B12 + 1, B21 = W21 + 2 * H, W22 = B21 + H, B22 = W22 + H;
  static constexpr int KIM = B22 + 1, KEL = KIM + 1, KEL2 = KEL + 1;
  static constexpr int WHR = KEL2 + 1, WHZ = WHR + ML * ML, WHH = WHZ + ML * ML;
  static constexpr int P = WHH + ML * ML;  // the packed weights' floats
  // The shared copy holds the GRU's weights transposed too: row k of lin_w is column k there.
  static constexpr int WHR_T = P, WHZ_T = WHR_T + ML * ML, WHH_T = WHZ_T + ML * ML;
  static constexpr int SHARED = WHH_T + ML * ML;
  // Slots of a lane: state components d = lane + s * kLanes, hidden units j = lane + u * kLanes.
  static constexpr int S = (D + kLanes - 1) / kLanes;
  static constexpr int SH = (H + kLanes - 1) / kLanes;
  static constexpr int MW = ML > 0 ? ML : 1;
  // A row's shared scratch: the state and the expert cotangents, r * h, and the GRU's pre-activation cotangents.
  static constexpr int SCRATCH = D + 4 + 4 * MW;
};

using L = Layout<kDim, kHidden>;
constexpr int kS = L::S;

// AB4's coefficients and RK4's weights as PyTorch rounds them to float32 (solvers/tableaus.py).
__constant__ float kAB4[4] = {float(55.0 / 24.0), float(-59.0 / 24.0), float(37.0 / 24.0), float(-9.0 / 24.0)};
__constant__ float kRK4B[4] = {float(1.0 / 6.0), float(1.0 / 3.0), float(1.0 / 3.0), float(1.0 / 6.0)};

// Sum each of v over the row's lanes, leaving the same sum in every lane (a + b == b + a in IEEE arithmetic).
template <int N>
__device__ __forceinline__ void lane_sum(float (&v)[N]) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  }
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float pick(const float (&v)[4], int d) {
  return d == 0 ? v[0] : d == 1 ? v[1] : d == 2 ? v[2] : v[3];
}

// The time of substep n, t = ts[i] + dt s with dt = (ts[i + 1] - ts[i]) / n_sub, rounded as odeint_fixed forms it.
__device__ __forceinline__ float substep_time(const float* ts, int n, int n_sub, float& dt) {
  const int i = n / n_sub;
  dt = __fdiv_rn(__fsub_rn(ts[i + 1], ts[i]), static_cast<float>(n_sub));
  return __fadd_rn(ts[i], __fmul_rn(dt, static_cast<float>(n % n_sub)));
}

// Entries of a row's depot table: the N substeps' times, then the middle and the end of each of the three RK4 substeps.
__host__ __device__ __forceinline__ int depot_entries(int N) { return N + 6; }

// One row's view of the block's shared memory.
struct Row {
  const float* w;    // the staged weights (Layout::SHARED floats)
  const float* act;  // the row's actions, (Ta, A)
  float* buf;        // the row's scratch (Layout::SCRATCH floats)
  float* dose;       // the row's depot table: depot_entries(N) values of the depot, then as many of its kel derivative
  int Ta, A, N, lane;

  // The depot sum_j a_j exp(kel (j - t)) [t >= j] and its derivative in kel, sum_j a_j exp(kel (j - t)) (j - t)
  // [t >= j], each term formed as fields/dose.py forms it, at every time the solve evaluates the field: they depend
  // on the time alone, so the lanes fill the table before the solve, off its serial chain.
  __device__ void depot_table(const float* ts, int n_sub) const {
    const int E = depot_entries(N);
    const float kel = w[L::KEL];
    for (int e = lane; e < E; e += kLanes) {
      const int n = e < N ? e : (e - N) / 2;
      float dose_t = 0.0f, ddose_t = 0.0f;
      if (n < N) {
        float dt;
        float t = substep_time(ts, n, n_sub, dt);
        if (e >= N) t = (e - N) % 2 == 0 ? __fadd_rn(t, __fmul_rn(0.5f, dt)) : __fadd_rn(t, dt);
        for (int j = 0; j < Ta; ++j) {
          const float hour = static_cast<float>(j + 1);
          if (t >= hour) {
            const float delta = __fsub_rn(hour, t);
            const float ex = expf(__fmul_rn(kel, delta));
            for (int q = 0; q < A; ++q) {
              const float term = __fmul_rn(act[j * A + q], ex);
              dose_t += term;
              ddose_t = fmaf(term, delta, ddose_t);
            }
          }
        }
      }
      dose[e] = dose_t;
      dose[E + e] = ddose_t;
    }
    __syncwarp();
  }

  // The depot table's entries of substep n (its own time) and of RK4's middle and end of it (n < 3).
  __device__ __forceinline__ int at(int n) const { return n; }
  __device__ __forceinline__ int at_half(int n) const { return N + 2 * n; }
  __device__ __forceinline__ int at_end(int n) const { return N + 2 * n + 1; }

  // The state gathered whole into every lane, from the lanes' slots; with `cot`, the cotangents of the four expert
  // states into ce too. A __syncwarp() on each side: the scratch is written by the lanes and read by all of them, and
  // no lane writes it for the next evaluation while another still reads it.
  __device__ __forceinline__ void gather(const float (&y)[kS], const float* cot, float (&yf)[kDim],
                                         float (&ce)[4]) const {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int d = lane + s * kLanes;
      if (d < kDim) {
        buf[d] = y[s];
        if (cot != nullptr && d < 4) buf[kDim + d] = cot[s];
      }
    }
    __syncwarp();
#pragma unroll
    for (int d = 0; d < kDim; ++d) yf[d] = buf[d];
    if (cot != nullptr) {
#pragma unroll
      for (int d = 0; d < 4; ++d) ce[d] = buf[kDim + d];
    }
    __syncwarp();
  }

  // f = roche_real_field(t, y), each lane its own slots; `e` the depot table's entry of t.
  __device__ void field(int e, const float (&y)[kS], float (&f)[kS]) const {
    constexpr int H = kHidden, ML = L::ML;
    float yf[kDim], unused[4];
    gather(y, nullptr, yf, unused);
    float acc[2] = {0.0f, 0.0f};  // dx1_net's output, dx2_net's
#pragma unroll
    for (int u = 0; u < L::SH; ++u) {
      const int j = lane + u * kLanes;
      if (j < H) {
        const float h1 = tanhf(fmaf(yf[2], w[L::W11 + 2 * H + j], fmaf(yf[1], w[L::W11 + H + j], yf[0] * w[L::W11 + j]))
                               + w[L::B11 + j]);
        acc[0] = fmaf(h1, w[L::W12 + j], acc[0]);
        const float h2 = tanhf(fmaf(yf[1], w[L::W21 + H + j], yf[0] * w[L::W21 + j]) + w[L::B21 + j]);
        acc[1] = fmaf(h2, w[L::W22 + j], acc[1]);
      }
    }
    lane_sum(acc);
    const float fe[4] = {tanhf(acc[0] + w[L::B12]), tanhf(acc[1] + w[L::B22]), yf[1] * w[L::KIM],
                         __fsub_rn(__fmul_rn(w[L::KEL], dose[e]), __fmul_rn(w[L::KEL2], yf[3]))};
    if constexpr (ML > 0) {
      float* rh = buf + kDim + 4;
      float z[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const int d = lane + s * kLanes;
        if (d >= 4 && d < kDim) {
          const int m = d - 4;
          float pr = 0.0f, pz = 0.0f;
#pragma unroll
          for (int k = 0; k < ML; ++k) {
            pr = fmaf(yf[4 + k], w[L::WHR + k * ML + m], pr);
            pz = fmaf(yf[4 + k], w[L::WHZ + k * ML + m], pz);
          }
          z[s] = sigmoid(pz);
          rh[m] = sigmoid(pr) * y[s];
        }
      }
      __syncwarp();
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const int d = lane + s * kLanes;
        if (d >= 4 && d < kDim) {
          const int m = d - 4;
          float pu = 0.0f;
#pragma unroll
          for (int k = 0; k < ML; ++k) pu = fmaf(rh[k], w[L::WHH + k * ML + m], pu);
          f[s] = (1.0f - z[s]) * (tanhf(pu) - y[s]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int d = lane + s * kLanes;
      if (d < 4) f[s] = pick(fe, d);
    }
  }

  // The lane's partial gradients of the weights: g_h[i][u] for hidden unit lane + u kLanes (i: dx1_net's three
  // first-layer weights, bias, output weight, then dx2_net's two, bias, output weight), g_gru[i][k][s] for the
  // GRU's column d - 4 of state slot s (i: lin_hr, lin_hz, lin_hh; k its row), g_s the five scalars (dx1_net's and
  // dx2_net's output biases, k_immunity, kel, kel2; lane 0 writes them).
  struct Grads {
    float h[9][L::SH];
    float gru[3][L::MW][kS];
    float s[5];
  };

  // ax = c J(y) of the field at (t, y), `e` the depot table's entry of t; c's products with its derivatives in the
  // weights added to g.
  __device__ void field_vjp(int e, const float (&y)[kS], const float (&c)[kS], float (&ax)[kS], Grads& g) const {
    constexpr int H = kHidden, ML = L::ML;
    float yf[kDim], ce[4];
    gather(y, c, yf, ce);

    float h1[L::SH], h2[L::SH];
    float acc[2] = {0.0f, 0.0f};  // dx1_net's output, dx2_net's
#pragma unroll
    for (int u = 0; u < L::SH; ++u) {
      const int j = lane + u * kLanes;
      h1[u] = h2[u] = 0.0f;
      if (j < H) {
        h1[u] = tanhf(fmaf(yf[2], w[L::W11 + 2 * H + j], fmaf(yf[1], w[L::W11 + H + j], yf[0] * w[L::W11 + j]))
                      + w[L::B11 + j]);
        acc[0] = fmaf(h1[u], w[L::W12 + j], acc[0]);
        h2[u] = tanhf(fmaf(yf[1], w[L::W21 + H + j], yf[0] * w[L::W21 + j]) + w[L::B21 + j]);
        acc[1] = fmaf(h2[u], w[L::W22 + j], acc[1]);
      }
    }
    lane_sum(acc);
    const float f0 = tanhf(acc[0] + w[L::B12]), f1 = tanhf(acc[1] + w[L::B22]);
    const float go1 = ce[0] * (1.0f - f0 * f0), go2 = ce[1] * (1.0f - f1 * f1);

    float px[3] = {0.0f, 0.0f, 0.0f};  // the MLPs' parts of the cotangents of y0, y1, y2
#pragma unroll
    for (int u = 0; u < L::SH; ++u) {
      const int j = lane + u * kLanes;
      if (j < H) {
        const float gp1 = go1 * w[L::W12 + j] * (1.0f - h1[u] * h1[u]);
        g.h[0][u] = fmaf(yf[0], gp1, g.h[0][u]);
        g.h[1][u] = fmaf(yf[1], gp1, g.h[1][u]);
        g.h[2][u] = fmaf(yf[2], gp1, g.h[2][u]);
        g.h[3][u] += gp1;
        g.h[4][u] = fmaf(go1, h1[u], g.h[4][u]);
        px[0] = fmaf(w[L::W11 + j], gp1, px[0]);
        px[1] = fmaf(w[L::W11 + H + j], gp1, px[1]);
        px[2] = fmaf(w[L::W11 + 2 * H + j], gp1, px[2]);
        const float gp2 = go2 * w[L::W22 + j] * (1.0f - h2[u] * h2[u]);
        g.h[5][u] = fmaf(yf[0], gp2, g.h[5][u]);
        g.h[6][u] = fmaf(yf[1], gp2, g.h[6][u]);
        g.h[7][u] += gp2;
        g.h[8][u] = fmaf(go2, h2[u], g.h[8][u]);
        px[0] = fmaf(w[L::W21 + j], gp2, px[0]);
        px[1] = fmaf(w[L::W21 + H + j], gp2, px[1]);
      }
    }
    lane_sum(px);
    const float kel = w[L::KEL];
    g.s[0] += go1;
    g.s[1] += go2;
    g.s[2] = fmaf(ce[2], yf[1], g.s[2]);
    g.s[3] = fmaf(ce[3], fmaf(kel, dose[depot_entries(N) + e], dose[e]), g.s[3]);
    g.s[4] = fmaf(-ce[3], yf[3], g.s[4]);
    const float ae[4] = {px[0], fmaf(ce[2], w[L::KIM], px[1]), px[2], -ce[3] * w[L::KEL2]};
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int d = lane + s * kLanes;
      if (d < 4) ax[s] = pick(ae, d);
    }

    if constexpr (ML > 0) {
      float* rh = buf + kDim + 4;
      float* gpu = rh + ML;
      float* gprz = gpu + ML;  // the cotangents of r's then z's pre-activations
      float r[kS], z[kS], gz[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const int d = lane + s * kLanes;
        if (d >= 4 && d < kDim) {
          const int m = d - 4;
          float pr = 0.0f, pz = 0.0f;
#pragma unroll
          for (int k = 0; k < ML; ++k) {
            pr = fmaf(yf[4 + k], w[L::WHR + k * ML + m], pr);
            pz = fmaf(yf[4 + k], w[L::WHZ + k * ML + m], pz);
          }
          r[s] = sigmoid(pr);
          z[s] = sigmoid(pz);
          rh[m] = r[s] * y[s];
        }
      }
      __syncwarp();
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const int d = lane + s * kLanes;
        if (d >= 4 && d < kDim) {
          const int m = d - 4;
          float pu = 0.0f;
#pragma unroll
          for (int k = 0; k < ML; ++k) pu = fmaf(rh[k], w[L::WHH + k * ML + m], pu);
          const float u = tanhf(pu);
          const float g_pu = c[s] * (1.0f - z[s]) * (1.0f - u * u);
          gpu[m] = g_pu;
#pragma unroll
          for (int k = 0; k < ML; ++k) g.gru[2][k][s] = fmaf(rh[k], g_pu, g.gru[2][k][s]);
          ax[s] = -c[s] * (1.0f - z[s]);
          gz[s] = -c[s] * (u - y[s]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const int d = lane + s * kLanes;
        if (d >= 4 && d < kDim) {
          const int m = d - 4;
          float grh = 0.0f;  // the cotangent of (r * h)[m]: row m of lin_hh against gpu
#pragma unroll
          for (int k = 0; k < ML; ++k) grh = fmaf(w[L::WHH_T + k * ML + m], gpu[k], grh);
          ax[s] = fmaf(grh, r[s], ax[s]);
          const float g_pr = grh * y[s] * r[s] * (1.0f - r[s]);
          const float g_pz = gz[s] * z[s] * (1.0f - z[s]);
          gprz[m] = g_pr;
          gprz[ML + m] = g_pz;
#pragma unroll
          for (int k = 0; k < ML; ++k) {
            g.gru[0][k][s] = fmaf(yf[4 + k], g_pr, g.gru[0][k][s]);
            g.gru[1][k][s] = fmaf(yf[4 + k], g_pz, g.gru[1][k][s]);
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const int d = lane + s * kLanes;
        if (d >= 4 && d < kDim) {
          const int m = d - 4;
          float a = ax[s];
#pragma unroll
          for (int k = 0; k < ML; ++k) {
            a = fmaf(w[L::WHR_T + k * ML + m], gprz[k], a);
            a = fmaf(w[L::WHZ_T + k * ML + m], gprz[ML + k], a);
          }
          ax[s] = a;
        }
      }
    }
  }
};

// dst = y + dt (k * a), rounded as `_rk_step` rounds a stage state.
__device__ __forceinline__ void stage_state(const float (&y)[kS], const float (&k)[kS], float a, float dt,
                                            float (&dst)[kS]) {
#pragma unroll
  for (int s = 0; s < kS; ++s) dst[s] = __fadd_rn(y[s], __fmul_rn(dt, __fmul_rn(k[s], a)));
}

// Stage the weights (and the GRU's transposes), the grid and the block's row's actions in shared memory, and fill the
// row's depot table -> the row's view.
__device__ Row stage(float* smem, const float* __restrict__ weights, const float* __restrict__ ts,
                     const float* __restrict__ actions, int B, int Ta, int A, int T, int n_sub) {
  constexpr int ML = L::ML;
  const int row = blockIdx.x;
  float* w = smem;
  float* s_ts = w + L::SHARED;
  float* s_act = s_ts + T;
  float* s_buf = s_act + Ta * A;
  float* s_dose = s_buf + L::SCRATCH;
  for (int i = threadIdx.x; i < L::P; i += kLanes) w[i] = weights[i];
  for (int i = threadIdx.x; i < ML * ML; i += kLanes) {
    const int k = i / ML, m = i % ML;
    w[L::WHR_T + m * ML + k] = weights[L::WHR + i];
    w[L::WHZ_T + m * ML + k] = weights[L::WHZ + i];
    w[L::WHH_T + m * ML + k] = weights[L::WHH + i];
  }
  for (int i = threadIdx.x; i < T; i += kLanes) s_ts[i] = ts[i];
  for (int i = threadIdx.x; i < Ta * A; i += kLanes) {
    s_act[i] = actions[(static_cast<size_t>(i / A) * B + row) * A + i % A];
  }
  __syncwarp();
  const Row r{w, s_act, s_buf, s_dose, Ta, A, (T - 1) * n_sub, static_cast<int>(threadIdx.x)};
  r.depot_table(s_ts, n_sub);
  return r;
}

__global__ void __launch_bounds__(kLanes)
roche_real_ab4_kernel(const float* __restrict__ y0, const float* __restrict__ actions,
                      const float* __restrict__ weights, const float* __restrict__ ts, float* __restrict__ out,
                      float* __restrict__ record, long long* __restrict__ rows, int B, int Ta, int A, int T,
                      int n_sub) {
  extern __shared__ float smem[];
  const int row = blockIdx.x;
  const Row r = stage(smem, weights, ts, actions, B, Ta, A, T, n_sub);
  if (rows != nullptr && threadIdx.x == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(rows), 1ull);
    atomicAdd(reinterpret_cast<unsigned long long*>(rows + 1), 1ull);
  }
  const float* s_ts = smem + L::SHARED;
  const int N = (T - 1) * n_sub;
  const size_t stride = static_cast<size_t>(B) * kDim;  // between two grid points of out

  float y[kS], h1[kS], h2[kS], h3[kS];  // the state, then f_{n-1}, f_{n-2}, f_{n-3}
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int d = r.lane + s * kLanes;
    y[s] = d < kDim ? y0[static_cast<size_t>(row) * kDim + d] : 0.0f;
    h1[s] = h2[s] = h3[s] = 0.0f;
    if (d < kDim) out[static_cast<size_t>(row) * kDim + d] = y[s];
  }
  int n = 0;
  for (int i = 0; i + 1 < T; ++i) {
    const float t_lo = s_ts[i];
    const float dt = __fdiv_rn(__fsub_rn(s_ts[i + 1], t_lo), static_cast<float>(n_sub));
    for (int sub = 0; sub < n_sub; ++sub, ++n) {
      if (record != nullptr) {
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          const int d = r.lane + s * kLanes;
          if (d < kDim) record[(static_cast<size_t>(row) * N + n) * kDim + d] = y[s];
        }
      }
      float f[kS];
      r.field(r.at(n), y, f);
      if (n >= 3) {
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          float acc = kAB4[0] * f[s];
          acc = fmaf(kAB4[1], h1[s], acc);
          acc = fmaf(kAB4[2], h2[s], acc);
          acc = fmaf(kAB4[3], h3[s], acc);
          y[s] = __fadd_rn(y[s], __fmul_rn(dt, acc));
        }
      } else {
        float ys[kS], k2[kS], k3[kS], k4[kS];
        stage_state(y, f, 0.5f, dt, ys);
        r.field(r.at_half(n), ys, k2);
        stage_state(y, k2, 0.5f, dt, ys);
        r.field(r.at_half(n), ys, k3);
        stage_state(y, k3, 1.0f, dt, ys);
        r.field(r.at_end(n), ys, k4);
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          float acc = __fmul_rn(f[s], kRK4B[0]);
          acc = __fadd_rn(acc, __fmul_rn(k2[s], kRK4B[1]));
          acc = __fadd_rn(acc, __fmul_rn(k3[s], kRK4B[2]));
          acc = __fadd_rn(acc, __fmul_rn(k4[s], kRK4B[3]));
          y[s] = __fadd_rn(y[s], __fmul_rn(dt, acc));
        }
      }
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        h3[s] = h2[s];
        h2[s] = h1[s];
        h1[s] = f[s];
      }
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int d = r.lane + s * kLanes;
      if (d < kDim) out[(i + 1) * stride + static_cast<size_t>(row) * kDim + d] = y[s];
    }
  }
}

__global__ void __launch_bounds__(kLanes)
roche_real_ab4_backward_kernel(const float* __restrict__ actions, const float* __restrict__ weights,
                               const float* __restrict__ ts, const float* __restrict__ record,
                               const float* __restrict__ g_out, float* __restrict__ dy0, float* __restrict__ dparams,
                               int B, int Ta, int A, int T, int n_sub) {
  constexpr int H = kHidden, ML = L::ML;
  extern __shared__ float smem[];
  const int row = blockIdx.x;
  const Row r = stage(smem, weights, ts, actions, B, Ta, A, T, n_sub);
  const float* s_ts = smem + L::SHARED;
  const int N = (T - 1) * n_sub;
  const size_t stride = static_cast<size_t>(B) * kDim;
  const float* rec = record + static_cast<size_t>(row) * N * kDim;

  Row::Grads g;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
#pragma unroll
    for (int u = 0; u < L::SH; ++u) g.h[i][u] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < L::MW; ++k) {
#pragma unroll
      for (int s = 0; s < kS; ++s) g.gru[i][k][s] = 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) g.s[i] = 0.0f;

  // a: the cotangent of the state after the substep being walked; p0 ... p3: those of f_n ... f_{n-3}.
  float a[kS], p0[kS], p1[kS], p2[kS], p3[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) a[s] = p0[s] = p1[s] = p2[s] = p3[s] = 0.0f;

  for (int i = T - 2; i >= 0; --i) {
    const float t_lo = s_ts[i];
    const float dt = __fdiv_rn(__fsub_rn(s_ts[i + 1], t_lo), static_cast<float>(n_sub));
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int d = r.lane + s * kLanes;
      if (d < kDim) a[s] += g_out[(i + 1) * stride + static_cast<size_t>(row) * kDim + d];
    }
    for (int sub = n_sub - 1; sub >= 0; --sub) {
      const int n = i * n_sub + sub;
      float y[kS], ax[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const int d = r.lane + s * kLanes;
        y[s] = d < kDim ? rec[static_cast<size_t>(n) * kDim + d] : 0.0f;
        ax[s] = 0.0f;
      }
      if (n >= 3) {  // y_{n+1} = y_n + dt sum_q AB4[q] f_{n-q}
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          p0[s] = fmaf(dt * kAB4[0], a[s], p0[s]);
          p1[s] = fmaf(dt * kAB4[1], a[s], p1[s]);
          p2[s] = fmaf(dt * kAB4[2], a[s], p2[s]);
          p3[s] = fmaf(dt * kAB4[3], a[s], p3[s]);
        }
        r.field_vjp(r.at(n), y, p0, ax, g);
#pragma unroll
        for (int s = 0; s < kS; ++s) a[s] += ax[s];
      } else {  // RK4 from y_n, its first stage f_n (whose AB4 cotangent is p0), recomputed
        float k[kS], y2[kS], y3[kS], y4[kS], an[kS], gk[kS];
        r.field(r.at(n), y, k);
        stage_state(y, k, 0.5f, dt, y2);
        r.field(r.at_half(n), y2, k);
        stage_state(y, k, 0.5f, dt, y3);
        r.field(r.at_half(n), y3, k);
        stage_state(y, k, 1.0f, dt, y4);
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          an[s] = a[s];
          gk[s] = dt * kRK4B[3] * an[s];
        }
        r.field_vjp(r.at_end(n), y4, gk, ax, g);
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          a[s] += ax[s];
          gk[s] = fmaf(dt * kRK4B[2], an[s], dt * ax[s]);
        }
        r.field_vjp(r.at_half(n), y3, gk, ax, g);
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          a[s] += ax[s];
          gk[s] = fmaf(dt * kRK4B[1], an[s], dt * 0.5f * ax[s]);
        }
        r.field_vjp(r.at_half(n), y2, gk, ax, g);
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          a[s] += ax[s];
          gk[s] = fmaf(dt * kRK4B[0], an[s], fmaf(dt * 0.5f, ax[s], p0[s]));
        }
        r.field_vjp(r.at(n), y, gk, ax, g);
#pragma unroll
        for (int s = 0; s < kS; ++s) a[s] += ax[s];
      }
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        p0[s] = p1[s];
        p1[s] = p2[s];
        p2[s] = p3[s];
        p3[s] = 0.0f;
      }
    }
  }

  // out[0] is y0 itself.
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int d = r.lane + s * kLanes;
    if (d < kDim) dy0[static_cast<size_t>(row) * kDim + d] = a[s] + g_out[static_cast<size_t>(row) * kDim + d];
  }
  float* gp = dparams + static_cast<size_t>(row) * L::P;
#pragma unroll
  for (int u = 0; u < L::SH; ++u) {
    const int j = r.lane + u * kLanes;
    if (j < H) {
      gp[L::W11 + j] = g.h[0][u];
      gp[L::W11 + H + j] = g.h[1][u];
      gp[L::W11 + 2 * H + j] = g.h[2][u];
      gp[L::B11 + j] = g.h[3][u];
      gp[L::W12 + j] = g.h[4][u];
      gp[L::W21 + j] = g.h[5][u];
      gp[L::W21 + H + j] = g.h[6][u];
      gp[L::B21 + j] = g.h[7][u];
      gp[L::W22 + j] = g.h[8][u];
    }
  }
  if (r.lane == 0) {
    gp[L::B12] = g.s[0];
    gp[L::B22] = g.s[1];
    gp[L::KIM] = g.s[2];
    gp[L::KEL] = g.s[3];
    gp[L::KEL2] = g.s[4];
  }
  if constexpr (ML > 0) {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int d = r.lane + s * kLanes;
      if (d >= 4 && d < kDim) {
        const int m = d - 4;
#pragma unroll
        for (int k = 0; k < ML; ++k) {
          gp[L::WHR + k * ML + m] = g.gru[0][k][s];
          gp[L::WHZ + k * ML + m] = g.gru[1][k][s];
          gp[L::WHH + k * ML + m] = g.gru[2][k][s];
        }
      }
    }
  }
}

constexpr size_t kMaxShared = 48 * 1024;  // without opt-in

size_t host_shared_bytes(int Ta, int A, int T, int n_sub) {
  return sizeof(float) * (L::SHARED + T + static_cast<size_t>(Ta) * A + L::SCRATCH
                          + 2 * static_cast<size_t>(depot_entries((T - 1) * n_sub)));
}

bool bad_args(int B, int D, int H, int Ta, int A, int T, int n_sub) {
  return D != kDim || H != kHidden || B < 1 || Ta < 1 || A < 1 || T < 2 || n_sub < 1 ||
         host_shared_bytes(Ta, A, T, n_sub) > kMaxShared;
}

}  // namespace

// Plain C entry points, bound with ctypes; each returns a cudaError_t (0 on success), cudaErrorInvalidValue for a
// (D, H) other than the library's or a grid and action sequence that do not fit in shared memory.
//
// The solve. Device pointers to contiguous float32 arrays: y0 (B, D), actions (Ta, B, A), weights (the packed
// leaves, Layout::P), ts (T,); out (T, B, D) written; record (B, (T - 1) n_sub, D) or null: with it, the state at the
// start of each substep is written; rows (2,) int64 or null, to which both entries the rows solved are added.
extern "C" int roche_real_ab4_launch(const float* y0, const float* actions, const float* weights, const float* ts,
                                     float* out, float* record, long long* rows, int B, int D, int H, int Ta, int A,
                                     int T, int n_sub, void* stream) {
  if (bad_args(B, D, H, Ta, A, T, n_sub)) return cudaErrorInvalidValue;
  roche_real_ab4_kernel<<<B, kLanes, host_shared_bytes(Ta, A, T, n_sub),
                          static_cast<cudaStream_t>(stream)>>>(y0, actions, weights, ts, out, record, rows, B, Ta, A,
                                                               T, n_sub);
  return cudaGetLastError();
}

// The backward of a recorded solve: actions, weights, ts as the solve's; record as it wrote it; g_out (T, B, D), the
// gradient of its output. Writes dy0 (B, D) and dparams (B, Layout::P), each row's gradient of the packed weights,
// which the caller sums over the rows.
extern "C" int roche_real_ab4_backward_launch(const float* actions, const float* weights, const float* ts,
                                              const float* record, const float* g_out, float* dy0, float* dparams,
                                              int B, int D, int H, int Ta, int A, int T, int n_sub, void* stream) {
  if (bad_args(B, D, H, Ta, A, T, n_sub)) return cudaErrorInvalidValue;
  roche_real_ab4_backward_kernel<<<B, kLanes, host_shared_bytes(Ta, A, T, n_sub),
                                   static_cast<cudaStream_t>(stream)>>>(actions, weights, ts, record, g_out, dy0,
                                                                        dparams, B, Ta, A, T, n_sub);
  return cudaGetLastError();
}

// Registers and local memory (spills) a thread of the forward (kind 0) or the backward (kind 1) kernel.
extern "C" int roche_real_ab4_kernel_info(int kind, int D, int H, int* registers, int* local_bytes) {
  if (D != kDim || H != kHidden || kind < 0 || kind > 1) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = kind == 0 ? cudaFuncGetAttributes(&attr, roche_real_ab4_kernel)
                                    : cudaFuncGetAttributes(&attr, roche_real_ab4_backward_kernel);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return err;
}
