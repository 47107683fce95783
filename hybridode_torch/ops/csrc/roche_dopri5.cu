// Per-row adaptive DOPRI5 of the hybrid Roche field, one thread per row: the solve, the same solve recording
// its accepted steps, and the backward of a recorded solve.
//
// Replaces no TPU kernel: the JAX package solves this with a `lax.scan` of
// masked trial steps under `jax.vmap` (hybridode/solvers/dopri5.py), and so
// does the port's plain path, `odeint_dopri5(roche_field, per_row=True)`
// (hybridode_torch/solvers/dopri5.py). Eager, that path launches some 480
// tiny kernels a trial step and reads the host once every 64 trial steps; at
// evaluate's shape (2,550 rows, D = 6, a 15-point grid) the host's dispatch
// of ~92,000 launches a decode was the whole request. Here one launch runs
// every row's whole solve, and a row stops when it finishes.
//
// It computes what `odeint_dopri5(..., per_row=True)` computes, in the order
// of solvers/dopri5.py: Hairer's initial step (`_initial_step`), the FSAL
// trial step with the tableau rounded to float32 as `_Tableau.make` rounds it
// (`_dopri5_step`), the error norm with its noise floor (`_error_norm`), the
// controller (`_next_h`, a rejected step never grows), the last step clipped
// at t_final, the dense output (`_dense_coeffs`, `_dense_eval`) filled into
// every grid point an accepted step crosses, NaN at grid points never
// reached, and a budget of `budget` trial steps a row (the eager loop's
// ceil(max_steps / 64) * 64). The solver's arithmetic rounds as PyTorch's
// CUDA operations round it: the stage sums, the error norm, the controller
// and the dense output unfused (`__fmul_rn`, `__fadd_rn`), the tableau
// products (`torch.tensordot`, a matrix product there) as FMA chains, the
// norm's mean in the reduction's order (`rms`). Where the field's values are
// exact (a field that scales by 0 and 1), the kernel's steps and outputs
// are the plain solver's bit for bit. The field itself is roche_field.cuh's,
// shared with roche_rk4.cu: its FMAs round otherwise than PyTorch's unfused
// operations, and its Hill power of 2 is x * x where PyTorch's powf is not,
// so on the real field the rows take other steps: at rtol 1e-7 in float32
// the error estimate is rounding noise, and one ulp moves an accept/reject
// decision. Each solve is then within its own accuracy; against a float64
// solve the kernel's error is the plain solver's or less (PERF.md §6).
//
// What bounds it on an H100: neither bytes nor FLOPs, but one thread's serial
// chain of field evaluations, six a trial step, for the row with the most
// trial steps. At 2,550 rows the launch is 80 warps, at most one per warp
// scheduler, so the kernel takes about as long as its slowest row whatever
// the rows' order.
//
// Design, each point measured on the card (PERF.md §6; chip_smoke.py's
// phase 3b times the kernel):
// - One thread a row; y, the seven stages, the step's sums, W and b in
//   registers (D is a template parameter): 89-168 registers for D = 4 ... 8,
//   208, 234 and 255 for D = 9, 10 and 11, no spills. At D = 12 the 255
//   registers a thread may hold are short: 80 bytes a thread spill to local
//   memory, which stays in L1 at one warp an SM. Two ways to spill nothing
//   were measured against it at 2,550 rows, D = 12 (one call, H100 at
//   700 W): this design 0.872 ms; W and b re-read from shared memory at each
//   evaluation (192 registers) 0.998 ms; the seven stages in shared memory
//   (7 D + 1 words a thread) 0.903 ms with W in registers, which still
//   spills, and 1.185 ms with W in shared memory too (247 registers). Each
//   shared-memory read sits on the row's serial chain, where a spilled
//   register is reloaded off it, so the spilling design is kept. From D = 9
//   to 12 the time grows with the field's work: 0.626, 0.702, 0.809 and
//   0.878 ms (D = 6: 0.353 ms).
// - Blocks of 32 threads, so that the warps spread over the SMs. Blocks of
//   64 and 128 took the same time at 2,550 rows (0.279-0.285 ms).
// - Rows in the caller's order. Evaluate's rows come point first, then the
//   draws MC-major, so a warp holds 32 patients and runs as long as the
//   slowest; but at 80 warps, at most one a scheduler, the launch runs as
//   long as its slowest row whatever the order. A patient-major order (a
//   warp holding one patient's draws) measured within 1.2 % of it, either
//   way in two calls, and the decoder could not know the patients' period.
// - The 13 constants, W, b and the grid are staged in shared memory; the
//   test HillCure == HillPatho == 2 is made there, on the device.
// - Each thread writes its own outputs, NaN included, so the wrapper
//   allocates with torch.empty and the decode is this one launch. With a
//   tally (`dopri5.full_budget(tally)`), each warp adds the sum of its rows'
//   trial steps to both counters with one atomic each; with `counts` (an
//   eager launch's), its rows' trial and accepted steps. The kernel allocates
//   nothing and never synchronises, so a CUDA graph can capture it.
//
// With gradients (the training step's decode; ops/roche_dopri5.py's
// `roche_dopri5_per_row_grad`, one torch.autograd.Function):
// - Forward: roche_dopri5_record_kernel, the solve above instantiated with
//   kRecord, which also writes each accepted step's (t, h, y at its start)
//   to the row's record of `budget` x (D + 2) floats. Its outputs are the
//   solve's bit for bit; it is a kernel of its own, so that the solve's code
//   is what it was (128 registers at D = 6; 255 and 80 bytes spilled at
//   D = 12).
// - Backward: roche_dopri5_backward_kernel, one thread a row, walks the
//   row's recorded steps in reverse. Each step is recomputed from its start,
//   its first stage included, in the forward's arithmetic (what
//   `dopri5.replay_step` computes); the gradients of the dense output at the
//   grid points the step filled, of y_{n+1} = y + h sum_j B[j] k[j], and of
//   the seven stages through the field (the Hill power's derivative as
//   torch.pow(torch.abs(x), p) takes it, 0 at 0; tanh's) give the gradient
//   of y_n and the row's partial gradients of W and b, which the wrapper sums
//   over the rows in a fixed order: no float atomics, so two launches agree
//   bit for bit. Recomputing k0 = f(t_n, y_n) where the forward carried the
//   last step's FSAL stage changes nothing in exact arithmetic (A[6] = B, C[6]
//   = 1), only the rounding of the point the Jacobian is taken at.
// - The gradients are the plain solver's: discretize-then-optimize through
//   the accepted steps; step sizes, the error norm and the controller carry
//   none. One difference: the plain solver's backward also runs through each
//   rejected trial, whose stages, where they overflow, put 0 * inf = NaN into
//   its gradient through the select (solvers/dopri5.py); this backward replays
//   no rejected trial. The 13 constants get no gradient (frozen).
// - Registers of the backward: 232 at D = 6, no spill; from D = 8 the seven
//   stages, their gradients and the row's W gradient exceed 255 and spill
//   (128 bytes at D = 8, 1,272 at D = 12), as phase 3c of chip_smoke.py
//   reports. At B = 50 and D = 6 the forward takes 0.32 ms and the backward
//   0.22 ms on an H100 (PERF.md §6).

#include <cuda_runtime.h>

#include "roche_field.cuh"

// The file is compiled once a state width, with -DROCHE_DOPRI5_DIM=D (ops/build.py): each library holds one
// width's kernels, so that a process compiles only the widths it launches, and its entry points refuse any other D.
#ifndef ROCHE_DOPRI5_DIM
#error "compile with -DROCHE_DOPRI5_DIM=<D>, 4 <= D <= 12 (ops/build.py)"
#endif

namespace {

using namespace roche;

constexpr int kThreads = 32;
constexpr int kDim = ROCHE_DOPRI5_DIM;
static_assert(kDim >= 4 && kDim <= 12, "the kernels take 4 <= D <= 12");

// Floats a recorded accepted step takes: t, h, then the state y at its start.
template <int D>
constexpr int kRecordWidth = D + 2;

// Rows of the remainder's W (as Field stores it) and of b; 1 where there is no remainder.
template <int D>
constexpr int kRemainderRows = D > 4 ? D - 4 : 1;

// The DOPRI5 tableau (solvers/tableaus.py), each coefficient the float64 quotient rounded to float32.
__constant__ float kC[7] = {0.0f, float(1.0 / 5.0), float(3.0 / 10.0), float(4.0 / 5.0), float(8.0 / 9.0), 1.0f,
                           1.0f};
__constant__ float kA[7][6] = {
    {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},
    {float(1.0 / 5.0), 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},
    {float(3.0 / 40.0), float(9.0 / 40.0), 0.0f, 0.0f, 0.0f, 0.0f},
    {float(44.0 / 45.0), float(-56.0 / 15.0), float(32.0 / 9.0), 0.0f, 0.0f, 0.0f},
    {float(19372.0 / 6561.0), float(-25360.0 / 2187.0), float(64448.0 / 6561.0), float(-212.0 / 729.0), 0.0f, 0.0f},
    {float(9017.0 / 3168.0), float(-355.0 / 33.0), float(46732.0 / 5247.0), float(49.0 / 176.0),
     float(-5103.0 / 18656.0), 0.0f},
    {float(35.0 / 384.0), 0.0f, float(500.0 / 1113.0), float(125.0 / 192.0), float(-2187.0 / 6784.0),
     float(11.0 / 84.0)},
};
__constant__ float kB[7] = {float(35.0 / 384.0), 0.0f, float(500.0 / 1113.0), float(125.0 / 192.0),
                            float(-2187.0 / 6784.0), float(11.0 / 84.0), 0.0f};
__constant__ float kE[7] = {float(71.0 / 57600.0), 0.0f, float(-71.0 / 16695.0), float(71.0 / 1920.0),
                            float(-17253.0 / 339200.0), float(22.0 / 525.0), float(-1.0 / 40.0)};
__constant__ float kDense[7] = {float(-12715105075.0 / 11282082432.0), 0.0f, float(87487479700.0 / 32700410799.0),
                                float(-10690763975.0 / 1880347072.0), float(701980252875.0 / 199316789632.0),
                                float(-1453857185.0 / 822651844.0), float(69997945.0 / 29380423.0)};

// The controller's constants (solvers/dopri5.py), as float32.
constexpr float kSafety = 0.9f, kMinFactor = 0.2f, kMaxFactor = 10.0f, kErrorExponent = float(-1.0 / 5.0);

// The solve's tolerances, each rounded to float32 as PyTorch rounds a Python float against a float32 tensor.
struct Tolerances {
  float rtol, atol;
  float floor, rtol_floor;  // `_noise_floor`: 10 eps and rtol + 10 eps
  float inv_dim;            // CUDA's mean multiplies the sum by float(1 / D)
};

// PyTorch's maximum, minimum and clamp: NaN in, NaN out (fmaxf and fminf drop a NaN).
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || b != b) ? a + b : fmaxf(a, b); }
__device__ __forceinline__ float nan_min(float a, float b) { return (a != a || b != b) ? a + b : fminf(a, b); }
__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x != x ? x : fminf(x, hi); }

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// `_rms_norm` over the row: sqrt(mean(x ** 2)). The squares are summed in the order of PyTorch's CUDA mean over a
// row of 4 <= D <= 12 (found on the card by matching every order of the adds for D <= 8, and held bit for bit
// against PyTorch's for D = 9 ... 12): W lanes, W the largest power of two <= D, lane i adds x[i] ** 2 and
// x[i + W] ** 2, then the lanes fold at offsets W / 2, ..., 1; the sum times float(1 / D).
template <int D>
__device__ __forceinline__ float rms(const float (&x)[D], float inv_dim) {
  static_assert(D >= 4 && D <= 12, "the reduction order is that of 4 <= D <= 12");
  constexpr int W = D >= 8 ? 8 : 4;
  float lane[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    lane[i] = mul(x[i], x[i]);
    if (i + W < D) lane[i] = add(lane[i], mul(x[i + W], x[i + W]));
  }
#pragma unroll
  for (int off = W / 2; off >= 1; off /= 2) {
#pragma unroll
    for (int i = 0; i < off; ++i) lane[i] = add(lane[i], lane[i + off]);
  }
  return sqrtf(mul(lane[0], inv_dim));
}

// torch.tensordot(w, k, dims=1) at one element, sum_j w[j] * k[j][d], summed as cuBLAS sums it at the decoder's
// shapes (measured on the H100 at 50 and 2,550 rows of D = 4 ... 12; at 100,000 rows cuBLAS takes one chain): FMA
// chains over stages 0-3 and 4-6, then their sum.
template <int D>
__device__ __forceinline__ float tensordot(const float* w, const float (&k)[7][D], int d) {
  float lo = mul(w[0], k[0][d]), hi = mul(w[4], k[4][d]);
#pragma unroll
  for (int j = 1; j < 4; ++j) lo = fmaf(w[j], k[j][d], lo);
#pragma unroll
  for (int j = 5; j < 7; ++j) hi = fmaf(w[j], k[j][d], hi);
  return add(lo, hi);
}

template <int D, Hill kHill>
struct Row {
  const Field<D, kHill>& f;
  float kel, dose_time, dose_amount;

  // The field at time t.
  __device__ __forceinline__ void eval(float t, const float (&y)[D], float (&dy)[D]) const {
    f(kel_dose_at(t, kel, dose_time, dose_amount), y, dy);
  }
};

// `_initial_step`: Hairer's initial step size (HNW I.4, alg. 4.14), one more field evaluation.
template <int D, Hill kHill>
__device__ __forceinline__ float initial_step(const Row<D, kHill>& row, float t0, const float (&y0)[D],
                                              const float (&f0)[D], const Tolerances& tol) {
  float scale[D], q[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    scale[d] = add(tol.atol, mul(fabsf(y0[d]), tol.rtol));
    q[d] = y0[d] / scale[d];
  }
  const float d0 = rms<D>(q, tol.inv_dim);
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = f0[d] / scale[d];
  const float d1 = rms<D>(q, tol.inv_dim);
  const float h0 = nan_min(d0, d1) < 1e-5f ? 1e-6f : mul(0.01f, d0) / clamp_min(d1, 1e-30f);

  float y1[D], f1[D];
#pragma unroll
  for (int d = 0; d < D; ++d) y1[d] = add(y0[d], mul(h0, f0[d]));
  row.eval(add(t0, h0), y1, f1);
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = sub(f1[d], f0[d]) / scale[d];
  const float d2 = rms<D>(q, tol.inv_dim) / h0;

  const float dmax = nan_max(d1, d2);
  // 0.01 / x is x.reciprocal() * 0.01 in PyTorch (Tensor.__rtruediv__).
  const float h1 = dmax <= 1e-15f ? clamp_min(mul(h0, 1e-3f), 1e-6f)
                                  : powf(mul(1.0f / clamp_min(dmax, 1e-30f), 0.01f), 0.2f);
  return nan_min(mul(100.0f, h0), h1);
}

template <int D>
__device__ __forceinline__ void store(float* o, const float (&y)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = y[d];
}

template <int D>
__device__ __forceinline__ void store_nan(float* o) {
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = __int_as_float(0x7fc00000);
}

// One row's whole solve -> its trial steps, and its accepted steps in `accepted`; writes out[:, row], n_accepted and
// success. With kRecord, each accepted step also writes (t, h, y) at its start to the row's `record`, kRecordWidth<D>
// floats a step, in the order of the steps.
template <int D, Hill kHill, bool kRecord>
__device__ int solve(const Staged& s_c, const Tolerances& tol, const float* __restrict__ y0,
                     const float* __restrict__ times, const float* __restrict__ amounts, float* __restrict__ out,
                     int* __restrict__ n_accepted, bool* __restrict__ success, float* __restrict__ record, int row,
                     int B, int T, int budget, int& accepted) {
  const Field<D, kHill> f = load_field<D, kHill>(s_c);
  const Row<D, kHill> r{f, f.p[kKel], times[row], amounts[row]};
  const float* ts = s_c.ts;
  const float t_final = ts[T - 1];
  const size_t stride = static_cast<size_t>(B) * D;  // between two grid points of out
  float* o = out + static_cast<size_t>(row) * D;

  float y[D], k[7][D];
  bool finite = true;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    y[d] = y0[static_cast<size_t>(row) * D + d];
    finite &= isfinite(y[d]);
  }
  store<D>(o, y);
  float t = ts[0];
  r.eval(t, y, k[0]);
  float h = initial_step<D, kHill>(r, t, y, k[0], tol);

  int n_trial = 0, n_acc = 0, next = 1;  // `next`: the first grid point not yet filled
  bool finished = false;
#pragma unroll 1
  while (n_trial < budget && !finished) {
    const float span = sub(t_final, t);
    const bool last = h >= span;
    const float h_eff = last ? span : h;

    // `_dopri5_step`: stage i at t + C[i] * h from y + h * sum_j A[i][j] k[j], summed as PyTorch sums it.
    float yi[D];
#pragma unroll
    for (int i = 1; i < 7; ++i) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float acc = mul(k[0][d], kA[i][0]);
#pragma unroll
        for (int j = 1; j < i; ++j) acc = add(acc, mul(k[j][d], kA[i][j]));
        yi[d] = add(y[d], mul(h_eff, acc));
      }
      r.eval(add(t, mul(kC[i], h_eff)), yi, k[i]);
    }

    // `_error_norm` of the embedded estimate, with the noise floor.
    float y1[D], q[D];
    const float floor_h = mul(tol.floor, h_eff);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      y1[d] = add(y[d], mul(h_eff, tensordot<D>(kB, k, d)));
      const float err = mul(h_eff, tensordot<D>(kE, k, d));
      const float k_mag = nan_max(fabsf(k[0][d]), fabsf(k[6][d]));
      const float scale = add(add(tol.atol, mul(tol.rtol_floor, nan_max(fabsf(y[d]), fabsf(y1[d])))),
                              mul(floor_h, k_mag));
      q[d] = err / scale;
    }
    const float norm = rms<D>(q, tol.inv_dim);
    const bool accept = norm <= 1.0f && isfinite(norm);
    const float t_new = last ? t_final : add(t, h_eff);

    if (accept) {
      if constexpr (kRecord) {
        float* e = record + (static_cast<size_t>(row) * budget + n_acc) * kRecordWidth<D>;
        e[0] = t;
        e[1] = h_eff;
        store<D>(e + 2, y);
      }
      // The dense output at every grid point in (t, t_new]; a point at or before t stays NaN, as in the eager fill.
      while (next < T && ts[next] <= t_new) {
        float* o_pt = o + static_cast<size_t>(next) * stride;
        if (ts[next] > t) {
          const float theta = clamp_max(clamp_min(sub(ts[next], t) / clamp_min(h_eff, 1e-30f), 0.0f), 1.0f);
          const float th1 = sub(1.0f, theta);
          float v[D];
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float dy = sub(y1[d], y[d]);
            const float bspl = sub(mul(h_eff, k[0][d]), dy);
            const float r4 = sub(sub(dy, mul(h_eff, k[6][d])), bspl);
            const float r5 = mul(h_eff, tensordot<D>(kDense, k, d));
            v[d] = add(y[d], mul(theta, add(dy, mul(th1, add(bspl, mul(theta, add(r4, mul(th1, r5))))))));
            finite &= isfinite(v[d]);
          }
          store<D>(o_pt, v);
        } else {
          store_nan<D>(o_pt);
          finite = false;
        }
        ++next;
      }
    }

    // `_next_h`: a rejected step never grows.
    float factor = norm == 0.0f ? kMaxFactor
                                : clamp_max(clamp_min(mul(kSafety, powf(norm, kErrorExponent)), kMinFactor),
                                            kMaxFactor);
    if (!accept) factor = clamp_max(factor, 1.0f);
    ++n_trial;
    if (accept) {
      t = t_new;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        y[d] = y1[d];
        k[0][d] = k[6][d];
      }
      ++n_acc;
      finished = last;
    }
    h = mul(h_eff, factor);
  }

  finite &= next == T;
  for (; next < T; ++next) store_nan<D>(o + static_cast<size_t>(next) * stride);
  n_accepted[row] = n_acc;
  success[row] = finished && finite;
  accepted = n_acc;
  return n_trial;
}

// A warp's trial steps added to both counters of the tally, and its trial and accepted steps to `counts`: one
// atomic each.
__device__ __forceinline__ void add_counts(int trials, int accepted, long long* __restrict__ tally,
                                           long long* __restrict__ counts) {
  if (tally != nullptr || counts != nullptr) {
    using u64 = unsigned long long;
    const u64 warp_trials = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(trials));
    const u64 warp_accepted = counts != nullptr ? __reduce_add_sync(0xffffffffu, static_cast<unsigned>(accepted)) : 0;
    if ((threadIdx.x & 31) == 0 && warp_trials != 0) {
      if (tally != nullptr) {
        atomicAdd(reinterpret_cast<u64*>(tally), warp_trials);
        atomicAdd(reinterpret_cast<u64*>(tally + 1), warp_trials);
      }
      if (counts != nullptr) {
        atomicAdd(reinterpret_cast<u64*>(counts), warp_trials);
        atomicAdd(reinterpret_cast<u64*>(counts + 1), warp_accepted);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
roche_dopri5_kernel(const float* __restrict__ y0, const float* __restrict__ times,
                    const float* __restrict__ amounts, const float* __restrict__ params,
                    const float* __restrict__ ml_w, const float* __restrict__ ml_b, const float* __restrict__ ts,
                    Tolerances tol, float* __restrict__ out, int* __restrict__ n_trial,
                    int* __restrict__ n_accepted, bool* __restrict__ success, long long* __restrict__ tally,
                    long long* __restrict__ counts, int B, int T, int budget) {
  extern __shared__ float smem[];
  const Staged s_c = stage_shared<D>(smem, params, ml_w, ml_b, ts, T);

  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  int trials = 0, accepted = 0;
  if (row < B) {
    // One branch for the whole launch: the exponents come from shared memory.
    trials = square_hill(s_c) ? solve<D, Hill::kSquare, false>(s_c, tol, y0, times, amounts, out, n_accepted,
                                                               success, nullptr, row, B, T, budget, accepted)
                              : solve<D, Hill::kGeneral, false>(s_c, tol, y0, times, amounts, out, n_accepted,
                                                                success, nullptr, row, B, T, budget, accepted);
    n_trial[row] = trials;
  }
  add_counts(trials, accepted, tally, counts);
}

// The same solve, which also writes each row's accepted steps to `record` for roche_dopri5_backward_kernel. It is a
// kernel of its own, so that the one above compiles to the code it had before there was a record.
template <int D>
__global__ void __launch_bounds__(kThreads)
roche_dopri5_record_kernel(const float* __restrict__ y0, const float* __restrict__ times,
                           const float* __restrict__ amounts, const float* __restrict__ params,
                           const float* __restrict__ ml_w, const float* __restrict__ ml_b,
                           const float* __restrict__ ts, Tolerances tol, float* __restrict__ out,
                           int* __restrict__ n_trial, int* __restrict__ n_accepted, bool* __restrict__ success,
                           float* __restrict__ record, long long* __restrict__ tally, long long* __restrict__ counts,
                           int B, int T, int budget) {
  extern __shared__ float smem[];
  const Staged s_c = stage_shared<D>(smem, params, ml_w, ml_b, ts, T);

  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  int trials = 0, accepted = 0;
  if (row < B) {
    trials = square_hill(s_c) ? solve<D, Hill::kSquare, true>(s_c, tol, y0, times, amounts, out, n_accepted,
                                                              success, record, row, B, T, budget, accepted)
                              : solve<D, Hill::kGeneral, true>(s_c, tol, y0, times, amounts, out, n_accepted,
                                                               success, record, row, B, T, budget, accepted);
    n_trial[row] = trials;
  }
  add_counts(trials, accepted, tally, counts);
}

// ---- Backward ---------------------------------------------------------------------------------------------------

// d|x|**p / dx as PyTorch's autograd takes it through torch.pow(torch.abs(x), p): p |x|**(p - 1) sign(x), 0 at 0.
template <Hill kHill>
__device__ __forceinline__ float hill_dpow(float x, float exponent) {
  if constexpr (kHill == Hill::kSquare) {
    return 2.0f * x;
  } else {
    return x == 0.0f ? 0.0f : copysignf(exponent * powf(fabsf(x), exponent - 1.0f), x);
  }
}

// The vector-Jacobian product of the field at state x, whose value there is k, with the cotangent c: ax = c J(x),
// and c's products with the field's derivatives in W and b added to gw (gw[m][j] for W[j][m]) and gb. The 13
// constants are frozen (the route refuses a decode that trains them), so they get none.
template <int D, Hill kHill>
__device__ __forceinline__ void field_vjp(const Field<D, kHill>& f, const float (&x)[D], const float (&k)[D],
                                          const float (&c)[D], float (&ax)[D], float (&gw)[kRemainderRows<D>][D],
                                          float (&gb)[kRemainderRows<D>]) {
  constexpr int ML = D - 4;
  const float* p = f.p;
  const float disease = x[0], immune_react = x[1], immunity = x[2], dose2 = x[3];
  const float hc = f.hill_pow(immunity, p[kHillCure]);
  const float hp = f.hill_pow(immune_react, p[kHillPatho]);
  const float den = f.ec50_pow + hp;
  // d/d hp of hp emax / (ec50_pow + hp), as autograd's division takes it.
  const float d_mm = p[kEmaxPatho] / den - (hp * p[kEmaxPatho] / den) / den;

  ax[0] = c[0] * (p[kDisprog] - hc * p[kDiscureImmunity] - immune_react * p[kDiscureImmunereact])
          + c[1] * (p[kImmuneDisease] + immune_react * p[kImmuneFeedback]);
  ax[1] = -c[0] * disease * p[kDiscureImmunereact]
          + c[1] * (-p[kImmuneOff] + disease * p[kImmuneFeedback]
                    + d_mm * hill_dpow<kHill>(immune_react, p[kHillPatho]) - dose2 * p[kDexa])
          + c[2] * p[kImmunity];
  ax[2] = -c[0] * disease * p[kDiscureImmunity] * hill_dpow<kHill>(immunity, p[kHillCure]);
  ax[3] = -c[1] * immune_react * p[kDexa] - c[3] * p[kKel];
#pragma unroll
  for (int j = 4; j < D; ++j) ax[j] = 0.0f;

#pragma unroll
  for (int m = 0; m < ML; ++m) {
    const float s = c[4 + m] * (1.0f - k[4 + m] * k[4 + m]);  // through tanh
    gb[m] += s;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      gw[m][j] = fmaf(x[j], s, gw[m][j]);
      ax[j] = fmaf(f.w[m][j], s, ax[j]);
    }
  }
}

// Stage i's state y + h sum_j A[i][j] k[j], summed as the solve sums it (solve, `_dopri5_step`).
template <int D>
__device__ __forceinline__ void stage_state(int i, float h, const float (&y)[D], const float (&k)[7][D],
                                            float (&yi)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float acc = mul(k[0][d], kA[i][0]);
#pragma unroll
    for (int j = 1; j < 7; ++j) {
      if (j < i) acc = add(acc, mul(k[j][d], kA[i][j]));
    }
    yi[d] = add(y[d], mul(h, acc));
  }
}

// One row's gradients from its recorded accepted steps, walked in reverse: dy0[row] and the row's partial gradient
// of W (D x ML, as ml_w) then b in dparams[row]. `g_out` is (T, B, D), the gradient of the solve's output.
template <int D, Hill kHill>
__device__ void backward(const Staged& s_c, const float* __restrict__ times, const float* __restrict__ amounts,
                         const float* __restrict__ record, int n_acc, const float* __restrict__ g_out,
                         float* __restrict__ dy0, float* __restrict__ dparams, int row, int B, int T, int budget) {
  constexpr int ML = D - 4, MW = kRemainderRows<D>;
  const Field<D, kHill> f = load_field<D, kHill>(s_c);
  const Row<D, kHill> r{f, f.p[kKel], times[row], amounts[row]};
  const float* ts = s_c.ts;
  const float t_final = ts[T - 1];
  const size_t stride = static_cast<size_t>(B) * D;  // between two grid points of g_out
  const float* g_row = g_out + static_cast<size_t>(row) * D;
  const float* rec = record + static_cast<size_t>(row) * budget * kRecordWidth<D>;

  float a[D], gw[MW][D], gb[MW];  // a: the gradient of the state after the step being walked
#pragma unroll
  for (int d = 0; d < D; ++d) a[d] = 0.0f;
#pragma unroll
  for (int m = 0; m < MW; ++m) {
    gb[m] = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) gw[m][d] = 0.0f;
  }

  // Grid points from `next` on were never reached: the solve filled those up to its last accepted step's end,
  // which is t_final exactly when that step was clipped there (its h then equals t_final - t, as it does nowhere
  // else). The grid ascends, so a step filled the points in (its t, its end] that no later step filled.
  int next = 1;
  if (n_acc > 0) {
    const float* e = rec + static_cast<size_t>(n_acc - 1) * kRecordWidth<D>;
    const float t_end = e[1] == sub(t_final, e[0]) ? t_final : add(e[0], e[1]);
    while (next < T && ts[next] <= t_end) ++next;
  }

#pragma unroll 1
  for (int n = n_acc - 1; n >= 0; --n) {
    const float* e = rec + static_cast<size_t>(n) * kRecordWidth<D>;
    const float t = e[0], h = e[1];
    float y[D], k[7][D], yi[D];
#pragma unroll
    for (int d = 0; d < D; ++d) y[d] = e[2 + d];

    // The step recomputed from its start, its first stage included (`dopri5.replay_step`).
    r.eval(t, y, k[0]);
#pragma unroll
    for (int i = 1; i < 7; ++i) {
      stage_state<D>(i, h, y, k, yi);
      r.eval(add(t, mul(kC[i], h)), yi, k[i]);
    }

    // ak[j]: the gradient of stage j. y_{n+1} = y + h sum_j B[j] k[j] passes `a` to y and h B[j] a to stage j;
    // each grid point the step filled adds its dense output's gradient (`_dense_coeffs`, `_dense_eval`).
    float ak[7][D], a1[D], r5[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      a1[d] = a[d];  // a now gathers the gradient of y, which the loops below complete
      a[d] = 0.0f;
      r5[d] = 0.0f;
#pragma unroll
      for (int j = 0; j < 7; ++j) ak[j][d] = 0.0f;
    }
    while (next > 1 && ts[next - 1] > t) {
      --next;
      const float theta = clamp_max(clamp_min(sub(ts[next], t) / clamp_min(h, 1e-30f), 0.0f), 1.0f);
      const float th1 = sub(1.0f, theta);
      const float* g = g_row + static_cast<size_t>(next) * stride;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        // v = y + theta (dy + th1 (bspl + theta (r4 + th1 r5))), dy = y1 - y, bspl = h k0 - dy,
        // r4 = dy - h k6 - bspl, r5 = h sum_j Dense[j] k[j].
        const float gv = g[d], g2 = theta * gv, g3 = th1 * g2, g4 = theta * g3, g5 = th1 * g4;
        const float g_bspl = g3 - g4;
        const float g_dy = g2 + g4 - g_bspl;
        a[d] += gv - g_dy;
        a1[d] += g_dy;
        ak[0][d] += h * g_bspl;
        ak[6][d] -= h * g4;
        r5[d] += g5;
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      a[d] += a1[d];
#pragma unroll
      for (int j = 0; j < 7; ++j) ak[j][d] += h * (kB[j] * a1[d] + kDense[j] * r5[d]);
    }

    // The stages in reverse: stage i's gradient through the field to its state, then to y and the earlier stages.
    float ax[D];
#pragma unroll
    for (int i = 6; i >= 1; --i) {
      stage_state<D>(i, h, y, k, yi);
      field_vjp<D, kHill>(f, yi, k[i], ak[i], ax, gw, gb);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        a[d] += ax[d];
        const float hax = h * ax[d];
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          if (j < i) ak[j][d] += kA[i][j] * hax;
        }
      }
    }
    field_vjp<D, kHill>(f, y, k[0], ak[0], ax, gw, gb);
#pragma unroll
    for (int d = 0; d < D; ++d) a[d] += ax[d];
  }

  // out[0] is y0 itself.
#pragma unroll
  for (int d = 0; d < D; ++d) dy0[static_cast<size_t>(row) * D + d] = a[d] + g_row[d];
  if constexpr (ML > 0) {
    float* gp = dparams + static_cast<size_t>(row) * (D * ML + ML);
#pragma unroll
    for (int j = 0; j < D; ++j) {
#pragma unroll
      for (int m = 0; m < ML; ++m) gp[j * ML + m] = gw[m][j];
    }
#pragma unroll
    for (int m = 0; m < ML; ++m) gp[D * ML + m] = gb[m];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
roche_dopri5_backward_kernel(const float* __restrict__ times, const float* __restrict__ amounts,
                             const float* __restrict__ params, const float* __restrict__ ml_w,
                             const float* __restrict__ ml_b, const float* __restrict__ ts,
                             const float* __restrict__ record, const int* __restrict__ n_accepted,
                             const float* __restrict__ g_out, float* __restrict__ dy0, float* __restrict__ dparams,
                             int B, int T, int budget) {
  extern __shared__ float smem[];
  const Staged s_c = stage_shared<D>(smem, params, ml_w, ml_b, ts, T);
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  if (square_hill(s_c)) {
    backward<D, Hill::kSquare>(s_c, times, amounts, record, n_accepted[row], g_out, dy0, dparams, row, B, T, budget);
  } else {
    backward<D, Hill::kGeneral>(s_c, times, amounts, record, n_accepted[row], g_out, dy0, dparams, row, B, T,
                                budget);
  }
}

template <int D>
cudaError_t launch(const float* y0, const float* times, const float* amounts, const float* params,
                   const float* ml_w, const float* ml_b, const float* ts, Tolerances tol, float* out, int* n_trial,
                   int* n_accepted, bool* success, float* record, long long* tally, long long* counts, int B, int T,
                   int budget, cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  if (record == nullptr) {
    roche_dopri5_kernel<D><<<blocks, kThreads, shared_bytes<D>(T), stream>>>(
        y0, times, amounts, params, ml_w, ml_b, ts, tol, out, n_trial, n_accepted, success, tally, counts, B, T,
        budget);
  } else {
    roche_dopri5_record_kernel<D><<<blocks, kThreads, shared_bytes<D>(T), stream>>>(
        y0, times, amounts, params, ml_w, ml_b, ts, tol, out, n_trial, n_accepted, success, record, tally, counts,
        B, T, budget);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_backward(const float* times, const float* amounts, const float* params, const float* ml_w,
                            const float* ml_b, const float* ts, const float* record, const int* n_accepted,
                            const float* g_out, float* dy0, float* dparams, int B, int T, int budget,
                            cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  roche_dopri5_backward_kernel<D><<<blocks, kThreads, shared_bytes<D>(T), stream>>>(
      times, amounts, params, ml_w, ml_b, ts, record, n_accepted, g_out, dy0, dparams, B, T, budget);
  return cudaGetLastError();
}

// Which kernel `info` reads: the solve, the solve that records, the backward.
enum Kind { kSolve = 0, kRecordSolve = 1, kBackward = 2 };

template <int D>
cudaError_t info(int kind, int* registers, int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err;
  switch (kind) {
    case kSolve: err = cudaFuncGetAttributes(&attr, roche_dopri5_kernel<D>); break;
    case kRecordSolve: err = cudaFuncGetAttributes(&attr, roche_dopri5_record_kernel<D>); break;
    case kBackward: err = cudaFuncGetAttributes(&attr, roche_dopri5_backward_kernel<D>); break;
    default: return cudaErrorInvalidValue;
  }
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return err;
}

}  // namespace

// Plain C entry points, bound with ctypes; each returns a cudaError_t (0 on success), cudaErrorInvalidValue for a D
// other than the library's.
//
// The solve. All pointers are device pointers to contiguous arrays: y0 (B, D), times (B,), amounts (B,), params
// (13,), ml_w (D, D-4) and ml_b (D-4,) (null when D == 4), ts (T,) float32; out (T, B, D) float32, n_trial and
// n_accepted (B,) int32, success (B,) bool, all written; record (B, budget, D + 2) float32 or null: with it, the
// recording kernel runs and writes each row's accepted steps (t, h, y at the step's start) from the row's first;
// tally (2,) int64 or null, to which each row's trial steps are added twice (live, run); counts (2,) int64 or null,
// to which its trial and its accepted steps are added.
extern "C" int roche_dopri5_per_row_launch(const float* y0, const float* times, const float* amounts,
                                           const float* params, const float* ml_w, const float* ml_b,
                                           const float* ts, float rtol, float atol, float floor, float rtol_floor,
                                           float* out, int* n_trial, int* n_accepted, bool* success, float* record,
                                           long long* tally, long long* counts, int B, int D, int T, int budget,
                                           void* stream) {
  if (D != kDim) return cudaErrorInvalidValue;
  const Tolerances tol{rtol, atol, floor, rtol_floor, 1.0f / static_cast<float>(D)};
  return launch<kDim>(y0, times, amounts, params, ml_w, ml_b, ts, tol, out, n_trial, n_accepted, success, record,
                      tally, counts, B, T, budget, static_cast<cudaStream_t>(stream));
}

// The backward of a recorded solve. times, amounts, params, ml_w, ml_b, ts as the solve's; record (B, budget, D + 2)
// and n_accepted (B,) as the solve wrote them; g_out (T, B, D) float32, the gradient of its output. Writes dy0
// (B, D) and, when D > 4, dparams (B, D (D-4) + D-4): each row's gradient of ml_w (row-major) then of ml_b, which the
// caller sums over the rows.
extern "C" int roche_dopri5_backward_launch(const float* times, const float* amounts, const float* params,
                                            const float* ml_w, const float* ml_b, const float* ts,
                                            const float* record, const int* n_accepted, const float* g_out,
                                            float* dy0, float* dparams, int B, int D, int T, int budget,
                                            void* stream) {
  if (D != kDim) return cudaErrorInvalidValue;
  return launch_backward<kDim>(times, amounts, params, ml_w, ml_b, ts, record, n_accepted, g_out, dy0, dparams, B,
                               T, budget, static_cast<cudaStream_t>(stream));
}

// Registers a thread and local memory (spills) a thread of one kernel, as the loaded binary has them: `kind` 0 the
// solve, 1 the solve that records, 2 the backward (Kind).
extern "C" int roche_dopri5_kernel_info(int kind, int D, int* registers, int* local_bytes) {
  return D == kDim ? info<kDim>(kind, registers, local_bytes) : cudaErrorInvalidValue;
}
