// Per-row adaptive DOPRI5 of the hybrid Roche field, forward only, one thread per row.
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
// - One thread a row; y, the seven stages and the step's sums in registers
//   (D is a template parameter): 94-167 registers for D = 4 ... 8, no spills.
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
//   trial steps to both counters with one atomic each. The kernel allocates
//   nothing and never synchronises, so a CUDA graph can capture it.

#include <cuda_runtime.h>

#include "roche_field.cuh"

namespace {

using namespace roche;

constexpr int kThreads = 32;

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
// row of 4 <= D <= 8 (found on the card by matching every order of the adds): W lanes, W the largest power of two
// <= D, lane i adds x[i] ** 2 and x[i + W] ** 2, then the lanes fold at offsets W / 2, ..., 1; the sum times
// float(1 / D).
template <int D>
__device__ __forceinline__ float rms(const float (&x)[D], float inv_dim) {
  static_assert(D >= 4 && D <= 8, "the reduction order is that of 4 <= D <= 8");
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
// shapes (measured on the H100 at 50 and 2,550 rows; at 100,000 rows cuBLAS takes one chain): FMA chains over
// stages 0-3 and 4-6, then their sum.
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

// One row's whole solve -> its trial steps; writes out[:, row], n_accepted and success.
template <int D, Hill kHill>
__device__ int solve(const Staged& s_c, const Tolerances& tol, const float* __restrict__ y0,
                     const float* __restrict__ times, const float* __restrict__ amounts, float* __restrict__ out,
                     int* __restrict__ n_accepted, bool* __restrict__ success, int row, int B, int T, int budget) {
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
  return n_trial;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
roche_dopri5_kernel(const float* __restrict__ y0, const float* __restrict__ times,
                    const float* __restrict__ amounts, const float* __restrict__ params,
                    const float* __restrict__ ml_w, const float* __restrict__ ml_b, const float* __restrict__ ts,
                    Tolerances tol, float* __restrict__ out, int* __restrict__ n_trial,
                    int* __restrict__ n_accepted, bool* __restrict__ success, long long* __restrict__ tally, int B,
                    int T, int budget) {
  extern __shared__ float smem[];
  const Staged s_c = stage_shared<D>(smem, params, ml_w, ml_b, ts, T);

  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  int trials = 0;
  if (row < B) {
    // One branch for the whole launch: the exponents come from shared memory.
    trials = square_hill(s_c)
                 ? solve<D, Hill::kSquare>(s_c, tol, y0, times, amounts, out, n_accepted, success, row, B, T, budget)
                 : solve<D, Hill::kGeneral>(s_c, tol, y0, times, amounts, out, n_accepted, success, row, B, T, budget);
    n_trial[row] = trials;
  }
  if (tally != nullptr) {
    const unsigned warp_sum = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(trials));
    if ((threadIdx.x & 31) == 0 && warp_sum != 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(tally), static_cast<unsigned long long>(warp_sum));
      atomicAdd(reinterpret_cast<unsigned long long*>(tally + 1), static_cast<unsigned long long>(warp_sum));
    }
  }
}

template <int D>
cudaError_t launch(const float* y0, const float* times, const float* amounts, const float* params,
                   const float* ml_w, const float* ml_b, const float* ts, Tolerances tol, float* out, int* n_trial,
                   int* n_accepted, bool* success, long long* tally, int B, int T, int budget,
                   cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  roche_dopri5_kernel<D><<<blocks, kThreads, shared_bytes<D>(T), stream>>>(
      y0, times, amounts, params, ml_w, ml_b, ts, tol, out, n_trial, n_accepted, success, tally, B, T, budget);
  return cudaGetLastError();
}

template <int D>
cudaError_t info(int* registers, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, roche_dopri5_kernel<D>);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return err;
}

}  // namespace

// Plain C entry point, bound with ctypes. All pointers are device pointers to contiguous arrays: y0 (B, D),
// times (B,), amounts (B,), params (13,), ml_w (D, D-4) and ml_b (D-4,) (null when D == 4), ts (T,) float32;
// out (T, B, D) float32, n_trial and n_accepted (B,) int32, success (B,) bool, all written; tally (2,) int64 or null.
// Returns the launch's cudaError_t (0 on success).
extern "C" int roche_dopri5_per_row_launch(const float* y0, const float* times, const float* amounts,
                                           const float* params, const float* ml_w, const float* ml_b,
                                           const float* ts, float rtol, float atol, float floor, float rtol_floor,
                                           float* out, int* n_trial, int* n_accepted, bool* success,
                                           long long* tally, int B, int D, int T, int budget, void* stream) {
  const Tolerances tol{rtol, atol, floor, rtol_floor, 1.0f / static_cast<float>(D)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ROCHE_DOPRI5_LAUNCH(DIM)                                                                              \
  launch<DIM>(y0, times, amounts, params, ml_w, ml_b, ts, tol, out, n_trial, n_accepted, success, tally, B, T, \
              budget, s)
  switch (D) {
    case 4: return ROCHE_DOPRI5_LAUNCH(4);
    case 5: return ROCHE_DOPRI5_LAUNCH(5);
    case 6: return ROCHE_DOPRI5_LAUNCH(6);
    case 7: return ROCHE_DOPRI5_LAUNCH(7);
    case 8: return ROCHE_DOPRI5_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef ROCHE_DOPRI5_LAUNCH
}

// The D-state kernel's registers a thread and local memory (spills) a thread, as the loaded binary has them.
// Returns a cudaError_t.
extern "C" int roche_dopri5_kernel_info(int D, int* registers, int* local_bytes) {
  switch (D) {
    case 4: return info<4>(registers, local_bytes);
    case 5: return info<5>(registers, local_bytes);
    case 6: return info<6>(registers, local_bytes);
    case 7: return info<7>(registers, local_bytes);
    case 8: return info<8>(registers, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}
