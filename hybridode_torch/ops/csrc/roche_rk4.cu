// Fixed-step RK4 trajectory of the hybrid Roche field, one thread per trajectory.
//
// Replaces the Pallas TPU kernel `roche_rk4_trajectory`
// (hybridode/ops/pallas/roche_kernel.py:114, pl.pallas_call at :151; body
// `_kernel` :80, field `_field_tile` :41). It computes what the port's plain
// version computes (hybridode_torch/ops/roche_rk4.py,
// `roche_rk4_trajectory_reference`: `odeint_fixed(roche_field, method="rk4")`),
// with the stage and weight arithmetic in the same order.
//
// Semantics: y' = expert PK/PD field (4 states) ++ tanh(y @ W + b) (ml
// remainder), single bolus dose amount * exp(kel * (t_dose - t)) * [t >= t_dose].
// n_sub RK4 steps per grid interval; only the T grid states are written.
//
// What bounds it on an H100: neither bytes nor FLOPs, but the serial stream of
// (T-1) * n_sub * 4 field evaluations (448 at T=15, n_sub=8) that one thread
// runs. At evaluate's shape (B = 2,550) the launch is 80 warps, one per warp
// scheduler, so nothing hides a stall and the time is flat in B. With the
// design below a field evaluation is ~106 SASS instructions, issued at ~0.4 a
// cycle (roche_rk4_study.py counts them and times the kernel).
//
// Design, each point against that stream:
// - Hill exponents of exactly 2. HillCure and HillPatho are 2.0 in every
//   model the repo trains (frozen expert constants); then the Hill terms
//   |x|**p (and ec50**p) are x * x. Any other exponent takes the accurate
//   powf. The test reads the constants from shared memory, so the whole
//   launch takes one branch, once, before the solve: the kernel holds one
//   solve for each case.
// - The dose term depends on t and the trajectory only: it is computed once a
//   step for t, t + dt/2 (shared by stages 2 and 3) and t + dt, off the chain.
// - The stage states y + dt * (k * 0.5) are one FMA with dt/2 (the product is
//   the same real number), and the RK4 weights are summed as the stages come.
// - y and the stage sums stay in registers (D is a template parameter); the
//   13 constants, W, b and ts are staged in shared memory once per block.
//   Built without --use_fast_math: expf, powf, tanhf and the division are the
//   accurate ones, as in PyTorch.
// - One thread a trajectory. Groups of 2 and 4 lanes a trajectory, exchanging
//   the remainder rows by shuffles, were measured slower at D=6 (PERF.md):
//   the shuffles lengthen the chain more than the split tanh work shortens it.
//
// The TPU layout does not carry over: the (8, B) transpose, the 128-lane
// padding and the exp(p * log(max(x, 1e-30))) power were Mosaic workarounds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNumParams = 13;

// Index of each rate constant in ROCHE_PARAM_NAMES order.
enum {
  kHillCure, kHillPatho, kEc50Patho, kEmaxPatho, kDexa, kDiscureImmunereact, kDiscureImmunity,
  kDisprog, kImmuneDisease, kImmuneFeedback, kImmuneOff, kImmunity, kKel
};

// How the Hill terms |x|**p are taken: both exponents exactly 2, or anything else.
enum class Hill { kSquare, kGeneral };

template <int D, Hill kHill>
struct Field {
  static constexpr int ML = D - 4;
  float p[kNumParams];
  float ec50_pow;                  // |ec50_patho| ** HillPatho, constant over the solve
  float w[ML > 0 ? ML : 1][D];     // w[m] = column m of W
  float b[ML > 0 ? ML : 1];

  __device__ float hill_pow(float x, float exponent) const {
    if constexpr (kHill == Hill::kSquare) {
      return x * x;
    } else {
      return powf(fabsf(x), exponent);
    }
  }

  // dy = f(y) given kel_dose = kel * dose(t), which depends on t only.
  __device__ __forceinline__ void operator()(float kel_dose, const float (&y)[D], float (&dy)[D]) const {
    const float disease = y[0], immune_react = y[1], immunity = y[2], dose2 = y[3];

    dy[0] = disease * p[kDisprog]
            - disease * hill_pow(immunity, p[kHillCure]) * p[kDiscureImmunity]
            - disease * immune_react * p[kDiscureImmunereact];

    const float ir_hill = hill_pow(immune_react, p[kHillPatho]);
    dy[1] = disease * p[kImmuneDisease]
            - immune_react * p[kImmuneOff]
            + disease * immune_react * p[kImmuneFeedback]
            + (ir_hill * p[kEmaxPatho]) / (ec50_pow + ir_hill)
            - dose2 * immune_react * p[kDexa];

    dy[2] = immune_react * p[kImmunity];
    dy[3] = kel_dose - p[kKel] * dose2;

#pragma unroll
    for (int m = 0; m < ML; ++m) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) acc = fmaf(y[j], w[m][j], acc);
      dy[4 + m] = tanhf(acc + b[m]);
    }
  }
};

// Depot concentration times kel at time t (the field's only t dependence).
__device__ __forceinline__ float kel_dose_at(float t, float kel, float dose_time, float dose_amount) {
  const bool active = t >= dose_time;
  const float delta = active ? dose_time - t : 0.0f;
  const float contrib = active ? expf(kel * delta) : 0.0f;
  return kel * (dose_amount * contrib);
}

template <int D>
__device__ __forceinline__ void store_state(float* o, const float (&y)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = y[d];
}

template <int D, Hill kHill>
__device__ __forceinline__ void solve(const float* s_p, const float* s_w, const float* s_b, const float* s_ts,
                                      const float* y0, float dose_time, float dose_amount, float* out, int row,
                                      int B, int T, int n_sub) {
  constexpr int ML = D - 4;
  Field<D, kHill> f;
#pragma unroll
  for (int i = 0; i < kNumParams; ++i) f.p[i] = s_p[i];
  f.ec50_pow = f.hill_pow(f.p[kEc50Patho], f.p[kHillPatho]);
#pragma unroll
  for (int m = 0; m < ML; ++m) {
#pragma unroll
    for (int j = 0; j < D; ++j) f.w[m][j] = s_w[j * ML + m];
    f.b[m] = s_b[m];
  }
  const float kel = f.p[kKel];

  // RK4 weights rounded to float32 as the plain version rounds them.
  const float b0 = 1.0f / 6.0f, b1 = 1.0f / 3.0f;

  float y[D], k[D], yi[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) y[d] = y0[row * D + d];
  store_state<D>(out + static_cast<size_t>(row) * D, y);

#pragma unroll 1
  for (int i = 0; i + 1 < T; ++i) {
    const float t_lo = s_ts[i];
    const float dt = (s_ts[i + 1] - t_lo) / static_cast<float>(n_sub);
    const float half_dt = 0.5f * dt;
#pragma unroll 1
    for (int s = 0; s < n_sub; ++s) {
      const float t = t_lo + dt * static_cast<float>(s);
      const float kd_lo = kel_dose_at(t, kel, dose_time, dose_amount);
      const float kd_mid = kel_dose_at(t + half_dt, kel, dose_time, dose_amount);
      const float kd_hi = kel_dose_at(t + dt, kel, dose_time, dose_amount);

      f(kd_lo, y, k);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        acc[d] = k[d] * b0;
        yi[d] = fmaf(half_dt, k[d], y[d]);
      }
      f(kd_mid, yi, k);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        acc[d] = fmaf(k[d], b1, acc[d]);
        yi[d] = fmaf(half_dt, k[d], y[d]);
      }
      f(kd_mid, yi, k);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        acc[d] = fmaf(k[d], b1, acc[d]);
        yi[d] = fmaf(dt, k[d], y[d]);
      }
      f(kd_hi, yi, k);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        acc[d] = fmaf(k[d], b0, acc[d]);
        y[d] = fmaf(dt, acc[d], y[d]);
      }
    }
    store_state<D>(out + (static_cast<size_t>(i + 1) * B + row) * D, y);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
roche_rk4_kernel(const float* __restrict__ y0, const float* __restrict__ times,
                 const float* __restrict__ amounts, const float* __restrict__ params,
                 const float* __restrict__ ml_w, const float* __restrict__ ml_b,
                 const float* __restrict__ ts, float* __restrict__ out, int B, int T, int n_sub) {
  constexpr int ML = D - 4;
  extern __shared__ float smem[];
  float* s_p = smem;                 // [13]
  float* s_w = s_p + kNumParams;     // [D * ML], row-major (D, ML)
  float* s_b = s_w + D * ML;         // [ML]
  float* s_ts = s_b + ML;            // [T]
  for (int i = threadIdx.x; i < kNumParams; i += blockDim.x) s_p[i] = params[i];
  for (int i = threadIdx.x; i < D * ML; i += blockDim.x) s_w[i] = ml_w[i];
  for (int i = threadIdx.x; i < ML; i += blockDim.x) s_b[i] = ml_b[i];
  for (int i = threadIdx.x; i < T; i += blockDim.x) s_ts[i] = ts[i];
  __syncthreads();

  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;

  // One branch for the whole launch: the exponents come from shared memory.
  const float dose_time = times[row], dose_amount = amounts[row];
  if (s_p[kHillCure] == 2.0f && s_p[kHillPatho] == 2.0f) {
    solve<D, Hill::kSquare>(s_p, s_w, s_b, s_ts, y0, dose_time, dose_amount, out, row, B, T, n_sub);
  } else {
    solve<D, Hill::kGeneral>(s_p, s_w, s_b, s_ts, y0, dose_time, dose_amount, out, row, B, T, n_sub);
  }
}

template <int D>
cudaError_t launch(const float* y0, const float* times, const float* amounts, const float* params,
                   const float* ml_w, const float* ml_b, const float* ts, float* out, int B, int T,
                   int n_sub, cudaStream_t stream) {
  constexpr int ML = D - 4;
  const size_t smem = sizeof(float) * (kNumParams + D * ML + ML + T);
  const int blocks = (B + kThreads - 1) / kThreads;
  roche_rk4_kernel<D><<<blocks, kThreads, smem, stream>>>(y0, times, amounts, params, ml_w, ml_b, ts,
                                                          out, B, T, n_sub);
  return cudaGetLastError();
}

template <int D>
cudaError_t info(int* registers, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, roche_rk4_kernel<D>);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return err;
}

}  // namespace

// Plain C entry point, bound with ctypes. All pointers are device pointers to
// contiguous float32 arrays: y0 (B, D), times (B,), amounts (B,), params (13,),
// ml_w (D, D-4) and ml_b (D-4,) (may be null when D == 4), ts (T,), out (T, B, D).
// Returns the launch's cudaError_t (0 on success).
extern "C" int roche_rk4_trajectory_launch(const float* y0, const float* times, const float* amounts,
                                           const float* params, const float* ml_w, const float* ml_b,
                                           const float* ts, float* out, int B, int D, int T, int n_sub,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 4: return launch<4>(y0, times, amounts, params, ml_w, ml_b, ts, out, B, T, n_sub, s);
    case 5: return launch<5>(y0, times, amounts, params, ml_w, ml_b, ts, out, B, T, n_sub, s);
    case 6: return launch<6>(y0, times, amounts, params, ml_w, ml_b, ts, out, B, T, n_sub, s);
    case 7: return launch<7>(y0, times, amounts, params, ml_w, ml_b, ts, out, B, T, n_sub, s);
    case 8: return launch<8>(y0, times, amounts, params, ml_w, ml_b, ts, out, B, T, n_sub, s);
    default: return cudaErrorInvalidValue;
  }
}

// The D-state kernel's registers a thread and local memory (spills) a thread,
// as the loaded binary has them. Returns a cudaError_t.
extern "C" int roche_rk4_kernel_info(int D, int* registers, int* local_bytes) {
  switch (D) {
    case 4: return info<4>(registers, local_bytes);
    case 5: return info<5>(registers, local_bytes);
    case 6: return info<6>(registers, local_bytes);
    case 7: return info<7>(registers, local_bytes);
    case 8: return info<8>(registers, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}
