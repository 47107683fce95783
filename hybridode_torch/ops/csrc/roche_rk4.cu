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
// What bounds it on an H100: neither bytes nor FLOPs. A trajectory is a serial
// chain of (T-1) * n_sub * 4 field evaluations (448 at T=15, n_sub=8), each a
// dependent sequence of powf, expf, tanhf, an IEEE division and a D x (D-4)
// mat-vec. At the evaluation shapes (B = 50 and 2,500 trajectories) the grid is
// 1 and 20 blocks of 128 threads on 132 SMs, so the kernel is bound by the
// latency of that chain, far above both the FP32 bound (~3.7e4 FLOP per
// trajectory at 67 TFLOP/s) and the HBM bound (y0 + out, ~1 MB at 3.35 TB/s).
//
// Design: y and the four stages stay in registers for the whole solve (D is a
// template parameter, so every loop over D unrolls); the 13 rate constants,
// W, b and the grid ts are staged in shared memory once per block and read
// from there as broadcasts. The remainder mat-vec is at most 8 x 4 FMAs:
// tensor cores do not apply at this size. Built without --use_fast_math, so
// expf, powf, tanhf and the division are the accurate ones, as in PyTorch.
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

template <int D>
struct Field {
  static constexpr int ML = D - 4;
  float p[kNumParams];
  float ec50_pow;  // |ec50_patho| ** HillPatho, constant over the solve
  float w[D * (ML > 0 ? ML : 1)];
  float b[ML > 0 ? ML : 1];
  float dose_time;
  float dose_amount;

  __device__ void operator()(float t, const float (&y)[D], float (&dy)[D]) const {
    const float disease = y[0], immune_react = y[1], immunity = y[2], dose2 = y[3];

    const bool active = t >= dose_time;
    const float delta = active ? dose_time - t : 0.0f;
    const float contrib = active ? expf(p[kKel] * delta) : 0.0f;
    const float dose = dose_amount * contrib;

    dy[0] = disease * p[kDisprog]
            - disease * powf(fabsf(immunity), p[kHillCure]) * p[kDiscureImmunity]
            - disease * immune_react * p[kDiscureImmunereact];

    const float ir_hill = powf(fabsf(immune_react), p[kHillPatho]);
    dy[1] = disease * p[kImmuneDisease]
            - immune_react * p[kImmuneOff]
            + disease * immune_react * p[kImmuneFeedback]
            + (ir_hill * p[kEmaxPatho]) / (ec50_pow + ir_hill)
            - dose2 * immune_react * p[kDexa];

    dy[2] = immune_react * p[kImmunity];
    dy[3] = p[kKel] * dose - p[kKel] * dose2;

#pragma unroll
    for (int m = 0; m < ML; ++m) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) acc = fmaf(y[j], w[j * ML + m], acc);
      dy[4 + m] = tanhf(acc + b[m]);
    }
  }
};

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

  Field<D> f;
#pragma unroll
  for (int i = 0; i < kNumParams; ++i) f.p[i] = s_p[i];
#pragma unroll
  for (int i = 0; i < D * ML; ++i) f.w[i] = s_w[i];
#pragma unroll
  for (int i = 0; i < ML; ++i) f.b[i] = s_b[i];
  f.ec50_pow = powf(fabsf(f.p[kEc50Patho]), f.p[kHillPatho]);
  f.dose_time = times[row];
  f.dose_amount = amounts[row];

  // RK4 weights rounded to float32 as the plain version rounds them.
  const float b0 = 1.0f / 6.0f, b1 = 1.0f / 3.0f;

  float y[D], k1[D], k2[D], k3[D], k4[D], yi[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    y[d] = y0[row * D + d];
    out[row * D + d] = y[d];
  }

  for (int i = 0; i + 1 < T; ++i) {
    const float t_lo = s_ts[i];
    const float dt = (s_ts[i + 1] - t_lo) / static_cast<float>(n_sub);
    const float half_dt = 0.5f * dt;
    for (int s = 0; s < n_sub; ++s) {
      const float t = t_lo + dt * static_cast<float>(s);
      f(t, y, k1);
#pragma unroll
      for (int d = 0; d < D; ++d) yi[d] = y[d] + dt * (k1[d] * 0.5f);
      f(t + half_dt, yi, k2);
#pragma unroll
      for (int d = 0; d < D; ++d) yi[d] = y[d] + dt * (k2[d] * 0.5f);
      f(t + half_dt, yi, k3);
#pragma unroll
      for (int d = 0; d < D; ++d) yi[d] = y[d] + dt * k3[d];
      f(t + dt, yi, k4);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float acc = k1[d] * b0 + k2[d] * b1 + k3[d] * b1 + k4[d] * b0;
        y[d] = y[d] + dt * acc;
      }
    }
    float* o = out + (static_cast<size_t>(i + 1) * B + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = y[d];
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
