// The hybrid Roche field of one trajectory, shared by the port's kernels
// (roche_rk4.cu, roche_dopri5.cu): what `hybridode_torch/fields/roche.py`
// `roche_field` computes for one row, with one bolus dose.
//
// y' = expert PK/PD field (4 states) ++ tanh(y @ W + b) (ml remainder); the
// dose enters as kel * amount * exp(kel * (t_dose - t)) * [t >= t_dose], the
// field's only dependence on t, computed apart (`kel_dose_at`) so that a
// solver can take it off the chain of the state. The 13 constants, W and b
// are copied from shared memory into registers once a solve (`load_field`).
//
// Hill exponents of exactly 2 (every model the repo trains) take |x|**p as
// x * x; any other exponent takes the accurate powf. The kernels test the
// constants on the device and hold one solve for each case.
//
// Built without --use_fast_math: expf, powf, tanhf and the division are the
// accurate ones, as in PyTorch. nvcc contracts a * b + c into FMAs here, so
// the field rounds otherwise than PyTorch's unfused operations.

#pragma once

#include <cuda_runtime.h>

namespace roche {

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

// The constants and the grid as staged in the block's shared memory.
struct Staged {
  const float* p;   // [13]
  const float* w;   // [D * ML], row-major (D, ML)
  const float* b;   // [ML]
  const float* ts;  // [T]
};

// Stages params, W, b and ts in the block's shared memory, one after the other. Every thread of the block calls
// it; it ends in a barrier.
template <int D>
__device__ __forceinline__ Staged stage_shared(float* smem, const float* params, const float* ml_w, const float* ml_b,
                                               const float* ts, int T) {
  constexpr int ML = D - 4;
  float* s_p = smem;
  float* s_w = s_p + kNumParams;
  float* s_b = s_w + D * ML;
  float* s_ts = s_b + ML;
  for (int i = threadIdx.x; i < kNumParams; i += blockDim.x) s_p[i] = params[i];
  for (int i = threadIdx.x; i < D * ML; i += blockDim.x) s_w[i] = ml_w[i];
  for (int i = threadIdx.x; i < ML; i += blockDim.x) s_b[i] = ml_b[i];
  for (int i = threadIdx.x; i < T; i += blockDim.x) s_ts[i] = ts[i];
  __syncthreads();
  return {s_p, s_w, s_b, s_ts};
}

// The field's constants, from shared memory into registers.
template <int D, Hill kHill>
__device__ __forceinline__ Field<D, kHill> load_field(const Staged& s) {
  constexpr int ML = D - 4;
  Field<D, kHill> f;
#pragma unroll
  for (int i = 0; i < kNumParams; ++i) f.p[i] = s.p[i];
  f.ec50_pow = f.hill_pow(f.p[kEc50Patho], f.p[kHillPatho]);
#pragma unroll
  for (int m = 0; m < ML; ++m) {
#pragma unroll
    for (int j = 0; j < D; ++j) f.w[m][j] = s.w[j * ML + m];
    f.b[m] = s.b[m];
  }
  return f;
}

template <int D>
constexpr size_t shared_bytes(int T) {
  return sizeof(float) * (kNumParams + D * (D - 4) + (D - 4) + T);
}

// Both Hill exponents exactly 2, read from the staged constants: one branch for the whole launch.
__device__ __forceinline__ bool square_hill(const Staged& s) {
  return s.p[kHillCure] == 2.0f && s.p[kHillPatho] == 2.0f;
}

// Depot concentration times kel at time t (the field's only t dependence).
__device__ __forceinline__ float kel_dose_at(float t, float kel, float dose_time, float dose_amount) {
  const bool active = t >= dose_time;
  const float delta = active ? dose_time - t : 0.0f;
  const float contrib = active ? expf(kel * delta) : 0.0f;
  return kel * (dose_amount * contrib);
}

}  // namespace roche
