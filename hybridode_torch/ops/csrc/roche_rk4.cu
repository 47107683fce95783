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
// The field, its shared-memory staging and the dose term are in
// roche_field.cuh, which roche_dopri5.cu includes too.
//
// The TPU layout does not carry over: the (8, B) transpose, the 128-lane
// padding and the exp(p * log(max(x, 1e-30))) power were Mosaic workarounds.

#include <cuda_runtime.h>

#include "roche_field.cuh"

namespace {

using namespace roche;

constexpr int kThreads = 128;

template <int D>
__device__ __forceinline__ void store_state(float* o, const float (&y)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = y[d];
}

template <int D, Hill kHill>
__device__ __forceinline__ void solve(const Staged& s_c, const float* y0, float dose_time, float dose_amount,
                                      float* out, int row, int B, int T, int n_sub) {
  const Field<D, kHill> f = load_field<D, kHill>(s_c);
  const float* s_ts = s_c.ts;
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
  extern __shared__ float smem[];
  const Staged s_c = stage_shared<D>(smem, params, ml_w, ml_b, ts, T);

  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;

  // One branch for the whole launch: the exponents come from shared memory.
  const float dose_time = times[row], dose_amount = amounts[row];
  if (square_hill(s_c)) {
    solve<D, Hill::kSquare>(s_c, y0, dose_time, dose_amount, out, row, B, T, n_sub);
  } else {
    solve<D, Hill::kGeneral>(s_c, y0, dose_time, dose_amount, out, row, B, T, n_sub);
  }
}

template <int D>
cudaError_t launch(const float* y0, const float* times, const float* amounts, const float* params,
                   const float* ml_w, const float* ml_b, const float* ts, float* out, int B, int T,
                   int n_sub, cudaStream_t stream) {
  const size_t smem = shared_bytes<D>(T);
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
    case 9: return launch<9>(y0, times, amounts, params, ml_w, ml_b, ts, out, B, T, n_sub, s);
    case 10: return launch<10>(y0, times, amounts, params, ml_w, ml_b, ts, out, B, T, n_sub, s);
    case 11: return launch<11>(y0, times, amounts, params, ml_w, ml_b, ts, out, B, T, n_sub, s);
    case 12: return launch<12>(y0, times, amounts, params, ml_w, ml_b, ts, out, B, T, n_sub, s);
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
    case 9: return info<9>(registers, local_bytes);
    case 10: return info<10>(registers, local_bytes);
    case 11: return info<11>(registers, local_bytes);
    case 12: return info<12>(registers, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}
