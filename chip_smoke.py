#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`hybridode_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--ckpt PATH_PREFIX] [--seed N]

Phases, one line each (any failure exits non-zero; there is no CPU fallback):

1. Environment: the card's name and power limit, the TF32 flags.
2. Build: every CUDA kernel of the port, compiled from the checkout with nvcc.
3. Kernels: each kernel against its plain PyTorch version on the card, at the
   shape the evaluation path gives it (B=2550: a chunk's point and 50 MC
   decodes in one launch), at other batches and widths (a ragged B=7), and
   with non-integer Hill exponents (the kernel's powf path), with the
   tolerance stated below; the kernel's and the plain version's times (CUDA
   events, medians after warm-up of 20 runs, `ms`, and of PLAIN_RUNS runs of
   the ~0.35 s plain version, `plain_ms`), the kernel's
   device time with the host's launch cost hidden (`device_ms`: 100 calls
   queued behind a GPU spin), and the built kernel's registers and local
   (spill) bytes a thread.
3b. DOPRI5 kernel: the per-row DOPRI5 kernel against the plain per-row
   solver on the card (`DOPRI5_CASES`: evaluate's shape, the validation's
   chunk of 50, D=4, 8 and 12, Hill 1.7, rows without a dose, a budget of
   64, and a field both compute exactly, on which the two must agree bit for
   bit), each against the same solve in float64; its times as phase 3's;
   its registers and spills; one forecast request (`evaluate` of 50 patients, mc 50) through the kernel
   (one launch) and through the plain solver, and their scores.
3c. DOPRI5 with gradients: the recording solve and the backward kernel
   (`roche_dopri5_per_row_grad`) at the training step's shape (B=50) for
   D=6 and D=12, forward plus backward against the plain per-row solver's
   autograd on the card: times as phase 3's (`ms`, `device_ms`, the forward
   and the backward alone on the device), every kernel's registers and
   spills, the gradients against a float64 plain solve (the kernel's error at
   most DOPRI5_ACCURACY times the plain solver's plus DOPRI5_GRAD_ATOL); and
   the sim model's training step (loss and gradients of a batch of 50 under
   `full_budget`) captured into a graph on the route and off it: its nodes
   (cuGraphGetNodes, as phase 9 reads them), capture seconds and a replay's
   device milliseconds.
   `python3 chip_smoke.py --phase kernels` runs phases 1-3c alone.
4. Slice: `evaluate` of the hybrid model (full width of the cohort's model:
   obs 20, LSTM hidden 40, latent 6, ml remainder 2) on the whole test fold of
   data_s123, decoding with the RK4 kernel (one launch per chunk of 50
   patients, 4 in all); launch counts read around that run, then
   EVAL_REPEATS more timed runs for the spread; the same evaluation on the
   CPU (plain path) must agree within METRIC_RTOL.
5. Train: the port's `run_simulation.run` (the CLI's entry point) on
   data_s123 at the same width, `--method hybrid` with per-patient DOPRI5
   (max_steps=256), batch 50, one restart of TRAIN_ITERS iterations with
   forecast validation every TRAIN_TEST_FREQ, a checkpoint, then the CLI's
   `evaluate` decoding with DOPRI5; once on the GPU and once on the CPU from
   the same seed. The `train` line gives seconds per iteration (median) on
   both, the GPU `evaluate` seconds, the steps of the first training batch's
   per-patient decode, the largest relative differences between the two
   curves and between the four metrics (each must stay within TRAIN_RTOL).
   The RK4 kernel is not on this path: its launches there must stay 0 (the
   validations and the `evaluate` decode through the per-row DOPRI5 kernel,
   the training steps through the DOPRI5 pair with gradients, whose launches
   the line counts). One training iteration is
   timed here and
   profiled at the end (`profile` line). The `checkpoint_steps` probe: the
   first training batch's per-patient DOPRI5 decode through the plain solver (batch 50, 256 trial
   steps) with its gradient, without and with `checkpoint_steps` (each chunk
   of 64 trial steps recomputed in the backward pass), in turns: the peak
   device memory above what was allocated before, the seconds, and the two
   gradients, which must be equal.
6. Real: the real-data track on data_real/ (read only) at the full width of
   the ICU cohort's model (obs 28, 1 dose channel, 11 statics, encoder LSTM
   hidden 49, latent 20, field hidden 48, explicit Adams over 73 hourly
   intervals). The port's `run_real.run` (the CLI's entry point) for
   `--method hybrid`: batch 100, val 100, test 1,000, REAL_ITERS iterations
   with validation every REAL_TEST_FREQ, then the test fold's forecast, once
   on the GPU and once on the CPU from the same seed, at the CLI's one step
   an hour (`cli`: GPU values must be finite where the CPU's are) and at
   REAL_HELD_STEP_DIV steps (`held`: curves and RMSEs within REAL_RTOL).
   Each gives seconds per iteration (median) and `predict_test` seconds on
   both devices, the four horizon RMSEs on both, the largest relative
   differences of the curves and of the RMSEs (one training iteration of
   each is profiled at the end); the RK4 kernel's launches in the phase must
   be 0 (no kernel is on this path).
   Then the five other methods on the GPU (REAL_OTHER_ITERS iterations each,
   finite losses and RMSEs), and the ensemble and residual CLIs from their
   expert and gruode checkpoints on the GPU and the CPU (RMSEs within
   REAL_RTOL; both non-finite counts as agreement, one alone as a failure).
7. Sim_more: the rest of the simulation study on data_s123 at the width of
   phases 4-5, each on the GPU and on the CPU from the same seed, held within
   SIM_MORE_RTOL. The flow CLI (`run_simulation_flow.run`, LHM-NF: 4 planar
   flows, a 50-sample MC KL, per-patient DOPRI5), one restart of FLOW_ITERS
   iterations at batch 50 with validation every FLOW_TEST_FREQ, then its
   `evaluate`: curves and metrics, seconds per iteration (one iteration is
   profiled at the end). Its GPU checkpoint evaluated at RK4 (ode_step_size=0.125)
   through the kernel and through the plain version. Expert and neural
   checkpoints from `run_simulation.run` (MEMBER_ITERS iterations, GPU), then
   `run_simulation_ensemble.run`, `run_simulation_residual.run`
   (RESIDUAL_ITERS iterations) and `run_eval.run` (the expert's horizon, 10
   steps) from them. Then `evaluate_horizon` of the hybrid (random weights
   from the seed) and `evaluate_ensemble_horizon` of the two members, both at
   RK4. The kernel must launch exactly EVAL_LAUNCHES times on each RK4 path
   (one per chunk; the ensemble's neural member has no Roche field) and never
   on a DOPRI5 path.
8. Lockstep: `create_data.main(["--which", "train", "--seed", "123", ...])` on
   the GPU and on the CPU (1,300 patients, latent 6, obs 20, T=15: one float64
   lockstep DOPRI5 of the cohort's ground truth), each file held against the
   committed data_s123 cohort (`cohort_faults`: the arrays drawn only from
   the RandomState byte for byte, latents within rtol 1e-5, atol 1e-6,
   measurements within atol 1e-5), with its seconds and the solve's trial
   and accepted steps. Then `run_simulation.run(..., lockstep=True)` as
   `--method hybrid` at phase 5's width (one controller for the batch, on the
   adjoint solver: max_steps 4096, max_record 1024), batch 50, one restart
   of LOCKSTEP_ITERS iterations with validation every LOCKSTEP_TEST_FREQ,
   then its `evaluate`, on the GPU and on the CPU from the same seed, curves
   and metrics within LOCKSTEP_RTOL; the first training batch's trial,
   accepted and recorded steps. On that batch, the `sim_loss` gradient with
   the adjoint against backprop through the same lockstep solve
   (`use_adjoint=False`), within ADJOINT_RTOL and ADJOINT_ATOL, each
   backward timed. The native C++ generator (`generate_data(backend=
   "native")`, the training cohort of seed 123 on the host) against the
   committed data_s123 (`cohort_faults`) and against the GPU file's latents
   within NATIVE_RTOL / NATIVE_ATOL, with its seconds. The lockstep
   restarts batched: `run_simulation.run(..., lockstep=True)` with
   `restart_mode="vmap"` and `"seq"` (LOCKSTEP_RESTARTS restarts of
   LOCKSTEP_VMAP_ITERS iterations, validation every LOCKSTEP_VMAP_TEST_FREQ,
   the fused loop, uncaptured on the adjoint), their training seconds and
   seconds an iteration, each restart's first validation and the best loss
   within LOCKSTEP_VMAP_RTOL and the checkpoint's iteration equal. The RK4 kernel
   must not launch in this phase. One lockstep training iteration is
   profiled at the end.
9. Fused, in a process of its own (with phase 10): the fused training loop
   (`inference/fused.py`: the loop's state on the device, one host read per
   validation window, on the GPU the step and the validation as CUDA graphs)
   through `run_simulation.run` as `--method hybrid` at phase 5's width,
   batch 50, one restart with validation every FUSED_TEST_FREQ, three ways in
   this call: GPU fused (captured, FUSED_ITERS iterations: two windows), CPU
   fused and GPU host loop (`HYBRIDODE_FUSED=0`), these two for the first
   window only, which is all that is held. Each run's window seconds (a
   window: FUSED_TEST_FREQ steps and one validation; on the GPU the first
   holds the warm-ups and captures, the second is all graph replays) and
   seconds per iteration of the last window, the graphs' capture seconds
   (capture and instantiation together), and the GPU fused curve's first
   validation against the CPU's and the GPU host loop's within TRAIN_RTOL
   (float32 differences grow chaotically over iterations in every loop, so
   later rows and the metrics are reported, not held). The captured step's
   graph: its nodes, capture and instantiation seconds, one replay's device
   and wall milliseconds. The real hybrid captured at REAL_HELD_STEP_DIV
   steps an hour against the CPU within REAL_RTOL. `--restart_mode vmap`
   with FUSED_RESTARTS restarts (VMAP_ITERS iterations, validation every
   VMAP_TEST_FREQ) against `seq` from the same seed: its seconds against the
   sequential restarts', its best loss within FUSED_BEST_RTOL and its
   checkpoint's iteration equal. The RK4 kernel must launch 0 times on every
   fused path.
10. Parallel, in phase 9's process: a world of one NCCL rank. Phase 9's GPU
   fused run once more through the DP entry (`variational_training_loop`
   with a one-rank "data" mesh; `--dp 1` means one device, as in JAX): its
   step and validation captured with their all-reduces, its first
   validation within DP_RTOL of phase 9's, its last window's seconds per
   iteration against phase 9's, the step graph's nodes and the all-reduces
   a step (1: the gradients and the loss in one flat buffer).
   `evaluate_sharded` of the hybrid at RK4 (random weights from the seed)
   on a 1 x 1 (data, mc) mesh of the test fold: EVAL_LAUNCHES kernel
   launches and `evaluate`'s four point metrics at 4 decimals, with its
   seconds. `--dp 2` on a one-GPU machine: JAX's mesh error. The CPU
   dryrun of DRYRUN_RANKS gloo ranks (`python -m
   hybridode_torch.parallel.dryrun`), run beside the GPU work: rc 0 and
   every OK line. With 2 GPUs or more visible, after the world of one rank
   has ended: the two-world check (`multigpu_study.two_worlds`: two 2-rank
   `--dp 2` worlds in turn, each within MULTI_GPU_TIMEOUT seconds, then a
   world of one rank; its first validation within DP_RTOL), printed in the
   line as `multi_gpu`; with one, `multi_gpu` says it was not run.

Phases 5-8 run the host loop (`HYBRIDODE_FUSED=0`), so that their numbers
stay comparable with the runs before the fused loop.

Then the `profile` line: for each training iteration set aside above (the
main path's, the real hybrid's at both step sizes, the flow's, the lockstep
hybrid's), its ATen
calls, CUDA kernels, host launch calls and the share of its untraced wall
time the GPU was busy under torch.profiler. It comes last because a trace
with CUDA activity slows every later step of the process. A `timing` line
gives the seconds of the phases, of the profile line and of the whole
script. The last lines are
the `kernels` JSON (the RK4 kernel's launches on every path of the run beside
the main path's `launches`, `evaluate_sharded` among them; the DOPRI5 kernel's
numbers; the DOPRI5 pair with gradients' numbers from phase 3c, its bound
computed from that solve's trial and accepted steps, and its forward launches
on every training path of phases 5-10), the nvidia-smi line and
{"ok": true, "device": {...}}. Every path of GRAD_ROUTE_PATHS must launch the
pair and every other training path must not, or the script fails after the
`kernels` JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

# Kernel against its plain version on the same card: float32 rounding of two
# evaluation orders (FMA contraction in the kernel), amplified over 448 field
# evaluations; f32-vs-f64 runs of the plain version use < 10% of this.
RTOL, ATOL = 1e-4, 1e-5
# GPU evaluate (kernel) against CPU evaluate (plain path): four aggregate metrics.
METRIC_RTOL = 1e-3
# H100 SXM published peaks at 700 W: FP32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
COHORT = os.path.join("data_s123", "datafile_dose_exp.pkl")
T_GRID, N_SUB = 15, 8
EVAL_LAUNCHES = 4  # one per chunk of the 200-patient test fold at batch 50
EVAL_REPEATS = 5  # further timed GPU evaluations after the counted one
PLAIN_RUNS = 5  # timed runs of a kernel's plain version (phase 3)
# (B, D, Hill exponent or None for the cohort's 2.0). The first is evaluate's shape:
# (50 MC + 1) x 50 patients; the next two are the two launches a chunk took before.
# Phase 5: the training run (OptimConfig(shuffle=False, niters=4, test_freq=2, early_stop=10)) and the
# agreement its GPU and CPU runs must keep (curves and metrics: float32 solves whose step sequences may differ).
TRAIN_ITERS, TRAIN_TEST_FREQ, TRAIN_BATCH = 4, 2, 50
TRAIN_RTOL = 1e-3
# Phase 6: the real track on data_real/ (full width), and the GPU-vs-CPU agreement of its curves and horizon RMSEs
# (the masked MSE draws no noise, so both devices see the same batches and inputs). The hybrid's agreement is held
# at two explicit-Adams steps an hour: at the CLI's one step an hour its GRU remainder's decay rate lies outside
# AB4's stability interval and the randomly initialised solve amplifies rounding (float32 against float64 on one
# CPU: beyond 1e-2 on the loss, tests/test_torch_real_models.py), so no two devices can agree there.
REAL_DATA = "data_real/"
REAL_ITERS, REAL_TEST_FREQ, REAL_OTHER_ITERS = 10, 5, 2
REAL_HELD_STEP_DIV = 2
REAL_RTOL = 1e-3
REAL_OTHER_METHODS = ("neural", "2nd", "expert", "tlstm", "gruode")
# Phase 7: the flow CLI (its CLI defaults: 4 planar flows, a 50-sample MC KL) for FLOW_ITERS iterations, validation
# every FLOW_TEST_FREQ; expert and neural members for MEMBER_ITERS; the residual model for RESIDUAL_ITERS. GPU against
# CPU within SIM_MORE_RTOL, as the main path's phases hold them. Horizon vectors have T - t0 = 10 steps.
FLOW_ITERS, FLOW_TEST_FREQ, MEMBER_ITERS, RESIDUAL_ITERS = 4, 2, 2, 2
SIM_MORE_RTOL = 1e-3
HORIZON_STEPS = 10
# Phase 8: the committed cohort that `create_data --which train --seed 123` reproduces; the arrays drawn only from the
# RandomState (byte for byte); the lockstep training run (LOCKSTEP_ITERS iterations, validation every
# LOCKSTEP_TEST_FREQ) and its GPU-vs-CPU agreement; the adjoint's gradient against backprop through the same lockstep
# solve, elementwise |a - b| <= ADJOINT_ATOL + ADJOINT_RTOL |b| (tests/test_models.py's tolerance).
DRAWN = ("output_coef", "ml_coef", "dose_time", "dose_amount", "actions", "masks")
LOCKSTEP_ITERS, LOCKSTEP_TEST_FREQ = 2, 2
LOCKSTEP_RTOL = 1e-3
# The lockstep restarts batched (`--restart_mode vmap`) against `seq` on the same card, held within LOCKSTEP_VMAP_RTOL
# (tests/test_torch_cuda_multigpu.py's tolerance for the same pair; LOCKSTEP_RTOL is for the GPU against the CPU); the
# native generator's latents against the GPU generator's (tests/test_torch_native.py's tolerance).
LOCKSTEP_RESTARTS, LOCKSTEP_VMAP_ITERS, LOCKSTEP_VMAP_TEST_FREQ = 2, 2, 2
LOCKSTEP_VMAP_RTOL = 1e-5
NATIVE_RTOL, NATIVE_ATOL = 1e-6, 1e-6
ADJOINT_RTOL, ADJOINT_ATOL = 2e-3, 1e-5
# Phase 9: the fused loop, GPU captured / CPU / GPU host loop (FUSED_ITERS iterations, validation every
# FUSED_TEST_FREQ), the first FUSED_HELD_ROWS validations held within TRAIN_RTOL; `--restart_mode vmap` with
# FUSED_RESTARTS restarts against `seq` (VMAP_ITERS, VMAP_TEST_FREQ): best losses within FUSED_BEST_RTOL (float32
# rounding of batched against separate matrix products).
# The CPU fused run and the GPU host loop run the first window only (FUSED_TEST_FREQ iterations): it is all that is
# held, and the GPU fused run's second window (all replays) gives the steady seconds.
FUSED_ITERS, FUSED_TEST_FREQ, FUSED_HELD_ROWS = 10, 5, 1
FUSED_RESTARTS, VMAP_ITERS, VMAP_TEST_FREQ = 2, 4, 2
# Phase 10: the DP fused restart on a world of one NCCL rank (phase 9's run through the DP entry: its first
# validation within DP_RTOL of phase 9's, a one-rank sum and a division by 1 being exact); `evaluate_sharded` on a
# 1 x 1 (data, mc) mesh against `evaluate` (the four point metrics equal at the CSV's 4 decimals, the kernel
# launched EVAL_LAUNCHES times); the CPU dryrun of DRYRUN_RANKS gloo ranks and its OK lines.
DP_RTOL = 1e-6
MULTI_GPU_TIMEOUT = 300.0  # seconds a world of the two-world check may take
DRYRUN_RANKS = 4
DRYRUN_LINES = ("dryrun 2D mesh (2x2 data x mc) eval parity OK", "dryrun real-track DP step: loss=",
                "dryrun flow DP step: loss=", "dryrun 2D mesh flow eval parity OK",
                "dryrun fused-DP whole-restart parity: best=", "dryrun 2x2 restart-x-data batched experiment: best=",
                "dryrun_multichip(4): loss=")
FUSED_BEST_RTOL = 1e-5
KERNEL_CASES = [(2550, 6, None), (2500, 6, None), (50, 6, None), (1000, 4, None), (1000, 8, None), (7, 6, None),
                (2550, 6, 1.7)]
# Phase 3b, the per-row DOPRI5 kernel: (B, D, Hill exponent or None, max_steps, every how many rows no dose or 0,
# exact). The first is evaluate's shape, the second the fused loop's validation chunk; max_steps 64 spends the budget.
# `exact`: every rate 0 but kel 1 and W 0, a field both solvers compute exactly, so that the kernel's steps and
# outputs must be the plain solver's bit for bit.
DOPRI5_CASES = [(2550, 6, None, 256, 0, False), (50, 6, None, 256, 0, False), (2550, 4, None, 256, 0, False),
                (2550, 8, None, 256, 0, False), (2550, 6, 1.7, 256, 0, False), (2550, 6, None, 256, 5, False),
                (2550, 6, None, 64, 0, False), (2550, 12, None, 256, 0, False), (2550, 6, None, 256, 0, True),
                (2550, 6, None, 64, 0, True), (2550, 12, None, 256, 0, True)]
DOPRI5_TOL = (1e-7, 1e-8)  # the CLI's rtol, atol
# Kernel and plain solver against the same solve in float64 (rtol 1e-10): at rtol 1e-7 the float32 error estimate
# is rounding noise, so on the real field the two float32 solvers take other steps on most rows, each within its own
# accuracy. The error is relative to the row's largest magnitude of each state; the kernel's, averaged over the rows'
# largest, may be at most DOPRI5_ACCURACY times the plain solver's, and its largest DOPRI5_MAX_ACCURACY times the plain
# solver's largest (a maximum over 2,550 rows of two solvers' step sequences), each plus DOPRI5_ATOL.
DOPRI5_ACCURACY, DOPRI5_MAX_ACCURACY, DOPRI5_ATOL = 1.25, 4.0, 1e-6
DOPRI5_SCORES_RTOL = 1e-6  # a forecast request's six scores, kernel against plain solver
# Phase 3c, DOPRI5 with gradients: (B, D); the gradients' error against float64 (norm of the difference over the
# float64 gradient's), the kernel's at most DOPRI5_ACCURACY times the plain float32 solver's plus DOPRI5_GRAD_ATOL.
DOPRI5_GRAD_CASES = [(50, 6), (50, 12)]
DOPRI5_GRAD_ATOL = 1e-5
# The training paths of phases 5-10 whose decode takes the DOPRI5 pair with gradients (`roche_kernel`): the sim
# hybrid's per-patient DOPRI5 with a frozen expert, host loop, fused loop (one restart, restarts in turn) and DP, the
# flow CLI, the expert member (D = 4). The real track, the lockstep adjoint, vmap restarts, the neural member and
# field (the residual CLI trains one) and the NNLS ensemble must not launch it.
GRAD_ROUTE_PATHS = ("run_simulation", "run_simulation_flow", "run_simulation_members_expert", "fused_gpu",
                    "fused_gpu_host_loop", "fused_seq", "fused_dp")


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, runs: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, calls: int = 100) -> float:
    """Device time of one call with the host's enqueue time hidden.

    The calls are queued behind a GPU spin of ~0.1 s, so the events time
    the device work back to back, whatever the wrapper costs on the host.
    """
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def kernel_inputs(B, D, cohort, gen, hill=None):
    """y0 in the encoder's range, real dose times and amounts, the port's remainder init;
    `hill` replaces both Hill exponents."""
    import torch

    from hybridode_torch.config import RocheConfig
    from hybridode_torch.fields import init_roche_field

    config = RocheConfig() if hill is None else RocheConfig(HillCure=hill, HillPatho=hill)
    field = init_roche_field(gen, D, config, device="cpu")
    y0 = torch.exp(0.3 * torch.randn(B, D, generator=gen)) / 10 + 0.01 * torch.randn(B, D, generator=gen)
    idx = torch.randint(0, cohort.n_sample, (B,), generator=gen)
    times = torch.as_tensor(cohort.dose_time[:, 0], dtype=torch.float32)[idx]
    amounts = torch.as_tensor(cohort.dose_amount, dtype=torch.float32)[idx]
    ml = field["ml_net"][0] if D > 4 else None
    cuda = lambda x: None if x is None else x.detach().to("cuda").contiguous()  # noqa: E731
    return dict(
        y0=cuda(y0), times=cuda(times), amounts=cuda(amounts),
        expert_params={k: cuda(field["expert"][k]) for k in field["expert"].keys()},
        ml_w=cuda(None if ml is None else ml["w"]), ml_b=cuda(None if ml is None else ml["b"]),
        ts=torch.arange(T_GRID, dtype=torch.float32, device="cuda"), n_substeps=N_SUB,
    )


def phase_kernels(cohort, seed):
    import torch

    from hybridode_torch.ops import roche_rk4

    gen = torch.Generator().manual_seed(seed)
    rows = []
    for B, D, hill in KERNEL_CASES:
        inp = kernel_inputs(B, D, cohort, gen, hill)
        with torch.no_grad():
            got = roche_rk4.roche_rk4_trajectory(**inp)
            want = roche_rk4.roche_rk4_trajectory_reference(**inp)
            torch.cuda.synchronize()
            err = (got - want).abs()
            ok = bool(torch.isfinite(got).all()) and bool((err <= ATOL + RTOL * want.abs()).all())
            ms = cuda_ms(lambda: roche_rk4.roche_rk4_trajectory(**inp))
            device_ms = queued_ms(lambda: roche_rk4.roche_rk4_trajectory(**inp))
            plain_ms = cuda_ms(lambda: roche_rk4.roche_rk4_trajectory_reference(**inp), warmup=1, runs=PLAIN_RUNS)
        flops = roche_rk4.roche_rk4_flops(B, D, T_GRID, N_SUB)
        nbytes = 4 * (B * D + 2 * B + 13 + D * (D - 4) + (D - 4) + T_GRID + T_GRID * B * D)
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        row = dict(B=B, D=D, T=T_GRID, n_sub=N_SUB, hill=2.0 if hill is None else hill, **roche_rk4.kernel_info(D),
                   max_abs_err=err.max().item(), ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                   flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes", within_tol=ok)
        print("kernel roche_rk4 " + json.dumps(row), flush=True)
        if not ok:
            raise SystemExit(f"roche_rk4 disagrees with its plain version at B={B} D={D} hill={row['hill']} "
                             f"(max abs err {row['max_abs_err']}, rtol={RTOL} atol={ATOL})")
        rows.append(row)
    return rows


def phase_dopri5(cohort, seed):
    """Phase 3b: the per-row DOPRI5 kernel against the plain per-row solver on the card (`DOPRI5_CASES`), its
    times, and one request of the forecast (`evaluate` of 50 patients, mc 50) through the kernel and through the
    plain solver."""
    import numpy as np
    import torch

    from hybridode_torch.cli.common import build_sim_model
    from hybridode_torch.config import DataConfig
    from hybridode_torch.eval import evaluate
    from hybridode_torch.fields import NO_DOSE_TIME
    from hybridode_torch.inference import init_vi
    from hybridode_torch.ops import contract, roche_dopri5

    gen = torch.Generator().manual_seed(seed)
    rows, faults = [], []
    for B, D, hill, max_steps, no_dose, exact_field in DOPRI5_CASES:
        inp = kernel_inputs(B, D, cohort, gen, hill)
        del inp["n_substeps"]
        if no_dose:
            inp["times"][::no_dose] = NO_DOSE_TIME
        if exact_field:
            for name, value in inp["expert_params"].items():
                value.fill_(value.item() if name in ("HillCure", "HillPatho", "ec50_patho", "kel") else 0.0)
            if inp["ml_w"] is not None:
                inp["ml_w"].zero_()
        solve = dict(rtol=DOPRI5_TOL[0], atol=DOPRI5_TOL[1], max_steps=max_steps)
        with torch.no_grad():
            got, got_st = roche_dopri5.roche_dopri5_per_row(**inp, **solve)
            want, want_st = roche_dopri5.roche_dopri5_per_row_reference(**inp, **solve)
            exact = dopri5_exact(inp)
            torch.cuda.synchronize()
            (err, err_mean), (err_plain, err_mean_plain) = (dopri5_error(ys, exact) for ys in (got, want))
            same_steps = (got_st.n_steps == want_st.n_steps) & (got_st.n_accepted == want_st.n_accepted)
            same_nan = torch.isnan(got) == torch.isnan(want)
            reached = torch.isfinite(got).all(dim=-1)
            ok = (err_mean <= DOPRI5_ACCURACY * err_mean_plain + DOPRI5_ATOL
                  and err <= DOPRI5_MAX_ACCURACY * err_plain + DOPRI5_ATOL
                  and bool((reached[:-1] >= reached[1:]).all()) and torch.equal(got_st.success, reached.all(dim=0)))
            if exact_field:
                ok = ok and bool(same_steps.all()) and torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
            ms = cuda_ms(lambda: roche_dopri5.roche_dopri5_per_row(**inp, **solve))
            device_ms = queued_ms(lambda: roche_dopri5.roche_dopri5_per_row(**inp, **solve))
            plain_ms = cuda_ms(lambda: roche_dopri5.roche_dopri5_per_row_reference(**inp, **solve), warmup=1,
                               runs=PLAIN_RUNS)
        flops = roche_dopri5.roche_dopri5_flops(got_st.n_steps, D)
        nbytes = 4 * (B * D + 2 * B + 13 + D * (D - 4) + (D - 4) + T_GRID + T_GRID * B * D) + 9 * B
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        trials = got_st.n_steps.double()
        row = dict(B=B, D=D, T=T_GRID, hill=2.0 if hill is None else hill, max_steps=max_steps, no_dose_every=no_dose,
                   exact_field=exact_field, **roche_dopri5.kernel_info(D), err=err, err_plain=err_plain,
                   err_mean=err_mean, err_mean_plain=err_mean_plain, max_rel_diff=dopri5_error(got, want)[0],
                   same_steps_share=same_steps.double().mean().item(),
                   same_steps_max_rel_diff=dopri5_error(got[:, same_steps], want[:, same_steps])[0],
                   nan_mismatch_rows=int((~same_nan).any(dim=0).any(dim=-1).sum()),
                   success=int(got_st.success.sum()), success_plain=int(want_st.success.sum()),
                   trials_max=int(trials.max()), trials_mean=trials.mean().item(),
                   trials_max_plain=int(want_st.n_steps.max()), ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                   flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes", within_tol=ok)
        print("kernel roche_dopri5 " + json.dumps(row), flush=True)
        if not ok:
            faults.append(f"roche_dopri5 at B={B} D={D} hill={row['hill']} max_steps={max_steps} exact={exact_field}: "
                          f"error (mean of rows {err_mean}, largest {err}) against the plain solver's ({err_mean_plain}, "
                          f"{err_plain}), a NaN that is no tail, a success unlike its outputs, or on the exact field "
                          "steps or outputs unlike the plain solver's")
        rows.append(row)

    # One forecast request through the kernel and through the plain solver (KERNEL_DEVICES emptied).
    model = build_sim_model("hybrid", DataConfig(), max_steps=256)
    params = init_vi(torch.Generator().manual_seed(seed), model, device="cuda")
    view = copy.copy(cohort)
    view.data_test = {k: v[:, :50] for k, v in cohort.data_test.items()}
    view.test_size = 50

    def request():
        np.random.seed(seed)
        t = time.perf_counter()
        out = evaluate(params, model, view, 50, 5, mc_itr=50, generator=torch.Generator().manual_seed(seed),
                       verbose=False, device="cuda")
        return out, time.perf_counter() - t

    request()
    roche_dopri5.roche_dopri5_per_row.launches = 0
    kernel = [request() for _ in range(EVAL_REPEATS)]
    launches = roche_dopri5.roche_dopri5_per_row.launches
    devices, contract.KERNEL_DEVICES = contract.KERNEL_DEVICES, ()
    try:
        plain = [request() for _ in range(2)]
    finally:
        contract.KERNEL_DEVICES = devices
    gap = max(_rel_diff(a, b) for a, b in zip(kernel[0][0], plain[0][0]))
    line = dict(request_s=[k[1] for k in kernel], request_s_plain=[p[1] for p in plain],
                launches_per_request=launches / EVAL_REPEATS, scores_max_rel_diff=gap)
    print("dopri5 " + json.dumps(line), flush=True)
    if launches != EVAL_REPEATS:
        faults.append(f"expected one roche_dopri5 launch a forecast request, got {launches} in {EVAL_REPEATS}")
    if gap > DOPRI5_SCORES_RTOL:
        faults.append(f"the request's scores through the kernel and the plain solver differ by {gap}")
    if faults:
        raise SystemExit("\n".join(faults))
    return rows, line


def phase_dopri5_grad(cohort, seed):
    """Phase 3c: the per-row DOPRI5 solve with gradients (recording forward, backward) against the plain per-row
    solver's autograd at the training step's shape, and the training step's graph on and off the route."""
    import torch

    from hybridode_torch.cli.common import build_sim_model
    from hybridode_torch.config import DataConfig
    from hybridode_torch.ops import contract, roche_dopri5

    gen = torch.Generator().manual_seed(seed)
    rows, faults = [], []
    for B, D in DOPRI5_GRAD_CASES:
        inp = kernel_inputs(B, D, cohort, gen)
        del inp["n_substeps"]
        g_out = torch.randn((T_GRID, B, D), generator=gen).to("cuda")

        def grads(fn, dtype=torch.float32, **solve):
            x = {k: (None if v is None else {n: t.to(dtype) for n, t in v.items()} if isinstance(v, dict)
                     else v.to(dtype).clone()) for k, v in inp.items()}
            leaves = [x["y0"].requires_grad_(), x["ml_w"].requires_grad_(), x["ml_b"].requires_grad_()]
            ys, _ = fn(**x, **solve)
            return torch.autograd.grad(ys, leaves, g_out.to(dtype))

        kernel = lambda: grads(roche_dopri5.roche_dopri5_per_row_grad)  # noqa: E731
        plain = lambda: grads(roche_dopri5.roche_dopri5_per_row_reference)  # noqa: E731
        got, want = kernel(), plain()
        exact = grads(roche_dopri5.roche_dopri5_per_row_reference, torch.float64, rtol=1e-10, atol=1e-12,
                      max_steps=4096)
        rel = lambda a, b: ((a.double() - b.double()).norm() / b.double().norm()).item()  # noqa: E731
        err, err_plain = [rel(g, e) for g, e in zip(got, exact)], [rel(p, e) for p, e in zip(want, exact)]
        ok = all(math.isfinite(e) and e <= DOPRI5_ACCURACY * p + DOPRI5_GRAD_ATOL for e, p in zip(err, err_plain))
        _, st, record = roche_dopri5.recorded_solve(**inp)
        # The pair's bound from this solve's steps: the forward's operations and bytes as phase 3b counts them, the
        # record written and read back, the backward's operations, the output's gradient read and the gradients
        # written.
        ml, accepted = D - 4, int(st.n_accepted.sum())
        flops = roche_dopri5.roche_dopri5_flops(st.n_steps, D) + roche_dopri5.roche_dopri5_backward_flops(
            st.n_accepted, D, T_GRID)
        inputs = 4 * (2 * B + 13 + D * ml + ml + T_GRID)
        nbytes = (inputs + 4 * (B * D + T_GRID * B * D) + 9 * B + 2 * 4 * accepted * (D + 2)
                  + inputs + 4 * (B + T_GRID * B * D + B * D + B * (D * ml + ml)))
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        row = dict(B=B, D=D, T=T_GRID, **{f"{k}_{name}": v for k in roche_dopri5.KINDS
                                          for name, v in roche_dopri5.kernel_info(D, k).items()},
                   err=err, err_plain=err_plain, rel_diff_plain=[rel(g, p) for g, p in zip(got, want)],
                   accepted_max=int(st.n_accepted.max()), trials_max=int(st.n_steps.max()),
                   ms=cuda_ms(kernel), device_ms=queued_ms(kernel),
                   forward_device_ms=queued_ms(lambda: roche_dopri5.recorded_solve(**inp)),
                   backward_device_ms=queued_ms(lambda: roche_dopri5.backward(
                       inp["times"], inp["amounts"], inp["expert_params"], inp["ml_w"], inp["ml_b"], inp["ts"],
                       record, st.n_accepted, g_out)),
                   plain_ms=cuda_ms(plain, warmup=1, runs=PLAIN_RUNS), flops=flops, bytes=nbytes,
                   bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                   within_tol=ok)
        print("kernel roche_dopri5_grad " + json.dumps(row), flush=True)
        if not ok:
            faults.append(f"roche_dopri5 with gradients at B={B} D={D}: error against float64 {err}, the plain "
                          f"solver's {err_plain}")
        rows.append(row)

    # The training step's graph, on the route and off it (KERNEL_DEVICES emptied).
    model = build_sim_model("hybrid", DataConfig(), max_steps=256)
    params, eps, eps_kl, batch = _first_batch(model, seed)
    graphs = {}
    for route, devices in (("dopri5_grad", contract.KERNEL_DEVICES), ("plain", ())):
        saved, contract.KERNEL_DEVICES = contract.KERNEL_DEVICES, devices
        try:
            graphs[route] = _step_graph(params, model, batch, eps, eps_kl)
        finally:
            contract.KERNEL_DEVICES = saved
    line = dict(step_graph=graphs, loss_rel_diff=_rel_diff(graphs["dopri5_grad"].pop("loss"),
                                                           graphs["plain"].pop("loss")))
    print("dopri5_grad " + json.dumps(line), flush=True)
    if faults:
        raise SystemExit("\n".join(faults))
    return rows, line


def _step_graph(params, model, batch, eps, eps_kl):
    """The sim training step's loss and gradients under `full_budget`, run once eagerly on a side stream, then
    measured as a graph (`_graph_of`) -> its numbers and the eager loss."""
    import torch

    from hybridode_torch.inference import elbo
    from hybridode_torch.solvers import dopri5

    leaves = [p for p in params.parameters() if p.requires_grad]

    def step():
        loss = elbo.sim_loss(params, model, batch, eps=eps, eps_kl=eps_kl)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), dopri5.full_budget():
        loss = step()[0].item()
    torch.cuda.current_stream().wait_stream(stream)
    return dict(_graph_of(step, stream), loss=loss)


def dopri5_exact(inp):
    """The per-row solve of `inp` in float64 at rtol 1e-10, atol 1e-12: the yardstick of both float32 solves."""
    from hybridode_torch.ops import roche_dopri5

    f64 = {k: (None if v is None else {n: x.double() for n, x in v.items()} if isinstance(v, dict) else v.double())
           for k, v in inp.items()}
    ys, _ = roche_dopri5.roche_dopri5_per_row_reference(**f64, rtol=1e-10, atol=1e-12, max_steps=4096)
    return ys


def dopri5_error(ys, exact) -> tuple[float, float]:
    """(largest, mean of the rows' largest) |ys - exact| over the grid points both reached, relative to the largest
    finite |exact| of the row's state over the grid (at least DOPRI5_ATOL)."""
    import torch

    scale = torch.nan_to_num(exact.abs(), nan=0.0).amax(dim=0, keepdim=True).clamp(min=DOPRI5_ATOL)
    both = torch.isfinite(ys) & torch.isfinite(exact)
    err = torch.where(both, (ys.double() - exact.double()).abs() / scale, 0.0)
    if not err.numel():
        return 0.0, 0.0
    rows = err.amax(dim=(0, 2))
    return rows.max().item(), rows.mean().item()


def phase_slice(cohort, args):
    import torch

    from hybridode_torch.cli.common import build_sim_model
    from hybridode_torch.config import DataConfig
    from hybridode_torch.eval import evaluate
    from hybridode_torch.inference import init_vi, load_checkpoint
    from hybridode_torch.ops import roche_rk4

    model = build_sim_model("hybrid", DataConfig(), ode_method="rk4")
    model = model._replace(decoder_spec=model.decoder_spec._replace(ode_step_size=0.125))
    if args.ckpt:
        params, _, _ = load_checkpoint(args.ckpt, model.model_name, device="cuda")
    else:
        params = init_vi(torch.Generator().manual_seed(args.seed), model, device="cuda")

    def run(device, p, verbose):
        t = time.perf_counter()
        out = evaluate(p, model, cohort, batch_size=50, t0=5, mc_itr=50,
                       generator=torch.Generator().manual_seed(args.seed), verbose=verbose, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t

    run("cuda", params, verbose=False)  # warm-up: allocator, library load
    roche_rk4.roche_rk4_trajectory.launches = 0
    gpu, gpu_s = run("cuda", params, verbose=True)
    launches = roche_rk4.roche_rk4_trajectory.launches
    gpu_runs = [run("cuda", params, verbose=False)[1] for _ in range(EVAL_REPEATS)]  # run-to-run spread
    cpu, cpu_s = run("cpu", copy.deepcopy(params).to("cpu"), verbose=False)

    gpu_m, cpu_m = _scores(gpu), _scores(cpu)
    print("slice " + json.dumps(dict(evaluate_s_gpu=gpu_s, evaluate_s_gpu_runs=gpu_runs, evaluate_s_cpu=cpu_s,
                                     launches=launches, gpu=gpu_m, cpu=cpu_m)), flush=True)
    if not all(map(lambda v: v == v and abs(v) != float("inf"), gpu_m.values())):
        raise SystemExit(f"non-finite metrics on the GPU: {gpu_m}")
    if launches != EVAL_LAUNCHES:
        raise SystemExit(f"expected {EVAL_LAUNCHES} roche_rk4 launches in evaluate (one per chunk), got {launches}")
    for k in gpu_m:
        if abs(gpu_m[k] - cpu_m[k]) > METRIC_RTOL * abs(cpu_m[k]):
            raise SystemExit(f"{k}: GPU {gpu_m[k]} vs CPU {cpu_m[k]} beyond rtol={METRIC_RTOL}")
    return launches


def _rel_diff(a: float, b: float) -> float:
    """|a - b| / |b|; 0 when both are the same non-finite value, inf when only one is finite."""
    if not (math.isfinite(a) and math.isfinite(b)):
        return 0.0 if (a == b or (a != a and b != b)) else math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def _optim(niters, test_freq):
    from hybridode_torch.config import OptimConfig

    return OptimConfig(shuffle=False, niters=niters, test_freq=test_freq, early_stop=10, n_restart=1,
                       batch_size=TRAIN_BATCH)


def _logged_run(cli, device, tmp, **kw):
    """A simulation CLI's `run` on `device` on data_s123 with its curve and event logs; -> its curve, per-step
    seconds, evaluate seconds and scores, params, model."""
    from hybridode_torch.config import DataConfig, EvalConfig

    path, curve_path, events_path = tmp + "/", os.path.join(tmp, "curve.csv"), os.path.join(tmp, "events.jsonl")
    t = time.perf_counter()
    params, model, scores = cli.run(data_path=COHORT, sample=1000, data_config=DataConfig(), path=path,
                                    eval_config=EvalConfig(t0=5), val_criterion="forecast", curve_path=curve_path,
                                    events_path=events_path, device=device, **kw)
    seconds = time.perf_counter() - t
    with open(curve_path) as f:
        curve = [[float(x) for x in ln.split(",")] for ln in f if ln.strip()]
    with open(events_path) as f:
        events = [json.loads(ln) for ln in f]
    steps = [e for e in events if e["event"] == "step"]
    return dict(curve=curve, step_s=[e["seconds"] for e in steps], first_loss=steps[0]["train_loss"] if steps else None,
                evaluate=next(e for e in events if e["event"] == "evaluate"), seconds=seconds,
                checkpoint=os.path.exists(path + model.model_name), **_loop_record(events)), params, model, scores


def _loop_record(events):
    """A training loop's windows (seconds of each, from the fused loop's `window` records or, for the host loop,
    between its validations), its graphs' capture seconds and its `done` records."""
    windows = [e["seconds"] for e in events if e["event"] == "window"]
    if not windows:  # the host loop: a window ends at its `val` record
        steps, vals = [e for e in events if e["event"] == "step"], [e for e in events if e["event"] == "val"]
        marks = [steps[0]["t"] - steps[0]["seconds"]] + [e["t"] for e in vals] if steps else []
        windows = [b - a for a, b in zip(marks, marks[1:])]
    return dict(window_s=windows, captures=[(e["graph"], e["seconds"]) for e in events if e["event"] == "capture"],
                done=[e for e in events if e["event"] == "done"])


def _train_run(device, seed, tmp):
    """The main path's CLI (`run_simulation --method hybrid`) on `device`; -> as `_logged_run`."""
    from hybridode_torch.cli import run_simulation

    return _logged_run(run_simulation, device, tmp, seed=seed, elbo=True, eval_only=False, init_path=None,
                       model_method="hybrid", optim_config=_optim(TRAIN_ITERS, TRAIN_TEST_FREQ))


def _aten_counter():
    """A dispatch mode that counts the ATen calls made under it (forward, backward, optimizer)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        calls = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.calls += 1
            return func(*args, **(kwargs or {}))

    return Count()


def _first_batch(model, seed, device="cuda"):
    """run()'s first draws (init, the loop's mini-batch seed, the ELBO's eps) replayed from the seed, and the first
    training batch (chunk 1 % train_chunk, as the loop takes it); -> (params, eps, eps_kl, batch)."""
    import torch

    from hybridode_torch.data import SyntheticCohort
    from hybridode_torch.inference import elbo, init_vi

    gen = torch.Generator().manual_seed(seed)
    params = init_vi(gen, model, device=device)
    torch.randint(0, 2**31 - 1, (), generator=gen)
    eps, eps_kl = elbo.draw_noise(model, TRAIN_BATCH, gen, device)
    cohort = SyntheticCohort.load(COHORT, device=device)
    cohort.set_train_size(1000)
    return params, eps, eps_kl, cohort.get_split("train", TRAIN_BATCH, 1 % max(1, cohort.train_size // TRAIN_BATCH))


def _first_batch_steps(model, seed, device="cuda"):
    """Step counts of iteration 1's per-patient decode (see `_first_batch`)."""
    import torch

    from hybridode_torch.fields import doses_from_actions, roche_field
    from hybridode_torch.inference import elbo
    from hybridode_torch.models import priors
    from hybridode_torch.solvers import odeint_dopri5

    params, eps, eps_kl, batch = _first_batch(model, seed, device)
    spec = model.decoder_spec
    with torch.no_grad():
        loss = elbo.sim_loss(params, model, batch, eps=eps, eps_kl=eps_kl).item()
        mu, log_var = elbo.encode(params, model, batch["measurements"], batch["actions"], batch["masks"])
        z = priors.gaussian_reparameterize(mu, log_var, eps)
        with _aten_counter() as count:
            _, st = odeint_dopri5(roche_field, z, torch.as_tensor(spec.ts, device=device),
                                  (params["decoder"]["ode"], doses_from_actions(batch["actions"], spec.step_size)),
                                  rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps, per_row=True)
    acc, trial = st.n_accepted.float(), st.n_steps.float()
    run = 64 * math.ceil(int(trial.max()) / 64)  # the loop stops at the first chunk boundary after the slowest row
    return dict(accepted_max=int(acc.max()), accepted_mean=acc.mean().item(), trial_max=int(trial.max()),
                trial_mean=trial.mean().item(), trial_steps_run=run, aten_calls_solve=count.calls,
                aten_calls_per_trial_step=count.calls / run, success=bool(st.success.all()), loss=loss), batch


def _traced(fn, activities=("CPU", "CUDA")):
    """fn() under torch.profiler; -> (its result, the sorted (start, end) microseconds of its device kernels, its
    kernel launch calls).

    It reads the profiler's raw events: building its `FunctionEvent` tree
    (`prof.events()`) in Python took most of the script's time once a
    lockstep training step (~1.6 million events) was traced. The
    trace holds its objects in reference cycles that outlive the profiler
    until a full collection, so they are collected here.
    """
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[getattr(ProfilerActivity, a) for a in activities]) as prof:
        out = fn()
    events = prof.profiler.kineto_results.events()
    kernels = sorted((e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3) for e in events
                     if e.device_type() == torch.autograd.DeviceType.CUDA)
    launches = sum(1 for e in events if e.name() in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    del prof, events
    gc.collect()
    return out, kernels, launches


def _profile_probe(params, model, batch, seed):
    """One training iteration's profile in two parts. Now: a warm-up step (its ATen calls counted, the optimizer's
    state made) and a plain step, timed. -> a function that later runs the step under torch.profiler and returns
    the profile: CUDA kernels, host launch calls, busy share.

    A trace with CUDA activity slows every later step of the process by ~1.3x, even once its events are
    collected (`flow_step_study.py`), so `main` traces only after every timed phase.
    """
    import torch

    from hybridode_torch.config import OptimConfig
    from hybridode_torch.inference import make_optimizer, train_step

    optimizer = make_optimizer(OptimConfig().lr, params)

    def step():
        t = time.perf_counter()
        loss = train_step(params, optimizer, model, batch, torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        return time.perf_counter() - t, loss.item()

    with _aten_counter() as count:
        step()
    plain_s, _ = step()

    def trace():
        (profiled_s, loss), kernels, launches = _traced(step)
        busy, end = 0.0, -math.inf
        for a, b in kernels:  # union of the kernels' intervals, in microseconds
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        return dict(step_s=plain_s, profiled_step_s=profiled_s, aten_calls=count.calls, cuda_kernels=len(kernels),
                    launch_calls=launches,
                    device_busy_us=busy if kernels else None,
                    busy_share=(busy * 1e-6 / plain_s) if kernels else None,
                    busy_share_profiled=(busy * 1e-6 / profiled_s) if kernels else None, loss=loss)

    return trace


def _checkpoint_probe(model, seed):
    """The first training batch's per-patient decode with its gradient through the plain solver (the main path's
    solve before the DOPRI5 pair with gradients), without and with `checkpoint_steps`, in turns (off, on, on, off);
    -> the peak device memory each run allocated beyond what was allocated before it, its seconds (the medians), the
    gradients' largest difference and the RK4 launches."""
    import torch

    from hybridode_torch.fields import doses_from_actions, roche_field
    from hybridode_torch.inference import elbo
    from hybridode_torch.models import nn, priors
    from hybridode_torch.ops import roche_rk4
    from hybridode_torch.solvers import odeint_dopri5

    params, eps, _, batch = _first_batch(model, seed)
    spec = model.decoder_spec
    leaves = [p for p in params.parameters() if p.requires_grad]
    ctx = doses_from_actions(batch["actions"], spec.step_size)
    ts = torch.as_tensor(spec.ts, dtype=torch.float32, device="cuda")

    def run(checkpoint_steps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        mu, log_var = elbo.encode(params, model, batch["measurements"], batch["actions"], batch["masks"])
        z = priors.gaussian_reparameterize(mu, log_var, eps)
        h, st = odeint_dopri5(roche_field, z, ts, (params["decoder"]["ode"], ctx), rtol=spec.rtol, atol=spec.atol,
                              max_steps=spec.max_steps, per_row=True, checkpoint_steps=checkpoint_steps)
        x_hat = nn.linear(params["decoder"]["output"], h)
        loss = torch.sum((x_hat - batch["measurements"]) ** 2 * batch["masks"]) / x_hat.shape[1]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t, (torch.cuda.max_memory_allocated() - base) / 2**20, grads, int(st.n_steps.max())

    roche_rk4.roche_rk4_trajectory.launches = 0
    runs = {False: [], True: []}
    for flag in (False, True, True, False):
        runs[flag].append(run(flag))
    launches = roche_rk4.roche_rk4_trajectory.launches
    diff = max(((a - b).abs().max().item() for a, b in zip(runs[False][0][2], runs[True][0][2])
                if a is not None), default=0.0)
    line = {("on" if flag else "off"): dict(step_s=statistics.median(r[0] for r in rs), peak_mb=max(r[1] for r in rs))
            for flag, rs in runs.items()}
    line.update(trial_max=runs[False][0][3], peak_ratio=line["on"]["peak_mb"] / line["off"]["peak_mb"],
                step_s_ratio=line["on"]["step_s"] / line["off"]["step_s"], grads_max_abs_diff=diff,
                roche_rk4_launches=launches)
    return line


def phase_train(args, probes):
    import torch

    from hybridode_torch.ops import roche_rk4

    t0 = time.perf_counter()
    _zero_launches()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs["cuda"], params, model, gpu_scores = _train_run("cuda", args.seed, os.path.join(tmp, "gpu"))
        torch.cuda.synchronize()
        rk4_launches, grad_launches = roche_rk4.roche_rk4_trajectory.launches, _grad_launches()
        runs["cpu"], _, _, cpu_scores = _train_run("cpu", args.seed, os.path.join(tmp, "cpu"))
    steps, batch = _first_batch_steps(model, args.seed)
    probes["train"] = _profile_probe(params, model, batch, args.seed)
    checkpoint = _checkpoint_probe(model, args.seed)

    line = dict(seconds=time.perf_counter() - t0, **_held_pair(runs, gpu_scores, cpu_scores),
                first_batch_steps=steps, roche_rk4_launches=rk4_launches, roche_dopri5_grad_launches=grad_launches,
                checkpoint_steps=checkpoint)
    print("train " + json.dumps(line), flush=True)
    _check_pair(line, TRAIN_ITERS, TRAIN_TEST_FREQ, TRAIN_RTOL)
    if rk4_launches or checkpoint["roche_rk4_launches"]:
        raise SystemExit(f"the RK4 kernel was launched {rk4_launches} times on the DOPRI5 training path and "
                         f"{checkpoint['roche_rk4_launches']} in the checkpoint_steps probe")
    if checkpoint["grads_max_abs_diff"] != 0:
        raise SystemExit(f"checkpoint_steps moved the gradients: {checkpoint}")
    return line


def _scores(scores) -> dict:
    """The four metrics of `evaluate`'s six numbers."""
    return dict(zip(("rmse_z0", "cprs_z0", "rmse_x", "cprs_x"), (scores[0], scores[2], scores[3], scores[5])))


def _losses(curve):
    return [v for row in curve for v in row[1:]]


def _held_pair(runs, gpu_scores, cpu_scores):
    """A training CLI's GPU and CPU runs side by side; -> their summary (see `_check_pair`)."""
    gpu, cpu = runs["cuda"], runs["cpu"]
    gpu_m, cpu_m = _scores(gpu_scores), _scores(cpu_scores)
    return dict(
        iter_s_gpu=statistics.median(gpu["step_s"]), iter_s_cpu=statistics.median(cpu["step_s"]),
        iter_s_gpu_all=gpu["step_s"], iter_s_cpu_all=cpu["step_s"],
        evaluate_s_gpu=gpu["evaluate"]["seconds"], evaluate_s_cpu=cpu["evaluate"]["seconds"],
        run_s_gpu=gpu["seconds"], run_s_cpu=cpu["seconds"], first_loss_gpu=gpu["first_loss"],
        curve_gpu=gpu["curve"], curve_cpu=cpu["curve"],
        curve_max_rel_diff=max((_rel_diff(a, b) for a, b in zip(_losses(gpu["curve"]), _losses(cpu["curve"]))),
                               default=math.inf),
        gpu=gpu_m, cpu=cpu_m, metric_max_rel_diff=max(_rel_diff(gpu_m[k], cpu_m[k]) for k in gpu_m),
        checkpoint_gpu=gpu["checkpoint"], checkpoint_cpu=cpu["checkpoint"],
    )


def _check_pair(pair, iters, test_freq, rtol):
    """Exits on a non-finite GPU metric or loss where the CPU's is finite, a curve of the wrong length, a curve or
    metric beyond `rtol`, or a missing checkpoint."""
    finite = lambda v: v == v and abs(v) != math.inf  # noqa: E731
    for k, v in pair["gpu"].items():
        if finite(pair["cpu"][k]) and not finite(v):
            raise SystemExit(f"{k}: non-finite on the GPU ({v}) where the CPU's is {pair['cpu'][k]}")
    for a, b in zip(_losses(pair["curve_gpu"]), _losses(pair["curve_cpu"])):
        if finite(b) and not finite(a):
            raise SystemExit(f"a GPU training or validation loss is non-finite ({a}) where the CPU's is {b}")
    if len(pair["curve_gpu"]) != iters // test_freq or len(pair["curve_gpu"]) != len(pair["curve_cpu"]):
        raise SystemExit(f"curves of {len(pair['curve_gpu'])} (GPU) and {len(pair['curve_cpu'])} (CPU) validations, "
                         f"expected {iters // test_freq}")
    if pair["curve_max_rel_diff"] > rtol or pair["metric_max_rel_diff"] > rtol:
        raise SystemExit(f"GPU vs CPU beyond rtol={rtol}: curve {pair['curve_max_rel_diff']}, "
                         f"metrics {pair['metric_max_rel_diff']}")
    if not (pair["checkpoint_gpu"] and pair["checkpoint_cpu"]):
        raise SystemExit("the training run wrote no checkpoint")


def _real_run(device, seed, model_dir, method="hybrid", niters=REAL_ITERS, test_freq=REAL_TEST_FREQ, ode_step_div=1):
    """The real CLI's run on `device`; -> its curve, step seconds, predict_test seconds, horizon RMSEs, params, model."""
    import numpy as np

    from hybridode_torch.cli import run_real

    os.makedirs(model_dir, exist_ok=True)
    curve_path, events_path = (os.path.join(model_dir, f"{method}.{ext}") for ext in ("csv", "jsonl"))
    np.random.seed(seed)  # the bootstrap sd column
    t = time.perf_counter()
    params, model, report = run_real.run(
        seed=seed, method=method, niters=niters, ode_step_div=ode_step_div, data_path=REAL_DATA, batch_size=100,
        val_size=100, test_size=1000, encoder_output_dim=4 if method == "expert" else 20, model_dir=model_dir + "/",
        curve_path=curve_path, device=device, test_freq=test_freq, events_path=events_path)
    seconds = time.perf_counter() - t
    with open(curve_path) as f:
        curve = [[float(x) for x in ln.split(",")] for ln in f if ln.strip()]
    with open(events_path) as f:
        events = [json.loads(ln) for ln in f]
    return dict(curve=curve, step_s=[e["seconds"] for e in events if e["event"] == "step"],
                predict_s=next(e["seconds"] for e in events if e["event"] == "predict_test"),
                rmse=[r[1] for r in report], seconds=seconds, **_loop_record(events)), params, model


def _real_pair(seed, tmp, ode_step_div, probes):
    """The hybrid real run on the GPU, then on the CPU; its profile probe (one iteration on iteration 1's batch)
    goes into `probes`."""
    import torch

    from hybridode_torch.data import RealCohort

    gpu, params, model = _real_run("cuda", seed, os.path.join(tmp, f"gpu{ode_step_div}"), ode_step_div=ode_step_div)
    torch.cuda.synchronize()
    cpu, _, _ = _real_run("cpu", seed, os.path.join(tmp, f"cpu{ode_step_div}"), ode_step_div=ode_step_div)
    cohort = RealCohort(REAL_DATA, device="cuda")
    cohort.split_sample()
    first = cohort.get_split("train", 100, 1 % max(1, cohort.train_size // 100))
    probes[f"real_step_div_{ode_step_div}"] = _profile_probe(params, model, first, seed)
    gpu_losses = [v for row in gpu["curve"] for v in row[1:]]
    cpu_losses = [v for row in cpu["curve"] for v in row[1:]]
    return dict(
        ode_step_div=ode_step_div,
        iter_s_gpu=statistics.median(gpu["step_s"]), iter_s_cpu=statistics.median(cpu["step_s"]),
        iter_s_gpu_all=gpu["step_s"], iter_s_cpu_all=cpu["step_s"],
        predict_test_s_gpu=gpu["predict_s"], predict_test_s_cpu=cpu["predict_s"],
        run_s_gpu=gpu["seconds"], run_s_cpu=cpu["seconds"],
        rmse_gpu=gpu["rmse"], rmse_cpu=cpu["rmse"],
        rmse_max_rel_diff=max(_rel_diff(a, b) for a, b in zip(gpu["rmse"], cpu["rmse"])),
        curve_gpu=gpu["curve"], curve_cpu=cpu["curve"],
        curve_max_rel_diff=max((_rel_diff(a, b) for a, b in zip(gpu_losses, cpu_losses)), default=math.inf),
    ), gpu_losses, cpu_losses


def _blend_run(cli, device, seed, init_path, model_dir):
    import numpy as np

    np.random.seed(seed)
    t = time.perf_counter()
    kw = dict(niters=REAL_OTHER_ITERS, model_dir=model_dir + "/") if cli.__name__.endswith("residual") else {}
    report = cli.run(seed=seed, init_path=init_path + "/", data_path=REAL_DATA, device=device, **kw)
    return dict(rmse=[r[1] for r in report], seconds=time.perf_counter() - t)


def phase_real(args, probes):
    import torch

    from hybridode_torch.cli import run_real_ensemble, run_real_residual
    from hybridode_torch.ops import roche_rk4

    finite = lambda v: v == v and abs(v) != math.inf  # noqa: E731
    t0 = time.perf_counter()
    _zero_launches()
    with tempfile.TemporaryDirectory() as tmp:
        cli, cli_gpu_losses, cli_cpu_losses = _real_pair(args.seed, tmp, 1, probes)
        held, _, _ = _real_pair(args.seed, tmp, REAL_HELD_STEP_DIV, probes)

        models = os.path.join(tmp, "models")
        others = {}
        for method in REAL_OTHER_METHODS:
            run, _, _ = _real_run("cuda", args.seed, models, method=method, niters=REAL_OTHER_ITERS,
                                  test_freq=REAL_OTHER_ITERS)
            losses = [v for row in run["curve"] for v in row[1:]]
            others[method] = dict(seconds=run["seconds"], iter_s=run["step_s"], losses=losses, rmse=run["rmse"],
                                  finite=bool(losses) and all(map(finite, losses + run["rmse"])))
        blends = {}
        for blend in (run_real_ensemble, run_real_residual):
            name = blend.__name__.rsplit("_", 1)[1]
            runs = {d: _blend_run(blend, d, args.seed, models, os.path.join(tmp, f"res_{d}")) for d in ("cuda", "cpu")}
            runs["max_rel_diff"] = max(_rel_diff(a, b) for a, b in zip(runs["cuda"]["rmse"], runs["cpu"]["rmse"]))
            blends[name] = runs
    torch.cuda.synchronize()
    rk4_launches = roche_rk4.roche_rk4_trajectory.launches

    line = dict(seconds=time.perf_counter() - t0, cli=cli, held=held, roche_rk4_launches=rk4_launches,
                roche_dopri5_grad_launches=_grad_launches(), methods=others, **blends)
    print("real " + json.dumps(line), flush=True)

    for a, b in zip(cli_gpu_losses + cli["rmse_gpu"], cli_cpu_losses + cli["rmse_cpu"]):
        if finite(b) and not finite(a):
            raise SystemExit(f"a GPU loss or RMSE of the hybrid is non-finite ({a}) where the CPU's is {b}")
    for run in (cli, held):
        if len(run["curve_gpu"]) != REAL_ITERS // REAL_TEST_FREQ or len(run["curve_gpu"]) != len(run["curve_cpu"]):
            raise SystemExit(f"curves of {len(run['curve_gpu'])} (GPU) and {len(run['curve_cpu'])} (CPU) "
                             f"validations, expected {REAL_ITERS // REAL_TEST_FREQ}")
    if held["curve_max_rel_diff"] > REAL_RTOL or held["rmse_max_rel_diff"] > REAL_RTOL:
        raise SystemExit(f"hybrid at ode_step_div={REAL_HELD_STEP_DIV}, GPU vs CPU beyond rtol={REAL_RTOL}: curve "
                         f"{held['curve_max_rel_diff']}, RMSEs {held['rmse_max_rel_diff']}")
    bad = [m for m, r in others.items() if not r["finite"]]
    if bad:
        raise SystemExit(f"non-finite losses or RMSEs on the GPU for {bad}")
    for name, runs in blends.items():
        if runs["max_rel_diff"] > REAL_RTOL:
            raise SystemExit(f"{name}: GPU {runs['cuda']['rmse']} vs CPU {runs['cpu']['rmse']} beyond rtol={REAL_RTOL}")
    if rk4_launches:
        raise SystemExit(f"the RK4 kernel was launched {rk4_launches} times on the real track")
    return line


def _zero_launches():
    """Zero the launch counts of the RK4 kernel and of the DOPRI5 kernel pair with gradients."""
    from hybridode_torch.ops import roche_dopri5, roche_rk4

    roche_rk4.roche_rk4_trajectory.launches = 0
    roche_dopri5.roche_dopri5_per_row_grad.launches = 0


def _grad_launches() -> int:
    """The DOPRI5 pair with gradients' forward launches since `_zero_launches`."""
    from hybridode_torch.ops import roche_dopri5

    return roche_dopri5.roche_dopri5_per_row_grad.launches


def _counted(fn):
    """fn() on the GPU, synchronised; -> (its result, seconds, RK4 kernel launches made in it, launches of the
    DOPRI5 pair with gradients made in it)."""
    import torch

    from hybridode_torch.ops import roche_rk4

    _zero_launches()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, roche_rk4.roche_rk4_trajectory.launches, _grad_launches()


def _both(fn, seed):
    """fn(device) on the GPU (launches counted) and on the CPU, np.random seeded alike for the bootstrap SDs;
    -> dict(gpu, cpu, seconds_gpu, seconds_cpu, roche_rk4_launches, roche_dopri5_grad_launches, max_rel_diff)."""
    import numpy as np

    np.random.seed(seed)
    gpu, gpu_s, launches, grad_launches = _counted(lambda: fn("cuda"))
    np.random.seed(seed)
    t = time.perf_counter()
    cpu = fn("cpu")
    cpu_s = time.perf_counter() - t
    if isinstance(gpu, tuple):  # the six numbers of an evaluation
        gpu, cpu = _scores(gpu), _scores(cpu)
    else:  # the dict of numpy vectors of a horizon evaluation
        gpu, cpu = ({k: [float(x) for x in v] for k, v in d.items()} for d in (gpu, cpu))
    return dict(gpu=gpu, cpu=cpu, seconds_gpu=gpu_s, seconds_cpu=cpu_s, roche_rk4_launches=launches,
                roche_dopri5_grad_launches=grad_launches,
                max_rel_diff=max(_rel_diff(a, b) for a, b in zip(_flat(gpu), _flat(cpu))))


def _flat(values: dict) -> list:
    """The numbers of a dict of numbers and lists, in order."""
    return [x for v in values.values() for x in (v if isinstance(v, list) else [v])]


def _rk4_at_eval_step(model):
    return model._replace(decoder_spec=model.decoder_spec._replace(method="rk4", ode_step_size=0.125))


def phase_sim_more(args, probes):
    """Phase 7: the flow CLI, the flow posterior's RK4 evaluate, the ensemble, residual and run_eval CLIs, and the
    kernel on the horizon and ensemble-horizon paths; each on the GPU and on the CPU from the same seed."""
    import torch

    from hybridode_torch.cli import run_eval, run_simulation, run_simulation_ensemble, run_simulation_flow
    from hybridode_torch.cli import run_simulation_residual
    from hybridode_torch.cli.common import build_sim_model
    from hybridode_torch.config import DataConfig, EvalConfig, OptimConfig
    from hybridode_torch.data import SyntheticCohort
    from hybridode_torch.eval import evaluate, evaluate_ensemble_horizon, evaluate_horizon
    from hybridode_torch.inference import init_vi, load_checkpoint
    from hybridode_torch.ops import roche_rk4

    t0, seed = time.perf_counter(), args.seed
    gen = lambda: torch.Generator().manual_seed(seed)  # noqa: E731
    line, faults = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        # The flow CLI (LHM-NF) on both devices: curves and metrics held, no kernel on its DOPRI5 path.
        runs = {}
        _zero_launches()
        runs["cuda"], params, model, gpu_scores = _logged_run(
            run_simulation_flow, "cuda", os.path.join(tmp, "flow_gpu"), seed=seed, eval_only=False,
            optim_config=_optim(FLOW_ITERS, FLOW_TEST_FREQ))
        torch.cuda.synchronize()
        flow_launches, flow_grad_launches = roche_rk4.roche_rk4_trajectory.launches, _grad_launches()
        runs["cpu"], _, _, cpu_scores = _logged_run(run_simulation_flow, "cpu", os.path.join(tmp, "flow_cpu"),
                                                    seed=seed, eval_only=False,
                                                    optim_config=_optim(FLOW_ITERS, FLOW_TEST_FREQ))
        train = SyntheticCohort.load(COHORT, device="cuda")
        train.set_train_size(1000)
        first = train.get_split("train", TRAIN_BATCH, 1 % max(1, train.train_size // TRAIN_BATCH))
        probes["flow"] = _profile_probe(params, model, first, seed)
        line["flow"] = dict(**_held_pair(runs, gpu_scores, cpu_scores), roche_rk4_launches=flow_launches,
                            roche_dopri5_grad_launches=flow_grad_launches)

        # The flow checkpoint evaluated through the RK4 kernel (GPU) and its plain version (CPU).
        flow_rk4 = _rk4_at_eval_step(model)
        flow_params, _, _ = load_checkpoint(os.path.join(tmp, "flow_gpu") + "/", model.model_name, device="cpu")
        line["flow_evaluate"] = _both(lambda d: evaluate(copy.deepcopy(flow_params).to(d), flow_rk4,
                                                         SyntheticCohort.load(COHORT, device=d), 50, 5,
                                                         generator=gen(), verbose=False, device=d), seed)

        # Expert and neural members (GPU), then the ensemble, residual and run_eval CLIs from their checkpoints.
        members = os.path.join(tmp, "members") + "/"
        seconds, launches, grad_launches = {}, 0, {}
        for method in ("expert", "neural"):
            _, seconds[method], n, grad_launches[method] = _counted(lambda: run_simulation.run(
                seed=seed, elbo=True, eval_only=False, init_path=None, data_path=COHORT, sample=1000,
                data_config=DataConfig(), model_method=method, path=members, optim_config=_optim(MEMBER_ITERS,
                                                                                                  MEMBER_ITERS),
                eval_config=EvalConfig(t0=5), device="cuda"))
            launches += n
        line["members"] = dict(seconds=seconds, roche_rk4_launches=launches, roche_dopri5_grad_launches=grad_launches)
        line["ensemble"] = _both(lambda d: run_simulation_ensemble.run(
            seed, COHORT, 1000, DataConfig(), members, OptimConfig(shuffle=False, n_restart=5), EvalConfig(t0=5),
            device=d), seed)
        line["residual"] = _both(lambda d: run_simulation_residual.run(
            seed, False, COHORT, 1000, DataConfig(), members, os.path.join(tmp, f"res_{d}_"),
            _optim(RESIDUAL_ITERS, RESIDUAL_ITERS), EvalConfig(t0=5), device=d), seed)
        line["run_eval"] = _both(lambda d: run_eval.run(seed, COHORT, DataConfig(), "expert", members,
                                                        OptimConfig(batch_size=50), EvalConfig(t0=5), device=d), seed)

        # The kernel on the horizon paths: the hybrid, and the ensemble of the two members, at RK4.
        hybrid = _rk4_at_eval_step(build_sim_model("hybrid", DataConfig()))
        hybrid_params = init_vi(gen(), hybrid, device="cpu")
        line["evaluate_horizon"] = _both(lambda d: evaluate_horizon(
            copy.deepcopy(hybrid_params).to(d), hybrid, SyntheticCohort.load(COHORT, device=d), 50, 5,
            generator=gen(), device=d), seed)
        pairs = [(load_checkpoint(members, m.model_name, device="cpu")[0], m)
                 for m in (_rk4_at_eval_step(build_sim_model(k, DataConfig())) for k in ("expert", "neural"))]
        line["evaluate_ensemble_horizon"] = _both(lambda d: evaluate_ensemble_horizon(
            *(x for p, m in pairs for x in (copy.deepcopy(p).to(d), m)), SyntheticCohort.load(COHORT, device=d), 50,
            5, generator=gen(), device=d), seed)

    line["seconds"] = time.perf_counter() - t0
    print("sim_more " + json.dumps(line), flush=True)

    _check_pair(line["flow"], FLOW_ITERS, FLOW_TEST_FREQ, SIM_MORE_RTOL)
    for name in ("flow", "members", "ensemble", "residual", "run_eval"):  # DOPRI5 paths
        if line[name]["roche_rk4_launches"]:
            faults.append(f"{name}: the RK4 kernel was launched {line[name]['roche_rk4_launches']} times on a "
                          "DOPRI5 path")
    for name in ("flow_evaluate", "ensemble", "residual", "run_eval", "evaluate_horizon", "evaluate_ensemble_horizon"):
        run = line[name]
        if not all(math.isfinite(x) for x in _flat(run["gpu"])):
            faults.append(f"{name}: non-finite values on the GPU: {run['gpu']}")
        if run["max_rel_diff"] > SIM_MORE_RTOL:
            faults.append(f"{name}: GPU vs CPU {run['max_rel_diff']} beyond rtol={SIM_MORE_RTOL}")
    for name in ("run_eval", "evaluate_horizon", "evaluate_ensemble_horizon"):
        if any(len(v) != HORIZON_STEPS for v in line[name]["gpu"].values()):
            faults.append(f"{name}: horizon vectors are not of length {HORIZON_STEPS}")
    for name in ("flow_evaluate", "evaluate_horizon", "evaluate_ensemble_horizon"):
        if line[name]["roche_rk4_launches"] != EVAL_LAUNCHES:
            faults.append(f"{name}: expected {EVAL_LAUNCHES} roche_rk4 launches (one per chunk), got "
                          f"{line[name]['roche_rk4_launches']}")
    if faults:
        raise SystemExit("; ".join(faults))
    return line


def cohort_faults(got: dict, want: dict) -> list:
    """A generated cohort file's state against the committed one's; -> what disagrees (empty when all agree)."""
    import numpy as np

    faults = [f"{k} is missing" for k in sorted(set(want) - set(got))]
    for k in DRAWN:
        if k in got and not (got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
                             and got[k].tobytes() == want[k].tobytes()):
            faults.append(f"{k} is not byte-equal to the committed file's")
    for k, rtol, atol in (("latents", 1e-5, 1e-6), ("measurements", 0.0, 1e-5)):
        if k not in got:
            continue
        if got[k].shape != want[k].shape:
            faults.append(f"{k}: shape {got[k].shape}, the committed file's {want[k].shape}")
            continue
        diff = np.abs(got[k].astype(np.float64) - want[k].astype(np.float64))
        bad = ~(diff <= atol + rtol * np.abs(want[k].astype(np.float64)))
        if bad.any():
            faults.append(f"{k}: {int(bad.sum())} entries beyond rtol={rtol} atol={atol} (max abs diff {diff.max()})")
    return faults


def _generate(device, out):
    """`create_data --which train --seed 123` on `device`, its file held against data_s123's; -> (its line, the
    file's state)."""
    from hybridode_torch.cli import create_data
    from hybridode_torch.utils.pickling import load_pickle

    t = time.perf_counter()
    ((path, cohort),) = create_data.main(["--which", "train", "--seed", "123", "--out", out]
                                         + (["--device", "c"] if device == "cpu" else [])).items()
    seconds = time.perf_counter() - t  # the latents were read back to the host before the file was written
    st, state = cohort.solve_stats, load_pickle(path)["state"]
    return dict(seconds=seconds, trial_steps=int(st.n_steps), accepted_steps=int(st.n_accepted),
                success=bool(st.success), faults=cohort_faults(state, load_pickle(COHORT)["state"])), state


def _generate_native(gpu_state):
    """The seed-123 training cohort with the native C++ solve on the host, held against data_s123's file and, its
    latents, against the GPU generator's within NATIVE_RTOL / NATIVE_ATOL."""
    import numpy as np

    from hybridode_torch import native
    from hybridode_torch.data import SyntheticCohort
    from hybridode_torch.data.synthetic import TRAIN_COHORT
    from hybridode_torch.utils.pickling import load_pickle

    t = time.perf_counter()
    native.available()  # the library's build, timed apart
    build_s = time.perf_counter() - t
    cohort = SyntheticCohort(rng=np.random.RandomState(123), device="cpu", **TRAIN_COHORT)
    t = time.perf_counter()
    cohort.generate_data(backend="native")
    cohort.split_sample()
    seconds = time.perf_counter() - t
    state = {k: getattr(cohort, k) for k in DRAWN + ("latents", "measurements")}
    diff = np.abs(cohort.latents.astype(np.float64) - gpu_state["latents"].astype(np.float64))
    bad = ~(diff <= NATIVE_ATOL + NATIVE_RTOL * np.abs(gpu_state["latents"].astype(np.float64)))
    committed = load_pickle(COHORT)["state"]
    return dict(seconds=seconds, build_s=build_s, faults=cohort_faults(state, {k: committed[k] for k in state}),
                latents_max_abs_diff_vs_gpu=float(diff.max()), latents_beyond_tol_vs_gpu=int(bad.sum()))


def _lockstep_restarts(seed, tmp):
    """The lockstep hybrid's restarts batched (`--restart_mode vmap`) and in turn (`seq`) on the card, the fused
    loop (uncaptured on the adjoint solver); -> their seconds, validations, checkpoints and RK4 launches."""
    from hybridode_torch.cli import run_simulation
    from hybridode_torch.inference import load_checkpoint

    out = {}
    for mode in ("vmap", "seq"):
        optim = dataclasses.replace(_optim(LOCKSTEP_VMAP_ITERS, LOCKSTEP_VMAP_TEST_FREQ), n_restart=LOCKSTEP_RESTARTS)
        path = os.path.join(tmp, f"lockstep_{mode}")
        with _fused_loop(True):
            (run, _, model, scores), _, launches, grad_launches = _counted(lambda: _logged_run(
                run_simulation, "cuda", path, seed=seed, elbo=True, eval_only=False, init_path=None,
                model_method="hybrid", optim_config=optim, lockstep=True, restart_mode=mode))
        _, best_itr, best = load_checkpoint(path + "/", model.model_name, device="cpu")
        with open(os.path.join(path, "events.jsonl")) as f:
            vals = [json.loads(ln) for ln in f]
        vals = [(v.get("restart"), v["itr"], v["val_loss"]) for v in vals if v["event"] == "val"]
        train_s = sum(d["wall"] for d in run["done"])
        out[mode] = dict(train_s=train_s, iter_s=train_s / (LOCKSTEP_RESTARTS * LOCKSTEP_VMAP_ITERS),
                         evaluate_s=run["evaluate"]["seconds"], run_s=run["seconds"], val=vals, best_loss=best,
                         best_itr=best_itr, metrics=_scores(scores), roche_rk4_launches=launches,
                         roche_dopri5_grad_launches=grad_launches)
    seq_first = [v for _, _, v in out["seq"]["val"]][::LOCKSTEP_VMAP_ITERS // LOCKSTEP_VMAP_TEST_FREQ]
    vmap_first = [next(v for r, _, v in out["vmap"]["val"] if r == lane) for lane in range(LOCKSTEP_RESTARTS)]
    out["first_val_max_rel_diff"] = max(map(_rel_diff, vmap_first, seq_first))
    out["best_rel_diff"] = _rel_diff(out["vmap"]["best_loss"], out["seq"]["best_loss"])
    out["train_s_ratio"] = out["vmap"]["train_s"] / out["seq"]["train_s"]
    return out


def _first_batch_lockstep_steps(model, params, eps, batch):
    """Trial, accepted and recorded steps of iteration 1's lockstep decode on the adjoint solver, under grad."""
    from hybridode_torch.fields import doses_from_actions, roche_field
    from hybridode_torch.inference import elbo
    from hybridode_torch.models import priors
    from hybridode_torch.solvers import odeint_dopri5_adjoint

    spec = model.decoder_spec
    mu, log_var = elbo.encode(params, model, batch["measurements"], batch["actions"], batch["masks"])
    z = priors.gaussian_reparameterize(mu, log_var, eps)
    _, st = odeint_dopri5_adjoint(roche_field, z, spec.ts, (params["decoder"]["ode"],
                                  doses_from_actions(batch["actions"], spec.step_size)), rtol=spec.rtol,
                                  atol=spec.atol, max_steps=spec.max_steps, max_record=spec.max_record)
    return dict(trial=int(st.n_steps), accepted=int(st.n_accepted), recorded=min(int(st.n_accepted), spec.max_record),
                recorded_all=bool(st.recorded_all), success=bool(st.success), z_requires_grad=z.requires_grad)


def _adjoint_vs_backprop(model, params, eps, eps_kl, batch):
    """One batch's `sim_loss` gradient with the adjoint and with backprop through the same lockstep solve."""
    import torch

    from hybridode_torch.inference import elbo

    runs = {}
    backprop = model._replace(decoder_spec=model.decoder_spec._replace(use_adjoint=False))
    for name, m in (("adjoint", model), ("backprop", backprop)):
        params.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = elbo.sim_loss(params, m, batch, eps=eps, eps_kl=eps_kl)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        runs[name] = (dict(loss=loss.item(), forward_s=t1 - t, backward_s=time.perf_counter() - t1),
                      {n: p.grad.clone() for n, p in params.named_parameters() if p.grad is not None})
    (adj, g_adj), (bp, g_bp) = runs["adjoint"], runs["backprop"]
    leaves = {}
    for n, b in g_bp.items():
        a = g_adj.get(n, torch.full_like(b, math.nan))
        excess = (a - b).abs() - (ADJOINT_ATOL + ADJOINT_RTOL * b.abs())
        leaves[n] = dict(max_abs_diff=(a - b).abs().max().item(), max_abs=b.abs().max().item(),
                         ok=bool((excess <= 0).all()))
    return dict(adjoint=adj, backprop=bp, leaves=leaves, same_leaves=sorted(g_adj) == sorted(g_bp),
                ok=sorted(g_adj) == sorted(g_bp) and all(v["ok"] for v in leaves.values()))


def phase_lockstep(args, probes):
    """Phase 8: create_data against data_s123 on both devices, the lockstep CLI on both, the adjoint against
    backprop on the card."""
    import torch

    from hybridode_torch.cli import run_simulation
    from hybridode_torch.ops import roche_rk4

    t0 = time.perf_counter()
    line = {}
    with tempfile.TemporaryDirectory() as tmp:
        roche_rk4.roche_rk4_trajectory.launches = 0
        gpu, gpu_state = _generate("cuda", os.path.join(tmp, "gen_gpu"))
        torch.cuda.synchronize()
        launches = roche_rk4.roche_rk4_trajectory.launches
        line["create_data"] = dict(gpu=gpu, cpu=_generate("cpu", os.path.join(tmp, "gen_cpu"))[0],
                                   roche_rk4_launches=launches)
        roche_rk4.roche_rk4_trajectory.launches = 0
        line["create_data"]["native"] = _generate_native(gpu_state)
        line["create_data"]["native"]["roche_rk4_launches"] = roche_rk4.roche_rk4_trajectory.launches

        runs, kw = {}, dict(seed=args.seed, elbo=True, eval_only=False, init_path=None, model_method="hybrid",
                            optim_config=_optim(LOCKSTEP_ITERS, LOCKSTEP_TEST_FREQ), lockstep=True)
        _zero_launches()
        runs["cuda"], params, model, gpu_scores = _logged_run(run_simulation, "cuda", os.path.join(tmp, "gpu"), **kw)
        torch.cuda.synchronize()
        launches, grad_launches = roche_rk4.roche_rk4_trajectory.launches, _grad_launches()
        runs["cpu"], _, _, cpu_scores = _logged_run(run_simulation, "cpu", os.path.join(tmp, "cpu"), **kw)
        line["restarts"] = _lockstep_restarts(args.seed, tmp)
    first = _first_batch(model, args.seed)
    steps = _first_batch_lockstep_steps(model, first[0], first[1], first[3])
    line["adjoint_vs_backprop"] = _adjoint_vs_backprop(model, *first)
    probes["lockstep"] = _profile_probe(params, model, first[3], args.seed)
    line["train"] = dict(**_held_pair(runs, gpu_scores, cpu_scores), first_batch_steps=steps,
                         roche_rk4_launches=launches, roche_dopri5_grad_launches=grad_launches)
    line["seconds"] = time.perf_counter() - t0
    print("lockstep " + json.dumps(line), flush=True)

    faults = []
    for device in ("gpu", "cpu"):
        gen = line["create_data"][device]
        faults += [f"create_data on the {device}: {f}" for f in gen["faults"]]
        if not gen["success"]:
            faults.append(f"create_data on the {device}: the ground-truth solve did not finish")
    gen = line["create_data"]["native"]
    faults += [f"native generation: {f}" for f in gen["faults"]]
    if gen["latents_beyond_tol_vs_gpu"]:
        faults.append(f"native generation: {gen['latents_beyond_tol_vs_gpu']} latents beyond rtol={NATIVE_RTOL} "
                      f"atol={NATIVE_ATOL} of the GPU generator's")
    restarts = line["restarts"]
    if restarts["first_val_max_rel_diff"] > LOCKSTEP_VMAP_RTOL or restarts["best_rel_diff"] > LOCKSTEP_VMAP_RTOL or \
            restarts["vmap"]["best_itr"] != restarts["seq"]["best_itr"] or \
            len(restarts["vmap"]["val"]) != len(restarts["seq"]["val"]):
        faults.append(f"lockstep vmap against seq beyond rtol={LOCKSTEP_VMAP_RTOL}: {restarts}")
    if not (steps["success"] and steps["recorded_all"] and steps["z_requires_grad"]):
        faults.append(f"the first batch's lockstep decode: {steps}")
    if not line["adjoint_vs_backprop"]["ok"]:
        faults.append(f"adjoint against backprop beyond rtol={ADJOINT_RTOL} atol={ADJOINT_ATOL}: "
                      f"{line['adjoint_vs_backprop']['leaves']}")
    for name, launched in (("create_data", line["create_data"]["roche_rk4_launches"]),
                           ("native generation", gen["roche_rk4_launches"]),
                           ("train", line["train"]["roche_rk4_launches"]),
                           ("lockstep vmap", restarts["vmap"]["roche_rk4_launches"]),
                           ("lockstep seq", restarts["seq"]["roche_rk4_launches"])):
        if launched:
            faults.append(f"{name}: the RK4 kernel was launched {launched} times")
    if faults:
        raise SystemExit("; ".join(faults))
    _check_pair(line["train"], LOCKSTEP_ITERS, LOCKSTEP_TEST_FREQ, LOCKSTEP_RTOL)
    return line


@contextlib.contextmanager
def _fused_loop(on: bool):
    """Training through the fused loop (`on`) or the host loop, by the port's switch HYBRIDODE_FUSED."""
    before = os.environ.get("HYBRIDODE_FUSED")
    os.environ["HYBRIDODE_FUSED"] = "1" if on else "0"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("HYBRIDODE_FUSED")
        else:
            os.environ["HYBRIDODE_FUSED"] = before


def _graph_measure(run):
    """A fused run's step captured once more, on its stream, into a graph that keeps its cudaGraph_t; -> as
    `_graph_of`. The run's own graphs are instantiated as they are captured and keep nothing to count. The replays
    step the finished run's parameters, which nothing reads any more."""
    return _graph_of(run.step.fn, run.step.stream)


def _graph_of(fn, stream):
    """`fn` captured under `full_budget` on `stream` (which has run it eagerly before) into a graph that keeps its
    cudaGraph_t; -> its nodes (cuGraphGetNodes), capture and instantiation seconds, one replay's device milliseconds
    (CUDA events) and wall milliseconds (host clock to a sync), and their ratio, the device's busy share during a
    replay. (A torch.profiler trace of a replay ended the process with a segmentation fault on the H100, so none is
    taken.)
    """
    import ctypes
    import gc

    import torch

    from hybridode_torch.solvers import dopri5

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    gc.collect()
    gc.disable()
    try:
        t = time.perf_counter()
        with torch.cuda.graph(graph, stream=stream), dopri5.full_budget():
            fn()
        capture_s = time.perf_counter() - t
    finally:
        gc.enable()
    nodes = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                                                     ctypes.byref(nodes))
    t = time.perf_counter()
    graph.instantiate()
    instantiate_s = time.perf_counter() - t
    device_ms = cuda_ms(graph.replay, warmup=1, runs=3)
    t = time.perf_counter()
    graph.replay()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    return dict(nodes=nodes.value if rc == 0 else None, capture_s=capture_s, instantiate_s=instantiate_s,
                replay_device_ms=device_ms, replay_wall_ms=wall_ms, busy_share=device_ms / wall_ms)


def _steady_iter_s(run, test_freq):
    """Seconds an iteration of the last window (all graph replays on the fused GPU path), validation included."""
    return run["window_s"][-1] / test_freq if run["window_s"] else None


def _curve_rel_diff(a, b):
    return max((_rel_diff(x, y) for x, y in zip(_losses(a), _losses(b))), default=math.inf)


def phase_fused(args):
    """Phase 9: the fused loop, GPU captured against CPU and against the GPU host loop; the real step captured;
    `--restart_mode vmap` against `seq`."""
    import torch

    from hybridode_torch.cli import run_simulation
    from hybridode_torch.config import OptimConfig
    from hybridode_torch.inference import fused, load_checkpoint

    t0, seed = time.perf_counter(), args.seed
    line, faults, launches, grad_launches = {}, [], {}, {}

    def sim(device, tmp, on, **kw):
        kw = dict(dict(niters=FUSED_ITERS, test_freq=FUSED_TEST_FREQ, n_restart=1), **kw)
        optim = OptimConfig(shuffle=False, niters=kw.pop("niters"), test_freq=kw.pop("test_freq"), early_stop=10,
                            n_restart=kw.pop("n_restart"), batch_size=TRAIN_BATCH)
        with _fused_loop(on):
            (run, params, model, scores), _, n, n_grad = _counted(lambda: _logged_run(
                run_simulation, device, tmp, seed=seed, elbo=True, eval_only=False, init_path=None,
                model_method="hybrid", optim_config=optim, **kw))
        run["scores"] = _scores(scores)
        return run, model, (n, n_grad)

    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        runs["gpu_fused"], model, (launches["gpu"], grad_launches["gpu"]) = sim("cuda", os.path.join(tmp, "gpu_fused"),
                                                                               True)
        line["step_graph"] = _graph_measure(fused._LAST_RUN)
        runs["cpu_fused"], _, _ = sim("cpu", os.path.join(tmp, "cpu_fused"), True, niters=FUSED_TEST_FREQ)
        runs["gpu_host"], _, (launches["gpu_host_loop"], grad_launches["gpu_host_loop"]) = sim(
            "cuda", os.path.join(tmp, "gpu_host"), False, niters=FUSED_TEST_FREQ)
        for name, run in runs.items():
            line[name] = dict(iter_s=_steady_iter_s(run, FUSED_TEST_FREQ), window_s=run["window_s"],
                              captures=run["captures"], train_s=run["done"][-1]["wall"],
                              evaluate_s=run["evaluate"]["seconds"], run_s=run["seconds"], curve=run["curve"],
                              metrics=run["scores"], step_s_median=statistics.median(run["step_s"])
                              if run["step_s"] else None)
        for name, other in (("gpu_vs_cpu", runs["cpu_fused"]), ("gpu_vs_host_loop", runs["gpu_host"]),
                            ("host_loop_vs_cpu", None)):
            a, b = (runs["gpu_host"], runs["cpu_fused"]) if other is None else (runs["gpu_fused"], other)
            same_length = len(a["curve"]) == len(b["curve"])  # else the metrics are of runs of other lengths
            line[name] = dict(held_rows_max_rel_diff=_curve_rel_diff(a["curve"][:FUSED_HELD_ROWS],
                                                                     b["curve"][:FUSED_HELD_ROWS]),
                              curve_max_rel_diff=_curve_rel_diff(a["curve"], b["curve"]),
                              metric_max_rel_diff=max(_rel_diff(a["scores"][k], b["scores"][k]) for k in a["scores"])
                              if same_length else None)
        line["speedup_vs_host_loop"] = line["gpu_host"]["iter_s"] / line["gpu_fused"]["iter_s"]
        line["speedup_vs_cpu"] = line["cpu_fused"]["iter_s"] / line["gpu_fused"]["iter_s"]

        # The real hybrid, captured, against the CPU at two steps an hour.
        with _fused_loop(True):
            (real_gpu, _, _), _, launches["real"], grad_launches["real"] = _counted(lambda: _real_run(
                "cuda", seed, os.path.join(tmp, "real_gpu"), ode_step_div=REAL_HELD_STEP_DIV))
            line["real_step_graph"] = _graph_measure(fused._LAST_RUN)
            real_cpu, _, _ = _real_run("cpu", seed, os.path.join(tmp, "real_cpu"), ode_step_div=REAL_HELD_STEP_DIV)
        line["real"] = dict(iter_s_gpu=_steady_iter_s(real_gpu, REAL_TEST_FREQ),
                            iter_s_cpu=_steady_iter_s(real_cpu, REAL_TEST_FREQ), window_s_gpu=real_gpu["window_s"],
                            window_s_cpu=real_cpu["window_s"], captures=real_gpu["captures"],
                            predict_test_s_gpu=real_gpu["predict_s"], rmse_gpu=real_gpu["rmse"],
                            rmse_cpu=real_cpu["rmse"], curve_gpu=real_gpu["curve"], curve_cpu=real_cpu["curve"],
                            curve_max_rel_diff=_curve_rel_diff(real_gpu["curve"], real_cpu["curve"]),
                            rmse_max_rel_diff=max(_rel_diff(a, b) for a, b in zip(real_gpu["rmse"], real_cpu["rmse"])))

        # Every restart in one batched program against one after another, from one seed.
        batched = {}
        for mode in ("vmap", "seq"):
            path = os.path.join(tmp, mode)
            run, model, (launches[mode], grad_launches[mode]) = sim(
                "cuda", path, True, niters=VMAP_ITERS, test_freq=VMAP_TEST_FREQ, n_restart=FUSED_RESTARTS,
                restart_mode=mode)
            _, best_itr, best = load_checkpoint(path + "/", model.model_name, device="cpu")
            batched[mode] = dict(train_s=sum(d["wall"] for d in run["done"]), window_s=run["window_s"],
                                 captures=run["captures"], best_loss=best, best_itr=best_itr, run_s=run["seconds"])
        batched["train_s_ratio"] = batched["vmap"]["train_s"] / batched["seq"]["train_s"]
        # The last window of the batched run against the last window of one sequential restart.
        batched["steady_window_ratio"] = batched["vmap"]["window_s"][-1] / batched["seq"]["window_s"][-1]
        line["vmap"] = batched
    line["roche_rk4_launches"] = launches
    line["roche_dopri5_grad_launches"] = grad_launches
    line["seconds"] = time.perf_counter() - t0
    print("fused " + json.dumps(line), flush=True)

    for name in ("gpu_vs_cpu", "gpu_vs_host_loop"):
        if line[name]["held_rows_max_rel_diff"] > TRAIN_RTOL:
            faults.append(f"fused {name} beyond rtol={TRAIN_RTOL} on the first {FUSED_HELD_ROWS} validations: "
                          f"{line[name]}")
    for name, windows in (("gpu_fused", FUSED_ITERS // FUSED_TEST_FREQ), ("cpu_fused", 1), ("gpu_host", 1)):
        if len(line[name]["curve"]) != windows:
            faults.append(f"{name}: {len(line[name]['curve'])} validations, expected {windows}")
        if not all(math.isfinite(v) for v in _losses(line[name]["curve"]) + list(line[name]["metrics"].values())):
            faults.append(f"{name}: non-finite losses or metrics")
    for name, captures in (("gpu_fused", line["gpu_fused"]["captures"]), ("real", line["real"]["captures"]),
                           ("vmap", batched["vmap"]["captures"])):
        if sorted({g for g, _ in captures}) != ["step", "validation"]:
            faults.append(f"{name}: the step and the validation were not both captured ({captures})")
    if line["cpu_fused"]["captures"] or line["gpu_host"]["captures"]:
        faults.append("a CPU or host-loop run captured a graph")
    if line["real"]["curve_max_rel_diff"] > REAL_RTOL or line["real"]["rmse_max_rel_diff"] > REAL_RTOL:
        faults.append(f"real hybrid captured vs CPU beyond rtol={REAL_RTOL}: {line['real']['curve_max_rel_diff']}, "
                      f"{line['real']['rmse_max_rel_diff']}")
    if _rel_diff(batched["vmap"]["best_loss"], batched["seq"]["best_loss"]) > FUSED_BEST_RTOL or \
            batched["vmap"]["best_itr"] != batched["seq"]["best_itr"]:
        faults.append(f"vmap selected {batched['vmap']['best_loss']} at {batched['vmap']['best_itr']}, seq "
                      f"{batched['seq']['best_loss']} at {batched['seq']['best_itr']}")
    if any(launches.values()):
        faults.append(f"the RK4 kernel was launched on a fused path: {launches}")
    if faults:
        raise SystemExit("; ".join(faults))
    torch.cuda.synchronize()
    return line


def _dryrun_start():
    """The CPU dryrun of DRYRUN_RANKS gloo ranks, started in the background (its ranks take one core each)."""
    return subprocess.Popen([sys.executable, "-m", "hybridode_torch.parallel.dryrun", str(DRYRUN_RANKS), "--device",
                             "c"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _dryrun_wait(proc, t_start):
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    lines = out.splitlines()
    missing = [want for want in DRYRUN_LINES if not any(ln.startswith(want) and ln.endswith("OK") for ln in lines)]
    return dict(rc=proc.returncode, seconds=time.perf_counter() - t_start, ok_lines=[ln for ln in lines if
                                                                                        ln.endswith("OK")],
                missing=missing, stderr_tail=err[-2000:] if proc.returncode else "")


def phase_parallel(args, fused_line):
    """Phase 10: the DP fused restart on a world of one NCCL rank, captured (its all-reduces in the step's and the
    validation's graphs), against phase 9's captured run from the same seed; `evaluate_sharded` on a 1 x 1 (data,
    mc) mesh at RK4 against `evaluate`; `--dp 2` refused on a one-GPU machine, the two-world check on a machine of
    several; the 4-rank CPU dryrun."""
    import torch

    from hybridode_torch.cli import common, run_simulation
    from hybridode_torch.config import DataConfig
    from hybridode_torch.data import SyntheticCohort
    from hybridode_torch.eval import evaluate
    from hybridode_torch.inference import fused, init_vi, variational_training_loop
    from hybridode_torch.ops import roche_rk4
    from hybridode_torch.parallel import close_world, evaluate_sharded, init_world, make_mesh, make_mesh_2d
    from hybridode_torch.parallel.mesh import all_reduce_sum

    t0, seed, line, faults = time.perf_counter(), args.seed, {}, []
    dryrun = _dryrun_start()
    with tempfile.TemporaryDirectory() as tmp:
        init_world(0, 1, os.path.join(tmp, "store"), "cuda")
        try:
            # Phase 9's `run_simulation.run` (one restart) through the DP entry: the same draws, a mesh of one rank.
            generator = torch.Generator().manual_seed(seed)
            cohort = SyntheticCohort.load(COHORT, device="cuda")
            cohort.set_train_size(1000)
            model = common.build_sim_model("hybrid", DataConfig(), elbo=True)
            gen_init, gen_train = common.restart_generators(generator)
            params = init_vi(gen_init, model, device="cuda")
            events = os.path.join(tmp, "dp.jsonl")
            calls = all_reduce_sum.calls
            (_, best, _), train_s, launches, grad_launches = _counted(lambda: variational_training_loop(
                niters=FUSED_ITERS, data_generator=cohort, model=model, params=params, batch_size=TRAIN_BATCH,
                lr=0.01, test_freq=FUSED_TEST_FREQ, generator=gen_train, path=os.path.join(tmp, "dp_"),
                early_stop=10, shuffle=False, val_criterion="forecast", val_t0=5, events_path=events,
                mesh=make_mesh(1), fused=True, verbose=False))
            calls_run = all_reduce_sum.calls - calls
            with open(events) as f:
                recs = [json.loads(ln) for ln in f]
            run = _loop_record(recs)
            curve = [[r["itr"], r["val_loss"], r["train_loss"]] for r in recs if r["event"] == "val"]
            calls = all_reduce_sum.calls
            graph = _graph_measure(fused._LAST_RUN)
            graph["all_reduce_calls"] = all_reduce_sum.calls - calls
            ref = fused_line["gpu_fused"]
            line["dp_fused"] = dict(
                iter_s=_steady_iter_s(run, FUSED_TEST_FREQ), window_s=run["window_s"], captures=run["captures"],
                train_s=train_s, curve=curve, best_loss=best, all_reduce_calls_run=calls_run, step_graph=graph,
                first_val_rel_diff=_rel_diff(curve[0][1], ref["curve"][0][1]) if curve and ref["curve"] else math.inf,
                curve_max_rel_diff=_curve_rel_diff(curve, ref["curve"]),
                iter_s_non_dp=ref["iter_s"], iter_s_ratio=_steady_iter_s(run, FUSED_TEST_FREQ) / ref["iter_s"],
                roche_rk4_launches=launches, roche_dopri5_grad_launches=grad_launches)

            # The 2-D evaluation on a 1 x 1 mesh of the hybrid at RK4, against `evaluate` from one generator seed.
            model_rk4 = _rk4_at_eval_step(model)
            params_rk4 = init_vi(torch.Generator().manual_seed(seed), model_rk4, device="cuda")
            mesh = make_mesh_2d(1, 1)
            evaluate(params_rk4, model_rk4, cohort, TRAIN_BATCH, 5, verbose=False, device="cuda")  # the kernel's load
            sharded, sharded_s, sharded_launches, _ = _counted(lambda: evaluate_sharded(
                params_rk4, model_rk4, cohort, TRAIN_BATCH, 5, mesh, generator=torch.Generator().manual_seed(seed),
                verbose=False, device="cuda"))
            plain, plain_s, plain_launches, _ = _counted(lambda: evaluate(
                params_rk4, model_rk4, cohort, TRAIN_BATCH, 5, generator=torch.Generator().manual_seed(seed),
                verbose=False, device="cuda"))
            line["evaluate_sharded"] = dict(
                seconds=sharded_s, evaluate_s=plain_s, roche_rk4_launches=sharded_launches,
                evaluate_launches=plain_launches, metrics=_scores(sharded), evaluate_metrics=_scores(plain),
                equal_at_4_decimals=all(f"{sharded[i]:.4f}" == f"{plain[i]:.4f}" for i in (0, 2, 3, 5)))

            # `--dp 2` on a machine of one GPU: the mesh error before any rank starts.
            gpus = torch.cuda.device_count()
            refusal = f"not run: {gpus} GPUs visible"
            if gpus == 1:
                try:
                    run_simulation.main(["--dp", "2", "--data_path", COHORT, "--path", os.path.join(tmp, "refused_")])
                    refusal = "no error"
                except ValueError as e:
                    refusal = str(e)
            line["refusal"] = refusal
        finally:
            close_world()
        if gpus > 1:  # worlds of 2 GPUs, once this process has left its world
            import multigpu_study

            line["multi_gpu"] = multigpu_study.two_worlds(tmp, "cuda", MULTI_GPU_TIMEOUT)
        else:
            line["multi_gpu"] = f"not run: {gpus} GPU visible"
    line["dryrun"] = _dryrun_wait(dryrun, t0)
    line["seconds"] = time.perf_counter() - t0
    print("parallel " + json.dumps(line), flush=True)

    dp = line["dp_fused"]
    if dp["first_val_rel_diff"] > DP_RTOL:
        faults.append(f"DP first validation {dp['curve'][:1]} against phase 9's {fused_line['gpu_fused']['curve'][:1]}"
                      f" beyond rtol={DP_RTOL}")
    if len(dp["curve"]) != FUSED_ITERS // FUSED_TEST_FREQ or not all(map(math.isfinite, _losses(dp["curve"]))):
        faults.append(f"DP run: {dp['curve']}")
    if sorted({g for g, _ in dp["captures"]}) != ["step", "validation"]:
        faults.append(f"DP run: the step and the validation were not both captured ({dp['captures']})")
    if dp["step_graph"]["all_reduce_calls"] != 1:
        faults.append(f"the DP step made {dp['step_graph']['all_reduce_calls']} all-reduces, expected 1")
    ev = line["evaluate_sharded"]
    if ev["roche_rk4_launches"] != EVAL_LAUNCHES or not ev["equal_at_4_decimals"]:
        faults.append(f"evaluate_sharded: {ev}")
    if gpus == 1 and not refusal.startswith("requested a 2-device 'data' mesh but only 1 devices are available"):
        faults.append(f"--dp 2 on one GPU: {refusal}")
    if gpus > 1 and not line["multi_gpu"]["ok"]:
        faults.append(f"the two-world check: {line['multi_gpu']}")
    if line["dryrun"]["rc"] or line["dryrun"]["missing"]:
        faults.append(f"dryrun: {line['dryrun']}")
    if dp["roche_rk4_launches"]:
        faults.append(f"the RK4 kernel was launched on the DP training path: {dp['roche_rk4_launches']}")
    if faults:
        raise SystemExit("; ".join(faults))
    return line


def phase_fused_apart(args):
    """Phases 9 and 10 in a process of its own, waited for; -> their `fused` and `parallel` lines.

    Its CUDA graphs then never share a process with the profiler's traces (a
    trace of a graph replay ended the process with a segmentation fault on
    the H100), and its times start from a fresh allocator.
    """
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--phase", "fused", "--seed", str(args.seed)],
                          capture_output=True, text=True, timeout=900)
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    if proc.returncode:
        sys.stderr.write(proc.stderr[-6000:])
        raise SystemExit(f"phase 9 or 10 failed with exit code {proc.returncode}")
    lines = {ln.split(" ", 1)[0]: json.loads(ln.split(" ", 1)[1]) for ln in proc.stdout.splitlines()
             if ln.startswith(("fused ", "parallel "))}
    return lines["fused"], lines["parallel"]


def grad_route_faults(launches_by_path: dict) -> list:
    """The training paths whose launches of the DOPRI5 pair with gradients contradict the route: each path of
    GRAD_ROUTE_PATHS must launch it, every other path must not."""
    return [f"{path}: {n} launches of roche_dopri5_grad, expected {'some' if path in GRAD_ROUTE_PATHS else 0}"
            for path, n in launches_by_path.items() if (n > 0) != (path in GRAD_ROUTE_PATHS)]


def kernels_line(rows, launches, train, real, more, lockstep, fused_line, parallel_line, dopri5_rows,
                 dopri5_line, grad_rows) -> dict:
    """The `kernels` JSON: the RK4 kernel's numbers at evaluate's shape (B=2550, the one launch of each chunk) and
    its launches on every path of the run, the main path's beside the others; the per-row DOPRI5 kernel's numbers at
    evaluate's shape and its launches a forecast request (phase 3b); the DOPRI5 pair with gradients' numbers at the
    training step's shape (B=50, D=6, phase 3c) and its forward launches on every training path of the run."""
    main_row, dopri5_row, grad_row = rows[0], dopri5_rows[0], grad_rows[0]
    grad = "roche_dopri5_grad_launches"
    return {"kernels": [dict(
        name="roche_rk4", route="cuda", source="hybridode_torch/ops/csrc/roche_rk4.cu",
        replaces="hybridode/ops/pallas/roche_kernel.py:151", launches=launches,
        launches_by_path=dict(
            evaluate=launches, evaluate_horizon=more["evaluate_horizon"]["roche_rk4_launches"],
            evaluate_ensemble_horizon=more["evaluate_ensemble_horizon"]["roche_rk4_launches"],
            flow_evaluate=more["flow_evaluate"]["roche_rk4_launches"],
            run_simulation=train["roche_rk4_launches"], run_real=real["roche_rk4_launches"],
            run_simulation_flow=more["flow"]["roche_rk4_launches"],
            run_simulation_members=more["members"]["roche_rk4_launches"],
            run_simulation_ensemble=more["ensemble"]["roche_rk4_launches"],
            run_simulation_residual=more["residual"]["roche_rk4_launches"],
            run_eval=more["run_eval"]["roche_rk4_launches"],
            run_simulation_lockstep=lockstep["train"]["roche_rk4_launches"],
            create_data=lockstep["create_data"]["roche_rk4_launches"],
            create_data_native=lockstep["create_data"]["native"]["roche_rk4_launches"],
            lockstep_vmap=lockstep["restarts"]["vmap"]["roche_rk4_launches"],
            lockstep_seq=lockstep["restarts"]["seq"]["roche_rk4_launches"],
            checkpoint_steps_probe=train["checkpoint_steps"]["roche_rk4_launches"],
            **{f"fused_{k}": v for k, v in fused_line["roche_rk4_launches"].items()},
            evaluate_sharded=parallel_line["evaluate_sharded"]["roche_rk4_launches"],
            fused_dp=parallel_line["dp_fused"]["roche_rk4_launches"]),
        max_abs_err=max(r["max_abs_err"] for r in rows), ms=main_row["ms"], device_ms=main_row["device_ms"],
        plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=None,  # no single PyTorch call computes an RK4 solve of this field
    ), dict(
        name="roche_dopri5", route="cuda", source="hybridode_torch/ops/csrc/roche_dopri5.cu", replaces=None,
        launches_per_forecast_request=dopri5_line["launches_per_request"],
        max_err=max(r["err"] for r in dopri5_rows), ms=dopri5_row["ms"], device_ms=dopri5_row["device_ms"],
        plain_ms=dopri5_row["plain_ms"], bound_ms=dopri5_row["bound_ms"], bound_by=dopri5_row["bound_by"],
        library_ms=None,  # no single PyTorch call computes this solve
    ), dict(
        name="roche_dopri5_grad", route="cuda", source="hybridode_torch/ops/csrc/roche_dopri5.cu", replaces=None,
        launches_by_path=dict(
            run_simulation=train[grad], run_real=real[grad], run_simulation_flow=more["flow"][grad],
            **{f"run_simulation_members_{k}": v for k, v in more["members"][grad].items()},
            run_simulation_ensemble=more["ensemble"][grad], run_simulation_residual=more["residual"][grad],
            run_eval=more["run_eval"][grad], run_simulation_lockstep=lockstep["train"][grad],
            lockstep_vmap=lockstep["restarts"]["vmap"][grad], lockstep_seq=lockstep["restarts"]["seq"][grad],
            **{f"fused_{k}": v for k, v in fused_line[grad].items()}, fused_dp=parallel_line["dp_fused"][grad]),
        max_err=max(e for r in grad_rows for e in r["err"]), ms=grad_row["ms"], device_ms=grad_row["device_ms"],
        forward_device_ms=grad_row["forward_device_ms"], backward_device_ms=grad_row["backward_device_ms"],
        plain_ms=grad_row["plain_ms"], bound_ms=grad_row["bound_ms"], bound_by=grad_row["bound_by"],
        library_ms=None,  # no single PyTorch call computes this solve or its backward
    )]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ckpt", default=None, help="checkpoint path prefix written by either package")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--phase", choices=["fused", "kernels"], default=None,
                        help="fused: run only phases 9 and 10 and print their lines (the whole script runs them so, "
                             "in a process of their own); kernels: run only phases 1-3, 3b and 3c, the kernels")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU and has no CPU mode", file=sys.stderr)
        return 1
    if args.phase == "fused":
        phase_parallel(args, phase_fused(args))
        return 0

    import hybridode_torch
    from hybridode_torch.data import SyntheticCohort
    from hybridode_torch.ops import build, roche_dopri5, roche_rk4

    start = time.perf_counter()
    smi = nvidia_smi()
    print("env " + json.dumps(dict(nvidia_smi=smi, device=torch.cuda.get_device_name(0),
                                   torch=torch.__version__, cuda=torch.version.cuda,
                                   matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                                   cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                                   port=hybridode_torch.__version__)), flush=True)

    t = time.perf_counter()
    built = build.build_all()
    ptxas = [ln.strip() for b in built.values() for ln in b.log.splitlines() if "registers" in ln or "spill" in ln]
    info = {name: {D: mod.kernel_info(D) for D in build.WIDTHS}  # registers, spills by D
            for name, mod in (("roche_rk4", roche_rk4), ("roche_dopri5", roche_dopri5))}
    print("build " + json.dumps(dict(seconds=time.perf_counter() - t, kernels=sorted(built), ptxas=ptxas, **info)),
          flush=True)

    cohort = SyntheticCohort.load(COHORT, device="cuda")
    rows = phase_kernels(cohort, args.seed)
    dopri5_rows, dopri5_line = phase_dopri5(cohort, args.seed)
    grad_rows, _ = phase_dopri5_grad(cohort, args.seed)
    if args.phase == "kernels":
        print(smi, flush=True)
        return 0
    launches = phase_slice(cohort, args)
    probes = {}
    with _fused_loop(False):  # phases 5-8 measure the host loop, as before the fused loop was ported
        train = phase_train(args, probes)
        real = phase_real(args, probes)
        more = phase_sim_more(args, probes)
        lockstep = phase_lockstep(args, probes)
    fused_line, parallel_line = phase_fused_apart(args)
    phases_s = time.perf_counter() - start
    print("profile " + json.dumps({name: trace() for name, trace in probes.items()}), flush=True)
    total_s = time.perf_counter() - start
    print("timing " + json.dumps(dict(phases_s=phases_s, profile_s=total_s - phases_s, total_s=total_s)), flush=True)

    kernels = kernels_line(rows, launches, train, real, more, lockstep, fused_line, parallel_line, dopri5_rows,
                           dopri5_line, grad_rows)
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    faults = grad_route_faults(kernels["kernels"][2]["launches_by_path"])
    if faults:
        raise SystemExit("; ".join(faults))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
