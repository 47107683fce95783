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
   events, median of 20 runs after warm-up: `ms`, `plain_ms`), the kernel's
   device time with the host's launch cost hidden (`device_ms`: 100 calls
   queued behind a GPU spin), and the built kernel's registers and local
   (spill) bytes a thread.
4. Slice: `evaluate` of the hybrid model (full width of the cohort's model:
   obs 20, LSTM hidden 40, latent 6, ml remainder 2) on the whole test fold of
   data_s123, decoding with the RK4 kernel (one launch per chunk of 50
   patients, 4 in all); launch counts read around that run, then
   EVAL_REPEATS more timed runs for the spread; the same evaluation on the
   CPU (plain path) must agree within METRIC_RTOL.

The last lines are the `kernels` JSON, the nvidia-smi line and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
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
# (B, D, Hill exponent or None for the cohort's 2.0). The first is evaluate's shape:
# (50 MC + 1) x 50 patients; the next two are the two launches a chunk took before.
KERNEL_CASES = [(2550, 6, None), (2500, 6, None), (50, 6, None), (1000, 4, None), (1000, 8, None), (7, 6, None),
                (2550, 6, 1.7)]


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
            plain_ms = cuda_ms(lambda: roche_rk4.roche_rk4_trajectory_reference(**inp))
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

    names = ("rmse_z0", "cprs_z0", "rmse_x", "cprs_x")
    gpu_m = dict(zip(names, (gpu[0], gpu[2], gpu[3], gpu[5])))
    cpu_m = dict(zip(names, (cpu[0], cpu[2], cpu[3], cpu[5])))
    print("slice " + json.dumps(dict(evaluate_s_gpu=gpu_s, evaluate_s_gpu_runs=gpu_runs, evaluate_s_cpu=cpu_s,
                                     launches=launches, gpu=gpu_m, cpu=cpu_m)), flush=True)
    if not all(map(lambda v: v == v and abs(v) != float("inf"), gpu_m.values())):
        raise SystemExit(f"non-finite metrics on the GPU: {gpu_m}")
    if launches != EVAL_LAUNCHES:
        raise SystemExit(f"expected {EVAL_LAUNCHES} roche_rk4 launches in evaluate (one per chunk), got {launches}")
    for k in names:
        if abs(gpu_m[k] - cpu_m[k]) > METRIC_RTOL * abs(cpu_m[k]):
            raise SystemExit(f"{k}: GPU {gpu_m[k]} vs CPU {cpu_m[k]} beyond rtol={METRIC_RTOL}")
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ckpt", default=None, help="checkpoint path prefix written by either package")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU and has no CPU mode", file=sys.stderr)
        return 1

    import hybridode_torch
    from hybridode_torch.data import SyntheticCohort
    from hybridode_torch.ops import build, roche_rk4

    smi = nvidia_smi()
    print("env " + json.dumps(dict(nvidia_smi=smi, device=torch.cuda.get_device_name(0),
                                   torch=torch.__version__, cuda=torch.version.cuda,
                                   matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                                   cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                                   port=hybridode_torch.__version__)), flush=True)

    t = time.perf_counter()
    built = build.build_all()
    ptxas = [ln.strip() for b in built.values() for ln in b.log.splitlines() if "registers" in ln or "spill" in ln]
    info = {D: roche_rk4.kernel_info(D) for D in range(4, roche_rk4.MAX_DIM + 1)}  # registers, spills by D
    print("build " + json.dumps(dict(seconds=time.perf_counter() - t, kernels=sorted(built), ptxas=ptxas,
                                     roche_rk4=info)), flush=True)

    cohort = SyntheticCohort.load(COHORT, device="cuda")
    rows = phase_kernels(cohort, args.seed)
    launches = phase_slice(cohort, args)

    main_row = rows[0]  # B=2550: the one launch of each chunk of evaluate
    print(json.dumps({"kernels": [dict(
        name="roche_rk4", route="cuda", source="hybridode_torch/ops/csrc/roche_rk4.cu",
        replaces="hybridode/ops/pallas/roche_kernel.py:151", launches=launches,
        max_abs_err=max(r["max_abs_err"] for r in rows), ms=main_row["ms"], device_ms=main_row["device_ms"],
        plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=None,  # no single PyTorch call computes an RK4 solve of this field
    )]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
