#!/usr/bin/env python3
"""Host time of one training step of the hybrid sim model and of its flow posterior (LHM-NF) on one GPU.

    python3 flow_step_study.py [--steps 3] [--out RESULT.json]

Both models at data_s123's width (obs 20, latent 6, LSTM hidden 40,
per-patient DOPRI5) on the first training batch of 50 patients, as
`chip_smoke.py`'s phases 5 and 7 take it, with random weights from seed 0. In
turns (hybrid, flow, flow, hybrid) each model runs `--steps` Adam steps on a
fresh copy of its weights, timed on the host clock up to a device sync, once
with Python's cyclic garbage collector on and once with it off; then one step
under cProfile (`state` "fresh"). Then one step of each model under a bare
torch.profiler trace whose events are read and dropped, and one more turn of
each (`state` "after_bare_trace": the trace's events, held in reference
cycles, are still alive); then a full `gc.collect()` and one more turn of
each ("after_collect", what `chip_smoke._traced` does). Reported per turn: the
step seconds, the ATen calls of a step (chip_smoke.py's counter), the DOPRI5
trial steps the decode ran, the CUDA caching allocator's device allocations
and retries during the timed steps, the objects the garbage collector tracks,
and the cProfile entries with the most host time. It needs a GPU and exits 1
without one.
"""

from __future__ import annotations

import argparse
import copy
import cProfile
import gc
import json
import pstats
import sys
import time


def _step_runner(model, batch, seed):
    import torch

    from hybridode_torch.config import OptimConfig
    from hybridode_torch.inference import init_vi, make_optimizer, train_step

    params0 = init_vi(torch.Generator().manual_seed(0), model, device="cuda")

    def run(steps):
        params = copy.deepcopy(params0)
        optimizer = make_optimizer(OptimConfig().lr, params)
        times = []
        for i in range(steps):
            t = time.perf_counter()
            train_step(params, optimizer, model, batch, torch.Generator().manual_seed(seed + i))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return times, params, optimizer

    return run


def _bare_trace(run):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(1)
    return len(prof.events())


def _turn(name, run, model, batch, steps, seed, state="fresh"):
    import torch

    from chip_smoke import _aten_counter
    from hybridode_torch.inference import train_step
    from hybridode_torch.models import decoders

    run(1)  # warm-up: allocator, cuBLAS
    before = torch.cuda.memory_stats()
    gc_on, _, _ = run(steps)
    after = torch.cuda.memory_stats()
    gc.disable()
    try:
        gc_off, params, optimizer = run(steps)
    finally:
        gc.enable()

    trial_steps = []
    solve = decoders.odeint_dopri5

    def counting_solve(*args, **kw):
        ys, st = solve(*args, **kw)
        trial_steps.append(int(st.n_steps.max()))
        return ys, st

    decoders.odeint_dopri5 = counting_solve
    try:
        with _aten_counter() as count:
            train_step(params, optimizer, model, batch, torch.Generator().manual_seed(seed))
    finally:
        decoders.odeint_dopri5 = solve

    prof = cProfile.Profile()
    prof.enable()
    train_step(params, optimizer, model, batch, torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof)
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]  # by own (total) time
    return dict(
        model=name, state=state, gc_objects=len(gc.get_objects()), step_s_gc_on=gc_on, step_s_gc_off=gc_off,
        aten_calls=count.calls, trial_steps_max=trial_steps,
        device_allocs=after["num_device_alloc"] - before["num_device_alloc"],
        alloc_retries=after["num_alloc_retries"] - before["num_alloc_retries"],
        cprofile_total_s=stats.total_tt,
        cprofile_top=[dict(fn=f"{f[0].rsplit('/', 1)[-1]}:{f[1]}:{f[2]}", calls=v[1], own_s=v[2]) for f, v in top],
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flow_step_study: no CUDA device", file=sys.stderr)
        return 1

    from chip_smoke import COHORT, TRAIN_BATCH, nvidia_smi
    from hybridode_torch.cli.common import build_sim_model
    from hybridode_torch.config import DataConfig
    from hybridode_torch.data import SyntheticCohort

    cohort = SyntheticCohort.load(COHORT, device="cuda")
    cohort.set_train_size(1000)
    batch = cohort.get_split("train", TRAIN_BATCH, 1 % (cohort.train_size // TRAIN_BATCH))
    models = {"hybrid": build_sim_model("hybrid", DataConfig()),
              "flow": build_sim_model("hybrid", DataConfig(), flow=True, mc_size=50)}
    runners = {k: _step_runner(m, batch, args.seed) for k, m in models.items()}
    turns = [_turn(k, runners[k], models[k], batch, args.steps, args.seed)
             for k in ("hybrid", "flow", "flow", "hybrid")]
    for k in models:
        _bare_trace(runners[k])
    turns += [_turn(k, runners[k], models[k], batch, args.steps, args.seed, "after_bare_trace") for k in models]
    gc.collect()
    turns += [_turn(k, runners[k], models[k], batch, args.steps, args.seed, "after_collect") for k in models]
    result = dict(nvidia_smi=nvidia_smi(), torch=torch.__version__, turns=turns)
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    for t in turns:
        print(json.dumps({k: v for k, v in t.items() if k != "cprofile_top"}))
        for row in t["cprofile_top"][:6]:
            print("   ", json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
