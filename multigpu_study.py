#!/usr/bin/env python3
"""Worlds of several GPUs: the two-world check and the scaling study of the port's parallel layer.

    python3 multigpu_study.py --check                  # the two-world check alone (2+ GPUs)
    python3 multigpu_study.py --out multigpu.json      # the check, then the study (4 GPUs)
    python3 multigpu_study.py --check --device c       # the check on gloo CPU ranks, at a small size

Every world is a `parallel.launch` world with a wall-clock `--timeout`: a
world that outlives it prints each rank's last steps and traceback and the
script fails.

The two-world check (`two_worlds`): `run_simulation.run` of the hybrid on
data_s123 with `--dp 2`, fused and captured on CUDA, in two worlds one after
the other (the second world starts only once every rank of the first has
left), then the same run in a world of one rank. Both DP runs' first
validation must match the one-rank run's within CHECK_RTOL, and each other's
exactly.

The study (`study`), each configuration in a world of its own, rank 0
reading its event log: the hybrid at batch 48, ITERS iterations with
forecast validation every TEST_FREQ, seconds an iteration of the last window
(all graph replays, its validation included):

* DP, strong scaling: a global batch of 48 over 1, 2 and 4 ranks;
* DP, weak scaling: 48 a rank (96 over 2, 192 over 4);
* `--restart_mode shard`, 4 restarts one a GPU, against `vmap` of 4 on one;
* the DOPRI5 `evaluate` of the one-rank run's checkpoint on a 2 x 2 (data,
  mc) `--eval_mesh` against 1 x 1.

The card's name and power limit go into the output beside the numbers.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
COHORT = os.path.join(ROOT, "data_s123", "datafile_dose_exp.pkl")
CHECK_RTOL = 1e-6  # a --dp 2 run's first validation against the one-rank run's
CHECK_ITERS, CHECK_TEST_FREQ = 4, 2
ITERS, TEST_FREQ, BATCH = 10, 5, 48
WORLD_TIMEOUT = 300.0  # seconds a world may take


def _kwargs(path, events, *, batch, iters, test_freq, device, sample=1000, n_restart=1, **flags):
    """`run_simulation.run`'s arguments for the hybrid on data_s123, as its CLI builds them."""
    from hybridode_torch.cli import common
    from hybridode_torch.config import EvalConfig, OptimConfig

    return dict(seed=666, elbo=True, eval_only=False, init_path=None, data_path=COHORT, sample=sample,
                data_config=common.resolve_data_config(None, sample), model_method="hybrid", path=path,
                optim_config=OptimConfig(shuffle=False, n_restart=n_restart, batch_size=batch, test_freq=test_freq),
                eval_config=EvalConfig(t0=5), arg_itr=iters, val_criterion="forecast", events_path=events,
                device=device) | flags


def _events(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def world_run(kwargs):
    """On every rank of a world: `run_simulation.run(**kwargs)`; -> (rank 0) the event log's numbers and the
    scores, as plain Python values, so that the caller never holds a tensor of the world's devices."""
    from hybridode_torch.cli import run_simulation
    from hybridode_torch.parallel.launch import is_writer

    _, _, scores = run_simulation.run(**kwargs)
    if not is_writer():
        return None
    recs = _events(kwargs["events_path"])
    evaluate = [r for r in recs if r["event"] == "evaluate"]
    done = [r for r in recs if r["event"] == "done"]
    return dict(val=[[r["itr"], r["val_loss"]] for r in recs if r["event"] == "val"],
                best_on_disk=done[-1]["best_on_disk"] if done else None,
                window_s=[r["seconds"] for r in recs if r["event"] == "window"],
                captures=[[r["graph"], r["seconds"]] for r in recs if r["event"] == "capture"],
                evaluate_s=evaluate[-1]["seconds"] if evaluate else None,
                scores=[float(x) for x in scores])


def in_world(kwargs, world, device, timeout):
    """`world_run(kwargs)` in a new world of `world` ranks -> (rank 0's result, the world's wall seconds)."""
    from hybridode_torch.parallel import launch

    t = time.perf_counter()
    out = launch(world_run, world, dict(kwargs, device=str(device)), device=device, timeout=timeout)
    return out, time.perf_counter() - t


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def two_worlds(tmp, device="cuda", timeout=WORLD_TIMEOUT, sample=1000, batch=BATCH):
    """Two 2-rank `--dp 2` worlds in turn through the CLI's own launch (`common.launch_run`: rank 0's whole
    result, parameters included, comes back to this process), then the run in a world of one rank.

    -> dict of each world's seconds and first validation, their relative differences and `ok`."""
    from hybridode_torch.cli import common, run_simulation

    out, firsts = {}, []
    for name in ("dp2_first", "dp2_second"):
        events = os.path.join(tmp, f"{name}.jsonl")
        kw = _kwargs(os.path.join(tmp, f"{name}_"), events, batch=batch, iters=CHECK_ITERS,
                     test_freq=CHECK_TEST_FREQ, device=device, sample=sample, dp_devices=2)
        t = time.perf_counter()
        _, _, scores = common.launch_run(run_simulation.run, kw, 2, device, timeout=timeout)
        val = [[r["itr"], r["val_loss"]] for r in _events(events) if r["event"] == "val"]
        out[name] = dict(world_s=time.perf_counter() - t, val=val, scores=[float(x) for x in scores])
        firsts.append(val[0][1])
    kw = _kwargs(os.path.join(tmp, "one_"), os.path.join(tmp, "one.jsonl"), batch=batch, iters=CHECK_ITERS,
                 test_freq=CHECK_TEST_FREQ, device=device, sample=sample)
    one, one_s = in_world(kw, 1, device, timeout)
    out["one_rank"] = dict(world_s=one_s, val=one["val"], scores=one["scores"])
    out["first_val_rel_diff"] = _rel(firsts[0], one["val"][0][1])
    out["worlds_rel_diff"] = _rel(firsts[0], firsts[1])
    out["ok"] = bool(out["first_val_rel_diff"] <= CHECK_RTOL and out["worlds_rel_diff"] == 0
                     and all(math.isfinite(v) for _, v in one["val"]))
    return out


def _iter_s(r, test_freq=TEST_FREQ):
    return r["window_s"][-1] / test_freq if r and r["window_s"] else None


def study(tmp, device="cuda", timeout=WORLD_TIMEOUT, sample=1000, batch=BATCH):
    """The scaling study's worlds, on 4 ranks at most -> dict of rows (world, global batch, seconds an
    iteration, ...)."""
    rows = {}

    def one(name, world, **flags):
        kw = _kwargs(os.path.join(tmp, f"{name}_"), os.path.join(tmp, f"{name}.jsonl"), iters=ITERS,
                     test_freq=TEST_FREQ, device=device, sample=sample, **({"batch": batch} | flags))
        r, wall = in_world(kw, world, device, timeout)
        rows[name] = dict(world=world, batch=kw["optim_config"].batch_size, iter_s=_iter_s(r), world_s=wall, **r)
        print(f"study {name} " + json.dumps(rows[name]), flush=True)
        return kw

    base = one("dp1", 1)
    for n in (2, 4):
        one(f"dp{n}_strong", n, dp_devices=n)
        one(f"dp{n}_weak", n, dp_devices=n, batch=batch * n)
    one("vmap4", 1, restart_mode="vmap", n_restart=4)
    one("shard4", 4, restart_mode="shard", n_restart=4, restart_devices=4)
    for mesh in ((1, 1), (2, 2)):
        name = f"eval_{mesh[0]}x{mesh[1]}"
        kw = dict(base, eval_only=True, eval_mesh=mesh, events_path=os.path.join(tmp, f"{name}.jsonl"))
        r, wall = in_world(kw, mesh[0] * mesh[1], device, timeout)
        rows[name] = dict(world=mesh[0] * mesh[1], evaluate_s=r["evaluate_s"], scores=r["scores"], world_s=wall)
        print(f"study {name} " + json.dumps(rows[name]), flush=True)
    return rows


def card():
    """`nvidia-smi`'s name and power limit of each visible card, or None without one."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return None
    return out.stdout.strip().splitlines() if out.returncode == 0 else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("multigpu_study")
    parser.add_argument("--check", action="store_true", help="the two-world check alone")
    parser.add_argument("--out", default=None, help="write the result as JSON here")
    parser.add_argument("--timeout", default=WORLD_TIMEOUT, type=float, help="seconds a world may take")
    parser.add_argument("--device", choices=["1", "c"], default="1",
                        help="c: gloo CPU ranks at a small size (a rehearsal; no number of it is a GPU's)")
    args = parser.parse_args(argv)
    import torch

    if args.device == "c":
        device, size, gpus = "cpu", dict(sample=400, batch=8), None
    else:
        device, size, gpus = "cuda", {}, torch.cuda.device_count()
        if gpus < (2 if args.check else 4):
            raise SystemExit(f"needs {2 if args.check else 4} GPUs, {gpus} visible")
    result = dict(cards=card(), device=device, gpus=gpus)
    with tempfile.TemporaryDirectory() as tmp:
        result["check"] = two_worlds(tmp, device, args.timeout, **size)  # a world that hangs raises here
        print("check " + json.dumps(result["check"]), flush=True)
        if not args.check:
            result["study"] = study(tmp, device, args.timeout, **size)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    ok = result["check"]["ok"]
    print(json.dumps(dict(cards=result["cards"], gpus=gpus, ok=ok)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
