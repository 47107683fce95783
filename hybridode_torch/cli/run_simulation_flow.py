"""Simulation-study CLI of the flow posterior (LHM-NF): the hybrid model with a planar-flow encoder.

    python -m hybridode_torch.cli.run_simulation_flow --restart 1 --arg_itr 4 \
        --data_path data_s123/datafile_dose_exp.pkl --path model/v_

Counterpart of hybridode/cli/run_simulation_flow.py: the same flags and
stdout as `run_simulation` (`Training with N samples`, the `Iter` lines,
`Time:`, `Overall best loss:` and the 4-line CSV of `evaluate`), with
`num_flows=4` planar flows and a 50-sample Monte-Carlo KL by default; the
checkpoint is `VI_FLOW_PlanarLSTMEncoder_HybridDecoder.pkl`, which either
package loads.

It runs on the GPU; `--device c` asks for the CPU. All noise comes from one
CPU `torch.Generator` seeded with `--seed`, drawn as `run_simulation` draws
it. `--restart_mode vmap` trains every restart in one batched program;
`--dp`, `--restart_mode shard` with `--restart_devices`, and `--eval_mesh`
run on a world of ranks as in `run_simulation`.
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from .. import resolve_device
from ..config import EvalConfig, OptimConfig
from ..data import SyntheticCohort
from . import common
from .run_simulation import add_parallel_flags, fit_and_evaluate, parse_eval_mesh


def run(seed, eval_only, data_path, sample, data_config, path, optim_config, eval_config, num_flows=4, mc_size=50,
        arg_itr=None, curve_path=None, events_path=None, val_criterion="forecast", restart_mode="seq",
        restart_devices=None, device=None, dp_devices=None, eval_mesh=None):
    """Train n_restart times, then evaluate; -> (params, model, the six numbers of `evaluate`).

    `dp_devices`, `restart_mode="shard"` with `restart_devices` and
    `eval_mesh` as in `run_simulation.run`: a run that needs more than one
    rank starts them and returns rank 0's result.
    """
    kwargs = dict(locals())
    device = resolve_device(device)
    world = common.check_parallel_flags(restart_mode=restart_mode, n_restart=optim_config.n_restart,
                                        dp_devices=dp_devices, restart_devices=restart_devices, eval_mesh=eval_mesh,
                                        batch_size=optim_config.batch_size, init_path=None, eval_only=eval_only,
                                        device=device)
    if world > 1 and not dist.is_initialized():
        return common.launch_run(run, kwargs, world, device)
    generator = torch.Generator().manual_seed(seed)

    dg = SyntheticCohort.load(data_path, device=device)
    if not eval_only:
        dg.set_train_size(sample)
    print("Training with {} samples".format(sample))

    model = common.build_sim_model("hybrid", data_config, elbo=True, ode_method=optim_config.ode_method, flow=True,
                                   num_flows=num_flows, mc_size=mc_size)
    niters = optim_config.niters if arg_itr is None else arg_itr
    params, scores = fit_and_evaluate(model, dg, generator, eval_only=eval_only, init_path=None, niters=niters,
                                      path=path, optim_config=optim_config, eval_config=eval_config,
                                      val_criterion=val_criterion, curve_path=curve_path, events_path=events_path,
                                      device=device, restart_mode=restart_mode, dp_devices=dp_devices,
                                      restart_devices=restart_devices, eval_mesh=eval_mesh)
    return params, model, scores


def main(argv=None):
    parser = argparse.ArgumentParser("PKPD simulation with flow posterior")
    parser.add_argument("--device", choices=["0", "1", "c"], default="1", type=str,
                        help="c: run on the CPU; 0 or 1: run on the GPU")
    parser.add_argument("--seed", default=666, type=int)
    parser.add_argument("--sample", default=1000, type=int)
    parser.add_argument("--path", default=None, type=str)
    parser.add_argument("--restart", default=3, type=int)
    parser.add_argument("--arg_itr", default=None, type=int)
    parser.add_argument("--eval", default="n", type=str)
    parser.add_argument("--batch_size", default=50, type=int)
    parser.add_argument("--t0", default=5, type=int)
    parser.add_argument("--lr", default=0.01, type=float)
    parser.add_argument("--data_config", default=None, type=str)
    parser.add_argument("--data_path", default="data/datafile_dose_exp.pkl", type=str)
    parser.add_argument("--num_flows", default=4, type=int)
    parser.add_argument("--mc_size", default=50, type=int)
    parser.add_argument("--val_criterion", choices=["forecast", "elbo"], default="forecast", type=str,
                        help="model-selection rule: t0-forecast error or the reference's full-sequence val ELBO")
    parser.add_argument("--curve_path", default=None, type=str,
                        help="write iter,val_loss,train_loss CSV (exp_flow.csv format)")
    parser.add_argument("--events_path", default=None, type=str, help="append JSONL training events")
    add_parallel_flags(parser)
    args = parser.parse_args(argv)

    data_config = common.resolve_data_config(args.data_config, args.sample)
    optim_config = OptimConfig(shuffle=False, n_restart=args.restart, batch_size=args.batch_size, lr=args.lr)
    run(args.seed, args.eval == "y", args.data_path, args.sample, data_config, args.path, optim_config,
        EvalConfig(t0=args.t0), args.num_flows, args.mc_size, args.arg_itr, curve_path=args.curve_path,
        events_path=args.events_path, val_criterion=args.val_criterion, restart_mode=args.restart_mode,
        restart_devices=args.restart_devices or None, device="cpu" if args.device == "c" else "cuda",
        dp_devices=args.dp if args.dp > 1 else None, eval_mesh=parse_eval_mesh(args.eval_mesh))


if __name__ == "__main__":
    main()
