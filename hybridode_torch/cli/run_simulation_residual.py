"""Simulation-study residual hybrid: a neural model trained on the residuals of a trained expert model.

    python -m hybridode_torch.cli.run_simulation_residual --path model/v_ \
        --data_path data_s123/datafile_dose_exp.pkl

Counterpart of hybridode/cli/run_simulation_residual.py: the expert model
loads its checkpoint from `--path`; the val fold's measurements become x -
x_hat_expert (the posterior mean of the FULL sequence decoded) and the fold is
cut to min(sample, its size) patients; a fresh neural model trains on it
(`train_fold="val"`, `--restart` restarts of OptimConfig's iterations,
checkpoints under `--res_path`, default `<path>res`); then the sum expert +
neural is scored by `evaluate_ensemble` at weights 1 and 1 (4-line CSV), or
with `--horizon` the dict of `evaluate_ensemble_horizon` is pickled to
`--result_path`. The flags are the JAX CLI's, `--horizon`'s `type=bool`
included (any non-empty value is true).

It runs on the GPU; `--device c` asks for the CPU. All noise comes from one
CPU `torch.Generator` seeded with `--seed`.
"""

from __future__ import annotations

import argparse
import pickle

import torch

from .. import resolve_device
from ..config import EvalConfig, OptimConfig
from ..data import SyntheticCohort
from ..eval import evaluate_ensemble, evaluate_ensemble_horizon
from ..inference import init_vi, variational_training_loop
from . import common
from .run_simulation_ensemble import init_and_load, predict_mean


def run(seed, eval_only, data_path, sample, data_config, path, res_path, optim_config, eval_config, horizon=False,
        result_path=None, val_criterion="forecast", device=None):
    """-> the six numbers of `evaluate_ensemble`, or with `horizon` the pickled dict."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    batch_size = min(optim_config.batch_size, sample)

    dg = SyntheticCohort.load(data_path, device=device)
    print("Training with {} samples".format(sample))

    params_e, model_e = init_and_load("expert", data_config, optim_config, generator, path, device)
    residual = dg.data_val["measurements"] - predict_mean(params_e, model_e, dg.data_val)
    dg.data_val = dict(dg.data_val, measurements=residual)
    dg.set_val_size(min(sample, residual.shape[1]))

    model = common.build_sim_model("neural", data_config, elbo=True, ode_method=optim_config.ode_method)
    best_on_disk = 1e9
    params = None
    for _ in range(optim_config.n_restart):
        params = init_vi(generator, model, device=device)
        if eval_only:
            break
        params, best_on_disk, _ = variational_training_loop(
            niters=optim_config.niters, data_generator=dg, model=model, params=params, batch_size=batch_size,
            lr=optim_config.lr, test_freq=optim_config.test_freq, generator=generator, path=res_path,
            best_on_disk=best_on_disk, early_stop=optim_config.early_stop, shuffle=optim_config.shuffle,
            train_fold="val", val_criterion=val_criterion, val_t0=eval_config.t0,
        )
    print("Ensemble weights learned.")

    args = (params_e, model_e, params, model, dg, batch_size, eval_config.t0)
    if not horizon:
        return evaluate_ensemble(*args, generator=generator, device=device)
    res = evaluate_ensemble_horizon(*args, generator=generator, device=device)
    with open(result_path, "wb") as f:
        pickle.dump(res, f)
    return res


def main(argv=None):
    parser = argparse.ArgumentParser("PKPD simulation residual")
    parser.add_argument("--method", choices=["residual"], default="residual", type=str)
    parser.add_argument("--device", choices=["0", "1", "c"], default="1", type=str,
                        help="c: run on the CPU; 0 or 1: run on the GPU")
    parser.add_argument("--seed", default=666, type=int)
    parser.add_argument("--sample", default=1000, type=int)
    parser.add_argument("--path", default=None, type=str)
    parser.add_argument("--res_path", default=None, type=str)
    parser.add_argument("--t0", default=5, type=int)
    parser.add_argument("--restart", default=3, type=int)
    parser.add_argument("--eval", default="n", type=str)
    parser.add_argument("--data_path", default="data/datafile_dose_exp.pkl", type=str)
    parser.add_argument("--data_config", default=None, type=str)
    parser.add_argument("--lr", default=0.01, type=float)
    parser.add_argument("--horizon", default=False, type=bool)
    parser.add_argument("--result_path", default=None, type=str)
    parser.add_argument("--val_criterion", choices=["forecast", "elbo"], default="forecast", type=str,
                        help="checkpoint-selection rule of the residual model: t0-forecast error or the reference's "
                             "full-sequence val ELBO")
    args = parser.parse_args(argv)

    res_path = args.res_path if args.res_path is not None else args.path + "res"
    data_config = common.resolve_data_config(args.data_config, args.sample)
    optim_config = OptimConfig(shuffle=False, n_restart=args.restart, lr=args.lr)
    run(args.seed, args.eval == "y", args.data_path, args.sample, data_config, args.path, res_path, optim_config,
        EvalConfig(t0=args.t0), args.horizon, args.result_path, val_criterion=args.val_criterion,
        device="cpu" if args.device == "c" else "cuda")


if __name__ == "__main__":
    main()
