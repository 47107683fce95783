"""Real-data residual hybrid: a gruode model trained on the residual of a scaled expert forecast.

    python -m hybridode_torch.cli.run_real_residual --init_path model/ --data_path data_real/

Counterpart of hybridode/cli/run_real_residual.py: the expert model loads its
checkpoint from `--init_path`; the train fold past t0 becomes x - 0.1 * expert
forecast (the expert encodes the FULL sequence here), the val fold becomes
that train fold, a gruode model trains on it (checkpoints under
`<model_dir>res`), and the test fold's forecast 0.1 * expert + gruode is
scored with the four `rmse_x,<t1>,<rmse>,<sd>` lines and written to
`<init_path>residualeval.pkl`.

With `--expert_actions_quirk y` (the default, reference parity) the expert
decodes with [a, s] as its actions; the reference pipeline can diverge
through it. It runs on the GPU; `--device c` asks for the CPU.
"""

from __future__ import annotations

import argparse

import torch

from .. import resolve_device
from ..data import RealCohort, make_real_standin
from ..inference import init_vi, variational_training_loop
from . import common
from .run_real import T0, horizon_report, write_eval
from .run_real_ensemble import _predict, init_and_load

MULTIPLIER = 0.1


def run(seed=666, train_sample_size=None, ode_method="explicit_adams", niters=1500, ode_step_div=1,
        encoder_output_dim=20, encoder_latent_ratio=1.2, init_path="model/", data_path="data/", standin=False,
        model_dir="model/", expert_actions_quirk=True, device=None):
    """-> the horizon report [(t1, rmse, sd)] of the residual hybrid's test forecast."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)

    if standin:
        make_real_standin(data_path, data_type="5")
    dg = RealCohort(data_path=data_path, data_type="5", latent_dim=10, val_size=100, test_size=1000, device=device)
    dg.split_sample()
    if train_sample_size is not None:
        dg.set_train_size(train_sample_size)
        init_path = init_path + str(train_sample_size)

    params_e, model_e = init_and_load(dg, 4, encoder_latent_ratio, ode_step_div, "expert", ode_method, init_path,
                                      generator, T0, device)

    # Residualise the train fold past t0: the expert encodes the FULL sequence.
    train = dg.data_train
    x_hat = _predict(params_e, model_e, train, train["measurements"].shape[0], expert_quirk=expert_actions_quirk)
    x = train["measurements"]
    dg.data_train = dict(train)
    dg.data_train["measurements"] = torch.cat([x[:T0], x[T0:] - x_hat * MULTIPLIER])
    dg.data_val = dg.data_train
    dg.val_size = dg.train_size

    path = model_dir if train_sample_size is None else model_dir + str(train_sample_size)
    model_ml = common.build_real_model(
        "gruode", dg.obs_dim, dg.action_dim, dg.static_dim, dg.t_max, dg.step_size,
        encoder_output_dim=encoder_output_dim, encoder_latent_ratio=encoder_latent_ratio,
        ode_method=ode_method, ode_step_div=ode_step_div, t0=T0,
    )
    params_ml = init_vi(generator, model_ml, device=device)
    params_ml, _, _ = variational_training_loop(
        niters=niters, data_generator=dg, model=model_ml, params=params_ml, batch_size=100,
        lr=0.01, test_freq=100, generator=generator, path=path + "res", best_on_disk=1e9,
        early_stop=10, shuffle=False, train_expert=True,
    )

    data = dg.data_test
    x_hat1 = _predict(params_e, model_e, data, T0, expert_quirk=expert_actions_quirk)
    x_hat2 = _predict(params_ml, model_ml, data, T0, expert_quirk=False)
    x_hat = (x_hat1 * MULTIPLIER + x_hat2).cpu().numpy()

    x, mask = data["measurements"].cpu().numpy(), data["masks"].cpu().numpy()
    write_eval(init_path + "residual" + "eval.pkl", x, x_hat, mask, "residual", None)
    return horizon_report(x, x_hat, mask, T0)


def main(argv=None):
    parser = argparse.ArgumentParser("Real data residual")
    parser.add_argument("--method", choices=["residual"], default="residual", type=str)
    parser.add_argument("--device", choices=["0", "1", "c"], default="1", type=str,
                        help="c: run on the CPU; 0 or 1: run on the GPU")
    parser.add_argument("--seed", default=666, type=int)
    parser.add_argument("--ode_method", default="explicit_adams", type=str)
    parser.add_argument("--ode_step_div", default=1, type=int)
    parser.add_argument("--encoder_output_dim", default=20, type=int)
    parser.add_argument("--encoder_latent_ratio", default=1.2, type=float)
    parser.add_argument("--niters", default=1500, type=int)
    parser.add_argument("--init_path", default="model/", type=str)
    parser.add_argument("--sample", default=None, type=int)
    parser.add_argument("--data_path", default="data/", type=str)
    parser.add_argument("--standin", default="n", type=str)
    parser.add_argument("--expert_actions_quirk", choices=["y", "n"], default="y", type=str,
                        help="y (reference parity): the expert residualiser decodes with [a, s] as actions, "
                             "which can make the reference pipeline diverge; n: plain dose actions")
    args = parser.parse_args(argv)

    run(seed=args.seed, train_sample_size=args.sample, ode_method=args.ode_method, niters=args.niters,
        ode_step_div=args.ode_step_div, encoder_output_dim=args.encoder_output_dim,
        encoder_latent_ratio=args.encoder_latent_ratio, init_path=args.init_path,
        data_path=args.data_path, standin=args.standin == "y",
        expert_actions_quirk=args.expert_actions_quirk == "y",
        device="cpu" if args.device == "c" else "cuda")


if __name__ == "__main__":
    main()
