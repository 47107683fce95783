from .checkpoint import load_checkpoint, save_checkpoint
from .elbo import (PRIORS, VIModel, decode, encode, flow_loss, flow_mc_kl, forecast_loss, init_vi, loss_fn, mc_kl,
                   real_loss, sim_loss)
from .train import make_eval_loss, make_optimizer, train_step, variational_training_loop

__all__ = [
    "VIModel",
    "PRIORS",
    "decode",
    "encode",
    "init_vi",
    "loss_fn",
    "sim_loss",
    "real_loss",
    "flow_loss",
    "mc_kl",
    "flow_mc_kl",
    "forecast_loss",
    "load_checkpoint",
    "save_checkpoint",
    "make_optimizer",
    "make_eval_loss",
    "train_step",
    "variational_training_loop",
]
