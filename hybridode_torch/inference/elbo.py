"""The variational model and its losses, for the simulation (`kind="sim"`) and real-data (`kind="real"`) tracks.

Counterpart of `VIModel`, `init_vi`, `encode`, `decode`, `sim_loss`,
`real_loss`, `mc_kl`, `forecast_loss_terms`, `forecast_loss` and `loss_fn` in
hybridode/inference/elbo.py:29-249. The flow posterior (`kind="flow"`) is
not ported yet.

JAX draws the ELBO's noise from PRNG keys inside the loss. A key stream
cannot be replayed here, so the noise is explicit: the losses take the
draws themselves (`eps` of shape (B, D) for the reparameterisation, `eps_kl`
of shape (mc, B, D) for the Monte-Carlo KL) or a CPU `torch.Generator` to
draw them from. Draws are made on the CPU and then moved, so a CPU run and a
GPU run from one seed see the same noise. The real track's CLIs train the
masked MSE (`elbo=False`), which draws nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import decoders, encoders, nn, priors

EPSILON = float(np.finfo(np.float32).eps)

PRIORS = {
    "normal": priors.standard_normal_log_density,
    "exponential": priors.exponential_log_density,
}


class VIModel(NamedTuple):
    """Static description of an encoder/decoder pair + loss settings."""

    kind: str  # "sim" | "real" | "flow" (not ported)
    encoder_spec: NamedTuple
    decoder_spec: NamedTuple
    elbo: bool = True
    prior: Optional[str] = None  # None -> analytic Gaussian KL
    mc_size: int = 100
    t0: int = 24  # real-data only
    weight: bool = False  # real-data only

    @property
    def model_name(self) -> str:
        tag = "VI_FLOW" if self.kind == "flow" else "VI"
        return f"{tag}_{self.encoder_spec.model_name}_{self.decoder_spec.model_name}.pkl"


def _refuse_flow(model: VIModel):
    if model.kind == "flow":
        raise NotImplementedError("the flow posterior (VIModel kind 'flow') is not ported yet "
                                  "(ROADMAP.md, queue 1, item 6)")


def init_vi(generator: torch.Generator, model: VIModel, device=None) -> nn.ParamTree:
    """Random parameters {"encoder", "decoder"} drawn from a CPU generator, placed on `device`."""
    _refuse_flow(model)
    device = resolve_device(device)
    if model.kind == "real":
        enc = encoders.init_encoder_lstm_real(generator, model.encoder_spec, device=device)
    else:
        enc = encoders.init_encoder_lstm(generator, model.encoder_spec, device=device)
    spec = model.decoder_spec
    if isinstance(spec, decoders.RealDecoderSpec):
        dec = decoders.init_real_decoder(generator, spec, device=device)
    elif isinstance(spec, decoders.RealBenchmarkSpec):
        dec = decoders.init_real_benchmark(generator, spec, device=device)
    else:
        dec = decoders.init_sim_decoder(generator, spec, device=device)
    return nn.ParamTree({"encoder": enc, "decoder": dec})


def decode(params, model: VIModel, z, batch):
    _refuse_flow(model)
    spec = model.decoder_spec
    if isinstance(spec, decoders.RealDecoderSpec):
        return decoders.real_decoder_apply(params["decoder"], spec, z, batch["actions"], batch["statics"])
    if isinstance(spec, decoders.RealBenchmarkSpec):
        return decoders.real_benchmark_apply(params["decoder"], spec, z, batch["actions"], batch["statics"])
    return decoders.sim_decoder_apply(params["decoder"], spec, z, batch["actions"])


def encode(params, model: VIModel, x, a, mask):
    _refuse_flow(model)
    if model.kind == "real":
        return encoders.encoder_lstm_real_apply(params["encoder"], model.encoder_spec, x, a, mask)
    return encoders.encoder_lstm_apply(params["encoder"], model.encoder_spec, x, a, mask)


# --- losses -----------------------------------------------------------------------


def _analytic_gaussian_kl(mu, log_var):
    """KL(q || N(0, I)) averaged over the batch."""
    return torch.mean(-0.5 * torch.sum(1 + log_var - mu**2 - torch.exp(log_var), dim=-1))


def mc_kl(eps_kl, mu, log_var, prior_log_pdf):
    """Monte-Carlo KL over the draws `eps_kl` (mc, B, D), with the z <= 0 -> eps clamp; -> (B,)."""
    z = priors.gaussian_reparameterize(mu, log_var, eps_kl)
    z = torch.where(z <= 0.0, EPSILON, z)
    return torch.mean(priors.gaussian_log_density(mu, log_var, z) - prior_log_pdf(z), dim=0)


def draw_noise(model: VIModel, batch_size: int, generator: torch.Generator, device):
    """The ELBO's noise `(eps, eps_kl)`, drawn on the CPU in that order and moved to `device`.

    Without `model.elbo` there is none; with the analytic KL (`prior=None`) `eps_kl` is None.
    """
    if not model.elbo:
        return None, None
    D = model.encoder_spec.output_dim
    eps = torch.randn((batch_size, D), generator=generator).to(device)
    if model.prior is None:
        return eps, None
    return eps, torch.randn((model.mc_size, batch_size, D), generator=generator).to(device)


def sim_loss(params, model: VIModel, batch, generator: Optional[torch.Generator] = None, *, eps=None,
             eps_kl=None):
    """ELBO of the simulation track: masked squared error of the decode plus the KL.

    The noise is `eps` / `eps_kl` when given, else drawn from `generator`.
    """
    x, a, mask = batch["measurements"], batch["actions"], batch["masks"]
    if model.elbo and eps is None:
        eps, eps_kl = draw_noise(model, x.shape[1], generator, x.device)

    mu, log_var = encode(params, model, x, a, mask)
    z = priors.gaussian_reparameterize(mu, log_var, eps) if model.elbo else mu
    x_hat, _ = decode(params, model, z, batch)

    lik = torch.sum((x - x_hat) ** 2 * mask) / x.shape[1]
    if not model.elbo:
        return lik
    return lik + _kl(model, mu, log_var, eps_kl)


def _kl(model: VIModel, mu, log_var, eps_kl):
    if model.prior is None:
        return _analytic_gaussian_kl(mu, log_var)
    return torch.mean(mc_kl(eps_kl, mu, log_var, PRIORS[model.prior]))


def real_loss(params, model: VIModel, batch, generator: Optional[torch.Generator] = None, *, eps=None,
              eps_kl=None):
    """t0-conditioned loss of the real track: encode [0, t0) of [x, a, statics], decode, masked MSE on x[t0:].

    With `model.weight` step k past t0 weighs 1/k. With `model.elbo` the KL is
    added, its noise `eps` / `eps_kl` given or drawn from `generator`; a
    per-step posterior (rank-3 `log_var`) takes the analytic KL.
    """
    x, a, mask, s = batch["measurements"], batch["actions"], batch["masks"], batch["statics"]
    t0 = model.t0
    if model.elbo and eps is None:
        eps, eps_kl = draw_noise(model, x.shape[1], generator, x.device)

    a_in = torch.cat([a, s], dim=-1)
    mu, log_var = encode(params, model, x[:t0], a_in[:t0], mask[:t0])
    z = priors.gaussian_reparameterize(mu, log_var, eps) if model.elbo else mu
    x_hat, _ = decode(params, model, z, batch)

    err = (x[t0:] - x_hat) ** 2 * mask[t0:]
    if model.weight:
        t_len = model.decoder_spec.t_max - t0
        err = err * (1.0 / torch.arange(1, t_len + 1, dtype=x.dtype, device=x.device))[:, None, None]
    lik = torch.sum(err) / x.shape[1]
    if not model.elbo:
        return lik
    if log_var.ndim == 2:
        return lik + _kl(model, mu, log_var, eps_kl)
    return lik + _analytic_gaussian_kl(mu, log_var)


def forecast_loss_terms(params, model: VIModel, batch, t0: int):
    """(masked squared-error sum, mask count) behind forecast_loss.

    The real track encodes [x, a, statics]; its decoders already emit x[t0:].
    """
    x, a, mask = batch["measurements"], batch["actions"], batch["masks"]
    if model.kind == "real":
        a = torch.cat([a, batch["statics"]], dim=-1)
    z, _ = encode(params, model, x[:t0], a[:t0], mask[:t0])
    x_hat, _ = decode(params, model, z, batch)
    pred = x_hat[: x.shape[0] - t0] if model.kind == "real" else x_hat[t0:]
    num = torch.sum((x[t0:] - pred) ** 2 * mask[t0:])
    den = torch.sum(mask[t0:])
    return num, den


def forecast_loss(params, model: VIModel, batch, t0: int):
    """Deterministic forecast error: encode x[:t0] (posterior mean), decode, masked MSE on x[t0:].

    The validation criterion of the CLI's default `--val_criterion forecast`.
    """
    num, den = forecast_loss_terms(params, model, batch, t0)
    return num / torch.clamp(den, min=1.0)


def loss_fn(params, model: VIModel, batch, generator: Optional[torch.Generator] = None, **noise):
    """The training loss of `model`: `sim_loss` or `real_loss` by its kind."""
    if model.kind == "real":
        return real_loss(params, model, batch, generator, **noise)
    return sim_loss(params, model, batch, generator, **noise)
