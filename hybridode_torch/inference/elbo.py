"""The variational model and its losses, for the simulation track (`kind="sim"`).

Counterpart of `VIModel`, `init_vi`, `encode`, `decode`, `sim_loss`,
`mc_kl`, `forecast_loss_terms`, `forecast_loss` and `loss_fn` in
hybridode/inference/elbo.py:29-249.

JAX draws the ELBO's noise from PRNG keys inside the loss. A key stream
cannot be replayed here, so the noise is explicit: `sim_loss` takes the
draws themselves (`eps` of shape (B, D) for the reparameterisation, `eps_kl`
of shape (mc, B, D) for the Monte-Carlo KL) or a CPU `torch.Generator` to
draw them from. Draws are made on the CPU and then moved, so a CPU run and a
GPU run from one seed see the same noise.
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

    kind: str  # "sim" is ported
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


def _require_sim(model: VIModel):
    if model.kind != "sim":
        raise NotImplementedError(f"VIModel kind {model.kind!r} is not ported yet (ROADMAP.md, queue 1)")


def init_vi(generator: torch.Generator, model: VIModel, device=None) -> nn.ParamTree:
    """Random parameters {"encoder", "decoder"} drawn from a CPU generator, placed on `device`."""
    _require_sim(model)
    device = resolve_device(device)
    return nn.ParamTree({
        "encoder": encoders.init_encoder_lstm(generator, model.encoder_spec, device=device),
        "decoder": decoders.init_sim_decoder(generator, model.decoder_spec, device=device),
    })


def decode(params, model: VIModel, z, batch):
    _require_sim(model)
    return decoders.sim_decoder_apply(params["decoder"], model.decoder_spec, z, batch["actions"])


def encode(params, model: VIModel, x, a, mask):
    _require_sim(model)
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
    if model.prior is None:
        kld = _analytic_gaussian_kl(mu, log_var)
    else:
        kld = torch.mean(mc_kl(eps_kl, mu, log_var, PRIORS[model.prior]))
    return lik + kld


def forecast_loss_terms(params, model: VIModel, batch, t0: int):
    """(masked squared-error sum, mask count) behind forecast_loss."""
    x, a, mask = batch["measurements"], batch["actions"], batch["masks"]
    z, _ = encode(params, model, x[:t0], a[:t0], mask[:t0])
    x_hat, _ = decode(params, model, z, batch)
    num = torch.sum((x[t0:] - x_hat[t0:]) ** 2 * mask[t0:])
    den = torch.sum(mask[t0:])
    return num, den


def forecast_loss(params, model: VIModel, batch, t0: int):
    """Deterministic forecast error: encode x[:t0] (posterior mean), decode, masked MSE on x[t0:].

    The validation criterion of the CLI's default `--val_criterion forecast`.
    """
    num, den = forecast_loss_terms(params, model, batch, t0)
    return num / torch.clamp(den, min=1.0)


def loss_fn(params, model: VIModel, batch, generator: Optional[torch.Generator] = None, **noise):
    """The training loss of `model`: the ELBO of the simulation track (the only kind ported)."""
    return sim_loss(params, model, batch, generator, **noise)
