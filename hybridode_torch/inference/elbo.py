"""The variational model and its losses: the simulation track (`kind="sim"`), its
flow posterior (`kind="flow"`, LHM-NF) and the real-data track (`kind="real"`).

Counterpart of `VIModel`, `init_vi`, `encode`, `decode`, `sim_loss`,
`real_loss`, `mc_kl`, `flow_mc_kl`, `flow_loss`, `forecast_loss_terms`,
`forecast_loss` and `loss_fn` in hybridode/inference/elbo.py:29-249.

JAX draws the ELBO's noise from PRNG keys inside the loss. A key stream
cannot be replayed here, so the noise is explicit: the losses take the
draws themselves (`eps` of shape (B, D) for the reparameterisation, `eps_kl`
of shape (mc, B, D) for the Monte-Carlo KL, the flow's as the sim's) or a CPU
`torch.Generator` to draw them from. Draws are made on the CPU and then moved, so a CPU run and a
GPU run from one seed see the same noise. The real track's CLIs train the
masked MSE (`elbo=False`), which draws nothing.
"""

from __future__ import annotations

import functools
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

    kind: str  # "sim" | "real" | "flow"
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


def init_vi(generator: torch.Generator, model: VIModel, device=None) -> nn.ParamTree:
    """Random parameters {"encoder", "decoder"} drawn from a CPU generator, placed on `device`."""
    device = resolve_device(device)
    if model.kind == "flow":
        enc = encoders.init_encoder_planar_lstm(generator, model.encoder_spec, device=device)
    elif model.kind == "real":
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
    spec = model.decoder_spec
    if isinstance(spec, decoders.RealDecoderSpec):
        return decoders.real_decoder_apply(params["decoder"], spec, z, batch["actions"], batch["statics"])
    if isinstance(spec, decoders.RealBenchmarkSpec):
        return decoders.real_benchmark_apply(params["decoder"], spec, z, batch["actions"], batch["statics"])
    return decoders.sim_decoder_apply(params["decoder"], spec, z, batch["actions"])


def encode(params, model: VIModel, x, a, mask):
    """-> (mu, log_var), or for the flow posterior (mu, log_var, u, w, b)."""
    if model.kind == "flow":
        return encoders.encoder_planar_lstm_apply(params["encoder"], model.encoder_spec, x, a, mask)
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
    The flow posterior draws the same two (its `mc_size == 1` branch leaves `eps_kl` unused).
    """
    if not model.elbo:
        return None, None
    D = model.encoder_spec.output_dim
    eps = torch.randn((batch_size, D), generator=generator).to(device)
    if model.prior is None:
        return eps, None
    return eps, torch.randn((model.mc_size, batch_size, D), generator=generator).to(device)


def draw_loss_noise(model: VIModel, batch_size: int, generator: torch.Generator, device):
    """The noise `loss_fn` draws for a batch of `batch_size`: `draw_noise`'s, the flow's always (its decoded
    latent is a sample)."""
    return draw_noise(model._replace(elbo=True) if model.kind == "flow" else model, batch_size, generator, device)


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


def flow_mc_kl(eps_kl, encoder_out, model: VIModel, prior_log_pdf):
    """Monte-Carlo KL through the flow posterior over the draws `eps_kl` (mc, B, D); -> (B,).

    No z <= 0 clamp: the flow's exp(z - 5) layer keeps z positive (JAX has none either).
    """
    mu, log_var, z, log_det_j, z0 = encoders.planar_reparameterize(encoder_out, model.encoder_spec.num_flows,
                                                                   eps_kl)
    log_q = encoders.planar_log_density(mu, log_var, z, log_det_j, z0)
    return torch.mean(log_q - prior_log_pdf(z), dim=0)


def flow_loss(params, model: VIModel, batch, generator: Optional[torch.Generator] = None, *, eps=None,
              eps_kl=None):
    """ELBO of the flow posterior: masked squared error of the decode of one flow sample plus the KL.

    The noise is `eps` / `eps_kl` when given, else drawn from `generator`.
    With `mc_size == 1` the KL is log q - log p of the decoded sample itself
    (the JAX package's sign, which fixes the reference's log p - log q there).
    """
    x, a, mask = batch["measurements"], batch["actions"], batch["masks"]
    if eps is None:  # the decoded latent is a flow sample even without the ELBO, as in JAX
        eps, eps_kl = draw_noise(model._replace(elbo=True), x.shape[1], generator, x.device)

    encoder_out = encode(params, model, x, a, mask)
    mu, log_var, z, log_det_j, z0 = encoders.planar_reparameterize(encoder_out, model.encoder_spec.num_flows, eps)
    x_hat, _ = decode(params, model, z, batch)

    lik = torch.sum((x - x_hat) ** 2 * mask) / x.shape[1]
    if not model.elbo:
        return lik

    prior_log_pdf = PRIORS[model.prior]
    if model.mc_size == 1:
        kld = torch.mean(encoders.planar_log_density(mu, log_var, z, log_det_j, z0) - prior_log_pdf(z))
    else:
        kld = torch.mean(flow_mc_kl(eps_kl, encoder_out, model, prior_log_pdf))
    return lik + kld


@functools.lru_cache(maxsize=None)
def _fixed_point_draw(shape: tuple, dtype, device) -> torch.Tensor:
    """The flow's default `eps_point`: drawn on the CPU from a generator seeded 0, put on `device` once
    per (shape, dtype, device); never written to."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(device=device, dtype=dtype)


def forecast_loss_terms(params, model: VIModel, batch, t0: int, eps_point=None):
    """(masked squared-error sum, mask count) behind forecast_loss.

    The real track encodes [x, a, statics]; its decoders already emit x[t0:].
    The flow posterior's point is one flow sample of a fixed draw: `eps_point`
    (B, D), by default the draw of a CPU generator seeded 0, the same on every
    call and made once per shape and device (JAX uses PRNGKey(0)).
    """
    x, a, mask = batch["measurements"], batch["actions"], batch["masks"]
    if model.kind == "real":
        a = torch.cat([a, batch["statics"]], dim=-1)
    enc_out = encode(params, model, x[:t0], a[:t0], mask[:t0])
    if model.kind == "flow":
        if eps_point is None:
            eps_point = _fixed_point_draw(tuple(enc_out[0].shape), x.dtype, x.device)
        z = encoders.planar_reparameterize(enc_out, model.encoder_spec.num_flows, eps_point)[2]
    else:
        z = enc_out[0]
    x_hat, _ = decode(params, model, z, batch)
    pred = x_hat[: x.shape[0] - t0] if model.kind == "real" else x_hat[t0:]
    num = torch.sum((x[t0:] - pred) ** 2 * mask[t0:])
    den = torch.sum(mask[t0:])
    return num, den


def forecast_loss(params, model: VIModel, batch, t0: int):
    """Deterministic forecast error: encode x[:t0] (posterior mean, or the flow's fixed sample), decode,
    masked MSE on x[t0:].

    The validation criterion of the CLI's default `--val_criterion forecast`.
    """
    num, den = forecast_loss_terms(params, model, batch, t0)
    return num / torch.clamp(den, min=1.0)


def loss_fn(params, model: VIModel, batch, generator: Optional[torch.Generator] = None, **noise):
    """The training loss of `model`: `sim_loss`, `real_loss` or `flow_loss` by its kind."""
    losses = {"sim": sim_loss, "real": real_loss, "flow": flow_loss}
    if model.kind not in losses:
        raise ValueError(model.kind)
    return losses[model.kind](params, model, batch, generator, **noise)
