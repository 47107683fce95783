"""Shared CLI plumbing (counterpart of `resolve_data_config` and `build_sim_model`, hybridode/cli/common.py:30-112).

Same signatures and the same spec values as the JAX package. The flow
posterior is not ported yet.
"""

from __future__ import annotations

from ..config import DataConfig, dim8_config, dim12_config
from ..inference.elbo import VIModel
from ..models.decoders import SimDecoderSpec
from ..models.encoders import EncoderLSTMSpec


def resolve_data_config(name: str | None, sample: int) -> DataConfig:
    if name == "dim8":
        return dim8_config
    if name == "dim12":
        return dim12_config
    return DataConfig(n_sample=sample)


def build_sim_model(
    method: str,
    data_config: DataConfig,
    encoder_output_dim: int | None = None,
    elbo: bool = True,
    ode_method: str = "dopri5",
    ablate: bool = False,
    mc_size: int = 100,
    max_steps: int | None = None,
    rtol: float = 1e-7,
    atol: float = 1e-8,
    flow: bool = False,
    num_flows: int = 4,
    lockstep: bool = False,
) -> VIModel:
    """expert / neural / hybrid -> VIModel.

    expert: 4 encoder latents, Roche field, Exponential prior, positivity
    normalisation. neural: full latents, black-box field, analytic-normal KL,
    no normalisation. hybrid: full latents, Roche+ml field, Exponential prior.
    """
    if flow:
        raise NotImplementedError("the flow posterior is not ported yet (ROADMAP.md, queue 1, item 6)")
    obs = data_config.obs_dim
    act = data_config.action_dim
    neural = method == "neural"
    if encoder_output_dim is None:
        encoder_output_dim = 4 if method == "expert" else data_config.latent_dim

    normalize = not neural
    prior = None if neural else "exponential"
    roche = not neural
    if max_steps is None:
        # Roche fields: per-patient control (~112 accepted steps per patient
        # at most, plus rejections); the smooth neural field solves in
        # lockstep in ~25 steps and keeps the generous budget.
        max_steps = (4096 if lockstep else 256) if roche else 512

    hidden = int(obs * 2.0)  # encoder_latent_ratio=2.0
    enc = EncoderLSTMSpec(obs + act, hidden, encoder_output_dim, normalize=normalize)
    dec = SimDecoderSpec(
        obs,
        encoder_output_dim,
        act,
        t_max=data_config.t_max,
        step_size=data_config.step_size,
        roche=roche,
        ablate=ablate,
        method=ode_method,
        max_steps=max_steps,
        rtol=rtol,
        atol=atol,
        per_sample_control=roche and not lockstep,
        use_adjoint=roche and lockstep,
        max_record=1024 if (roche and lockstep) else None,
    )
    return VIModel(kind="sim", encoder_spec=enc, decoder_spec=dec, elbo=elbo, prior=prior, mc_size=mc_size)
