"""The variational model: specs, initialisation, encode and decode.

Counterpart of `VIModel`, `init_vi`, `encode` and `decode` in
hybridode/inference/elbo.py:29-100, for the simulation track (`kind="sim"`).
The losses come with the training slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import resolve_device
from ..models import decoders, encoders, nn


class VIModel(NamedTuple):
    """Static description of an encoder/decoder pair + loss settings."""

    kind: str  # "sim" in this slice
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
