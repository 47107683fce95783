"""Evaluation sharded over a 2-D (patients x MC samples) mesh (counterpart of hybridode/parallel/eval.py).

`evaluate` decodes `mc_itr` posterior samples of every test patient. Its two
independent axes map onto a 2-D mesh of ranks:

* ``data``: the patient axis: each rank encodes and decodes its block of the
  chunk's patients;
* ``mc``: the Monte-Carlo axis: each rank decodes `mc_itr / n_mc` samples of
  its patient block, in one decode with the point latent ((MC_local + 1) x
  B_local trajectories: at `method="rk4"` one kernel launch a chunk a rank).

Every rank draws the chunk's whole noise with `draw_chunk_noise` from the
same generator and takes its patient and MC block (JAX's `_reparam_block`,
eval.py:34-48), so the sharded result uses `evaluate`'s very draws. CRPS
ranks the whole sample set, so the MC decodes are exchanged with one
all-gather over the ``mc`` group before it; the per-patient terms are then
the same on every ``mc`` rank and are gathered over the ``data`` group.
A call is a root span with `evaluate`'s children (`eval/metrics.py`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..eval.metrics import _point_scores, _point_terms, _seeded, _test_chunks, draw_chunk_noise
from ..inference.elbo import VIModel, decode, encode
from ..models import encoders, priors
from ..utils.logging import root_span, span
from .mesh import all_gather_rows, axis, block


def check_sharded_eval(mc_itr: int, batch_size: int, n_data: int, n_mc: int) -> None:
    """The splits a sharded evaluation needs, with JAX's messages (eval.py:90-91, 162-165)."""
    if mc_itr % n_mc:
        raise ValueError(f"mc_itr={mc_itr} not divisible by mc shards={n_mc}")
    if batch_size % n_data:
        raise ValueError(
            f"batch_size {batch_size} not divisible by the data mesh axis ({n_data}); "
            "sharded eval chunks must split evenly over devices")


def make_sharded_eval_chunk(model: VIModel, mesh, t0: int, mc_itr: int, expert_dim: int, data_axis: str = "data",
                            mc_axis: str = "mc"):
    """-> `chunk(params, batch, eps, eps_point=None)` -> per-patient (err_z0, err_x, crps_z0, crps_x) of the
    whole chunk, the sharded twin of `eval.metrics._eval_chunk` on the same draws (`eps` (MC, B, D),
    `eps_point` (B, D) for the flow's point), on every rank of the mesh."""
    data_group, i_data, n_data = axis(mesh, data_axis)
    mc_group, i_mc, n_mc = axis(mesh, mc_axis)
    if mc_itr % n_mc:
        raise ValueError(f"mc_itr={mc_itr} not divisible by mc shards={n_mc}")

    @torch.no_grad()
    def chunk(params, batch, eps, eps_point=None):
        local = {k: block(v, 1, i_data, n_data) for k, v in batch.items()}
        eps_loc = block(block(eps, 1, i_data, n_data), 0, i_mc, n_mc)  # (MC_loc, B_loc, D)
        with span("encode"):
            enc = encode(params, model, local["measurements"][:t0], local["actions"][:t0], local["masks"][:t0])
        if model.kind == "flow":
            K = model.encoder_spec.num_flows
            z0_hat = encoders.planar_reparameterize(enc, K, block(eps_point, 0, i_data, n_data))[2]
            z_mc = encoders.planar_reparameterize(enc, K, eps_loc)[2]
        else:
            mu, log_var = enc
            z0_hat, z_mc = mu, priors.gaussian_reparameterize(mu, log_var, eps_loc)
        mc, B, D = eps_loc.shape
        z_all = torch.cat([z0_hat[None], z_mc]).reshape((mc + 1) * B, D)  # the point, then the local draws
        with span("decode", rows=(mc + 1) * B, dim=D):
            x_all, _ = decode(params, model, z_all, {"actions": local["actions"].repeat(1, mc + 1, 1)})
        x_all = x_all.reshape(x_all.shape[0], mc + 1, B, -1)
        x_hat, x_mc = x_all[:, 0], x_all[:, 1:].transpose(0, 1)  # (T, B, obs), (MC_loc, T, B, obs)
        z_mc = all_gather_rows(z_mc, mc_group, n_mc)  # (MC, B_loc, D): every mc rank holds all samples
        x_mc = all_gather_rows(x_mc, mc_group, n_mc)  # (MC, T, B_loc, obs)
        terms = torch.stack(_point_terms(local, t0, expert_dim, z0_hat, z_mc, x_hat, x_mc), dim=1)  # (B_loc, 4)
        return all_gather_rows(terms, data_group, n_data).unbind(1)

    return chunk


@root_span
def evaluate_sharded(params, model: VIModel, data_generator, batch_size: int, t0: int, mesh, mc_itr: int = 50,
                     generator: Optional[torch.Generator] = None, verbose: bool = True, device=None):
    """Mesh-parallel twin of `eval.metrics.evaluate`: its chunks, its draws from `generator` (seed 0 when None)
    and its CSV; each chunk sharded (patients x MC). Every rank of the mesh calls it; rank 0 prints.

    -> the six numbers of `evaluate`.
    """
    from .. import resolve_device
    from .launch import is_writer

    device, generator = resolve_device(device), _seeded(generator)
    _, _, n_data = axis(mesh, "data")
    _, _, n_mc = axis(mesh, "mc")
    check_sharded_eval(mc_itr, batch_size, n_data, n_mc)
    chunk_fn = make_sharded_eval_chunk(model, mesh, t0, mc_itr, data_generator.expert_dim)
    tots = [[], [], [], []]
    for batch in _test_chunks(data_generator, batch_size, device):
        noise = draw_chunk_noise(model, mc_itr, batch_size, generator, device)
        for acc, out in zip(tots, chunk_fn(params, batch, *noise)):
            acc.append(out.cpu().numpy())
    return _point_scores(*(np.concatenate(t) for t in tots), verbose and is_writer())
