"""The dim12 LHM (obs 80, latent 12 = 4 expert + 8 learned states, encoder LSTM 160) on the CPU.

The benchmark's files for it (`benchmark/configs/lhm_sim_dim12.json`, its
cell, its committed cohort), and the port's plain path at its widths against
the benchmark's float64 plain reference (`benchmark/reference/sim.py`), from
the same seeded weights and noise: a forecast of 4 patients with 3 draws,
held to the cell's limit, and a training batch's loss and gradient, held to
the limits of the simulation training cell.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from benchmark.generators import forecast
from benchmark.harness import compare, port, spec as spec_mod, weights
from benchmark.reference import cohort as ref_cohort
from benchmark.reference import sim as ref_sim
from hybridode_torch.eval import evaluate
from hybridode_torch.inference import elbo
from hybridode_torch.utils import logging as tracing

ROOT = spec_mod.ROOT
CELL = "sim_dim12.forecast_dopri5"
CPU = torch.device("cpu")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
TRAIN_LIMITS = json.load(open(os.path.join(ROOT, "benchmark", "limits", "sim_hybrid.train.json")))


@pytest.fixture(scope="module")
def spec():
    return spec_mod.load(CELL)


def test_the_configuration_is_the_papers_dim12_at_published_widths(spec):
    entry = next(c for c in BENCH["configs"] if c["name"] == "lhm_sim_dim12")
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    cfg = spec.config
    assert entry["reduced"] == cfg["reduced"] == [] and cfg["published"] == {}
    assert max(len(entry["source"]), len(entry["why"]), len(cell["why"]), len(cfg["source"])) <= 200
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("lhm_sim_dim12", "forecast_dopri5", 1)
    assert (cfg["obs_dim"], cfg["latent_dim"], cfg["expert_dim"], cfg["encoder_hidden_dim"]) == (80, 12, 4, 160)
    vi = port.model(cfg, spec.mix)
    dec = vi.decoder_spec
    assert (dec.obs_dim, dec.latent_dim, vi.encoder_spec.hidden_dim) == (80, 12, 160)
    assert dec.per_sample_control and not dec.use_adjoint and dec.method == "dopri5"
    assert (dec.rtol, dec.atol, dec.max_steps) == (1e-7, 1e-8, 256)


def test_the_committed_cohort_has_the_configurations_split_and_widths(spec):
    c = spec.config["cohort"]
    arrays, split = ref_sim.arrays(c, ROOT)
    assert split == (c["train"], c["val"], c["test"]) == (1000, 100, 1000)
    assert sum(split) == c["n_sample"] == 2100
    assert arrays["measurements"].shape == arrays["masks"].shape == (15, 2100, 80)
    assert arrays["latents"].shape == (15, 2100, 12) and arrays["actions"].shape == (15, 2100, 1)
    state = ref_cohort.read_pickle(os.path.join(ROOT, c["path"]))["state"]
    assert (state["dose_max"], state["output_sparsity"], state["output_sigma"]) == (10, 0.75, 0.2)
    data = port.cohort(spec.config, ROOT, CPU)
    assert (data.train_size, data.val_size, data.test_size) == split


def test_a_forecast_of_the_plain_path_agrees_with_the_reference(spec):
    """`evaluate` of 4 test patients with 3 draws (t0 5) on the CPU, against the reference's six numbers."""
    cfg, mix = spec.config, dict(spec.mix, patients_per_request=4, mc_itr=3)
    w0 = weights.make(cfg, 3_000_000_019, CPU)
    vi = port.model(cfg, mix)
    params = port.params(vi, w0, CPU)
    data = port.cohort(cfg, ROOT, CPU)
    chunk = 7
    view = copy.copy(data)
    view.data_test = {k: v[:, chunk * 4:chunk * 4 + 4] for k, v in data.data_test.items()}
    view.test_size = 4
    np.random.seed(11)
    got = evaluate(params, vi, view, 4, mix["t0"], mc_itr=3, generator=torch.Generator().manual_seed(5), verbose=False,
                   device=CPU)
    decode = tracing.RECORDER.last("decode")
    assert decode.fields == {"rows": 16, "dim": 12, "route": "plain"}
    test = ref_cohort.load(cfg, ROOT)["test"]
    want, trials = forecast.reference(cfg, mix, (chunk, 5, 11), w0, test, CPU)
    assert np.isfinite(got).all() and trials is not None and trials.shape == (16,)
    assert forecast.score_gap(got, want) <= spec.limits["scores"]["limit"]


def test_a_training_loss_and_gradient_of_the_plain_path_agree_with_the_reference(spec):
    """The ELBO of 4 training patients and its gradient, from the same weights and noise, against the reference's in
    float64, within the limits of the simulation training cell (`loss1`, `grad`)."""
    cfg = spec.config
    w0 = weights.make(cfg, 4_100_007_919, CPU)
    vi = port.model(cfg)
    params = port.params(vi, w0, CPU)
    data = port.cohort(cfg, ROOT, CPU)
    batch = {k: v[:, 10:14] for k, v in data.data_train.items()}
    gen = torch.Generator().manual_seed(8)
    eps, eps_kl = torch.randn(4, 12, generator=gen), torch.randn(cfg["mc_size"], 4, 12, generator=gen)
    loss = elbo.sim_loss(params, vi, batch, eps=eps, eps_kl=eps_kl)
    named = {n: t for n, t in params.named_parameters() if t.requires_grad}
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))

    ref_batch = {k: torch.as_tensor(v[:, 10:14], dtype=torch.float64)
                 for k, v in ref_cohort.load(cfg, ROOT)["train"].items()}
    names = ref_sim.trainable(cfg)
    p = {n: t.double().requires_grad_(n in names) for n, t in w0.items()}
    want, _ = ref_sim.loss(cfg, p, ref_batch, (eps.double(), eps_kl.double()))
    want_grads = dict(zip(names, torch.autograd.grad(want, [p[n] for n in names])))

    assert set(grads) == set(want_grads)
    assert compare.rel_gap(float(loss.detach()), float(want.detach())) <= TRAIN_LIMITS["loss1"]["limit"]
    assert compare.worst_leaf_gap(grads, want_grads, names) <= TRAIN_LIMITS["grad"]["limit"]
