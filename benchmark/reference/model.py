"""The plain reference of the Latent Hybrid Models that the benchmark measures: training, for every family.

Written from the published models (Qian et al., NeurIPS 2021, "Integrating
Expert ODEs into Neural ODEs") in plain PyTorch. It imports nothing of the
program under test: the parameters, the cohort tensors and the noise come in
as arguments, in whatever dtype the caller chose (float64 for the
comparisons, float32 with TF32 for the control).

Each configuration's `kind` names its model family, the module
`benchmark/reference/<kind>.py`, found by name. A family gives `layout(cfg)`
(trainable leaves -> (shape, uniform bound), constants -> value),
`trainable(cfg)`, `arrays(cohort, root)` (its cohort's arrays and split),
`loss(cfg, p, batch, noise)` -> (loss, per-patient trial steps or None) and
`validation(cfg, mix, p, chunk)` -> float; a family that forecasts also
gives `encode` and `decode` (`scores.py`).
"""

from __future__ import annotations

import importlib
import math

import torch


def family(cfg: dict):
    """The reference module of the configuration's kind."""
    return importlib.import_module(f"{__package__}.{cfg['kind']}")


def layout(cfg: dict) -> tuple[dict, dict]:
    return family(cfg).layout(cfg)


def trainable(cfg: dict) -> list[str]:
    """Names of the leaves that Adam updates, in the layout's order."""
    return family(cfg).trainable(cfg)


class Adam:
    """Adam (Kingma and Ba) with its bias corrections: p -= lr m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, lr, names, params, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.names, self.betas, self.eps, self.t = lr, names, betas, eps, 0
        self.m = {n: torch.zeros_like(params[n]) for n in names}
        self.v = {n: torch.zeros_like(params[n]) for n in names}

    @torch.no_grad()
    def step(self, params, grads):
        b1, b2 = self.betas
        self.t += 1
        for n in self.names:
            g = grads[n]
            if g is None:  # a leaf the loss does not reach (the real track's log_var head) is not stepped
                continue
            self.m[n] = b1 * self.m[n] + (1 - b1) * g
            self.v[n] = b2 * self.v[n] + (1 - b2) * g * g
            m_hat = self.m[n] / (1 - b1 ** self.t)
            v_hat = self.v[n] / (1 - b2 ** self.t)
            params[n] = params[n] - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)


def validation(cfg, mix, p, chunks):
    """The validation total over the chunks of the validation fold, as float (1e9 for a chunk that diverged)."""
    fam, total = family(cfg), 0.0
    with torch.no_grad():
        for chunk in chunks:
            value = fam.validation(cfg, mix, p, chunk)
            total += value if math.isfinite(value) else 1e9
    return total


def train_steps(cfg, mix, params, batches, noises, val_chunks):
    """Adam steps on `batches` from `params` -> dict(losses, first_grads, params, val, trials).

    `first_grads` are the gradients of the first step, `params` the leaves
    after the last, `val` the validation total at `params`, `trials` the
    trial steps each patient's solve needed, over all steps (or None).
    """
    fam, names = family(cfg), trainable(cfg)
    p = dict(params)
    val = validation(cfg, mix, p, val_chunks)
    adam = Adam(mix["lr"], names, p)
    losses, first, trials = [], None, []
    for batch, noise in zip(batches, noises):
        leaves = {n: p[n].detach().requires_grad_(True) for n in names}
        p.update(leaves)
        loss, tr = fam.loss(cfg, p, batch, noise)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)))
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: torch.zeros_like(leaves[n]) if g is None else g for n, g in grads.items()}
        if tr is not None:
            trials.append(tr)
        adam.step(p, grads)
    p = {n: t.detach() for n, t in p.items()}
    return dict(losses=losses, first_grads=first, params=p, val=val, trials=torch.cat(trials) if trials else None)
