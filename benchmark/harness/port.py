"""The program under test, built the way its CLIs build it: cohort, model and parameters of a configuration,
by the builder of the configuration's kind (`benchmark/builders/<kind>.py`)."""

from __future__ import annotations

import importlib


def family(cfg: dict):
    """The builder module of the configuration's kind."""
    return importlib.import_module(f"benchmark.builders.{cfg['kind']}")


def cohort(cfg: dict, root: str, device):
    """The configuration's cohort, loaded by the program and cut to the configuration's fold sizes (the first
    patients of each fold, as the program's own `set_*_size` keep them)."""
    data = family(cfg).cohort(cfg, root, device)
    for fold in ("train", "val", "test"):
        n = cfg["cohort"][fold]
        setattr(data, f"data_{fold}", {k: v[:, :n] for k, v in getattr(data, f"data_{fold}").items()})
        setattr(data, f"{fold}_size", n)
    return data


def model(cfg: dict, method: dict | None = None):
    """The program's model of `cfg`; `method` ({"ode_method", "ode_step_size"}) replaces the decoder's solve."""
    return family(cfg).model(cfg, method)


def params(vi, weights: dict, device):
    """The program's parameter tree for `vi`, holding `weights`."""
    import torch

    from hybridode_torch.inference import init_vi

    from . import weights as w

    tree = init_vi(torch.Generator().manual_seed(0), vi, device=device)  # the tree's structure; values replaced
    w.load_into(tree, weights)
    return tree
