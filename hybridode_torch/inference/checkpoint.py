"""Checkpoints in the JAX package's format (counterpart of hybridode/inference/checkpoint.py:22-43).

A checkpoint is a pickled dict {itr, encoder_state_dict, decoder_state_dict,
best_loss} whose state dicts are the JAX parameter trees with numpy leaves,
so either package loads what the other wrote.
"""

from __future__ import annotations

import os
import pickle

from ..convert import params_from_jax, params_to_jax
from ..utils.pickling import load_pickle


def save_checkpoint(path: str, model_name: str, params, itr: int, best_loss: float) -> str:
    full = path + model_name
    os.makedirs(os.path.dirname(full) or ".", exist_ok=True)
    payload = {
        "itr": int(itr),
        "encoder_state_dict": params_to_jax(params["encoder"]),
        "decoder_state_dict": params_to_jax(params["decoder"]),
        "best_loss": float(best_loss),
    }
    with open(full, "wb") as f:
        pickle.dump(payload, f)
    return full


def load_checkpoint(path: str, model_name: str, device=None):
    """-> (params on `device`, itr, best_loss)."""
    payload = load_pickle(path + model_name)
    tree = {"encoder": payload["encoder_state_dict"], "decoder": payload["decoder_state_dict"]}
    return params_from_jax(tree, device), payload["itr"], payload["best_loss"]
