from .checkpoint import load_checkpoint, save_checkpoint
from .elbo import VIModel, decode, encode, init_vi

__all__ = ["VIModel", "decode", "encode", "init_vi", "load_checkpoint", "save_checkpoint"]
