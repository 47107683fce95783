"""Command-line entry points of the port: `python -m hybridode_torch.cli.<name>`, each with the JAX CLI's flags."""
