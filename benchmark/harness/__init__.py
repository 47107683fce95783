"""The harness: what every cell shares, driven by the files that name its configuration, traffic and metrics."""
