"""Seconds the program spent capturing its CUDA graphs (step and validation) during set-up: its `capture` events."""


def read(rec):
    captures = rec.get("captures")
    return sum(s for _, s in captures) if captures else None
