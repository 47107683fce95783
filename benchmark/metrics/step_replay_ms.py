"""Mean device milliseconds of one replay of the training step's CUDA graph in the window (CUDA events)."""


def read(rec):
    steps = rec.get("replays", {}).get("step")
    return sum(steps) / len(steps) if steps else None
