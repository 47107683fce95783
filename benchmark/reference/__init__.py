"""The benchmark's plain reference of the measured models: plain PyTorch and numpy, nothing of the program."""
