"""Command-line plumbing. The CLIs themselves come with the training slice."""
