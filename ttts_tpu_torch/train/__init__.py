"""Training: train state and optimizer, steps, trainer, checkpoints, entry points."""
