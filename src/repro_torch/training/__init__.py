"""Training of the port, after ``repro.training``: the synthetic token
stream, AdamW, flat-npz checkpoints and the eager training loop."""
