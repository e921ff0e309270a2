"""Training: optimizer and schedule, train state, train/eval steps,
checkpoints and the training loop (port of the JAX package's ``train/``)."""
