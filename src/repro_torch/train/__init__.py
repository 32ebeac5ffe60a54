"""Training of the port: optimizers and the single-device train step."""
