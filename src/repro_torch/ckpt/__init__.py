"""Checkpoints (port of ``src/repro/ckpt``)."""
