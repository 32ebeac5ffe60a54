"""Data pipelines of the port (synthetic LM batches, synthetic biosignals)."""
