"""Model families of the port (transformer decode path so far)."""
