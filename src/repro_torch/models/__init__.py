"""Model families of the port (the dense transformer: training and decode)."""
