"""Runtime of the port: the serving engine's request journal."""
