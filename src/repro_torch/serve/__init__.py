"""Serving stack of the port: paged engine, page pool, greedy sampling."""
