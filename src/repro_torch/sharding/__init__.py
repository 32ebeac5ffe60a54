"""Parameter declarations and logical axes (port of ``repro/sharding``)."""
