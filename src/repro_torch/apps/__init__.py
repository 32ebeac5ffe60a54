"""The paper's applications on the port: the healthcare pipeline."""
