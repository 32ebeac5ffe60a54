"""The X-HEEP platform model of the port: power domains, the calibrated
energy model, the XAIF accelerator registry and the platform object."""
