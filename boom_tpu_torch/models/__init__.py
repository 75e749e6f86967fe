"""Models of the port (port of boom_tpu/models)."""
