"""State-space models (port of boom_tpu/statespace)."""
