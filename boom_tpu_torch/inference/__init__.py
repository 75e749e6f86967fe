"""MCMC driver and diagnostics (port of boom_tpu/inference)."""
