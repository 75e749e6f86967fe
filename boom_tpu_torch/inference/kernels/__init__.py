"""MCMC kernels (port of boom_tpu/inference/kernels)."""
