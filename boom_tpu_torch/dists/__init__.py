"""Distributions on the bsts path (port of boom_tpu/dists)."""

from boom_tpu_torch.dists.continuous import gamma, scaled_inv_chisq
from boom_tpu_torch.dists.truncated import trun_gamma_lower_fast

__all__ = ["gamma", "scaled_inv_chisq", "trun_gamma_lower_fast"]
