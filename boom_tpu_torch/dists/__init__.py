"""Distributions on the bsts path (port of boom_tpu/dists)."""

from boom_tpu_torch.dists.continuous import gamma, scaled_inv_chisq
from boom_tpu_torch.dists.discrete import categorical
from boom_tpu_torch.dists.multivariate import mvt
from boom_tpu_torch.dists.truncated import trun_gamma_lower_fast

__all__ = ["categorical", "gamma", "mvt", "scaled_inv_chisq",
           "trun_gamma_lower_fast"]
