"""Distributions of the port's models (port of boom_tpu/dists)."""

from boom_tpu_torch.dists.continuous import (
    beta,
    gamma,
    normal,
    scaled_inv_chisq,
)
from boom_tpu_torch.dists.discrete import beta_binomial, categorical
from boom_tpu_torch.dists.multivariate import dirichlet, mvt
from boom_tpu_torch.dists.truncated import trun_gamma_lower_fast

__all__ = ["beta", "beta_binomial", "categorical", "dirichlet", "gamma",
           "mvt", "normal", "scaled_inv_chisq", "trun_gamma_lower_fast"]
