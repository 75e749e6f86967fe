"""Distributions of the port's models (port of boom_tpu/dists)."""

from boom_tpu_torch.dists.continuous import (
    beta,
    gamma,
    normal,
    scaled_inv_chisq,
)
from boom_tpu_torch.dists.discrete import beta_binomial, categorical
from boom_tpu_torch.dists.multivariate import dirichlet, mvn, mvt
from boom_tpu_torch.dists.truncated import trun_gamma_lower_fast, trun_normal

__all__ = ["beta", "beta_binomial", "categorical", "dirichlet", "gamma",
           "mvn", "mvt", "normal", "scaled_inv_chisq", "trun_gamma_lower_fast",
           "trun_normal"]
