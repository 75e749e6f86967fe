"""State-model blocks on the bsts slice (port of
boom_tpu/statespace/state_models.py:35-246): ``SdPrior``, ``LocalLevel``,
``LocalLinearTrend`` and ``Seasonal``.

A block is a frozen dataclass of floats (the model spec) whose methods work
on a batch of chains:

    z(device, dtype)            -> [dim] observation weights
    build(params)               -> (T [C,dim,dim], R [C,dim,err], Q [C,err,err])
    init_dist(device, dtype)    -> (a0 [dim], P0 [dim,dim])
    init_noise_spec()           -> per-chain uniforms of init_params
    init_params(noise)          -> dict of [C] parameters
    noise_spec()                -> per-chain uniforms of draw_params
    draw_params(noise, params, path [C,T,dim]) -> dict of [C] parameters
    asis_groups()               -> [(param name, SdPrior, error dims)]

Random numbers come in through ``noise`` mappings (see
``boom_tpu_torch.rng``); the blocks never draw.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from boom_tpu_torch import dists
from boom_tpu_torch.dists.truncated import trun_gamma_lower_fast


def _sd(y: torch.Tensor) -> float:
    """Population standard deviation (ddof 0, as ``jnp.std``)."""
    return float(torch.std(y, correction=0))


@dataclasses.dataclass(frozen=True)
class SdPrior:
    """Prior on a standard deviation: sigma^2 ~ ScaledInvChisq(sample_size,
    sigma_guess^2) truncated to sigma <= upper_limit."""

    sigma_guess: float
    sample_size: float = 0.01
    upper_limit: float = float("inf")

    def draw_variance(self, u, n, sum_sq):
        """Conjugate draw of sigma^2 given n innovations with sum of squares
        ``sum_sq`` [C], by inverse CDF at the uniforms ``u`` [C]. A finite
        upper limit on sigma is a lower bound on the precision."""
        df = self.sample_size + n
        ss = self.sample_size * self.sigma_guess ** 2 + sum_sq
        if math.isinf(self.upper_limit):
            return dists.scaled_inv_chisq.sample(u, df, ss / df)
        prec = trun_gamma_lower_fast(u, 0.5 * df, 0.5 * ss,
                                     1.0 / self.upper_limit ** 2,
                                     newton_iters=8)
        return 1.0 / prec


def _innovations(path, t_mat):
    """eta rows path[:, t+1] - T path[:, t]: [C, T-1, dim]."""
    return path[:, 1:] - (t_mat[:, None] * path[:, :-1, None, :]).sum(-1)


def _chain_mats(mat, c):
    """[r, s] -> [C, r, s] (expanded, not copied)."""
    return mat.expand(c, *mat.shape)


@dataclasses.dataclass(frozen=True)
class LocalLevel:
    """Random-walk level (reference LocalLevelStateModel; bsts
    add.local.level)."""

    sigma_prior: SdPrior
    initial_mean: float = 0.0
    initial_sd: float = 1.0
    name: str = "local_level"
    dim: int = 1
    err_dim: int = 1

    @staticmethod
    def default(y, name="local_level"):
        sd = _sd(y)
        return LocalLevel(
            sigma_prior=SdPrior(sigma_guess=0.01 * sd, upper_limit=sd),
            initial_mean=float(y[0]), initial_sd=sd, name=name)

    def z(self, device, dtype):
        return torch.ones(1, device=device, dtype=dtype)

    def build(self, params):
        var = params["sigma_level_sq"]
        one = torch.ones(1, 1, device=var.device, dtype=var.dtype)
        c = var.shape[0]
        return (_chain_mats(one, c), _chain_mats(one, c),
                var[:, None, None])

    def init_dist(self, device, dtype):
        return (torch.tensor([self.initial_mean], device=device,
                             dtype=dtype),
                torch.tensor([[self.initial_sd ** 2]], device=device,
                             dtype=dtype))

    def init_noise_spec(self):
        return {"level_u": ((), "uniform")}

    def init_params(self, noise):
        # overdispersed data-scaled start: U(0.05, 0.5) of the sd, scaled
        # as jax.random.uniform scales its [0, 1) draw
        u = noise["level_u"] * (0.5 - 0.05) + 0.05
        return {"sigma_level_sq": (self.initial_sd * u) ** 2}

    def noise_spec(self):
        return {"level_u": ((), "uniform_pos")}

    def draw_params(self, noise, params, path):
        eta = path[:, 1:, 0] - path[:, :-1, 0]
        return {"sigma_level_sq": self.sigma_prior.draw_variance(
            noise["level_u"], eta.shape[1], (eta * eta).sum(-1))}

    def asis_groups(self):
        return [("sigma_level_sq", self.sigma_prior, (0,))]


@dataclasses.dataclass(frozen=True)
class LocalLinearTrend:
    """Level plus random-walk slope (reference LocalLinearTrend; bsts
    add.local.linear.trend)."""

    level_prior: SdPrior
    slope_prior: SdPrior
    initial_level_mean: float = 0.0
    initial_level_sd: float = 1.0
    initial_slope_mean: float = 0.0
    initial_slope_sd: float = 1.0
    name: str = "trend"
    dim: int = 2
    err_dim: int = 2

    @staticmethod
    def default(y, name="trend"):
        sd = _sd(y)
        return LocalLinearTrend(
            level_prior=SdPrior(sigma_guess=0.01 * sd, upper_limit=sd),
            slope_prior=SdPrior(sigma_guess=0.01 * sd, upper_limit=sd),
            initial_level_mean=float(y[0]), initial_level_sd=sd,
            initial_slope_mean=0.0, initial_slope_sd=sd, name=name)

    def z(self, device, dtype):
        return torch.tensor([1.0, 0.0], device=device, dtype=dtype)

    def _t(self, device, dtype):
        return torch.tensor([[1.0, 1.0], [0.0, 1.0]], device=device,
                            dtype=dtype)

    def build(self, params):
        lvl, slope = params["sigma_level_sq"], params["sigma_slope_sq"]
        c = lvl.shape[0]
        q_mat = torch.diag_embed(torch.stack([lvl, slope], dim=-1))
        eye = torch.eye(2, device=lvl.device, dtype=lvl.dtype)
        return (_chain_mats(self._t(lvl.device, lvl.dtype), c),
                _chain_mats(eye, c), q_mat)

    def init_dist(self, device, dtype):
        return (torch.tensor([self.initial_level_mean,
                              self.initial_slope_mean], device=device,
                             dtype=dtype),
                torch.diag(torch.tensor([self.initial_level_sd ** 2,
                                         self.initial_slope_sd ** 2],
                                        device=device, dtype=dtype)))

    def init_noise_spec(self):
        return {"level_u": ((), "uniform"), "slope_u": ((), "uniform")}

    def init_params(self, noise):
        u1 = noise["level_u"] * (0.5 - 0.05) + 0.05
        u2 = noise["slope_u"] * (0.2 - 0.01) + 0.01
        return {"sigma_level_sq": (self.initial_level_sd * u1) ** 2,
                "sigma_slope_sq": (self.initial_slope_sd * u2) ** 2}

    def noise_spec(self):
        return {"level_u": ((), "uniform_pos"),
                "slope_u": ((), "uniform_pos")}

    def draw_params(self, noise, params, path):
        t_mat = _chain_mats(self._t(path.device, path.dtype), path.shape[0])
        eta = _innovations(path, t_mat)
        n = eta.shape[1]
        return {
            "sigma_level_sq": self.level_prior.draw_variance(
                noise["level_u"], n, (eta[..., 0] ** 2).sum(-1)),
            "sigma_slope_sq": self.slope_prior.draw_variance(
                noise["slope_u"], n, (eta[..., 1] ** 2).sum(-1))}

    def asis_groups(self):
        return [("sigma_level_sq", self.level_prior, (0,)),
                ("sigma_slope_sq", self.slope_prior, (1,))]


@dataclasses.dataclass(frozen=True)
class Seasonal:
    """Dummy-variable seasonal of ``nseasons`` seasons (reference Seasonal,
    state_models.py:186-246; bsts add.seasonal): the state holds the last
    nseasons - 1 effects, and the new effect is minus their sum plus an
    innovation."""

    nseasons: int
    sigma_prior: SdPrior
    initial_sd: float = 1.0
    name: str = "seasonal"
    err_dim: int = 1

    @property
    def dim(self):
        return self.nseasons - 1

    @staticmethod
    def default(y, nseasons, name=None):
        sd = _sd(y)
        return Seasonal(
            nseasons=nseasons,
            sigma_prior=SdPrior(sigma_guess=0.01 * sd, upper_limit=sd),
            initial_sd=sd, name=name or f"seasonal_{nseasons}")

    def z(self, device, dtype):
        z = torch.zeros(self.dim, device=device, dtype=dtype)
        z[0] = 1.0
        return z

    def _t(self, device, dtype):
        """Top row -1 (minus the sum of the effects), then a shift."""
        d = self.dim
        top = -torch.ones(1, d, device=device, dtype=dtype)
        shift = torch.eye(d - 1, d, device=device, dtype=dtype)
        return torch.cat([top, shift], dim=0)

    def build(self, params):
        var = params["sigma_seasonal_sq"]
        c = var.shape[0]
        r_mat = torch.zeros(self.dim, 1, device=var.device, dtype=var.dtype)
        r_mat[0, 0] = 1.0
        return (_chain_mats(self._t(var.device, var.dtype), c),
                _chain_mats(r_mat, c), var[:, None, None])

    def init_dist(self, device, dtype):
        return (torch.zeros(self.dim, device=device, dtype=dtype),
                self.initial_sd ** 2 * torch.eye(self.dim, device=device,
                                                 dtype=dtype))

    def init_noise_spec(self):
        return {"seasonal_u": ((), "uniform")}

    def init_params(self, noise):
        u = noise["seasonal_u"] * (0.3 - 0.02) + 0.02
        return {"sigma_seasonal_sq": (self.initial_sd * u) ** 2}

    def noise_spec(self):
        return {"seasonal_u": ((), "uniform_pos")}

    def draw_params(self, noise, params, path):
        t_mat = _chain_mats(self._t(path.device, path.dtype), path.shape[0])
        eta = _innovations(path, t_mat)[..., 0]
        return {"sigma_seasonal_sq": self.sigma_prior.draw_variance(
            noise["seasonal_u"], eta.shape[1], (eta * eta).sum(-1))}

    def asis_groups(self):
        return [("sigma_seasonal_sq", self.sigma_prior, (0,))]
