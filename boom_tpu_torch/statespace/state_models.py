"""State-model blocks of bsts (port of
boom_tpu/statespace/state_models.py:35-676, :677-925): ``SdPrior``,
``LocalLevel``, ``LocalLinearTrend``, ``Seasonal``, ``MonthlyAnnualCycle``,
``Trig``, ``ArState``, ``StaticIntercept``, ``SemilocalLinearTrend``, and
the time-varying ``DynamicRegression``, ``RandomWalkHoliday`` and
``StudentLocalLinearTrend``.

A block is a frozen dataclass of floats (the model spec) whose methods work
on a batch of chains:

    z(device, dtype)            -> [dim] observation weights
    transition(device, dtype)   -> (T [dim,dim], R [dim,err]), constants of
                                   the spec, one for every chain
    variance(params)            -> Q [C,err,err]
    build(params)               -> (T [C,dim,dim], R [C,dim,err], Q [C,err,err])
    init_dist(device, dtype)    -> (a0 [dim], P0 [dim,dim])
    init_noise_spec()           -> per-chain uniforms of init_params
    init_params(noise)          -> dict of [C] parameters
    noise_spec()                -> per-chain uniforms of draw_params
    draw_params(noise, params, path [C,T,dim]) -> dict of [C] parameters
    asis_groups()               -> [(param name, SdPrior, error dims)]

A block whose T moves with its parameters (``ArState``'s and
``SemilocalLinearTrend``'s phi) has ``selection(device, dtype)`` -> R and
``chain_transition(params)`` -> T [C, dim, dim], a chain each, in place of
``transition``.

A time-varying block adds ``z_seq(device, dtype)`` -> [T, dim] observation
rows (one for every chain) and/or ``q_scale_seq(params)`` -> sd scales of
its errors, [T, err] for every chain or [C, T, err] a chain; row t of
q_scale_seq scales the transition t -> t+1 (reference ``SsmParams``). A
calendar block (``MonthlyAnnualCycle``) adds ``t_seq(device, dtype)`` ->
(its distinct transitions [K, dim, dim], the one step t takes [T]): row t
maps alpha_t to alpha_{t+1}.

Random numbers come in through ``noise`` mappings (see
``boom_tpu_torch.rng``); the blocks never draw.
"""

from __future__ import annotations

import dataclasses
import datetime
import math

import numpy as np
import torch

from boom_tpu_torch import dists
from boom_tpu_torch.dists.truncated import TAIL_TRIPS, trun_gamma_lower_fast
from boom_tpu_torch.inference.kernels.slice import slice_step


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


def _built(block, q_mat):
    """(T, R, Q) [C, ...] of ``block`` whose Q is ``q_mat`` [C, err, err]:
    its T and R expanded over the chains."""
    t_mat, r_mat = block.transition(q_mat.device, q_mat.dtype)
    c = q_mat.shape[0]
    return _chain_mats(t_mat, c), _chain_mats(r_mat, c), q_mat


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

    def transition(self, device, dtype):
        one = torch.ones(1, 1, device=device, dtype=dtype)
        return one, one

    def variance(self, params):
        return params["sigma_level_sq"][:, None, None]

    def build(self, params):
        return _built(self, self.variance(params))

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

    def transition(self, device, dtype):
        return (self._t(device, dtype),
                torch.eye(2, device=device, dtype=dtype))

    def variance(self, params):
        return torch.diag_embed(torch.stack(
            [params["sigma_level_sq"], params["sigma_slope_sq"]], dim=-1))

    def build(self, params):
        return _built(self, self.variance(params))

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

    def transition(self, device, dtype):
        r_mat = torch.zeros(self.dim, 1, device=device, dtype=dtype)
        r_mat[0, 0] = 1.0
        return self._t(device, dtype), r_mat

    def variance(self, params):
        return params["sigma_seasonal_sq"][:, None, None]

    def build(self, params):
        return _built(self, self.variance(params))

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


def _top_shift(top):
    """[C, d, d] of a top row ``top`` [C, d] over the shift eye(d - 1, d)
    (the AR(p) companion; the seasonal's with a row of -1s)."""
    c, d = top.shape
    shift = torch.eye(d - 1, d, device=top.device, dtype=top.dtype)
    return torch.cat([top[:, None], shift.expand(c, d - 1, d)], dim=1)


def _first_selection(dim, device, dtype):
    """R [dim, 1]: the error enters the first state."""
    r_mat = torch.zeros(dim, 1, device=device, dtype=dtype)
    r_mat[0, 0] = 1.0
    return r_mat


def _first_z(dim, device, dtype):
    z = torch.zeros(dim, device=device, dtype=dtype)
    z[0] = 1.0
    return z


@dataclasses.dataclass(frozen=True)
class MonthlyAnnualCycle:
    """A 12-season cycle of a daily series that moves on the first of each
    month (reference MonthlyAnnualCycle, state_models.py:249-355; bsts
    add.monthly.annual.cycle): T_t is the seasonal rotation where day t + 1
    is the 1st and the identity elsewhere, and the innovation fires on those
    transitions alone. ``first_date`` is the date of y[0] and ``t_len`` the
    series' length."""

    first_date: datetime.date
    t_len: int
    sigma_prior: SdPrior
    initial_sd: float = 1.0
    name: str = "monthly"
    nseasons = 12
    err_dim: int = 1

    @property
    def dim(self):
        return self.nseasons - 1

    @staticmethod
    def default(y, first_date, name="monthly"):
        sd = _sd(y)
        return MonthlyAnnualCycle(
            first_date=first_date, t_len=int(y.shape[0]),
            sigma_prior=SdPrior(sigma_guess=0.01 * sd, upper_limit=sd),
            initial_sd=sd, name=name)

    def sliced(self, t_len):
        """The block on the first ``t_len`` days (a holdout's refit)."""
        return dataclasses.replace(self, t_len=t_len)

    def _boundary_np(self, start, length):
        """[length] floats: entry k is 1 iff the transition start + k ->
        start + k + 1 enters a new month (the date at start + k + 1 is the
        1st)."""
        return np.asarray(
            [1.0 if (self.first_date
                     + datetime.timedelta(days=start + k + 1)).day == 1
             else 0.0 for k in range(length)], dtype=np.float64)

    def _rotation(self, device, dtype):
        d = self.dim
        top = -torch.ones(1, d, device=device, dtype=dtype)
        return _top_shift(top)[0]

    def _steps(self, start, length, device, dtype):
        mats = torch.stack([torch.eye(self.dim, device=device, dtype=dtype),
                            self._rotation(device, dtype)])
        choice = torch.as_tensor(self._boundary_np(start, length),
                                 device=device).to(torch.int64)
        return mats, choice

    def z(self, device, dtype):
        return _first_z(self.dim, device, dtype)

    def transition(self, device, dtype):
        """The static T (the rotation: the reference's ``build``, which ASIS
        reads) and R."""
        return (self._rotation(device, dtype),
                _first_selection(self.dim, device, dtype))

    def t_seq(self, device, dtype):
        """(the identity and the rotation [2, dim, dim], [T] which of them
        the transition t -> t + 1 takes)."""
        return self._steps(0, self.t_len, device, dtype)

    def future_t_rows(self, horizon, device, dtype):
        """t_seq's form over the forecast's ``horizon`` steps (the calendar
        continued from the last day)."""
        return self._steps(self.t_len - 1, horizon, device, dtype)

    def q_scale_seq(self, params):
        """[T, 1], one for every chain: the innovation's gate."""
        var = params["sigma_monthly_sq"]
        return torch.as_tensor(self._boundary_np(0, self.t_len),
                               device=var.device).to(var.dtype)[:, None]

    def future_q_scale(self, horizon, device, dtype):
        return torch.as_tensor(self._boundary_np(self.t_len - 1, horizon),
                               device=device).to(dtype)[:, None]

    def variance(self, params):
        return params["sigma_monthly_sq"][:, None, None]

    def build(self, params):
        return _built(self, self.variance(params))

    def init_dist(self, device, dtype):
        d = self.dim
        return (torch.zeros(d, device=device, dtype=dtype),
                self.initial_sd ** 2 * torch.eye(d, device=device,
                                                 dtype=dtype))

    def init_noise_spec(self):
        return {"monthly_u": ((), "uniform")}

    def init_params(self, noise):
        u = noise["monthly_u"] * (0.3 - 0.02) + 0.02
        return {"sigma_monthly_sq": (self.initial_sd * u) ** 2}

    def noise_spec(self):
        return {"monthly_u": ((), "uniform_pos")}

    def draw_params(self, noise, params, path):
        """The variance from the innovations of the month boundaries:
        alpha_{t+1,0} = -sum(alpha_t) + eta there."""
        bnd_np = self._boundary_np(0, path.shape[1] - 1)
        bnd = torch.as_tensor(bnd_np, device=path.device).to(path.dtype)
        eta = path[:, 1:, 0] + path[:, :-1].sum(-1)
        return {"sigma_monthly_sq": self.sigma_prior.draw_variance(
            noise["monthly_u"], float(bnd_np.sum()),
            (bnd * eta * eta).sum(-1))}

    def asis_groups(self):
        # the reference's ASIS assumes a static T: this block's variance
        # takes the centered draw alone, as the reference's
        return []


@dataclasses.dataclass(frozen=True)
class Trig:
    """Trigonometric seasonality of period ``period`` at the harmonics
    ``frequencies`` (reference Trig, state_models.py:362-425; bsts
    add.trig): a rotation by 2 pi f / period a harmonic, one variance for
    every error."""

    period: float
    frequencies: tuple
    sigma_prior: SdPrior
    initial_sd: float = 1.0
    name: str = "trig"

    @property
    def dim(self):
        return 2 * len(self.frequencies)

    @property
    def err_dim(self):
        return 2 * len(self.frequencies)

    @staticmethod
    def default(y, period, nfreq, name="trig"):
        sd = _sd(y)
        return Trig(period=float(period),
                    frequencies=tuple(range(1, nfreq + 1)),
                    sigma_prior=SdPrior(sigma_guess=0.01 * sd,
                                        upper_limit=sd),
                    initial_sd=sd, name=name)

    def z(self, device, dtype):
        z = torch.zeros(self.dim, device=device, dtype=dtype)
        z[0::2] = 1.0
        return z

    def _t(self, device, dtype):
        t_mat = torch.zeros(self.dim, self.dim, device=device, dtype=dtype)
        for i, f in enumerate(self.frequencies):
            lam = 2.0 * math.pi * f / self.period
            c, s = math.cos(lam), math.sin(lam)
            t_mat[2 * i:2 * i + 2, 2 * i:2 * i + 2] = torch.tensor(
                [[c, s], [-s, c]], device=device, dtype=dtype)
        return t_mat

    def transition(self, device, dtype):
        return (self._t(device, dtype),
                torch.eye(self.dim, device=device, dtype=dtype))

    def variance(self, params):
        var = params["sigma_trig_sq"]
        return var[:, None, None] * torch.eye(self.err_dim, device=var.device,
                                              dtype=var.dtype)

    def build(self, params):
        return _built(self, self.variance(params))

    def init_dist(self, device, dtype):
        return (torch.zeros(self.dim, device=device, dtype=dtype),
                self.initial_sd ** 2 * torch.eye(self.dim, device=device,
                                                 dtype=dtype))

    def init_noise_spec(self):
        return {"trig_u": ((), "uniform")}

    def init_params(self, noise):
        u = noise["trig_u"] * (0.3 - 0.02) + 0.02
        return {"sigma_trig_sq": (self.initial_sd * u) ** 2}

    def noise_spec(self):
        return {"trig_u": ((), "uniform_pos")}

    def draw_params(self, noise, params, path):
        eta = _innovations(path, _chain_mats(
            self._t(path.device, path.dtype), path.shape[0]))
        return {"sigma_trig_sq": self.sigma_prior.draw_variance(
            noise["trig_u"], eta.shape[1] * eta.shape[2],
            (eta * eta).sum((1, 2)))}

    def asis_groups(self):
        return [("sigma_trig_sq", self.sigma_prior,
                 tuple(range(self.err_dim)))]


# candidates of ArState's conjugate coefficient draw (reference :487)
AR_CANDIDATES = 16


@dataclasses.dataclass(frozen=True)
class ArState:
    """An AR(p) state (reference ArState, state_models.py:428-508; bsts
    add.ar): T is the companion of phi, a chain each. phi's conjugate draw
    under a N(0, phi_prior_sd^2 I) prior takes the first stationary of
    AR_CANDIDATES candidates, else halves phi (the reference's fixed-trip
    form of ArPosteriorSampler's retries)."""

    lags: int
    sigma_prior: SdPrior
    initial_sd: float = 1.0
    phi_prior_sd: float = 1.0
    name: str = "ar"
    err_dim: int = 1

    @property
    def dim(self):
        return self.lags

    @staticmethod
    def default(y, lags, name=None):
        sd = _sd(y)
        return ArState(lags=lags,
                       sigma_prior=SdPrior(sigma_guess=0.01 * sd,
                                           upper_limit=sd),
                       initial_sd=sd, name=name or f"ar{lags}")

    def z(self, device, dtype):
        return _first_z(self.dim, device, dtype)

    def selection(self, device, dtype):
        return _first_selection(self.dim, device, dtype)

    def chain_transition(self, params):
        return _top_shift(params["phi"])

    def variance(self, params):
        return params["sigma_ar_sq"][:, None, None]

    def build(self, params):
        q_mat = self.variance(params)
        c = q_mat.shape[0]
        return (self.chain_transition(params),
                _chain_mats(self.selection(q_mat.device, q_mat.dtype), c),
                q_mat)

    def init_dist(self, device, dtype):
        return (torch.zeros(self.dim, device=device, dtype=dtype),
                self.initial_sd ** 2 * torch.eye(self.dim, device=device,
                                                 dtype=dtype))

    def init_noise_spec(self):
        return {"phi_u": ((), "uniform"), "ar_u": ((), "uniform")}

    def init_params(self, noise):
        phi0 = noise["phi_u"] * 0.8
        u = noise["ar_u"] * (0.7 - 0.1) + 0.1
        rest = phi0.new_zeros(phi0.shape[0], self.lags - 1)
        return {"phi": torch.cat([phi0[:, None], rest], dim=1),
                "sigma_ar_sq": (self.initial_sd * u) ** 2}

    def noise_spec(self):
        return {"phi_z": ((AR_CANDIDATES, self.lags), "normal"),
                "ar_u": ((), "uniform_pos")}

    def draw_params(self, noise, params, path):
        """phi by regression of path[t + 1, 0] on the lag vector path[t]:
        AR_CANDIDATES draws of its conjugate posterior at the normals
        ``phi_z`` [C, k, p], the first stationary one kept; then the
        variance from the residuals."""
        resp, preds = path[:, 1:, 0], path[:, :-1, :]
        sigsq = params["sigma_ar_sq"]
        eye = torch.eye(self.lags, device=path.device, dtype=path.dtype)
        prec = ((preds.transpose(1, 2) @ preds) / sigsq[:, None, None]
                + eye / self.phi_prior_sd ** 2)
        b = (preds * resp[..., None]).sum(1) / sigsq[:, None]
        chol = torch.linalg.cholesky(prec)
        cands = dists.mvn.sample_suf(noise["phi_z"], b[:, None],
                                     prec_chol=chol[:, None])
        ok = _jury_stationary(cands)
        first = torch.argmax(ok.to(torch.int8), dim=-1)
        pick = cands[torch.arange(cands.shape[0], device=path.device), first]
        phi = torch.where(ok.any(-1)[:, None], pick, params["phi"] * 0.5)
        eps = resp - (preds * phi[:, None, :]).sum(-1)
        return {"phi": phi, "sigma_ar_sq": self.sigma_prior.draw_variance(
            noise["ar_u"], eps.shape[1], (eps * eps).sum(-1))}

    def asis_groups(self):
        return [("sigma_ar_sq", self.sigma_prior, (0,))]


def _jury_stationary(phi):
    """[...] whether the AR(p) polynomials of phi [..., p] are stationary:
    every reflection coefficient of the Levinson-Durbin step-down |k| < 1
    (reference :511-535)."""
    p = phi.shape[-1]
    idx = torch.arange(p, device=phi.device)
    a = phi
    ok = torch.ones(phi.shape[:-1], dtype=torch.bool, device=phi.device)
    for m in range(p, 0, -1):
        k = a[..., m - 1]
        ok = ok & (k.abs() < 1.0)
        denom = torch.clamp_min(1.0 - k * k, 1e-12)
        rev = a[..., (m - 2 - idx).clamp(0, p - 1)]
        a = torch.where(idx < m - 1,
                        (a + k[..., None] * rev) / denom[..., None], 0.0)
    return ok


@dataclasses.dataclass(frozen=True)
class StaticIntercept:
    """A constant level (reference StaticIntercept, state_models.py:539-572):
    one state and no error (R [1, 0]), so no parameter and no ``variance``:
    the model's Q holds an empty block for it."""

    initial_mean: float = 0.0
    initial_sd: float = 1.0
    name: str = "static_intercept"
    dim: int = 1
    err_dim: int = 0

    @staticmethod
    def default(y, name="static_intercept"):
        return StaticIntercept(initial_mean=float(torch.mean(y)),
                               initial_sd=_sd(y), name=name)

    def z(self, device, dtype):
        return torch.ones(1, device=device, dtype=dtype)

    def transition(self, device, dtype):
        return (torch.ones(1, 1, device=device, dtype=dtype),
                torch.zeros(1, 0, device=device, dtype=dtype))

    def init_dist(self, device, dtype):
        return (torch.tensor([self.initial_mean], device=device, dtype=dtype),
                torch.tensor([[self.initial_sd ** 2]], device=device,
                             dtype=dtype))

    def init_noise_spec(self):
        return {}

    def init_params(self, noise):
        return {}

    def noise_spec(self):
        return {}

    def draw_params(self, noise, params, path):
        return {}

    def asis_groups(self):
        return []


@dataclasses.dataclass(frozen=True)
class SemilocalLinearTrend:
    """A level whose slope reverts to a long-run mean D (reference
    SemilocalLinearTrend, state_models.py:576-673; bsts
    add.semilocal.linear.trend):

        mu_{t+1}    = mu_t + delta_t + eta_0
        delta_{t+1} = D + phi (delta_t - D) + eta_1

    D rides as a static third state, drawn with the path; phi, a chain each
    (so T is a chain's), from its truncated-normal conditional on
    (-0.999, 0.999) given the slope path."""

    level_prior: SdPrior
    slope_prior: SdPrior
    initial_level_mean: float = 0.0
    initial_level_sd: float = 1.0
    initial_slope_mean: float = 0.0
    initial_slope_sd: float = 1.0
    slope_mean_mean: float = 0.0
    slope_mean_sd: float = 1.0
    phi_prior_mean: float = 0.0
    phi_prior_sd: float = 0.5
    name: str = "semilocal_trend"
    dim: int = 3
    err_dim: int = 2

    @staticmethod
    def default(y, name="semilocal_trend"):
        sd = _sd(y)
        return SemilocalLinearTrend(
            level_prior=SdPrior(sigma_guess=0.01 * sd, upper_limit=sd),
            slope_prior=SdPrior(sigma_guess=0.01 * sd, upper_limit=sd),
            initial_level_mean=float(y[0]), initial_level_sd=sd,
            initial_slope_sd=sd, slope_mean_sd=sd, name=name)

    def z(self, device, dtype):
        return _first_z(3, device, dtype)

    def selection(self, device, dtype):
        return torch.eye(3, 2, device=device, dtype=dtype)

    def chain_transition(self, params):
        phi = params["phi"]
        c = phi.shape[0]
        t_mat = torch.tensor([[1.0, 1.0, 0.0], [0.0, 0.0, 0.0],
                              [0.0, 0.0, 1.0]], device=phi.device,
                             dtype=phi.dtype).repeat(c, 1, 1)
        t_mat[:, 1, 1] = phi
        t_mat[:, 1, 2] = 1.0 - phi
        return t_mat

    def variance(self, params):
        return torch.diag_embed(torch.stack(
            [params["sigma_level_sq"], params["sigma_slope_sq"]], dim=-1))

    def build(self, params):
        q_mat = self.variance(params)
        return (self.chain_transition(params),
                _chain_mats(self.selection(q_mat.device, q_mat.dtype),
                            q_mat.shape[0]), q_mat)

    def init_dist(self, device, dtype):
        return (torch.tensor([self.initial_level_mean,
                              self.initial_slope_mean, self.slope_mean_mean],
                             device=device, dtype=dtype),
                torch.diag(torch.tensor(
                    [self.initial_level_sd ** 2, self.initial_slope_sd ** 2,
                     self.slope_mean_sd ** 2], device=device, dtype=dtype)))

    def init_noise_spec(self):
        return {"level_u": ((), "uniform"), "slope_u": ((), "uniform"),
                "phi_u": ((), "uniform")}

    def init_params(self, noise):
        u1 = noise["level_u"] * (0.5 - 0.05) + 0.05
        u2 = noise["slope_u"] * (0.2 - 0.01) + 0.01
        # the slope's initial sd is the level's, as the reference's
        return {"sigma_level_sq": (self.initial_level_sd * u1) ** 2,
                "sigma_slope_sq": (self.initial_level_sd * u2) ** 2,
                "phi": noise["phi_u"] * (0.8 - 0.2) + 0.2}

    def noise_spec(self):
        return {"level_u": ((), "uniform_pos"),
                "phi_u": ((), "uniform_pos"),
                "phi_tail_u1": ((TAIL_TRIPS,), "uniform_pos"),
                "phi_tail_u2": ((TAIL_TRIPS,), "uniform_pos"),
                "slope_u": ((), "uniform_pos")}

    def draw_params(self, noise, params, path):
        level, slope, d_mean = path[..., 0], path[..., 1], path[:, 0, 2]
        e_lvl = level[:, 1:] - level[:, :-1] - slope[:, :-1]
        n = e_lvl.shape[1]
        lvl = self.level_prior.draw_variance(noise["level_u"], n,
                                             (e_lvl * e_lvl).sum(-1))
        # phi | slope path: the regression of delta_{t+1} - D on
        # delta_t - D, truncated to (-0.999, 0.999)
        dc = slope - d_mean[:, None]
        sxx = (dc[:, :-1] * dc[:, :-1]).sum(-1)
        sxy = (dc[:, :-1] * dc[:, 1:]).sum(-1)
        sig = params["sigma_slope_sq"]
        post_prec = sxx / sig + 1.0 / self.phi_prior_sd ** 2
        post_mean = (sxy / sig + self.phi_prior_mean
                     / self.phi_prior_sd ** 2) / post_prec
        phi = dists.trun_normal.sample(
            noise["phi_u"], noise["phi_tail_u1"], noise["phi_tail_u2"],
            post_mean, torch.sqrt(1.0 / post_prec), -0.999, 0.999)
        e_slope = dc[:, 1:] - phi[:, None] * dc[:, :-1]
        slope_var = self.slope_prior.draw_variance(
            noise["slope_u"], n, (e_slope * e_slope).sum(-1))
        return {"sigma_level_sq": lvl, "sigma_slope_sq": slope_var,
                "phi": phi}

    def asis_groups(self):
        return [("sigma_level_sq", self.level_prior, (0,)),
                ("sigma_slope_sq", self.slope_prior, (1,))]


@dataclasses.dataclass(frozen=True, eq=False)
class DynamicRegression:
    """Time-varying regression coefficients (reference DynamicRegression,
    state_models.py:677-736; bsts add.dynamic.regression): beta_{t+1,j} =
    beta_{t,j} + eta_j, a random-walk sd a coefficient, Z_t = x_t."""

    predictors: torch.Tensor  # [T, p]
    sigma_prior: SdPrior
    initial_sd: float = 1.0
    name: str = "dynamic_regression"

    @property
    def dim(self):
        return self.predictors.shape[1]

    @property
    def err_dim(self):
        return self.predictors.shape[1]

    @staticmethod
    def default(y, predictors, name="dynamic_regression"):
        sd = _sd(y)
        predictors = torch.as_tensor(predictors, dtype=y.dtype,
                                     device=y.device)
        xsd = float(torch.std(predictors, dim=0, correction=0).mean()
                    + 1e-12)
        return DynamicRegression(
            predictors=predictors,
            sigma_prior=SdPrior(sigma_guess=0.01 * sd / xsd,
                                upper_limit=sd / xsd),
            initial_sd=sd / xsd, name=name)

    def z(self, device, dtype):
        """The static fallback, x_0 (the composite uses z_seq)."""
        return self.predictors[0].to(device=device, dtype=dtype)

    def sliced(self, t_len):
        """The block on the first ``t_len`` steps (a holdout's refit)."""
        return dataclasses.replace(self, predictors=self.predictors[:t_len])

    def z_seq(self, device, dtype):
        return self.predictors.to(device=device, dtype=dtype)

    def transition(self, device, dtype):
        eye = torch.eye(self.dim, device=device, dtype=dtype)
        return eye, eye

    def variance(self, params):
        return torch.diag_embed(params["sigma_dynreg_sq"])

    def build(self, params):
        return _built(self, self.variance(params))

    def init_dist(self, device, dtype):
        d = self.dim
        return (torch.zeros(d, device=device, dtype=dtype),
                self.initial_sd ** 2 * torch.eye(d, device=device,
                                                 dtype=dtype))

    def init_noise_spec(self):
        return {"dynreg_u": ((self.dim,), "uniform")}

    def init_params(self, noise):
        u = noise["dynreg_u"] * (0.3 - 0.02) + 0.02
        return {"sigma_dynreg_sq": (self.initial_sd * u) ** 2}

    def noise_spec(self):
        return {"dynreg_u": ((self.dim,), "uniform_pos")}

    def draw_params(self, noise, params, path):
        eta = path[:, 1:] - path[:, :-1]
        return {"sigma_dynreg_sq": self.sigma_prior.draw_variance(
            noise["dynreg_u"], eta.shape[1], (eta * eta).sum(1))}

    def asis_groups(self):
        return []


def _one_hot_days(days, window, dtype):
    """[T, window]: row t the one-hot of day days[t] of the window, zeros
    where days[t] < 0."""
    hot = torch.nn.functional.one_hot(days.clamp_min(0), window).to(dtype)
    return torch.where((days >= 0)[:, None], hot, 0.0)


@dataclasses.dataclass(frozen=True, eq=False)
class RandomWalkHoliday:
    """Holiday-window effects (reference RandomWalkHoliday,
    state_models.py:740-817; bsts add.random.walk.holiday): a state a day
    of the window, each a random walk that moves only when its day recurs
    (Q_t's sd 1 on the transition into an active day of that day, else 0);
    the observation loads the active day's effect (a one-hot Z_t).

    active: [T] int, active[t] = j when time t is day j of the window, else
    -1."""

    active: torch.Tensor  # [T] int64
    window: int
    sigma_prior: SdPrior
    initial_sd: float = 1.0
    name: str = "holiday"

    @property
    def dim(self):
        return self.window

    @property
    def err_dim(self):
        return self.window

    @staticmethod
    def default(y, active, window, name="holiday"):
        sd = _sd(y)
        return RandomWalkHoliday(
            active=torch.as_tensor(active, dtype=torch.int64,
                                   device=y.device),
            window=window,
            sigma_prior=SdPrior(sigma_guess=0.1 * sd, upper_limit=sd),
            initial_sd=sd, name=name)

    def z(self, device, dtype):
        return torch.zeros(self.window, device=device, dtype=dtype)

    def sliced(self, t_len):
        """The block on the first ``t_len`` steps (a holdout's refit)."""
        return dataclasses.replace(self, active=self.active[:t_len])

    def z_seq(self, device, dtype):
        return _one_hot_days(self.active.to(device), self.window, dtype)

    def _next_days(self):
        """The day active at t + 1 of each transition t -> t + 1 (-1 after
        the last step)."""
        return torch.cat([self.active[1:], self.active.new_full((1,), -1)])

    def q_scale_seq(self, params):
        """[T, window], one for every chain: transition t -> t + 1
        refreshes the day active at t + 1."""
        var = params["sigma_holiday_sq"]
        return _one_hot_days(self._next_days().to(var.device), self.window,
                             var.dtype)

    def transition(self, device, dtype):
        eye = torch.eye(self.window, device=device, dtype=dtype)
        return eye, eye

    def variance(self, params):
        var = params["sigma_holiday_sq"]
        return var[:, None, None] * torch.eye(self.window, device=var.device,
                                              dtype=var.dtype)

    def build(self, params):
        return _built(self, self.variance(params))

    def init_dist(self, device, dtype):
        d = self.window
        return (torch.zeros(d, device=device, dtype=dtype),
                self.initial_sd ** 2 * torch.eye(d, device=device,
                                                 dtype=dtype))

    def init_noise_spec(self):
        return {"holiday_u": ((), "uniform")}

    def init_params(self, noise):
        u = noise["holiday_u"] * (0.5 - 0.05) + 0.05
        return {"sigma_holiday_sq": (self.initial_sd * u) ** 2}

    def noise_spec(self):
        return {"holiday_u": ((), "uniform_pos")}

    def draw_params(self, noise, params, path):
        """The variance from the innovations of the refresh steps only."""
        mask = _one_hot_days(self._next_days().to(path.device), self.window,
                             path.dtype)[:-1]
        eta = (path[:, 1:] - path[:, :-1]) * mask
        return {"sigma_holiday_sq": self.sigma_prior.draw_variance(
            noise["holiday_u"], mask.sum(), (eta * eta).sum((1, 2)))}

    def asis_groups(self):
        return []


# the slice step of the Student trend's degrees of freedom (the reference
# slice_step's defaults)
NU_EXPAND, NU_SHRINK = 16, 32


@dataclasses.dataclass(frozen=True)
class StudentLocalLinearTrend:
    """Local linear trend with Student-t level and slope innovations
    (reference StudentLocalLinearTrend, state_models.py:821-925; bsts
    add.student.local.linear.trend): a scale mixture of normals, Q_t =
    diag(sigma_level^2 / w_level_t, sigma_slope^2 / w_slope_t). The latent
    weights w [C, T-1] are parameters, imputed every sweep from the state
    path; nu is slice-sampled."""

    t_len: int
    level_prior: SdPrior
    slope_prior: SdPrior
    initial_level_mean: float = 0.0
    initial_level_sd: float = 1.0
    initial_slope_sd: float = 1.0
    nu_prior_rate: float = 0.1
    name: str = "student_trend"
    dim: int = 2
    err_dim: int = 2

    @staticmethod
    def default(y, name="student_trend"):
        sd = _sd(y)
        return StudentLocalLinearTrend(
            t_len=int(y.shape[0]),
            level_prior=SdPrior(sigma_guess=0.01 * sd, upper_limit=sd),
            slope_prior=SdPrior(sigma_guess=0.01 * sd, upper_limit=sd),
            initial_level_mean=float(y[0]), initial_level_sd=sd,
            initial_slope_sd=sd, name=name)

    def z(self, device, dtype):
        return torch.tensor([1.0, 0.0], device=device, dtype=dtype)

    def sliced(self, t_len):
        """The block on the first ``t_len`` steps (a holdout's refit)."""
        return dataclasses.replace(self, t_len=t_len)

    def extend_params(self, params, t_len):
        """Parameters of a fit to fewer steps carried to ``t_len``: the
        weights of the steps it did not see at 1, their mean, as the
        forecast takes them (a holdout's filter past its cutpoint)."""
        out = dict(params)
        for k in ("w_level", "w_slope"):
            w = params[k]
            out[k] = torch.cat([w, w.new_ones(w.shape[0],
                                              t_len - 1 - w.shape[1])], 1)
        return out

    def _t(self, device, dtype):
        return torch.tensor([[1.0, 1.0], [0.0, 1.0]], device=device,
                            dtype=dtype)

    def transition(self, device, dtype):
        return (self._t(device, dtype),
                torch.eye(2, device=device, dtype=dtype))

    def variance(self, params):
        return torch.diag_embed(torch.stack(
            [params["sigma_level_sq"], params["sigma_slope_sq"]], dim=-1))

    def build(self, params):
        return _built(self, self.variance(params))

    def q_scale_seq(self, params):
        """[C, T, 2]: 1 / sqrt(w) of each transition, 1 on the last row."""
        w = torch.stack([params["w_level"], params["w_slope"]], dim=-1)
        scale = 1.0 / torch.sqrt(torch.clamp_min(w, 1e-12))
        return torch.cat([scale, torch.ones_like(scale[:, :1])], dim=1)

    def init_dist(self, device, dtype):
        return (torch.tensor([self.initial_level_mean, 0.0], device=device,
                             dtype=dtype),
                torch.diag(torch.tensor([self.initial_level_sd ** 2,
                                         self.initial_slope_sd ** 2],
                                        device=device, dtype=dtype)))

    def init_noise_spec(self):
        return {"level_u": ((), "uniform"), "slope_u": ((), "uniform")}

    def init_params(self, noise):
        u1 = noise["level_u"] * (0.5 - 0.05) + 0.05
        u2 = noise["slope_u"] * (0.2 - 0.01) + 0.01
        ones = u1.new_ones(u1.shape[0], self.t_len - 1)
        ten = torch.full_like(u1, 10.0)
        # the slope's initial sd is the level's, as the reference's
        return {"sigma_level_sq": (self.initial_level_sd * u1) ** 2,
                "sigma_slope_sq": (self.initial_level_sd * u2) ** 2,
                "nu_level": ten, "nu_slope": ten.clone(),
                "w_level": ones, "w_slope": ones.clone()}

    def noise_spec(self):
        n = self.t_len - 1
        spec = {"w_level_u": ((n,), "uniform_pos"),
                "w_slope_u": ((n,), "uniform_pos"),
                "level_u": ((), "uniform_pos"),
                "slope_u": ((), "uniform_pos")}
        for part in ("level", "slope"):
            spec.update({f"nu_{part}_h_u": ((), "uniform_pos"),
                         f"nu_{part}_u_u": ((), "uniform"),
                         f"nu_{part}_shrink_u": ((NU_SHRINK,), "uniform")})
        return spec

    def innovations(self, path):
        """[C, T-1, 2] level and slope innovations of the state path."""
        return _innovations(path, _chain_mats(
            self._t(path.device, path.dtype), path.shape[0]))

    @staticmethod
    def impute_weights(u, e, sigsq, nu):
        """The latent weights' draw, Gamma((nu + 1) / 2, rate (nu + e^2 /
        sigma^2) / 2), by inverse CDF at the uniforms ``u`` [C, T-1] (the
        reference draws jax.random.gamma: the same distribution)."""
        a = 0.5 * (nu[:, None] + 1.0)
        b = 0.5 * (nu[:, None] + e * e / sigsq[:, None])
        return trun_gamma_lower_fast(u, a, b, 0.0, newton_iters=8)

    def draw_params(self, noise, params, path):
        eta = self.innovations(path)
        w_lvl = self.impute_weights(noise["w_level_u"], eta[..., 0],
                                    params["sigma_level_sq"],
                                    params["nu_level"])
        w_slp = self.impute_weights(noise["w_slope_u"], eta[..., 1],
                                    params["sigma_slope_sq"],
                                    params["nu_slope"])
        return self.draw_given_weights(noise, params, eta, w_lvl, w_slp)

    def draw_given_weights(self, noise, params, eta, w_lvl, w_slp):
        """The variances and nu given the imputed weights (reference
        :889-918): the variances from the weighted sums of squares, each nu
        by a slice step on its weights' log posterior."""
        n = eta.shape[1]
        lvl = self.level_prior.draw_variance(
            noise["level_u"], n, (w_lvl * eta[..., 0] ** 2).sum(-1))
        slp = self.slope_prior.draw_variance(
            noise["slope_u"], n, (w_slp * eta[..., 1] ** 2).sum(-1))

        def nu_step(part, nu, w):
            sum_log_w, sum_w = torch.log(w).sum(-1), w.sum(-1)

            def logpost(v):
                half = 0.5 * v
                return (n * (half * torch.log(half) - torch.lgamma(half))
                        + (half - 1.0) * sum_log_w - half * sum_w
                        - self.nu_prior_rate * v)

            return slice_step(nu, logpost, 2.0, noise[f"nu_{part}_h_u"],
                              noise[f"nu_{part}_u_u"],
                              noise[f"nu_{part}_shrink_u"],
                              expand_iters=NU_EXPAND, lower=0.5, upper=500.0)

        return {"sigma_level_sq": lvl, "sigma_slope_sq": slp,
                "nu_level": nu_step("level", params["nu_level"], w_lvl),
                "nu_slope": nu_step("slope", params["nu_slope"], w_slp),
                "w_level": w_lvl, "w_slope": w_slp}

    def asis_groups(self):
        return []
