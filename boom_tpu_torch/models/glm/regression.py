"""Gaussian linear regression with spike-and-slab variable selection (SSVS;
port of boom_tpu/models/glm/regression.py:36-341).

Every chain carries its own inclusion mask, so masks are ``[C, p]`` and
the conjugate quantities are batched over chains. Noise comes in as tensors
(``SpikeSlabRegression.noise_spec``): each chain's flip order ``perm`` [p]
(a permutation), a uniform a flip ``flip_u`` [p], the mode jump's
``jump_u`` [p] and ``jump_acc`` [], the variance's ``sigsq_u`` [] and the
coefficients' normals ``beta_z`` [p]; the reference draws the same from its
key tree.

Choices of the port (the reference is unchanged):

- one sweep computes the conjugate quantities of the new mask once
  (:func:`reg_post_params`) for both the sigma^2 and the beta draws, where
  the reference computes them twice on the same mask (no number changes);
- Cholesky factors come from ``torch.linalg.cholesky_ex`` with no host
  synchronisation; a sweep keeps a running flag on the device, and
  ``run_mcmc`` raises at the end of the run if any factor failed
  (``kernel().finish``);
- the inclusion draw runs in kernel (a) on the card
  (``ssvs_kernel.draw_indicators_swept``) and the sigma^2 and beta draws
  stay plain PyTorch, as they were XLA ops in the reference.

``WeightedRegression`` is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.profiler import record_function

from boom_tpu_torch import rng
from boom_tpu_torch.dists import scaled_inv_chisq
from boom_tpu_torch.linalg import masked

# the sweep's phases, each a named profiler range "ssvs.<phase>"
SWEEP_PHASES = ("indicators", "sigsq", "beta")


class RegSuf(NamedTuple):
    """Regression sufficient statistics (reference :36). One response
    (``xty`` [p], ``yty`` []) or one a chain (``xty`` [C, p], ``yty`` [C],
    as bsts regresses each chain's residual, reference
    statespace/bsts.py:375-385 under ``vmap``) beside one shared ``xtx``;
    every function here takes either."""

    xtx: torch.Tensor  # [p, p]
    xty: torch.Tensor  # [p] or [C, p]
    yty: torch.Tensor  # [] or [C]
    n: torch.Tensor  # []

    @staticmethod
    def from_data(x, y):
        return RegSuf(xtx=x.T @ x, xty=x.T @ y, yty=y @ y,
                      n=torch.tensor(x.shape[0], dtype=x.dtype,
                                     device=x.device))

    def combine(self, other):
        return RegSuf(*(a + b for a, b in zip(self, other)))


@dataclasses.dataclass(frozen=True)
class SpikeSlabPrior:
    """Independent Bernoulli spike, conditional Gaussian slab
    beta | g, sigma^2 ~ N(b_g, sigma^2 Omega_g^{-1}) and sigma^2 ~
    ScaledInvChisq(sigma_df, sigma_guess^2) (reference :57)."""

    mean: torch.Tensor  # [p] prior mean of beta (b)
    unscaled_precision: torch.Tensor  # [p, p] Omega
    log_inclusion_odds: torch.Tensor  # [p]
    log_inclusion_norm: torch.Tensor  # [] sum log(1 - pi)
    sigma_df: torch.Tensor  # []
    prior_ss: torch.Tensor  # [] sigma_df * sigma_guess^2
    max_size: int | None = None
    # upper limit of sigma (not sigma^2), or None
    sigma_upper_limit: float | None = None

    @staticmethod
    def from_data(x, y, expected_model_size=1.0, expected_rsq=0.5,
                  prior_information_weight=1.0, diagonal_shrinkage=0.05,
                  sigma_df=0.01, optional_coefficient_estimate=None,
                  max_size=None, prior_inclusion_probabilities=None,
                  sigma_upper_limit=None):
        """The default prior of R's SpikeSlabPrior (reference :79)."""
        n, p = x.shape
        dt, dev = x.dtype, x.device
        xtx = x.T @ x
        if prior_inclusion_probabilities is None:
            pi = torch.clamp(torch.tensor(expected_model_size / p, dtype=dt,
                                          device=dev), 1e-6, 1.0)
            pi = pi.expand(p)
        else:
            pi = torch.clamp(torch.as_tensor(
                prior_inclusion_probabilities, dtype=dt, device=dev),
                1e-6, 1.0 - 1e-12)
        sample_var = torch.var(y, correction=0)
        sigma_guess = torch.sqrt((1.0 - expected_rsq) * sample_var)
        mean = (torch.zeros(p, dtype=dt, device=dev)
                if optional_coefficient_estimate is None
                else torch.as_tensor(optional_coefficient_estimate,
                                     dtype=dt, device=dev))
        a = diagonal_shrinkage
        omega = prior_information_weight * (
            (1.0 - a) * xtx + a * torch.diag(torch.diag(xtx))) / n
        return SpikeSlabPrior(
            mean=mean, unscaled_precision=omega,
            log_inclusion_odds=torch.log(pi) - torch.log1p(-pi),
            log_inclusion_norm=torch.log1p(-pi).sum(),
            sigma_df=torch.tensor(sigma_df, dtype=dt, device=dev),
            prior_ss=sigma_df * sigma_guess ** 2, max_size=max_size,
            sigma_upper_limit=sigma_upper_limit)

    def spike_logp(self, mask):
        """log P(g) under independent Bernoulli inclusion; -inf past
        ``max_size`` (reference :114)."""
        m = mask.to(self.mean.dtype)
        logp = (m * self.log_inclusion_odds).sum(-1) + self.log_inclusion_norm
        if self.max_size is not None:
            logp = torch.where(m.sum(-1) > self.max_size, -torch.inf, logp)
        return logp


class RegPostParams(NamedTuple):
    """Conjugate posterior quantities of a mask (reference :123), plus the
    Cholesky factor's ``info`` (nonzero where it failed)."""

    chol: torch.Tensor  # [C, p, p] masked Cholesky of Omega_g + X'X_g
    beta_tilde: torch.Tensor  # [C, p] posterior mean, zeros off-mask
    df: torch.Tensor  # []
    ss: torch.Tensor  # [C]
    info: torch.Tensor  # [C] int


def _matvec(a, x):
    """a [p, p] or [C, p, p] times x [..., p]."""
    return (a @ x[..., None])[..., 0]


def reg_post_params(suf: RegSuf, prior: SpikeSlabPrior, mask) \
        -> RegPostParams:
    """Reference :133, batched over the masks' chains."""
    m = mask.to(suf.xty.dtype)
    prec = masked.masked_spd(prior.unscaled_precision + suf.xtx, mask)
    chol, info = torch.linalg.cholesky_ex(prec)
    om_masked = prior.unscaled_precision * masked.mask_outer(m)
    bm = prior.mean * m
    prec_mean = _matvec(om_masked, bm) + suf.xty * m
    beta_tilde = masked.masked_cho_solve(chol, prec_mean, mask)
    df = suf.n + prior.sigma_df
    lik_ss = (suf.yty - 2.0 * (beta_tilde * (suf.xty * m)).sum(-1)
              + (beta_tilde * _matvec(suf.xtx, beta_tilde)).sum(-1))
    diff = beta_tilde - bm
    mismatch = (diff * _matvec(om_masked, diff)).sum(-1)
    ss = prior.prior_ss + lik_ss + mismatch
    return RegPostParams(chol=chol, beta_tilde=beta_tilde, df=df, ss=ss,
                         info=info)


def _log_model_prob_info(suf, prior, mask):
    post = reg_post_params(suf, prior, mask)
    om_chol, info = masked.masked_cholesky_ex(prior.unscaled_precision, mask)
    ldoi = masked.masked_logdet(om_chol, mask)
    ld_post = masked.masked_logdet(post.chol, mask)
    logp = (prior.spike_logp(mask) + 0.5 * (ldoi - ld_post)
            - (0.5 * post.df - 1.0) * torch.log(post.ss))
    return logp, post.info | info


def log_model_prob(suf: RegSuf, prior: SpikeSlabPrior, mask):
    """log p(g | y) with beta and sigma^2 integrated out (reference :150)."""
    return _log_model_prob_info(suf, prior, mask)[0]


def _flipped(mask, j):
    ar = torch.arange(mask.shape[0], device=mask.device)
    out = mask.clone()
    out[ar, j] = ~mask[ar, j]
    return out


def draw_indicators_sweep(noise, suf: RegSuf, prior: SpikeSlabPrior, mask,
                          max_flips=None, info=None):
    """One random-order Gibbs sweep by masked Cholesky factors, the
    reference's oracle (reference :164): each flip recomputes the log model
    probability. Uses ``noise["perm"]`` and ``noise["flip_u"]``; ``info``
    [C] (optional) accumulates the factors' failures."""
    p = mask.shape[-1]
    n_flips = p if max_flips is None else min(int(max_flips), p)
    logp_cur, inf0 = _log_model_prob_info(suf, prior, mask)
    fails = inf0
    for f in range(n_flips):
        flipped = _flipped(mask, noise["perm"][:, f])
        logp_flip, inf = _log_model_prob_info(suf, prior, flipped)
        fails = fails | inf
        take = torch.log(noise["flip_u"][:, f]) < torch.nn.functional \
            .logsigmoid(logp_flip - logp_cur)
        mask = torch.where(take[:, None], flipped, mask)
        logp_cur = torch.where(take, logp_flip, logp_cur)
    if info is not None:
        info |= fails
    return mask


def screening_proposal_probs(suf: RegSuf, prior: SpikeSlabPrior, lo=0.02,
                             hi=0.98):
    """Product-Bernoulli proposal from the marginal screening statistics
    (reference :194)."""
    p = suf.xty.shape[-1]
    s2 = suf.yty / torch.clamp_min(suf.n, 1.0)
    z2 = suf.xty ** 2 / (torch.diagonal(suf.xtx, dim1=-2, dim2=-1) * s2
                         + 1e-30)
    raw = torch.sigmoid(0.5 * (z2 - 2.0 * math.log(float(p))))
    return torch.clamp(raw, lo, hi)


def mode_jump_move(noise, suf: RegSuf, prior: SpikeSlabPrior, mask, qprobs,
                   info=None):
    """Independence Metropolis-Hastings on the whole mask by masked
    Cholesky (reference :212; the oracle of the SWEEP path's jump), from
    ``noise["jump_u"]`` [C, p] and ``noise["jump_acc"]`` [C]."""
    prop = noise["jump_u"] < qprobs
    logq, log1mq = torch.log(qprobs), torch.log1p(-qprobs)

    def lq(m):
        mf = m.to(qprobs.dtype)
        return (mf * logq + (1.0 - mf) * log1mq).sum(-1)

    lp_prop, inf1 = _log_model_prob_info(suf, prior, prop)
    lp_cur, inf2 = _log_model_prob_info(suf, prior, mask)
    if info is not None:
        info |= inf1 | inf2
    log_ratio = lp_prop - lp_cur + lq(mask) - lq(prop)
    take = torch.log(noise["jump_acc"]) < log_ratio
    return torch.where(take[:, None], prop, mask)


def _draw_sigsq(u, post: RegPostParams, prior: SpikeSlabPrior):
    if prior.sigma_upper_limit is not None:
        return scaled_inv_chisq.sample_upper_truncated(
            u, post.df, post.ss / post.df,
            float(prior.sigma_upper_limit) ** 2)
    return scaled_inv_chisq.sample(u, post.df, post.ss / post.df)


def _draw_beta(z, post: RegPostParams, mask, sigsq):
    m = mask.to(post.beta_tilde.dtype)
    extra = masked._solve_upper_t(post.chol, z * m)
    return post.beta_tilde + torch.sqrt(sigsq)[:, None] * extra * m


def draw_sigsq(u, suf: RegSuf, prior: SpikeSlabPrior, mask):
    """sigma^2 | g, y with beta integrated out (reference :243), by
    inverse CDF at the uniforms ``u`` [C]."""
    return _draw_sigsq(u, reg_post_params(suf, prior, mask), prior)


def draw_beta(z, suf: RegSuf, prior: SpikeSlabPrior, mask, sigsq):
    """beta_g | g, sigma^2, y (reference :254) from the normals ``z``
    [C, p]; zeros off-mask."""
    return _draw_beta(z, reg_post_params(suf, prior, mask), mask, sigsq)


def gibbs_draw(noise, suf: RegSuf, prior: SpikeSlabPrior, gamma, *, swept,
               max_flips=None, qprobs=None, operands=None):
    """One Gibbs draw of every chain's (gamma, sigma^2, beta) given the
    statistics ``suf`` (one response, or one a chain): the indicators by
    the SWEEP path (``swept``: kernel (a) on the card, its plain version on
    the CPU; ``operands``: ``ssvs_kernel.sweep_operands``, made once) or
    by masked Cholesky factors, after the mode jump with ``qprobs``; then
    sigma^2 and beta from one set of conjugate quantities. Returns (gamma,
    sigsq, beta, info [C]: nonzero where a Cholesky factor failed)."""
    from boom_tpu_torch.models.glm import ssvs_kernel

    info = torch.zeros(gamma.shape[0], dtype=torch.int32,
                       device=gamma.device)
    with record_function("ssvs.indicators"):
        if swept:
            gamma = ssvs_kernel.draw_indicators_swept(
                noise, suf, prior, gamma, max_flips, qprobs, operands)
        else:
            if qprobs is not None:
                gamma = mode_jump_move(noise, suf, prior, gamma, qprobs, info)
            gamma = draw_indicators_sweep(noise, suf, prior, gamma,
                                          max_flips, info)
    with record_function("ssvs.sigsq"):
        post = reg_post_params(suf, prior, gamma)
        sigsq = _draw_sigsq(noise["sigsq_u"], post, prior)
    with record_function("ssvs.beta"):
        beta = _draw_beta(noise["beta_z"], post, gamma, sigsq)
    return gamma, sigsq, beta, info | post.info


def failure_count(device, what):
    """(count, finish): a device counter a sweep adds its failed Cholesky
    factors to, with no host synchronisation, and ``finish()``, which
    raises at the end of a run if any failed (``run_mcmc`` calls it)."""
    fails = torch.zeros((), dtype=torch.int32, device=device)

    def finish():
        n = int(fails)
        if n:
            raise RuntimeError(
                f"{n} Cholesky factors of {what} failed (Omega_g + X'X_g "
                "not positive definite) in this run")

    return fails, finish


@dataclasses.dataclass(frozen=True)
class SpikeSlabRegression:
    """lm.spike (reference :267). State keys: gamma (bool [C, p]), beta
    [C, p], sigsq [C]."""

    suf: RegSuf
    prior: SpikeSlabPrior
    max_flips: int | None = None
    # "sweep": incremental SWEEP updates (kernel (a) on the card);
    # "cholesky": a masked Cholesky a flip (the reference's oracle)
    method: str = "sweep"
    # the independence mode jump before the flips of each sweep
    mode_jump: bool = True

    @staticmethod
    def from_data(x, y, method="sweep", max_flips=None, mode_jump=True,
                  **prior_kwargs):
        return SpikeSlabRegression(
            suf=RegSuf.from_data(x, y),
            prior=SpikeSlabPrior.from_data(x, y, **prior_kwargs),
            max_flips=max_flips, method=method, mode_jump=mode_jump)

    @property
    def num_predictors(self):
        return self.prior.mean.shape[0]

    @property
    def dtype(self):
        return self.prior.mean.dtype

    def noise_spec(self):
        """One sweep's noise per chain (``rng.draw``)."""
        p = self.num_predictors
        spec = {"perm": ((p,), "permutation"), "flip_u": ((p,), "uniform"),
                "sigsq_u": ((), "uniform_pos"), "beta_z": ((p,), "normal")}
        if self.mode_jump:
            spec.update(jump_u=((p,), "uniform"), jump_acc=((), "uniform"))
        return spec

    def draw_noise(self, generator, num_chains: int):
        return rng.draw(generator, self.noise_spec(), num_chains, self.dtype)

    def init_noise_spec(self):
        return {"gamma_u": ((self.num_predictors,), "uniform")}

    def draw_init_noise(self, generator, num_chains: int):
        return rng.draw(generator, self.init_noise_spec(), num_chains,
                        self.dtype)

    def init_state(self, noise):
        """Initial states (reference :285): each coordinate in with
        probability max(pi, 2/p). With ``max_size``, a mask past the cap
        keeps its first ``max_size`` coordinates: the port's flips never
        leave the prior's support, so a chain must start inside it."""
        p = self.num_predictors
        pi = torch.sigmoid(self.prior.log_inclusion_odds)
        gamma = noise["gamma_u"] < torch.clamp_min(pi, 2.0 / p)
        if self.prior.max_size is not None:
            gamma = gamma & (gamma.cumsum(-1) <= self.prior.max_size)
        c = gamma.shape[0]
        sigsq = self.prior.prior_ss / torch.clamp_min(self.prior.sigma_df,
                                                      1.0)
        return {"gamma": gamma,
                "beta": torch.zeros(c, p, dtype=self.dtype,
                                    device=gamma.device),
                "sigsq": sigsq.expand(c).clone()}

    def kernel(self):
        """``sweep(noise, state) -> state``; ``sweep.finish()`` raises if
        any Cholesky factor of the run failed (``run_mcmc`` calls it)."""
        from boom_tpu_torch.models.glm import regression_sweep, ssvs_kernel

        swept = (self.method == "sweep"
                 and regression_sweep.valid_for_prior(self.prior))
        qprobs = (screening_proposal_probs(self.suf, self.prior)
                  if self.mode_jump else None)
        # kernel (a)'s per-model operands, made once
        operands = (ssvs_kernel.sweep_operands(self.suf, self.prior, qprobs)
                    if swept and self.prior.mean.device.type == "cuda"
                    else None)
        fails, finish = failure_count(self.prior.mean.device,
                                      "the spike-and-slab posterior")

        def sweep(noise, state):
            gamma, sigsq, beta, bad = gibbs_draw(
                noise, self.suf, self.prior, state["gamma"], swept=swept,
                max_flips=self.max_flips, qprobs=qprobs, operands=operands)
            fails.add_((bad != 0).sum(dtype=torch.int32))
            return {"gamma": gamma, "beta": beta, "sigsq": sigsq}

        sweep.finish = finish
        return sweep

    @staticmethod
    def simulate(generator, n, p, nonzero, sigma=1.0, beta_scale=2.0,
                 dtype=torch.float64):
        """A sparse-regression test problem (reference :344), drawn from
        ``generator``: x [n, p] standard normal with an intercept column,
        the first ``nonzero`` coefficients +-beta_scale, y = x beta + sigma
        eps. Returns (x, y, beta)."""
        dev = generator.device
        x = torch.randn(n, p, generator=generator, device=dev, dtype=dtype)
        x[:, 0] = 1.0
        signs = torch.where(torch.rand(nonzero, generator=generator,
                                       device=dev, dtype=dtype) < 0.5,
                            -1.0, 1.0)
        beta = torch.zeros(p, dtype=dtype, device=dev)
        beta[:nonzero] = beta_scale * signs
        y = x @ beta + sigma * torch.randn(n, generator=generator,
                                           device=dev, dtype=dtype)
        return x, y, beta
