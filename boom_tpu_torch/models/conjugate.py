"""Gaussian conjugate draws (port of ``GaussianSuf`` and the Gaussian
draws of boom_tpu/models/conjugate.py:27-97). The rest of that file (the
Beta, Poisson, exponential, Dirichlet-multinomial and MVN updates) waits
for the GLM items of ROADMAP.md.

Batched over any leading dims (chains, components); the draws take their
uniforms and normals as tensors. The variance is drawn as the reference
draws it, sigma^2 = 1 / (g / b) with g ~ Gamma(df / 2, 1) and b = df s^2 /
2, g by inverse CDF (``dists.gamma.sample``, which holds the shape 1/2 of
an empty component).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from boom_tpu_torch.dists.continuous import gamma, normal


class MeanVarPosterior(NamedTuple):
    """The normal-inverse-chi-square posterior of (mu, sigma^2): sigma^2's
    precision ~ Gamma(shape, rate), mu | sigma^2 ~ N(mean, sigma^2 /
    n)."""

    shape: torch.Tensor
    rate: torch.Tensor
    mean: torch.Tensor
    n: torch.Tensor


class GaussianSuf(NamedTuple):
    """n, sum and the uncentered sum of squares (reference :27)."""

    n: torch.Tensor
    sum: torch.Tensor
    sumsq: torch.Tensor

    @staticmethod
    def from_data(y, weights=None, dim=-1):
        if weights is None:
            n = torch.full_like(y.sum(dim), y.shape[dim])
            return GaussianSuf(n=n, sum=y.sum(dim), sumsq=(y * y).sum(dim))
        return GaussianSuf(n=weights.sum(dim), sum=(weights * y).sum(dim),
                           sumsq=(weights * y * y).sum(dim))

    def centered_sumsq(self, center=None):
        mean = self.sum / torch.clamp_min(self.n, 1e-30)
        c = mean if center is None else center
        return self.sumsq - 2.0 * c * self.sum + self.n * c * c


def _inv_chisq(u, df, sigsq):
    """ScaledInvChisq(df, sigsq) at the uniforms ``u``: the reference's
    ``inverse_gamma.sample(df / 2, df sigsq / 2)``, 1 / (g / b)."""
    return 1.0 / gamma.sample(u, 0.5 * df, 0.5 * df * sigsq)


def gaussian_mean_draw(z, suf: GaussianSuf, sigsq, prior_mean, prior_nobs):
    """mu | sigma^2, data under N(prior_mean, sigma^2 / prior_nobs), at the
    standard normals ``z`` (reference :61)."""
    n_post = suf.n + prior_nobs
    mean_post = (suf.sum + prior_nobs * prior_mean) / n_post
    return normal.sample(z, mean_post, torch.sqrt(sigsq / n_post))


def gaussian_var_draw(u, suf: GaussianSuf, mu, prior_df, prior_sigsq):
    """sigma^2 | mu, data under ScaledInvChisq(prior_df, prior_sigsq), at
    the uniforms ``u`` (reference :69)."""
    df_post = prior_df + suf.n
    ss_post = prior_df * prior_sigsq + suf.centered_sumsq(mu)
    return _inv_chisq(u, df_post, ss_post / df_post)


def gaussian_mean_var_posterior(suf: GaussianSuf, prior_mean, prior_nobs,
                                prior_df, prior_sigsq) -> MeanVarPosterior:
    """(mu, sigma^2)'s conjugate posterior (reference :78): the precision's
    Gamma(df / 2, df s^2 / 2) and mu's mean and count."""
    n_post = suf.n + prior_nobs
    ybar = suf.sum / torch.clamp_min(suf.n, 1e-30)
    mean_post = (suf.sum + prior_nobs * prior_mean) / n_post
    shrink = suf.n * prior_nobs / n_post * (ybar - prior_mean) ** 2
    df_post = prior_df + suf.n
    ss_post = prior_df * prior_sigsq + suf.centered_sumsq() + shrink
    # the reference's inverse_gamma.sample(df / 2, df (ss / df) / 2)
    return MeanVarPosterior(shape=0.5 * df_post,
                            rate=0.5 * df_post * (ss_post / df_post),
                            mean=mean_post, n=n_post)


def gaussian_mean_var_from_gamma(g, z, post: MeanVarPosterior):
    """(mu, sigma^2) from the precision's unit-rate gamma draw ``g``
    (sigma^2 = 1 / (g / rate)) and the standard normals ``z``."""
    sigsq = 1.0 / (g / post.rate)
    mu = normal.sample(z, post.mean, torch.sqrt(sigsq / post.n))
    return mu, sigsq


def gaussian_mean_var_draw(u, z, suf: GaussianSuf, prior_mean, prior_nobs,
                           prior_df, prior_sigsq):
    """(mu, sigma^2) jointly: sigma^2 from its marginal under the
    normal-inverse-chi-square prior at the uniforms ``u``, then mu |
    sigma^2 at the normals ``z`` (reference :78)."""
    post = gaussian_mean_var_posterior(suf, prior_mean, prior_nobs, prior_df,
                                       prior_sigsq)
    return gaussian_mean_var_from_gamma(gamma.sample(u, post.shape), z, post)
