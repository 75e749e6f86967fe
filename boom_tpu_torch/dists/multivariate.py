"""Multivariate T (port of ``mvt`` in boom_tpu/dists/multivariate.py:121-147,
with the triangular solves and log-determinant it uses, :21-45), the
multivariate normal's draw from its natural parameters (``mvn.sample_suf``
:100) and the Dirichlet (:153).

Batched over leading dimensions; the samplers take their normals and
uniforms as tensors (see ``boom_tpu_torch.rng``).
"""

from __future__ import annotations

import math

import torch

from boom_tpu_torch.dists.continuous import gamma
from boom_tpu_torch.dists.truncated import trun_gamma_lower_fast


def _solve_tri_lower(chol, b):
    """L^{-1} b for a lower-triangular L, broadcasting batch dims."""
    batch = torch.broadcast_shapes(chol.shape[:-2], b.shape[:-2])
    return torch.linalg.solve_triangular(
        chol.expand(*batch, *chol.shape[-2:]),
        b.expand(*batch, *b.shape[-2:]), upper=False)


def _solve_tri_upper_t(chol, b):
    """L'^{-1} b for a lower-triangular L (the reference's ``_solve_tri(...,
    trans=True)``), broadcasting batch dims."""
    batch = torch.broadcast_shapes(chol.shape[:-2], b.shape[:-2])
    return torch.linalg.solve_triangular(
        chol.expand(*batch, *chol.shape[-2:]).transpose(-1, -2),
        b.expand(*batch, *b.shape[-2:]), upper=True)


def log_det_from_chol(chol):
    return 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)


class mvn:
    """The multivariate normal's draws (reference ``mvn``)."""

    @staticmethod
    def sample_suf(normals, prec_mean, prec=None, prec_chol=None):
        """x ~ N(prec^{-1} b, prec^{-1}) given the natural parameters b =
        ``prec_mean`` [..., d] and ``prec`` [..., d, d] (or its lower
        Cholesky factor L), at the standard normals ``normals`` [..., d]:
        x = L'^{-1} (L^{-1} b + z), one factor for the mean and the noise
        (reference ``sample_suf``, rmvn_suf_mt)."""
        if prec_chol is None:
            prec_chol = torch.linalg.cholesky(prec)
        w = _solve_tri_lower(prec_chol, prec_mean[..., None])[..., 0]
        return _solve_tri_upper_t(prec_chol, (w + normals)[..., None])[..., 0]


class mvt:
    """Multivariate T with location ``mean``, scale ``sigma = L L'`` and
    ``df`` degrees of freedom."""

    @staticmethod
    def logpdf(x, mean, sigma, df, chol=None):
        if chol is None:
            chol = torch.linalg.cholesky(sigma)
        d = x.shape[-1]
        z = _solve_tri_lower(chol, (x - mean)[..., None])[..., 0]
        maha = (z * z).sum(-1)
        h = 0.5 * (df + d)
        return (math.lgamma(h) - math.lgamma(0.5 * df)
                - 0.5 * d * math.log(df * math.pi)
                - 0.5 * log_det_from_chol(chol)
                - h * torch.log1p(maha / df))

    @staticmethod
    def sample(normals, chi_u, mean, sigma, df, chol=None):
        """mean + L g / sqrt(w): g = the standard normals ``normals``
        [..., d], and w ~ Gamma(df/2, rate df/2) (a chi-square over df)
        drawn by inverse CDF at the uniforms ``chi_u`` [...]. The
        reference draws w from ``jax.random.gamma``; the inverse CDF
        (``trun_gamma_lower_fast``, as ``scaled_inv_chisq.sample``) keeps
        the draw a function of one uniform."""
        if chol is None:
            chol = torch.linalg.cholesky(sigma)
        g = (chol * normals[..., None, :]).sum(-1)
        w = trun_gamma_lower_fast(chi_u, 0.5 * df, 0.5 * df, 0.0,
                                  newton_iters=8)
        return mean + g / torch.sqrt(w)[..., None]


class dirichlet:
    """Dirichlet over the last axis (reference multivariate.py:153)."""

    @staticmethod
    def logpdf(x, alpha):
        return ((alpha - 1.0) * torch.log(x)).sum(-1) + torch.lgamma(
            alpha.sum(-1)) - torch.lgamma(alpha).sum(-1)

    @staticmethod
    def sample(u, alpha):
        """Gammas (rate 1) by inverse CDF at the uniforms ``u`` (the shape
        of ``alpha`` broadcast), normalised over the last axis. The
        reference normalises ``jax.random.gamma`` draws: the same
        distribution."""
        g = gamma.sample(u, alpha)
        return g / g.sum(-1, keepdim=True)
