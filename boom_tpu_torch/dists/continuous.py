"""Continuous distributions on the bsts path (port of the gamma and
scaled-inverse-chi-square parts of boom_tpu/dists/continuous.py).

Parameter conventions follow the reference: ``gamma(shape a, rate b)`` with
mean a/b, and ``scaled_inv_chisq(df, sigma^2)``. Every function is
elementwise over broadcast tensors. Samplers take their uniforms as tensors
(see ``boom_tpu_torch.rng``) and invert the CDF, so given the same uniforms
they are deterministic.
"""

from __future__ import annotations

import torch


class gamma:
    """Gamma(a, rate b) (reference continuous.py:133-158)."""

    @staticmethod
    def logpdf(x, a, b=1.0):
        x, a, b = torch.broadcast_tensors(*_as_tensors(x, a, b))
        out = (a * torch.log(b) - torch.lgamma(a)
               + (a - 1.0) * torch.log(torch.where(x > 0, x, 1.0)) - b * x)
        at_zero = torch.where(
            a < 1, torch.inf,
            torch.where(a == 1, torch.log(b), -torch.inf))
        return torch.where(x > 0, out,
                           torch.where(x == 0, at_zero, -torch.inf))

    @staticmethod
    def cdf(x, a, b=1.0):
        x, a, b = torch.broadcast_tensors(*_as_tensors(x, a, b))
        return torch.where(
            x > 0, torch.special.gammainc(a, b * torch.clamp_min(x, 0.0)),
            0.0)


class scaled_inv_chisq:
    """sigma^2 ~ ScaledInvChisq(df, s^2): df s^2 / sigma^2 ~ chisq(df)
    (reference continuous.py:233)."""

    @staticmethod
    def sample(u, df, sigsq):
        """Draw by inverting the CDF of the precision Gamma(df/2, df s^2/2)
        at the uniforms ``u``. The reference draws the same distribution
        from ``jax.random.gamma``; the inverse CDF keeps the draw a
        function of one uniform per lane."""
        from boom_tpu_torch.dists.truncated import trun_gamma_lower_fast

        prec = trun_gamma_lower_fast(u, 0.5 * df, 0.5 * df * sigsq, 0.0,
                                     newton_iters=8)
        return 1.0 / prec

    @staticmethod
    def sample_upper_truncated(u, df, sigsq, upper):
        """The same distribution restricted to sigma^2 <= ``upper``
        (reference continuous.py:254): the precision Gamma(df/2,
        df s^2/2) truncated to [1/upper, inf), by inverse CDF at ``u``."""
        from boom_tpu_torch.dists.truncated import trun_gamma_lower_fast

        prec = trun_gamma_lower_fast(u, 0.5 * df, 0.5 * df * sigsq,
                                     1.0 / upper, newton_iters=8)
        return 1.0 / prec


def _as_tensors(*vals):
    """Python numbers and tensors -> tensors of one float dtype/device."""
    like = next((v for v in vals if isinstance(v, torch.Tensor)), None)
    dtype = like.dtype if like is not None else torch.get_default_dtype()
    device = like.device if like is not None else None
    return tuple(torch.as_tensor(v, dtype=dtype, device=device)
                 for v in vals)
