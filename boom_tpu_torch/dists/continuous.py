"""Continuous distributions (port of the normal, gamma, beta and
scaled-inverse-chi-square parts of boom_tpu/dists/continuous.py).

Parameter conventions follow the reference: ``gamma(shape a, rate b)`` with
mean a/b, ``beta(a, b)`` and ``scaled_inv_chisq(df, sigma^2)``. Every
function is elementwise over broadcast tensors. Samplers take their
normals and uniforms as tensors (see ``boom_tpu_torch.rng``) and invert the
CDF, so given the same numbers they are deterministic.
"""

from __future__ import annotations

import math

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
# gamma.sample holds shapes from here up (the conjugate variance draw of an
# empty component, prior df 1, has shape 1/2); a smaller one is refused
GAMMA_MIN_SHAPE = 0.5
# Newton steps of gamma.sample: 5 reach 1e-14 relative at every shape in
# [0.5, 1200] and level in [1e-300, 1 - 1e-15]; one more for margin (each
# step is an incomplete gamma and its complement, in float64: ~0.3 ms a
# call on an H100 whatever the size, the most of an HMM sweep's device time)
GAMMA_NEWTON_ITERS = 6
_SMALL_SHAPE = (
    "gamma.sample draws shapes >= {min} by inverse CDF; a shape of {a:g} "
    "would put its quantiles below the float range (ROADMAP.md, queue 1 "
    "item 14: the rest of dists)")


def _betaln(a, b):
    """log B(a, b) through lgamma (the reference's ``_betaln``)."""
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


class normal:
    """Gaussian (reference continuous.py:64)."""

    @staticmethod
    def logpdf(x, mean=0.0, sd=1.0):
        x, mean, sd = _as_tensors(x, mean, sd)
        z = (x - mean) / sd
        return -0.5 * z * z - torch.log(sd) - _LOG_SQRT_2PI

    @staticmethod
    def sample(z, mean=0.0, sd=1.0):
        """mean + sd z at the standard normals ``z``."""
        return mean + sd * z


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

    @staticmethod
    def sample(u, a, b=1.0):
        """Gamma(a, rate b) by inverse CDF at the uniforms ``u`` in (0, 1),
        for shapes a >= ``GAMMA_MIN_SHAPE`` (a smaller one raises; the
        check reads the shapes on the host). The reference draws from
        ``jax.random.gamma``; the same distribution, a function of one
        uniform a lane.

        Computed in float64 whatever the dtype, then cast back. Newton in
        t = log x on log P(a, e^t) = log u below the median and on
        log Q(a, e^t) = log(1 - u) above it: both are concave in t (the log
        gamma density is log-concave), so from the larger of the
        Wilson-Hilferty start and the small-x root of x^a / Gamma(a + 1) =
        u the iterates overshoot at most once and then close in
        monotonically, at every shape and level (``trun_gamma_lower_fast``
        takes linear steps in a tail at small shapes)."""
        u, a, b = torch.broadcast_tensors(*_as_tensors(u, a, b))
        if a.numel() and float(a.min()) < GAMMA_MIN_SHAPE:
            raise NotImplementedError(_SMALL_SHAPE.format(
                min=GAMMA_MIN_SHAPE, a=float(a.min())))
        out_dtype = u.dtype
        u, a64 = u.double(), a.double()
        p = u.clamp(1e-300, 1.0 - 2.0 ** -53)
        lower = p <= 0.5
        log_p, log_q = torch.log(p), torch.log1p(-p)
        lga = torch.lgamma(a64)
        c = 1.0 / (9.0 * a64)
        wh = a64 * (1.0 - c + torch.special.ndtri(p) * torch.sqrt(c)) ** 3
        small = torch.exp((log_p + torch.lgamma(a64 + 1.0)) / a64)
        t = torch.log(torch.maximum(wh, small))
        for _ in range(GAMMA_NEWTON_ITERS):
            x = torch.exp(t)
            log_fx = a64 * t - x - lga  # log(f(x) x), the density of t
            tail = torch.where(lower, torch.special.gammainc(a64, x),
                               torch.special.gammaincc(a64, x))
            log_tail = torch.log(tail)
            step = ((log_tail - torch.where(lower, log_p, log_q))
                    * torch.exp(log_tail - log_fx))
            # a converged lane can read 0 / 0
            step = torch.nan_to_num(torch.where(lower, step, -step), nan=0.0)
            t = t - step
        return (torch.exp(t) / b.double()).to(out_dtype)

    @staticmethod
    def sample_many(*pairs):
        """``sample(u, a)`` (rate 1) of several (u, a) pairs in one pass,
        their lanes side by side, so that the inverse CDF's incomplete
        gammas (and the shapes' read on the host) run once for all of them;
        returns the draws in the pairs' order and shapes."""
        shapes = [torch.broadcast_shapes(u.shape, torch.as_tensor(a).shape)
                  for u, a in pairs]
        us, shape_s = zip(*(torch.broadcast_tensors(*_as_tensors(u, a))
                            for u, a in pairs))
        flat = gamma.sample(torch.cat([u.reshape(-1) for u in us]),
                            torch.cat([a.reshape(-1) for a in shape_s]))
        sizes = [u.numel() for u in us]
        return [g.reshape(sh) for g, sh in zip(flat.split(sizes), shapes)]


class beta:
    """Beta(a, b) (reference continuous.py:302)."""

    @staticmethod
    def logpdf(x, a, b):
        x, a, b = torch.broadcast_tensors(*_as_tensors(x, a, b))
        inside = (x > 0) & (x < 1)
        safe = torch.where(inside, x, 0.5)
        out = ((a - 1.0) * torch.log(safe) + (b - 1.0) * torch.log1p(-safe)
               - _betaln(a, b))
        return torch.where(inside, out, -torch.inf)

    @staticmethod
    def sample(u_a, u_b, a, b):
        """g_a / (g_a + g_b), the two gammas (rate 1) drawn by
        ``gamma.sample`` at the uniforms ``u_a`` and ``u_b``. The reference
        draws ``jax.random.beta``: the same distribution."""
        g_a = gamma.sample(u_a, a)
        g_b = gamma.sample(u_b, b)
        return g_a / (g_a + g_b)


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
    """Python numbers and tensors -> tensors of one float dtype/device. A
    number becomes a filled 0-dim tensor on the device: ``as_tensor`` would
    copy it from the host, a copy that waits for the card's queue."""
    like = next((v for v in vals if isinstance(v, torch.Tensor)), None)
    dtype = like.dtype if like is not None else torch.get_default_dtype()
    device = like.device if like is not None else None
    return tuple(torch.as_tensor(v, dtype=dtype, device=device)
                 if isinstance(v, torch.Tensor)
                 else torch.full((), v, dtype=dtype, device=device)
                 for v in vals)
