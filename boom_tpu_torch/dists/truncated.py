"""Truncated distributions (port of boom_tpu/dists/truncated.py: the
truncated normal ``trun_normal`` :20-115 and ``trun_gamma_lower_fast``
:213-257).

The samplers take their uniforms as tensors (see ``boom_tpu_torch.rng``):
given the same numbers they are deterministic.
"""

from __future__ import annotations

import math

import torch

from boom_tpu_torch.dists.continuous import _as_tensors, gamma, normal

# standardized bound beyond which the truncated normal takes Robert's tail
# rejection, and that rejection's fixed number of trips (reference :18, :35)
TAIL = 4.0
TAIL_TRIPS = 32


def _std_trunc_normal_body(u, a, b):
    """A standard normal truncated to [a, b] by inverse CDF on the ndtr
    scale at the uniforms ``u`` (in (0, 1)); accurate where the interval is
    not deep in a tail (reference :22)."""
    tiny = torch.finfo(a.dtype).tiny
    pa, pb = torch.special.ndtr(a), torch.special.ndtr(b)
    p = pa + u * (pb - pa)
    x = torch.special.ndtri(torch.clamp(p, tiny, 1.0 - 1e-7))
    return torch.minimum(torch.maximum(x, a), b)


def _tail_rejection(u1, u2, a, b):
    """Robert's (1995) exponential-proposal rejection for the upper tail
    [a, b], a >= TAIL, over the trips of the uniforms ``u1``, ``u2`` [...,
    trips] (the proposal's and the acceptance's), the first accepted
    proposal kept; the bound where none is (reference :35)."""
    alpha = 0.5 * (a + torch.sqrt(a * a + 4.0))
    x, acc = a, torch.zeros_like(a, dtype=torch.bool)
    cap = -torch.expm1(-alpha * (b - a))
    for k in range(u1.shape[-1]):
        # exponential(alpha) truncated to [0, b - a] by inverse CDF
        prop = a + (-torch.log1p(-u1[..., k] * cap) / alpha)
        take = ~acc & (torch.log(u2[..., k]) < -0.5 * (prop - alpha) ** 2)
        x = torch.where(take, prop, x)
        acc = acc | take
    return torch.where(acc, x, a)


def _log_normal_interval_mass(a, b):
    """log(Phi(b) - Phi(a)), stable in either tail (reference :118)."""
    flip = a > 0.0
    a2, b2 = torch.where(flip, -b, a), torch.where(flip, -a, b)
    la = torch.where(a2 > -math.inf, torch.special.log_ndtr(a2), -math.inf)
    lb = torch.special.log_ndtr(b2)
    diff = torch.clamp(la - lb, max=-1e-20)
    return lb + torch.log(-torch.expm1(diff))


class trun_normal:
    """Normal(mean, sd) truncated to [lo, hi], either side possibly
    infinite (reference ``trun_normal``, distributions/trun_norm.cpp)."""

    @staticmethod
    def logpdf(x, mean=0.0, sd=1.0, lo=-math.inf, hi=math.inf):
        x, mean, sd, lo, hi = _as_tensors(x, mean, sd, lo, hi)
        inside = (x >= lo) & (x <= hi)
        logz = _log_normal_interval_mass((lo - mean) / sd, (hi - mean) / sd)
        return torch.where(inside, normal.logpdf(x, mean, sd) - logz,
                           -math.inf)

    @staticmethod
    def sample(u, tail_u1, tail_u2, mean=0.0, sd=1.0, lo=-math.inf,
               hi=math.inf):
        """A draw at the uniforms of the body ``u`` [...] and of the tail's
        TAIL_TRIPS trips ``tail_u1``, ``tail_u2`` [..., TAIL_TRIPS] (the
        reference's ``jax.random.uniform``s of its key, minval tiny): the
        standardized interval is mirrored so that its hard side is the
        upper tail, drawn by inverse CDF unless it starts past TAIL, then
        by the tail's rejection."""
        u, mean, sd, lo, hi = torch.broadcast_tensors(
            *_as_tensors(u, mean, sd, lo, hi))
        a = torch.clamp((lo - mean) / sd, -1e30, 1e30)
        b = torch.clamp((hi - mean) / sd, -1e30, 1e30)
        flip = b < 0.0
        a2, b2 = torch.where(flip, -b, a), torch.where(flip, -a, b)
        x_mid = _std_trunc_normal_body(u, a2, b2)
        x_tail = _tail_rejection(tail_u1, tail_u2,
                                 torch.clamp_min(a2, TAIL), b2)
        x = torch.where(a2 >= TAIL, x_tail, x_mid)
        return mean + sd * torch.where(flip, -x, x)

    @staticmethod
    def mean_sd(mean, sd, lo=-math.inf, hi=math.inf):
        """The truncated normal's mean and sd (reference :97)."""
        mean, sd, lo, hi = _as_tensors(mean, sd, lo, hi)
        a, b = (lo - mean) / sd, (hi - mean) / sd
        logz = _log_normal_interval_mass(a, b)
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        pa = torch.where(fa, torch.exp(normal.logpdf(a) - logz), 0.0)
        pb = torch.where(fb, torch.exp(normal.logpdf(b) - logz), 0.0)
        m = pa - pb
        v = (1.0 + torch.where(fa, a, 0.0) * pa
             - torch.where(fb, b, 0.0) * pb - m * m)
        return mean + sd * m, sd * torch.sqrt(torch.clamp_min(v, 1e-30))


def trun_gamma_lower_fast(u, a, b, lo, newton_iters: int = 6):
    """Gamma(a, rate b) truncated to [lo, inf), drawn by inverse CDF at the
    uniforms ``u`` (in (0, 1)): a Wilson-Hilferty start and a log-space
    Newton polish. The reference draws ``u`` from its key inside; here it
    is an argument, so the draw is deterministic given ``u``."""
    u, a, b, lo = torch.broadcast_tensors(*_as_tensors(u, a, b, lo))
    finfo = torch.finfo(u.dtype)
    tiny = finfo.tiny

    p_lo = gamma.cdf(lo, a, b)
    # dtype-aware upper clip, the reference's 1 - finfo.epsneg: a fixed
    # 1 - 1e-7 rounds to exactly 1.0 in float32 and ndtri(1.0) = inf
    p_hi = 1.0 - finfo.eps / 2
    p = torch.clamp(p_lo + u * (1.0 - p_lo), tiny, p_hi)

    # Wilson-Hilferty initial value (for the unit-rate gamma)
    z = torch.special.ndtri(p)
    c = 1.0 / (9.0 * torch.clamp_min(a, 0.5))
    x = torch.maximum(a * (1.0 - c + z * torch.sqrt(c)) ** 3, 0.1 * a)
    t = torch.log(torch.clamp_min(x / b, tiny))  # log-space iterate

    # Newton on F(e^t) - p = 0: dt = -(F - p) / (f(x) * x)
    for _ in range(newton_iters):
        x = torch.exp(t)
        fx = gamma.cdf(x, a, b)
        log_dens_x = gamma.logpdf(x, a, b) + t  # log(f(x) * x)
        step = (fx - p) * torch.exp(-torch.clamp(log_dens_x, -80.0, 80.0))
        t = t - torch.clamp(step, -2.0, 2.0)

    return torch.maximum(torch.exp(t), lo)
