"""Truncated gamma by inverse CDF (port of
boom_tpu/dists/truncated.py:213-257, ``trun_gamma_lower_fast``)."""

from __future__ import annotations

import torch

from boom_tpu_torch.dists.continuous import _as_tensors, gamma


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
