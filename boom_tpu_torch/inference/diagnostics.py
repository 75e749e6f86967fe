"""Convergence diagnostics: split R-hat, effective sample size, summaries
(port of boom_tpu/inference/diagnostics.py:24-112).

Split R-hat and Geyer initial-monotone-sequence ESS (Vehtari, Gelman,
Simpson, Carpenter, Bürkner 2021), on the device of the draws. Variances
are sample variances (``correction=1``), as the reference's ``ddof=1``.
"""

from __future__ import annotations

import torch


def split_chains(x):
    """Split each chain into halves: [c, n, ...] -> [2c, n//2, ...]."""
    c, n = x.shape[0], x.shape[1]
    half = n // 2
    x = x[:, : 2 * half]
    return x.reshape(c * 2, half, *x.shape[2:])


def potential_scale_reduction(x):
    """Split R-hat. x: [chains, draws, ...] -> [...]."""
    x = split_chains(torch.as_tensor(x))
    n = x.shape[1]
    chain_means = x.mean(dim=1)
    chain_vars = x.var(dim=1, correction=1)
    w = chain_vars.mean(dim=0)
    b_over_n = chain_means.var(dim=0, correction=1)
    var_plus = (n - 1) / n * w + b_over_n
    return torch.sqrt(var_plus / w)


def _autocovariance(x, max_lag):
    """Per-chain autocovariance via FFT. x: [m, n, p] -> [m, max_lag, p]."""
    n = x.shape[1]
    xc = x - x.mean(dim=1, keepdim=True)
    size = 2 * n  # zero-pad to avoid circular wrap
    f = torch.fft.rfft(xc, n=size, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=size, dim=1)[:, :max_lag]
    return acov / n


def effective_sample_size(x):
    """Geyer initial-monotone-sequence ESS. x: [chains, draws, ...] -> [...].

    Uses split chains; combines within-chain autocovariances with the
    cross-chain variance so stuck chains deflate the estimate.
    """
    x = torch.as_tensor(x)
    trailing = x.shape[2:]
    x = split_chains(x).reshape(x.shape[0] * 2, x.shape[1] // 2, -1)
    m, n, p = x.shape

    chain_vars = x.var(dim=1, correction=1)  # [m, p]
    w = chain_vars.mean(dim=0)  # [p]
    b_over_n = x.mean(dim=1).var(dim=0, correction=1)
    var_plus = (n - 1) / n * w + b_over_n

    acov = _autocovariance(x, n)  # [m, n, p]
    mean_acov = acov.mean(dim=0)  # [n, p]
    rho = 1.0 - (w[None, :] - mean_acov) / var_plus[None, :]
    rho = torch.cat([torch.ones_like(rho[:1]), rho[1:]], dim=0)

    # Geyer pairs P_k = rho_{2k} + rho_{2k+1}
    n_pairs = n // 2
    pairs = rho[: 2 * n_pairs].reshape(n_pairs, 2, p).sum(dim=1)  # [K, p]
    # initial positive sequence: stop at the first non-positive pair
    positive = torch.cumprod((pairs > 0.0).to(torch.int32), dim=0).bool()
    # initial monotone: running minimum over the positive prefix
    monotone = torch.cummin(pairs, dim=0).values
    tau = -rho[0] + 2.0 * torch.where(positive, monotone, 0.0).sum(dim=0)
    tau = torch.clamp_min(tau, 1.0 / (m * n))
    ess = torch.clamp(m * n / tau, 1.0, m * n * 10.0)
    return ess.reshape(trailing) if trailing else ess[0]


def summary(x):
    """Posterior summary dict for draws [chains, draws, ...]."""
    x = torch.as_tensor(x)
    flat = x.reshape(-1, *x.shape[2:])
    qs = torch.quantile(
        flat, torch.tensor([0.025, 0.25, 0.5, 0.75, 0.975], dtype=x.dtype,
                           device=x.device), dim=0)
    return {
        "mean": flat.mean(dim=0),
        "sd": flat.std(dim=0, correction=1),
        "q2.5": qs[0],
        "q25": qs[1],
        "median": qs[2],
        "q75": qs[3],
        "q97.5": qs[4],
        "rhat": potential_scale_reduction(x),
        "ess": effective_sample_size(x),
    }
