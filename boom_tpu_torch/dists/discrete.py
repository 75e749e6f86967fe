"""Discrete distributions (port of ``categorical.sample`` in
boom_tpu/dists/discrete.py:262-280, which is ``jax.random.categorical``,
and of ``beta_binomial.logpmf`` :212)."""

from __future__ import annotations

import torch

from boom_tpu_torch.dists.continuous import _as_tensors, _betaln


def log_binom_coef(n, k):
    """log C(n, k) through lgamma (reference discrete.py:19)."""
    return (torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0)
            - torch.lgamma(n - k + 1.0))


def _is_count(x):
    return (x >= 0) & (x == torch.floor(x))


class beta_binomial:
    """Beta-binomial counts (reference discrete.py:212)."""

    @staticmethod
    def logpmf(x, n, a, b):
        x, n, a, b = torch.broadcast_tensors(*_as_tensors(x, n, a, b))
        ok = _is_count(x) & (x <= n)
        xs = torch.where(ok, x, 0.0)
        out = (log_binom_coef(n, xs) + _betaln(xs + a, n - xs + b)
               - _betaln(a, b))
        return torch.where(ok, out, -torch.inf)


class categorical:
    """Categorical over {0..K-1} given (possibly unnormalized) log-probs."""

    @staticmethod
    def sample(logits, gumbel_u):
        """argmax over the last axis of logits + Gumbel noise, as
        ``jax.random.categorical`` computes it: the noise is
        -log(-log(u)) of the uniforms ``gumbel_u`` (shape of ``logits``, in
        [tiny, 1), as ``jax.random.gumbel`` draws them). A ``-inf`` logit is
        never chosen unless all are."""
        return torch.argmax(logits - torch.log(-torch.log(gumbel_u)),
                            dim=-1)
