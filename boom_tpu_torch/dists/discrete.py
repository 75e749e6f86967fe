"""Categorical draws (port of ``categorical.sample`` in
boom_tpu/dists/discrete.py:262-280, which is ``jax.random.categorical``)."""

from __future__ import annotations

import torch


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
