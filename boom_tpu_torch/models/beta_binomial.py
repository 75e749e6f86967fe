"""Beta-Binomial model: overdispersed binomial counts per group (port of
boom_tpu/models/beta_binomial.py:29-94; BASELINE config #1).

(prob, size) = (a / (a + b), a + b) under a Beta prior on prob and a Gamma
prior on size; a sweep is two scalar slice updates through ``compose``:
prob on (1e-6, 1 - 1e-6), then log(size) with its Jacobian. Chains are the
leading axis of every state tensor ([C]); the log likelihood of every
chain is one [C, G] ``beta_binomial.logpmf`` summed over the groups. Plain
batched PyTorch: a slice step evaluates the log posterior up to 65 times
(16 rounds of stepping out, 32 of shrinkage), ~25 elementwise launches
each; the rounds stop once no chain can change, a flag read on the host a
round. Fusing them is ROADMAP.md queue 1 item 6.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from boom_tpu_torch import rng
from boom_tpu_torch.dists import beta, gamma
from boom_tpu_torch.dists.continuous import _betaln
from boom_tpu_torch.dists.discrete import _is_count, log_binom_coef
from boom_tpu_torch.inference.kernels.slice import slice_step
from boom_tpu_torch.inference.state import compose, compose_spec

# the reference's slice_step defaults (expand_iters 16, shrink_iters 32)
SHRINK_ITERS = 32


def slice_noise_spec(shrink_iters=SHRINK_ITERS):
    """The uniforms of one scalar ``slice_step`` a chain: the height (in
    [tiny, 1), as the reference's), the interval's offset and one a
    shrink step."""
    return {"h_u": ((), "uniform_pos"), "u_u": ((), "uniform"),
            "shrink_u": ((shrink_iters,), "uniform")}


@dataclasses.dataclass(frozen=True)
class BetaBinomialModel:
    """trials, successes: the data [G], shared by every chain."""

    trials: torch.Tensor
    successes: torch.Tensor
    # Beta(prob_a, prob_b) prior on prob = a / (a + b)
    prob_a: float = 1.0
    prob_b: float = 1.0
    # Gamma(size_shape, size_rate) prior on sample_size = a + b
    size_shape: float = 1.0
    size_rate: float = 0.1
    slice_width: float = 1.0

    @property
    def dtype(self):
        return self.trials.dtype

    @functools.cached_property
    def _data_terms(self):
        """``beta_binomial.logpmf``'s terms of the data alone, made once:
        the valid counts, x and n - x, and log C(n, x)."""
        x, n = torch.broadcast_tensors(self.successes, self.trials)
        ok = _is_count(x) & (x <= n)
        xs = torch.where(ok, x, 0.0)
        return ok, xs, n - xs, log_binom_coef(n, xs)

    def log_lik(self, prob, size):
        """Summed over the groups, elementwise over prob and size:
        ``beta_binomial.logpmf`` with its data terms made once (the same
        operations on the same numbers)."""
        ok, xs, n_xs, lbc = self._data_terms
        a = (prob * size)[..., None]
        b = ((1.0 - prob) * size)[..., None]
        lp = lbc + _betaln(xs + a, n_xs + b) - _betaln(a, b)
        return torch.where(ok, lp, -torch.inf).sum(-1)

    @functools.cached_property
    def _priors(self):
        """The priors' parameters as 0-dim tensors on the data's device."""
        return tuple(torch.full((), v, dtype=self.dtype,
                                device=self.trials.device)
                     for v in (self.prob_a, self.prob_b, self.size_shape,
                               self.size_rate))

    def log_post(self, prob, size):
        pa, pb, shape, rate = self._priors
        return (self.log_lik(prob, size) + beta.logpdf(prob, pa, pb)
                + gamma.logpdf(size, shape, rate))

    def init_noise_spec(self):
        return {"prob_u": ((2,), "uniform_pos"),
                "size_u": ((), "uniform_pos")}

    def draw_init_noise(self, generator, num_chains: int):
        return rng.draw(generator, self.init_noise_spec(), num_chains,
                        self.dtype)

    def init_state(self, noise):
        """prob ~ Beta(2, 2) / 2 + ybar / 2 and size ~ Gamma(2, 0.5) + 1
        (reference :53), each chain from its own uniforms."""
        ybar = ((self.successes.sum() + 0.5) / (self.trials.sum() + 1.0))
        u = noise["prob_u"]
        prob = beta.sample(u[:, 0], u[:, 1], 2.0, 2.0) * 0.5 + ybar * 0.5
        size = gamma.sample(noise["size_u"], 2.0, 0.5) + 1.0
        return {"prob": prob, "size": size}

    def noise_spec(self):
        return compose_spec(slice_noise_spec(), slice_noise_spec())

    def draw_noise(self, generator, num_chains: int):
        return rng.draw(generator, self.noise_spec(), num_chains,
                        self.dtype)

    def kernel(self):
        def prob_kernel(noise, state):
            out = dict(state)
            out["prob"] = slice_step(
                state["prob"], lambda p: self.log_post(p, state["size"]),
                self.slice_width, noise["h_u"], noise["u_u"],
                noise["shrink_u"], lower=1e-6, upper=1.0 - 1e-6)
            return out

        def size_kernel(noise, state):
            # slice on log(size) with its +log(size) Jacobian
            def target(ls):
                return self.log_post(state["prob"], torch.exp(ls)) + ls

            out = dict(state)
            ls = slice_step(torch.log(state["size"]), target,
                            self.slice_width, noise["h_u"], noise["u_u"],
                            noise["shrink_u"])
            out["size"] = torch.exp(ls)
            return out

        return compose(prob_kernel, size_kernel)

    @staticmethod
    def simulate(u_a, u_b, u_trials, trials_per_group, a, b):
        """(n, y) for G groups: p_g ~ Beta(a, b) from the uniforms ``u_a``,
        ``u_b`` [G], then y_g the count of the uniforms ``u_trials`` [G,
        trials_per_group] below p_g (reference :89)."""
        p = beta.sample(u_a, u_b, a, b)
        y = (u_trials < p[:, None]).sum(-1).to(u_a.dtype)
        return torch.full_like(y, float(trials_per_group)), y
