"""Finite Gaussian mixture by data-augmentation Gibbs (port of
``GaussianMixtureModel``, ``relabel_sorted``, ``identify_permutation`` and
``relabel_by_permutation`` of boom_tpu/models/mixtures.py; BASELINE config
#3). ``BetaBinomialMixture`` and ``RegressionMixture`` wait (ROADMAP.md,
queue 1 item 8).

Chains are the leading axis of every state tensor ([C, K]). A sweep is one
batched [C, n, K] pass: the responsibilities, the indicators (Gumbel
argmax), their one-hot sufficient statistics, the conjugate component
draws and the Dirichlet weights, about a dozen launches; there is no
sequential scan to hand to a kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from boom_tpu_torch import rng
from boom_tpu_torch.dists import categorical, dirichlet, gamma, normal
from boom_tpu_torch.models.conjugate import (
    GaussianSuf,
    gaussian_mean_var_from_gamma,
    gaussian_mean_var_posterior,
)
from boom_tpu_torch.numopt import linear_assignment

# the reference's overdispersed starts: component means at data quantiles
# drawn from U(0.05, 0.95)
_Q_LO, _Q_HI = 0.05, 0.95


def start_quantiles(u, y):
    """Quantiles of y [n] at levels 0.05 + u (0.95 - 0.05) for the uniforms
    ``u`` [C, K], interpolated linearly between order statistics as
    ``jnp.quantile`` does (the reference's init_state)."""
    q = u * (_Q_HI - _Q_LO) + _Q_LO
    ys = torch.sort(y).values
    pos = q * (y.shape[0] - 1)
    lo = torch.floor(pos)
    hi_w = pos - lo
    lo = lo.long()
    hi = torch.clamp(lo + 1, max=y.shape[0] - 1)
    return ys[lo] * (1.0 - hi_w) + ys[hi] * hi_w


def onehot_suf(z, num, y):
    """The one-hot [C, n, K] of indicators z [C, n], and the per-component
    GaussianSuf [C, K] of y [n] (the reference's one-hot matmuls)."""
    onehot = torch.nn.functional.one_hot(z, num).to(y.dtype)
    suf = GaussianSuf(n=onehot.sum(1),
                      sum=torch.einsum("cnk,n->ck", onehot, y),
                      sumsq=torch.einsum("cnk,n->ck", onehot, y * y))
    return onehot, suf


@dataclasses.dataclass(frozen=True)
class GaussianMixtureModel:
    """K-component univariate Gaussian mixture (reference :28):
    weights ~ Dirichlet(weight_prior), (mu_k, sigsq_k) ~
    Normal-Inverse-ChiSq(mean_guess, mean_nobs, sigma_df, sigma_guess^2)."""

    y: torch.Tensor  # [n]
    num_components: int
    weight_prior: float = 1.0
    mean_guess: float = 0.0
    mean_nobs: float = 0.01
    sigma_df: float = 1.0
    sigma_guess: float = 1.0

    @property
    def dtype(self):
        return self.y.dtype

    def init_noise_spec(self):
        k = self.num_components
        return {"q_u": ((k,), "uniform"), "w_u": ((k,), "uniform_pos")}

    def draw_init_noise(self, generator, num_chains: int):
        return rng.draw(generator, self.init_noise_spec(), num_chains,
                        self.dtype)

    def init_state(self, noise):
        """Means at random data quantiles, every variance var(y) / K,
        weights ~ Dirichlet(1) (reference :50)."""
        k = self.num_components
        mu = start_quantiles(noise["q_u"], self.y)
        sigsq = torch.full_like(mu, float(self.y.var(correction=0)) / k)
        weights = dirichlet.sample(noise["w_u"], torch.ones_like(mu))
        return {"mu": mu, "sigsq": sigsq, "weights": weights}

    def responsibilities(self, state, y=None):
        """Log responsibilities [C, n, K] (unnormalised), of ``y`` (default
        the model's)."""
        y = self.y if y is None else y
        logp = normal.logpdf(y[None, :, None], state["mu"][:, None, :],
                             torch.sqrt(state["sigsq"])[:, None, :])
        return logp + torch.log(state["weights"])[:, None, :]

    def log_lik(self, state):
        """[C]."""
        return torch.logsumexp(self.responsibilities(state), dim=-1).sum(-1)

    def noise_spec(self):
        n, k = self.y.shape[0], self.num_components
        return {"z_u": ((n, k), "uniform_pos"), "sig_u": ((k,), "uniform_pos"),
                "mu_z": ((k,), "normal"), "w_u": ((k,), "uniform_pos")}

    def draw_noise(self, generator, num_chains: int):
        return rng.draw(generator, self.noise_spec(), num_chains,
                        self.dtype)

    def kernel(self):
        k = self.num_components

        def sweep(noise, state):
            # 1. the indicators (impute_latent_data)
            z = categorical.sample(self.responsibilities(state),
                                   noise["z_u"])
            # 2. each component's sufficient statistics
            _, suf = onehot_suf(z, k, self.y)
            # 3. the conjugate component draws, 4. the weights, their
            # gammas in one inverse CDF
            post = gaussian_mean_var_posterior(
                suf, self.mean_guess, self.mean_nobs, self.sigma_df,
                self.sigma_guess ** 2)
            g_sig, g_w = gamma.sample_many(
                (noise["sig_u"], post.shape),
                (noise["w_u"], self.weight_prior + suf.n))
            mu, sigsq = gaussian_mean_var_from_gamma(g_sig, noise["mu_z"],
                                                     post)
            return {"mu": mu, "sigsq": sigsq,
                    "weights": g_w / g_w.sum(-1, keepdim=True)}

        return sweep

    @staticmethod
    def simulate(z_u, y_z, weights, means, sds):
        """(y, z) [n]: z ~ Categorical(weights) at the Gumbel uniforms
        ``z_u`` [n, K], y = means[z] + sds[z] at the normals ``y_z`` [n]
        (reference :95)."""
        weights, means, sds = (torch.as_tensor(v, dtype=y_z.dtype)
                               for v in (weights, means, sds))
        z = categorical.sample(torch.log(weights), z_u)
        return means[z] + sds[z] * y_z, z


def main_mode(draws_mu):
    """[C] bool: the chains that stayed in the posterior's main mode, from
    the means' draws [C, N, K]: every draw's smallest gap between its
    sorted component means at least half the median draw's. A draw below
    it holds two components on one cluster while one wide component covers
    two (the mixture), or both states on one Gaussian (the HMM): a mode
    that a few chains of a run from the reference's overdispersed starts
    enter and keep, or leave late, which alone puts R-hat over all chains
    near 3."""
    if not isinstance(draws_mu, torch.Tensor):
        draws_mu = torch.tensor(np.asarray(draws_mu))
    mu = torch.sort(draws_mu, dim=-1).values
    if mu.shape[-1] < 2:
        return torch.ones(mu.shape[0], dtype=torch.bool, device=mu.device)
    gap = torch.diff(mu, dim=-1).amin(-1).double()
    return (gap >= 0.5 * gap.median()).all(-1)


def relabel_sorted(draws_mu, *other_draws):
    """Sort the components by mu in every draw (reference :105); the
    component axis is the last."""
    order = torch.argsort(draws_mu, dim=-1)
    out = [torch.take_along_dim(draws_mu, order, dim=-1)]
    out += [torch.take_along_dim(o, order, dim=-1) for o in other_draws]
    return tuple(out)


def identify_permutation(assignments, num_components, num_rounds: int = 3):
    """Label permutations [draws, K] from assignment draws [draws, n]
    (numpy, on the host) that agree best with the draws' co-clustering
    (reference :253, identify_permutation.cpp): new_label = perms[d,
    old_label]."""
    z = np.asarray(assignments)
    d, _n = z.shape
    k = int(num_components)
    perms = np.tile(np.arange(k), (d, 1))
    onehot = np.eye(k)[z]  # [draws, n, K]
    for _ in range(num_rounds):
        relab = np.take_along_axis(perms[:, None, :], z[..., None],
                                   axis=2)[..., 0]
        pbar = np.eye(k)[relab].mean(0)  # [n, K]
        changed = False
        for di in range(d):
            agree = onehot[di].T @ pbar  # [K, K]
            new_perm = linear_assignment(-agree)
            if not np.array_equal(new_perm, perms[di]):
                changed = True
            perms[di] = new_perm
        if not changed:
            break
    return perms


def relabel_by_permutation(perms, assignments=None, *component_draws):
    """Apply ``identify_permutation``'s perms (reference :293): relabelled
    assignments, then each component draw [draws, ..., K] reordered."""
    perms = np.asarray(perms)
    d, k = perms.shape
    out = []
    if assignments is not None:
        z = np.asarray(assignments)
        out.append(np.take_along_axis(perms[:, None, :], z[..., None],
                                      axis=2)[..., 0])
    inv = np.argsort(perms, axis=1)
    for arr in component_draws:
        a = np.asarray(arr)
        idx = inv.reshape((d,) + (1,) * (a.ndim - 2) + (k,))
        out.append(np.take_along_axis(a, np.broadcast_to(
            idx, a.shape[:-1] + (k,)), axis=-1))
    return tuple(out)
