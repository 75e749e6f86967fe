"""Hidden Markov models: forward filtering and FFBS Gibbs (port of
``forward_filter``, ``backward_sample``, ``smoothed_marginals``,
``transition_counts`` and ``GaussianHmm`` of boom_tpu/models/hmm.py:32-205;
BASELINE config #4). ``CategoricalHmm``, ``pairwise_smoothed``,
``hmm_em_gaussian``, ``GeneralHmm`` and ``NestedHmm`` wait (ROADMAP.md,
queue 1 item 8).

Chains are the leading axis: log_lik [C, T, S], log_trans [C, S, S] (row =
from, column = to), log_init [C, S]. The functions here are the plain
PyTorch versions, a Python loop over T of batched [C, S] steps: the CPU
path and the yardstick of the hand kernels H1 (the forward filter) and H2
(the backward sampler with the path's statistics), ``csrc/hmm.cu``, which
``models/hmm_kernel.py`` launches on a CUDA tensor. ``GaussianHmm``'s sweep
goes through ``hmm_kernel``, so a sweep on the card is one H1 and one H2
launch (``parallel_filter=True``: the associative scan of
``hmm_parallel.py`` in place of H1).
"""

from __future__ import annotations

import dataclasses

import torch

from boom_tpu_torch import rng
from boom_tpu_torch.dists import categorical, dirichlet, gamma, normal
from boom_tpu_torch.models.conjugate import (
    GaussianSuf,
    gaussian_mean_var_from_gamma,
    gaussian_mean_var_posterior,
)
from boom_tpu_torch.models.mixtures import start_quantiles


def forward_filter(log_lik, log_trans, log_init, want_alphas=True):
    """The normalised forward pass (reference :32): (log_alphas [C, T, S]
    normalised a step, or None without ``want_alphas``; loglike [C])."""
    la = log_init + log_lik[:, 0]
    norm = torch.logsumexp(la, dim=-1)
    la = la - norm[:, None]
    total = norm
    out = [la] if want_alphas else None
    for t in range(1, log_lik.shape[1]):
        # predict: log-sum-exp over the previous state
        pred = torch.logsumexp(la[:, :, None] + log_trans, dim=1)
        la = pred + log_lik[:, t]
        norm = torch.logsumexp(la, dim=-1)
        la = la - norm[:, None]
        total = total + norm
        if want_alphas:
            out.append(la)
    return (torch.stack(out, dim=1) if want_alphas else None), total


def gumbel_logits(log_alphas, log_trans, z_next, log_neg_log_u):
    """logits + Gumbel noise of z_t given z_{t+1} = ``z_next`` [C]: la_t +
    log_trans[:, z_next] - log(-log u_t)."""
    col = torch.gather(log_trans, 2, z_next[:, None, None].expand(
        -1, log_trans.shape[1], 1))[..., 0]
    return log_alphas + col - log_neg_log_u


def backward_sample(log_alphas, log_trans, path_u):
    """The stochastic backward pass (reference :58): the path z [C, T]
    int32 at the Gumbel uniforms ``path_u`` [C, T, S]: z_{T-1} from the last
    row, then z_t = argmax(la_t + log_trans[:, z_{t+1}] - log(-log u_t))
    for t = T-2 down to 0 (the reference draws row T-1 from its first key
    and row t from the t-th of its scan's keys)."""
    g = torch.log(-torch.log(path_u))
    t_len = log_alphas.shape[1]
    z = categorical.sample(log_alphas[:, -1], path_u[:, -1])
    out = [None] * t_len
    out[-1] = z
    for t in range(t_len - 2, -1, -1):
        z = torch.argmax(gumbel_logits(log_alphas[:, t], log_trans, z,
                                       g[:, t]), dim=-1)
        out[t] = z
    return torch.stack(out, dim=1).to(torch.int32)


def path_stats(z, y, num_states):
    """The sweep's statistics of paths z [C, T] (reference :168-182, the
    one-hot matmuls): GaussianSuf [C, S] of y [T] by state, the transition
    counts [C, S, S] and the first state's one-hot [C, S]."""
    onehot = torch.nn.functional.one_hot(z.long(), num_states).to(y.dtype)
    suf = GaussianSuf(n=onehot.sum(1),
                      sum=torch.einsum("cts,t->cs", onehot, y),
                      sumsq=torch.einsum("cts,t->cs", onehot, y * y))
    counts = torch.einsum("cts,ctr->csr", onehot[:, :-1], onehot[:, 1:])
    return suf, counts, onehot[:, 0]


def backward_sample_stats(log_alphas, log_trans, path_u, y):
    """H2's plain version: ``backward_sample``, then ``path_stats``: (z,
    GaussianSuf, counts, first state's one-hot)."""
    z = backward_sample(log_alphas, log_trans, path_u)
    return (z, *path_stats(z, y, log_alphas.shape[-1]))


def smoothed_marginals(log_lik, log_trans, log_init):
    """P(z_t = s | y) [C, T, S] and loglike [C] (reference :77): the
    forward pass (H1 on the card), then the backward messages in plain
    PyTorch (a loop over T; off the sweep's path)."""
    from boom_tpu_torch.models import hmm_kernel

    log_alphas, loglike = hmm_kernel.forward_filter(log_lik, log_trans,
                                                    log_init)
    lb = torch.zeros_like(log_lik[:, 0])
    betas = [lb]
    for t in range(log_lik.shape[1] - 1, 0, -1):
        lb = torch.logsumexp(
            log_trans + (log_lik[:, t] + lb)[:, None, :], dim=2)
        betas.append(lb)
    post = log_alphas + torch.stack(betas[::-1], dim=1)
    post = post - torch.logsumexp(post, dim=-1, keepdim=True)
    return torch.exp(post), loglike


def transition_counts(z, num_states):
    """[..., S, S] transition counts of paths z [..., T] (reference :97)."""
    onehot = torch.nn.functional.one_hot(z.long(), num_states).to(
        torch.get_default_dtype())
    return onehot[..., :-1, :].transpose(-1, -2) @ onehot[..., 1:, :]


@dataclasses.dataclass(frozen=True)
class GaussianHmm:
    """HMM with Gaussian emissions and conjugate priors (reference :105):
    transition rows ~ Dirichlet(trans_prior), the initial distribution ~
    Dirichlet(init_prior) given the path's first state, (mu_s, sigsq_s) ~
    Normal-Inverse-ChiSq. y [T] is shared by every chain."""

    y: torch.Tensor  # [T]
    num_states: int
    trans_prior: float = 1.0
    init_prior: float = 1.0
    mean_guess: float = 0.0
    mean_nobs: float = 0.01
    sigma_df: float = 1.0
    sigma_guess: float = 1.0
    # the associative-scan forward filter (hmm_parallel.py) in place of H1
    parallel_filter: bool = False

    @property
    def dtype(self):
        return self.y.dtype

    def _forward(self, log_lik, log_trans, log_init, want_alphas=True):
        from boom_tpu_torch.models import hmm_kernel

        if self.parallel_filter:
            from boom_tpu_torch.models.hmm_parallel import (
                parallel_forward_filter,
            )

            return parallel_forward_filter(log_lik, log_trans, log_init)
        return hmm_kernel.forward_filter(log_lik, log_trans, log_init,
                                         want_alphas=want_alphas)

    def init_noise_spec(self):
        s = self.num_states
        return {"q_u": ((s,), "uniform"), "trans_u": ((s, s), "uniform_pos")}

    def draw_init_noise(self, generator, num_chains: int):
        return rng.draw(generator, self.init_noise_spec(), num_chains,
                        self.dtype)

    def init_state(self, noise):
        """Means at random data quantiles, variances var(y) / S, rows of
        the transition matrix ~ Dirichlet(5), a uniform initial
        distribution (reference :138)."""
        s = self.num_states
        mu = start_quantiles(noise["q_u"], self.y)
        sigsq = torch.full_like(mu, float(self.y.var(correction=0)) / s)
        trans = dirichlet.sample(noise["trans_u"],
                                 torch.full_like(noise["trans_u"], 5.0))
        return {"mu": mu, "sigsq": sigsq, "trans": trans,
                "init": torch.full_like(mu, 1.0 / s)}

    def emission_loglik(self, state):
        """[C, T, S]."""
        return normal.logpdf(self.y[None, :, None], state["mu"][:, None, :],
                             torch.sqrt(state["sigsq"])[:, None, :])

    def log_lik(self, state):
        """[C]: H1 without its alphas on the card."""
        _, ll = self._forward(self.emission_loglik(state),
                              torch.log(state["trans"]),
                              torch.log(state["init"]), want_alphas=False)
        return ll

    def noise_spec(self):
        t_len, s = self.y.shape[0], self.num_states
        return {"path_u": ((t_len, s), "uniform_pos"),
                "sig_u": ((s,), "uniform_pos"), "mu_z": ((s,), "normal"),
                "trans_u": ((s, s), "uniform_pos"),
                "init_u": ((s,), "uniform_pos")}

    def draw_noise(self, generator, num_chains: int):
        return rng.draw(generator, self.noise_spec(), num_chains,
                        self.dtype)

    def kernel(self):
        from boom_tpu_torch.models import hmm_kernel

        def sweep(noise, state):
            log_trans = torch.log(state["trans"])
            # 1. the hidden path and its statistics (H1, then H2)
            log_alphas, _ = self._forward(self.emission_loglik(state),
                                          log_trans,
                                          torch.log(state["init"]))
            _z, suf, counts, first = hmm_kernel.backward_sample_stats(
                log_alphas, log_trans, noise["path_u"], self.y)
            # 2. the emissions' and 3. the Markov chain's conjugate draws,
            # their gammas in one inverse CDF
            post = gaussian_mean_var_posterior(
                suf, self.mean_guess, self.mean_nobs, self.sigma_df,
                self.sigma_guess ** 2)
            g_sig, g_trans, g_init = gamma.sample_many(
                (noise["sig_u"], post.shape),
                (noise["trans_u"], self.trans_prior + counts),
                (noise["init_u"], self.init_prior + first))
            mu, sigsq = gaussian_mean_var_from_gamma(g_sig, noise["mu_z"],
                                                     post)
            return {"mu": mu, "sigsq": sigsq,
                    "trans": g_trans / g_trans.sum(-1, keepdim=True),
                    "init": g_init / g_init.sum(-1, keepdim=True)}

        return sweep

    @staticmethod
    def simulate(z0_u, z_u, y_z, trans, means, sds, init=None):
        """(y, z) [T]: z_0 ~ init (uniform by default) at the Gumbel
        uniforms ``z0_u`` [S], z_t | z_{t-1} at ``z_u`` [T-1, S], y = means[z]
        + sds[z] at the normals ``y_z`` [T] (reference :184)."""
        dt = y_z.dtype
        trans, means, sds = (torch.as_tensor(v, dtype=dt)
                             for v in (trans, means, sds))
        s = trans.shape[0]
        init = (torch.full((s,), 1.0 / s, dtype=dt) if init is None
                else torch.as_tensor(init, dtype=dt))
        z = [categorical.sample(torch.log(init), z0_u)]
        log_trans = torch.log(trans)
        for t in range(z_u.shape[0]):
            z.append(categorical.sample(log_trans[z[-1]], z_u[t]))
        z = torch.stack(z)
        return means[z] + sds[z] * y_z, z
