"""User front ends beyond lm.spike and bsts (port of ``FiniteMixture`` in
boom_tpu/frontends.py:90-133; the reference's mixtures/finite_mixture.py).

    fit = FiniteMixture(num_components=3).fit(y, niter=1000)  # the card
    fit.components()       # label-switching-resolved means, sds, weights
    fit.cluster_probs()    # posterior-mean responsibilities [n, K]

``fit`` runs on the CUDA card unless the caller passes ``device="cpu"``;
with no card it raises rather than falling back to the CPU. The other
front ends of the reference's file wait for their models (ROADMAP.md,
queue 1 items 9-13); ``save`` waits for ``serialize`` (item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from boom_tpu_torch import rng
from boom_tpu_torch.api import _DEFAULT_DTYPE
from boom_tpu_torch.inference.driver import McmcResult, run_mcmc


@dataclasses.dataclass
class FiniteMixture:
    """Finite Gaussian mixture (reference FiniteMixtureModel): the
    data-augmentation Gibbs sweep of ``GaussianMixtureModel`` over
    ``num_chains`` chains."""

    num_components: int = 2
    _model: Any = None
    _result: McmcResult | None = None

    def fit(self, y, niter=1000, num_chains=4, burn=300, seed=0,
            device="cuda", dtype=None, **model_kw):
        """``burn`` sweeps, then ``niter`` recorded draws of every chain on
        ``device`` (a CUDA device where there is none raises). ``dtype``
        defaults to float64 on the CPU and float32 on the card;
        ``model_kw`` are ``GaussianMixtureModel``'s priors."""
        from boom_tpu_torch.models.mixtures import GaussianMixtureModel

        device = rng.resolve_device(device)
        dtype = dtype or _DEFAULT_DTYPE[device.type]
        model = GaussianMixtureModel(
            y=torch.tensor(np.asarray(y), dtype=dtype, device=device),
            num_components=self.num_components, **model_kw)
        self._model = model
        self._result = run_mcmc(
            model.kernel(), model.draw_noise,
            lambda g, c: model.init_state(model.draw_init_noise(g, c)),
            num_draws=niter, generator=rng.generator(seed, device),
            num_chains=num_chains, burn=burn)
        return self

    @property
    def draws(self):
        """Chain-major draws, ``[chains, niter, K]``: mu, sigsq, weights."""
        return self._result.draws

    def components(self):
        """Posterior means of each component's mean, sd and weight, the
        components sorted by mu in every draw (reference :114)."""
        from boom_tpu_torch.models.mixtures import relabel_sorted

        d = self.draws
        mu, sigsq, w = relabel_sorted(d["mu"], d["sigsq"], d["weights"])
        k = self.num_components

        def flat(a):
            return a.double().reshape(-1, k).cpu().numpy()

        mu, sd, w = flat(mu), np.sqrt(flat(sigsq)), flat(w)
        return [{"mean": float(mu[:, j].mean()), "sd": float(sd[:, j].mean()),
                 "weight": float(w[:, j].mean())} for j in range(k)]

    def cluster_probs(self, y=None):
        """Posterior-mean responsibilities [n, K] over the chains' final
        states (reference :124), of ``y`` (default the fit's data)."""
        model = self._model
        y = model.y if y is None else torch.as_tensor(
            np.asarray(y), dtype=model.dtype, device=model.y.device)
        resp = torch.softmax(model.responsibilities(self._result.final_state,
                                                    y), dim=-1)
        return resp.mean(0).double().cpu().numpy()

    def save(self, path):
        raise NotImplementedError(
            "FiniteMixture.save (serialize) is not ported yet (ROADMAP.md, "
            "queue 1 item 9)")
