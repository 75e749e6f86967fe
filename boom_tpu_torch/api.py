"""User front end of the port: a builder-style ``BstsModel`` (port of the
Gaussian part of boom_tpu/api.py:278-301 and :371-474).

    model = BstsModel().add_local_linear_trend()
    model.fit(y, niter=200, burn=100, num_chains=8)   # on the CUDA card
    model.draws["blocks"]["trend"]["sigma_level_sq"]   # [chains, draws]

``fit`` runs on the card unless the caller passes ``device="cpu"``; with no
card it raises rather than falling back to the CPU.

Only the local-level and local-linear-trend blocks, Gaussian observations
and no regression are ported so far; other options raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from boom_tpu_torch import rng
from boom_tpu_torch.inference.driver import McmcResult, run_mcmc

# dtype policy: float64 for CPU runs (parity with the reference), float32
# on the card
_DEFAULT_DTYPE = {"cpu": torch.float64, "cuda": torch.float32}


@dataclasses.dataclass
class BstsModel:
    """Builder-style bsts front end (R ``bsts()`` with ``add.*`` specs)."""

    _specs: list = dataclasses.field(default_factory=list)
    _model: Any = None
    _result: McmcResult | None = None

    def add_local_level(self, **kw):
        self._specs.append(("local_level", kw))
        return self

    def add_local_linear_trend(self, **kw):
        self._specs.append(("local_linear_trend", kw))
        return self

    def _build_blocks(self, y):
        from boom_tpu_torch.statespace import state_models as sm

        builders = {
            "local_level": lambda kw: sm.LocalLevel.default(y, **kw),
            "local_linear_trend":
                lambda kw: sm.LocalLinearTrend.default(y, **kw),
        }
        return [builders[name](kw) for name, kw in self._specs]

    def fit(self, y, predictors=None, family="gaussian",
            expected_model_size=1.0, niter=1000, num_chains=4, burn=200,
            seed=0, timestamps=None, device="cuda", dtype=None, **model_kw):
        """Run ``num_chains`` chains of the Gibbs sweep on ``device``:
        ``burn`` sweeps, then ``niter`` recorded draws. The parameters up to
        ``timestamps`` are the reference's, in its order;
        ``expected_model_size`` matters only with ``predictors``, which are
        not ported yet, and ``timestamps`` raise. ``device`` is the CUDA
        card unless the caller asks for ``"cpu"``; a CUDA device on a
        machine without one raises. ``dtype`` defaults to float64 on the
        CPU and float32 on a CUDA device."""
        from boom_tpu_torch.statespace.bsts import Bsts

        if family != "gaussian":
            raise NotImplementedError(
                f"family={family!r} is not ported yet (ROADMAP.md, queue 1: "
                "statespace families)")
        if timestamps is not None:
            raise NotImplementedError(
                "timestamps are not ported yet (ROADMAP.md, queue 1 item 7: "
                "the observed/timestamps path)")
        device = rng.resolve_device(device)
        dtype = dtype or _DEFAULT_DTYPE[device.type]
        y = torch.as_tensor(np.asarray(y), dtype=dtype, device=device)
        model_kw.setdefault("chains_hint", num_chains)
        self._model = Bsts(y=y, blocks=self._build_blocks(y),
                           predictors=predictors, **model_kw)
        model = self._model
        self._result = run_mcmc(
            model.kernel(), model.draw_noise,
            lambda g, c: model.init_state(model.draw_init_noise(g, c)),
            num_draws=niter, generator=rng.generator(seed, device),
            num_chains=num_chains, burn=burn)
        return self

    @property
    def draws(self):
        """Chain-major draws of the whole state, ``[chains, niter, ...]``."""
        return self._result.draws
