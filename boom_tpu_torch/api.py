"""User front ends of the port: ``LmSpike`` (port of boom_tpu/api.py:43-171,
lm.spike) and a builder-style ``BstsModel`` (the Gaussian part of
boom_tpu/api.py:278-755).

    fit = LmSpike(expected_model_size=3.0).fit(x, y, niter=1000)  # the card
    fit.coefficients()                     # inclusion probabilities, ...
    model = BstsModel().add_local_linear_trend().add_seasonal(nseasons=7)
    model.fit(y, predictors=x, niter=1000)            # on the CUDA card
    model.predict(horizon=30, future_predictors=x_new)    # [draws, 30]
    model.draws["blocks"]["trend"]["sigma_level_sq"]   # [chains, draws]

``fit`` runs on the card unless the caller passes ``device="cpu"``; with no
card it raises rather than falling back to the CPU.

``LmSpike`` takes the default prior's keywords; the ``priors`` module,
formulas, plots and saving are not ported yet. ``BstsModel`` has the
local-level, local-linear-trend, Student local-linear-trend, seasonal,
dynamic-regression and random-walk-holiday blocks, Gaussian observations,
the spike-and-slab regression and irregular or duplicated ``timestamps``.
Other options raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from boom_tpu_torch import rng
from boom_tpu_torch.inference.driver import McmcResult, first_leaf, run_mcmc

# dtype policy: float64 for CPU runs (parity with the reference), float32
# on the card
_DEFAULT_DTYPE = {"cpu": torch.float64, "cuda": torch.float32}


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                               f"queue 1 {item})")


def _coef_table(beta, gamma, names=None):
    """Posterior summary rows of spike-and-slab coefficients (reference
    api.py:43): draws [..., p] of beta and the inclusion indicators."""
    beta = beta.detach().double().cpu().numpy()
    gamma = gamma.detach().cpu().numpy()
    beta = beta.reshape(-1, beta.shape[-1])
    gamma = gamma.reshape(-1, gamma.shape[-1])
    names = names or [f"x{j}" for j in range(beta.shape[1])]
    rows = []
    for j in range(beta.shape[1]):
        b = beta[:, j]
        nz = b[np.abs(b) > 0]
        rows.append({
            "name": names[j],
            "inclusion_prob": float(gamma[:, j].mean()),
            "mean": float(b.mean()),
            "mean_given_inclusion": float(nz.mean()) if nz.size else 0.0,
            "sd": float(b.std()),
            "q025": float(np.quantile(b, 0.025)),
            "q975": float(np.quantile(b, 0.975)),
        })
    return rows


class LmSpike:
    """lm.spike (reference api.py:130): Gaussian regression with
    spike-and-slab variable selection, the SSVS sweep in kernel (a) on the
    card. ``prior_kw`` are ``SpikeSlabPrior.from_data``'s keywords and
    ``SpikeSlabRegression.from_data``'s (``method``, ``max_flips``,
    ``mode_jump``)."""

    def __init__(self, expected_model_size=1.0, names=None, prior=None,
                 **prior_kw):
        if prior is not None:
            raise _not_ported("LmSpike(prior=...) (the priors module)",
                              "item 14")
        self._prior_kw = dict(prior_kw,
                              expected_model_size=expected_model_size)
        self._names = names
        self._model = None
        self._result: McmcResult | None = None

    def fit(self, x, y, niter=1000, num_chains=4, burn=200, seed=0,
            device="cuda", dtype=None):
        """Run ``num_chains`` chains on ``device`` (the CUDA card unless the
        caller asks for ``"cpu"``; a CUDA device where there is none
        raises): ``burn`` sweeps, then ``niter`` recorded draws. ``dtype``
        defaults to float64 on the CPU and float32 on the card."""
        from boom_tpu_torch.models.glm import SpikeSlabRegression

        device = rng.resolve_device(device)
        dtype = dtype or _DEFAULT_DTYPE[device.type]
        x = torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        y = torch.as_tensor(np.asarray(y), dtype=dtype, device=device)
        model = SpikeSlabRegression.from_data(x, y, **self._prior_kw)
        self._model = model
        self._result = run_mcmc(
            model.kernel(), model.draw_noise,
            lambda g, c: model.init_state(model.draw_init_noise(g, c)),
            num_draws=niter, generator=rng.generator(seed, device),
            num_chains=num_chains, burn=burn)
        return self

    @property
    def draws(self):
        """Chain-major draws, ``[chains, niter, ...]``: gamma, beta,
        sigsq."""
        return self._result.draws

    def coefficients(self):
        return _coef_table(self.draws["beta"], self.draws["gamma"],
                           self._names)

    def summary(self):
        from boom_tpu_torch.inference import diagnostics

        s = torch.sqrt(self.draws["sigsq"].double()).flatten().cpu().numpy()
        return {
            "coefficients": self.coefficients(),
            "residual_sd": {"mean": float(s.mean()),
                            "q025": float(np.quantile(s, 0.025)),
                            "q975": float(np.quantile(s, 0.975))},
            "diagnostics": {"beta_rhat": diagnostics
                            .potential_scale_reduction(
                                self.draws["beta"].double()).tolist()},
        }

    def predict(self, x_new, seed=0):
        """Posterior-predictive draws [draws, n_new], the noise from a
        generator seeded with ``seed`` on the fit's device."""
        beta = self.draws["beta"]
        x_new = torch.as_tensor(np.asarray(x_new), dtype=beta.dtype,
                                device=beta.device)
        beta = beta.reshape(-1, x_new.shape[1])
        sig = torch.sqrt(self.draws["sigsq"].reshape(-1))
        eta = beta @ x_new.T
        eps = torch.randn(eta.shape, generator=rng.generator(
            seed, beta.device), device=beta.device, dtype=beta.dtype)
        return eta + sig[:, None] * eps

    def fit_formula(self, formula, data, **fit_kw):
        raise _not_ported("LmSpike.fit_formula (the formula module)",
                          "item 14")

    def plot(self, kind="inclusion", ax=None, **kw):
        raise _not_ported("LmSpike.plot (rplots)", "item 9")

    def save(self, path):
        raise _not_ported("LmSpike.save (serialize)", "item 9")


@dataclasses.dataclass
class BstsModel:
    """Builder-style bsts front end (R ``bsts()`` with ``add.*`` specs;
    reference api.py:278)."""

    _specs: list = dataclasses.field(default_factory=list)
    _model: Any = None
    _result: McmcResult | None = None
    _timestamp_info: Any = None

    def add_local_level(self, **kw):
        self._specs.append(("local_level", kw))
        return self

    def add_local_linear_trend(self, **kw):
        self._specs.append(("local_linear_trend", kw))
        return self

    def add_semilocal_linear_trend(self, **kw):
        """A level whose slope reverts to a long-run mean (R bsts'
        AddSemilocalLinearTrend)."""
        self._specs.append(("semilocal_linear_trend", kw))
        return self

    def add_student_local_linear_trend(self, **kw):
        self._specs.append(("student_local_linear_trend", kw))
        return self

    def add_seasonal(self, nseasons, **kw):
        self._specs.append(("seasonal", dict(kw, nseasons=nseasons)))
        return self

    def add_trig(self, period, nfreq, **kw):
        """Trigonometric seasonality of ``period`` with ``nfreq`` harmonics
        (AddTrig)."""
        self._specs.append(("trig", dict(kw, period=period, nfreq=nfreq)))
        return self

    def add_ar(self, lags=1, **kw):
        """An AR(``lags``) state (AddAr)."""
        self._specs.append(("ar", dict(kw, lags=lags)))
        return self

    def add_static_intercept(self, **kw):
        """A constant level (AddStaticIntercept)."""
        self._specs.append(("static_intercept", kw))
        return self

    def add_monthly_annual_cycle(self, first_date, **kw):
        """A 12-season cycle of a daily series, moving on the first of each
        month (AddMonthlyAnnualCycle); ``first_date``: the date of y[0]."""
        self._specs.append(
            ("monthly_annual_cycle", dict(kw, first_date=first_date)))
        return self

    def add_dynamic_regression(self, predictors, **kw):
        """Coefficients that follow random walks on ``predictors`` [T, p],
        one row a time point of the (regularized) grid."""
        self._specs.append(("dynamic_regression",
                            dict(kw, predictors=np.asarray(predictors))))
        return self

    def add_random_walk_holiday(self, active, window, **kw):
        """A holiday window of ``window`` days: ``active`` [T] gives each
        time point's day of the window, -1 outside it."""
        self._specs.append(("holiday", dict(kw, active=np.asarray(active),
                                            window=window)))
        return self

    def _build_blocks(self, y):
        from boom_tpu_torch.statespace import state_models as sm

        builders = {
            "local_level": lambda kw: sm.LocalLevel.default(y, **kw),
            "local_linear_trend":
                lambda kw: sm.LocalLinearTrend.default(y, **kw),
            "semilocal_linear_trend":
                lambda kw: sm.SemilocalLinearTrend.default(y, **kw),
            "student_local_linear_trend":
                lambda kw: sm.StudentLocalLinearTrend.default(y, **kw),
            "seasonal": lambda kw: sm.Seasonal.default(y, **kw),
            "trig": lambda kw: sm.Trig.default(y, **kw),
            "ar": lambda kw: sm.ArState.default(y, **kw),
            "static_intercept":
                lambda kw: sm.StaticIntercept.default(y, **kw),
            "monthly_annual_cycle":
                lambda kw: sm.MonthlyAnnualCycle.default(y, **kw),
            "dynamic_regression":
                lambda kw: sm.DynamicRegression.default(y, **kw),
            "holiday": lambda kw: sm.RandomWalkHoliday.default(y, **kw),
        }
        return [builders[name](kw) for name, kw in self._specs]

    def fit(self, y, predictors=None, family="gaussian",
            expected_model_size=1.0, niter=1000, num_chains=4, burn=200,
            seed=0, timestamps=None, device="cuda", dtype=None, **model_kw):
        """Run ``num_chains`` chains of the Gibbs sweep on ``device``:
        ``burn`` sweeps, then ``niter`` recorded draws. The parameters up to
        ``timestamps`` are the reference's, in its order: ``predictors``
        [T, p] add a spike-and-slab regression whose prior is
        ``SpikeSlabPrior.from_data`` with ``expected_model_size``, as the
        reference builds it (api.py:458-463). ``timestamps`` (numeric,
        numpy datetime64 or dates, one a raw observation) regularize the
        series as the reference's (api.py:411-452, ``utils.timestamps``):
        gaps become unobserved grid points and duplicated stamps one grid
        point of their mean, y and ``predictors`` averaged onto the grid;
        the time-varying blocks' series (``add_dynamic_regression``,
        ``add_random_walk_holiday``) are on that grid.
        ``device`` is the CUDA card unless the caller asks for ``"cpu"``; a
        CUDA device on a machine without one raises. ``dtype`` defaults to
        float64 on the CPU and float32 on a CUDA device."""
        from boom_tpu_torch.models.glm.regression import SpikeSlabPrior
        from boom_tpu_torch.statespace.bsts import Bsts

        if family != "gaussian":
            raise NotImplementedError(
                f"family={family!r} is not ported yet (ROADMAP.md, queue 1: "
                "statespace families)")
        device = rng.resolve_device(device)
        dtype = dtype or _DEFAULT_DTYPE[device.type]
        if timestamps is not None:
            from boom_tpu_torch.utils.timestamps import (
                collapse_to_grid,
                regularize_timestamps,
            )

            info = regularize_timestamps(timestamps)
            if not info.timestamps_are_trivial:
                grid = collapse_to_grid(
                    np.asarray(y), info, predictors=None
                    if predictors is None else np.asarray(predictors))
                y = grid["y_grid"]
                model_kw.setdefault("observed", torch.as_tensor(
                    grid["observed"], device=device))
                model_kw.setdefault("obs_weights", torch.as_tensor(
                    grid["weights"], dtype=dtype, device=device))
                model_kw.setdefault("extra_obs_ss", torch.as_tensor(
                    grid["extra_ss_t"], dtype=dtype, device=device))
                if predictors is not None:
                    predictors = grid["predictors_grid"]
            self._timestamp_info = info
        y = torch.as_tensor(np.asarray(y), dtype=dtype, device=device)
        reg_prior = None
        if predictors is not None:
            predictors = torch.as_tensor(np.asarray(predictors), dtype=dtype,
                                         device=device)
            reg_prior = SpikeSlabPrior.from_data(
                predictors, y, expected_model_size=expected_model_size,
                prior_information_weight=1.0)
        model_kw.setdefault("chains_hint", num_chains)
        self._model = Bsts(y=y, blocks=self._build_blocks(y),
                           predictors=predictors, reg_prior=reg_prior,
                           **model_kw)
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

    def _flat(self, burn=0):
        """The draws flattened chain-major, the first ``burn`` recorded
        draws of each chain dropped."""
        from boom_tpu_torch.inference.driver import tree_map

        draws = self.draws
        if burn:
            draws = tree_map(lambda a: a[:, burn:], draws)
        return tree_map(lambda a: a.reshape((-1,) + tuple(a.shape[2:])),
                        draws)

    def _subsampled_states(self, burn=0, max_draws=50):
        """Thinned flat draw states honoring a per-chain burn (reference
        api.py:480)."""
        from boom_tpu_torch.statespace.bsts import thinned

        return thinned(self._flat(burn), max_draws)

    def prediction_errors(self, cutpoints=None, burn=0, seed=0,
                          max_draws=50):
        """{"in.sample": standardized one-step prediction errors [draws, T]
        of ``max_draws`` thinned draws, "<cutpoint>": [draws, T], ...}
        (reference api.py:501-515). A cutpoint's entry refits the model to
        y[:cutpoint] (2 chains, 100 + 50 sweeps, from a generator seeded
        with ``seed`` + its index, on the fit's device) and filters through
        the holdout, so its columns past the cutpoint are out-of-sample
        one-step errors (``bsts.holdout_prediction_errors``)."""
        from boom_tpu_torch.statespace.bsts import (
            holdout_prediction_errors,
            one_step_prediction_errors,
        )

        out = {"in.sample": one_step_prediction_errors(
            self._model, self._subsampled_states(burn, max_draws))}
        for i, c in enumerate(cutpoints or []):
            out[str(int(c))] = holdout_prediction_errors(
                self._model, rng.generator(seed + i, self._model.y.device),
                int(c), max_draws=max_draws)
        return out

    def state_contribution_draws(self, burn=0):
        """Each block's contribution path over all draws {name: [draws, T]},
        and the regression's as ``"regression"`` (reference api.py:518)."""
        return self._model.state_contributions(self._flat(burn))

    def coefficients(self):
        """The regression's posterior rows (reference api.py:531)."""
        if "beta" not in self.draws:
            raise ValueError("the model has no regression component")
        return _coef_table(self.draws["beta"], self.draws["gamma"])

    def summary(self):
        """The observation sd's posterior, and the coefficients' with a
        regression (reference api.py:535)."""
        out = {}
        s = torch.sqrt(self.draws["sigsq_obs"].double()).flatten()
        s = s.cpu().numpy()
        out["observation_sd"] = {"mean": float(s.mean()),
                                 "q025": float(np.quantile(s, 0.025)),
                                 "q975": float(np.quantile(s, 0.975))}
        if "beta" in self.draws:
            out["coefficients"] = self.coefficients()
        return out

    def predict(self, horizon, seed=0, future_z=None,
                future_predictors=None, max_draws=200):
        """Posterior-predictive forecasts [draws, horizon] simulated forward
        from ``max_draws`` thinned posterior draws (reference api.py:723);
        the normals from a generator seeded with ``seed`` on the fit's
        device. ``future_z`` {block name: [horizon, dim]} gives the future
        rows of the blocks with a time-varying z (the dynamic regression's
        predictors, the holiday's one-hot days), as the reference's. With
        ``future_predictors`` [horizon, p] the regression's X beta is
        added."""
        model = self._model
        sub = self._subsampled_states(0, max_draws)
        take = first_leaf(sub).shape[0]
        noise = rng.draw(rng.generator(seed, model.y.device),
                         model.predict_noise_spec(horizon), take,
                         model.y.dtype)
        ys = model.predict(noise, sub, horizon, future_z=future_z)
        if future_predictors is not None:
            x_new = torch.as_tensor(np.asarray(future_predictors),
                                    dtype=model.y.dtype,
                                    device=model.y.device)
            ys = ys + sub["beta"] @ x_new.T
        return ys

