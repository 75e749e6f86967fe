"""Carry the reference's numbers across: turn arrays and model specs of the
JAX package (as numpy arrays and Python floats) into the port's tensors and
dataclasses, so both compute on the same inputs. Nothing here imports JAX:
it reads attributes and converts with ``numpy.asarray``. Every helper puts
its tensors on the CUDA card unless the caller passes ``device="cpu"``; a
CUDA device on a machine without one raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from boom_tpu_torch.rng import resolve_device
from boom_tpu_torch.statespace import state_models as sm
from boom_tpu_torch.statespace.kalman import SsmParams


def _tensor(x, device, dtype):
    """A float tensor of ``dtype``; a boolean array stays boolean (the
    inclusion indicators gamma) and an integer one int64 (a permutation)."""
    x = np.asarray(x)
    if x.dtype == np.bool_:
        dtype = torch.bool
    elif np.issubdtype(x.dtype, np.integer):
        dtype = torch.int64
    return torch.tensor(x, dtype=dtype, device=resolve_device(device))


def ssm_params_from_numpy(fields, device="cuda", dtype=torch.float64,
                          h_scale=None):
    """Port ``SsmParams`` from a mapping (or a NamedTuple, such as the
    reference's ``SsmParams``) of arrays that carry a leading chain axis.
    A time-varying z [C, T, d] must be one [T, d] for every chain (it is
    passed expanded); q_scale [C, T, q] is carried as it is. h must be [C]:
    a reference h [C, T] of observation weights is h [C] with ``h_scale``
    [T] (1 / max(w, 1)). A time-varying T, ``t_seq`` [C, T, d, d], becomes
    its distinct matrices and each step's choice (:func:`transition_steps`).
    """
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    out = {k: _tensor(fields[k], device, dtype)
           for k in ("t_mat", "r_mat", "q_mat", "h", "a0", "p0")}
    if fields.get("t_seq") is not None:
        mats, choice = transition_steps(fields["t_seq"])
        out["t_mats"] = _tensor(mats, device, dtype)
        if (mats == mats[:1]).all():
            out["t_mats"] = out["t_mats"][:1].expand(mats.shape[0], -1, -1,
                                                     -1)
        out["t_choice"] = _tensor(choice, device, dtype)
    z = np.asarray(fields["z"])
    if z.ndim == 3:
        if not (z == z[:1]).all():
            from boom_tpu_torch.statespace.kalman import _PER_SYSTEM_Z
            raise NotImplementedError(_PER_SYSTEM_Z)
        out["z"] = _tensor(z[0], device, dtype).expand(z.shape[0], -1, -1)
    else:
        out["z"] = _tensor(z, device, dtype)
    if out["h"].dim() != 1:
        raise ValueError("h must be [C]; pass a time-varying h as h [C] and "
                         "h_scale [T]")
    if fields.get("q_scale") is not None:
        out["q_scale"] = _tensor(fields["q_scale"], device, dtype)
    if h_scale is not None:
        out["h_scale"] = _tensor(h_scale, device, dtype)
    return SsmParams(**out)


# distinct transitions a calendar gives the kernels (K1w's and K2w's
# calendar forms take two)
MAX_TRANSITIONS = 2


def transition_steps(t_seq):
    """The reference's time-varying T, ``t_seq`` [C, T, d, d] (chains' rows
    t map alpha_t to alpha_{t+1}), as its distinct matrices [C, K, d, d]
    (a step's matrices over all chains counted as one) and the one each
    step takes [T] (int64), found once on the host. Raises where there are
    more than MAX_TRANSITIONS, which the kernels take."""
    t_seq = np.asarray(t_seq)
    c, t_len, d, _ = t_seq.shape
    rows = np.ascontiguousarray(t_seq.transpose(1, 0, 2, 3)).reshape(t_len, -1)
    uniq, choice = np.unique(rows, axis=0, return_inverse=True)
    if uniq.shape[0] > MAX_TRANSITIONS:
        raise NotImplementedError(
            f"a time-varying T of {uniq.shape[0]} distinct matrices; the "
            f"kernels take {MAX_TRANSITIONS} (the monthly cycle's calendar) "
            "(ROADMAP.md, queue 1 item 7: T_t of more than two matrices)")
    mats = uniq.reshape(-1, c, d, d).transpose(1, 0, 2, 3)
    return np.ascontiguousarray(mats), choice.reshape(-1).astype(np.int64)


def state_from_numpy(tree, device="cuda", dtype=torch.float64):
    """A reference bsts state ``{"blocks": {...}, "sigsq_obs", "alpha"}``
    (with a regression also ``gamma``, ``beta``) whose leaves carry a
    leading chain axis -> the same tree of tensors; boolean leaves stay
    boolean, integer leaves become int64."""
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    return _tensor(tree, device, dtype)


def reg_suf_from_numpy(suf, device="cuda", dtype=torch.float64):
    """The port's ``RegSuf`` from the reference's (or any object with its
    fields xtx, xty, yty, n as arrays)."""
    from boom_tpu_torch.models.glm.regression import RegSuf

    return RegSuf(**{k: _tensor(getattr(suf, k), device, dtype)
                     for k in RegSuf._fields})


def spike_slab_prior_from_numpy(prior, device="cuda", dtype=torch.float64):
    """The port's ``SpikeSlabPrior`` with the reference prior's fields:
    its arrays as tensors, ``max_size`` and ``sigma_upper_limit`` as they
    are."""
    from boom_tpu_torch.models.glm.regression import SpikeSlabPrior

    arrays = ("mean", "unscaled_precision", "log_inclusion_odds",
              "log_inclusion_norm", "sigma_df", "prior_ss")
    return SpikeSlabPrior(
        **{k: _tensor(getattr(prior, k), device, dtype) for k in arrays},
        max_size=prior.max_size,
        sigma_upper_limit=(None if prior.sigma_upper_limit is None
                           else float(prior.sigma_upper_limit)))


def _prior(p):
    return sm.SdPrior(sigma_guess=float(p.sigma_guess),
                      sample_size=float(p.sample_size),
                      upper_limit=float(p.upper_limit))


def _block(b, device, dtype, t_len):
    kind = type(b).__name__
    if kind == "LocalLevel":
        return sm.LocalLevel(
            sigma_prior=_prior(b.sigma_prior),
            initial_mean=float(b.initial_mean),
            initial_sd=float(b.initial_sd), name=b.name)
    if kind == "LocalLinearTrend":
        return sm.LocalLinearTrend(
            level_prior=_prior(b.level_prior),
            slope_prior=_prior(b.slope_prior),
            initial_level_mean=float(b.initial_level_mean),
            initial_level_sd=float(b.initial_level_sd),
            initial_slope_mean=float(b.initial_slope_mean),
            initial_slope_sd=float(b.initial_slope_sd), name=b.name)
    if kind == "Seasonal":
        return sm.Seasonal(
            nseasons=int(b.nseasons), sigma_prior=_prior(b.sigma_prior),
            initial_sd=float(b.initial_sd), name=b.name)
    if kind == "DynamicRegression":
        return sm.DynamicRegression(
            predictors=_tensor(b.predictors, device, dtype),
            sigma_prior=_prior(b.sigma_prior),
            initial_sd=float(b.initial_sd), name=b.name)
    if kind == "RandomWalkHoliday":
        return sm.RandomWalkHoliday(
            active=_tensor(np.asarray(b.active).astype(np.int64), device,
                           dtype),
            window=int(b.window), sigma_prior=_prior(b.sigma_prior),
            initial_sd=float(b.initial_sd), name=b.name)
    if kind == "StudentLocalLinearTrend":
        return sm.StudentLocalLinearTrend(
            t_len=int(b.t_len), level_prior=_prior(b.level_prior),
            slope_prior=_prior(b.slope_prior),
            initial_level_mean=float(b.initial_level_mean),
            initial_level_sd=float(b.initial_level_sd),
            initial_slope_sd=float(b.initial_slope_sd),
            nu_prior_rate=float(b.nu_prior_rate), name=b.name)
    if kind == "MonthlyAnnualCycle":
        return sm.MonthlyAnnualCycle(
            first_date=b.first_date, t_len=t_len,
            sigma_prior=_prior(b.sigma_prior),
            initial_sd=float(b.initial_sd), name=b.name)
    if kind == "Trig":
        return sm.Trig(period=float(b.period),
                       frequencies=tuple(b.frequencies),
                       sigma_prior=_prior(b.sigma_prior),
                       initial_sd=float(b.initial_sd), name=b.name)
    if kind == "ArState":
        return sm.ArState(lags=int(b.lags), sigma_prior=_prior(b.sigma_prior),
                          initial_sd=float(b.initial_sd),
                          phi_prior_sd=float(b.phi_prior_sd), name=b.name)
    if kind == "StaticIntercept":
        return sm.StaticIntercept(initial_mean=float(b.initial_mean),
                                  initial_sd=float(b.initial_sd),
                                  name=b.name)
    if kind == "SemilocalLinearTrend":
        return sm.SemilocalLinearTrend(
            level_prior=_prior(b.level_prior),
            slope_prior=_prior(b.slope_prior),
            **{f: float(getattr(b, f)) for f in (
                "initial_level_mean", "initial_level_sd",
                "initial_slope_mean", "initial_slope_sd", "slope_mean_mean",
                "slope_mean_sd", "phi_prior_mean", "phi_prior_sd")},
            name=b.name)
    raise NotImplementedError(
        f"state block {kind} is not ported yet (ROADMAP.md, queue 1 item 7: "
        "the other block classes)")


def model_from_jax(bsts, device="cuda", dtype=torch.float64, **overrides):
    """The port's ``Bsts`` with the reference model's series, state blocks,
    observation prior, regression (predictors, prior, max flips), gaps and
    weights (observed, obs_weights, extra_obs_ss) and sampler options. ``overrides`` replace options (for example
    ``parallel_smoother``)."""
    from boom_tpu_torch.statespace.bsts import Bsts

    opts = dict(parallel_smoother=bsts.parallel_smoother,
                chains_hint=bsts.chains_hint, asis=bsts.asis,
                asis_passes=bsts.asis_passes,
                reg_max_flips=bsts.reg_max_flips,
                extra_obs_ss=float(bsts.extra_obs_ss))
    for name in ("observed", "obs_weights"):
        if getattr(bsts, name) is not None:
            opts[name] = _tensor(getattr(bsts, name), device, dtype)
    if bsts.predictors is not None:
        opts["predictors"] = _tensor(bsts.predictors, device, dtype)
        opts["reg_prior"] = spike_slab_prior_from_numpy(bsts.reg_prior,
                                                        device, dtype)
    opts.update({f.name: getattr(bsts, f.name)
                 for f in dataclasses.fields(Bsts)
                 if f.name.startswith("marginal_")})
    opts.update(overrides)
    return Bsts(y=_tensor(bsts.y, device, dtype),
                blocks=[_block(b, device, dtype, int(bsts.y.shape[0]))
                        for b in bsts.blocks],
                obs_prior=(None if bsts.obs_prior is None
                           else _prior(bsts.obs_prior)), **opts)


def _data(x, device, dtype):
    """A data array as a float tensor (counts included)."""
    return torch.tensor(np.asarray(x, dtype=np.float64), dtype=dtype,
                        device=resolve_device(device))


def _scalars(model, names):
    """The reference model's scalar options as Python floats."""
    return {n: float(np.asarray(getattr(model, n))) for n in names}


def beta_binomial_from_jax(model, device="cuda", dtype=torch.float64):
    """The port's ``BetaBinomialModel`` with the reference model's data
    (trials, successes) and priors."""
    from boom_tpu_torch.models.beta_binomial import BetaBinomialModel

    return BetaBinomialModel(
        trials=_data(model.trials, device, dtype),
        successes=_data(model.successes, device, dtype),
        **_scalars(model, ("prob_a", "prob_b", "size_shape", "size_rate",
                           "slice_width")))


def mixture_from_jax(model, device="cuda", dtype=torch.float64):
    """The port's ``GaussianMixtureModel`` with the reference model's y and
    priors (a weight prior the same for every component)."""
    from boom_tpu_torch.models.mixtures import GaussianMixtureModel

    prior = np.asarray(model.weight_prior, dtype=np.float64)
    if prior.ndim and not (prior == prior.flat[0]).all():
        raise NotImplementedError(
            "a weight prior that differs by component is not ported yet "
            "(ROADMAP.md, queue 1 item 8)")
    return GaussianMixtureModel(
        y=_data(model.y, device, dtype),
        num_components=int(model.num_components),
        weight_prior=float(prior.flat[0]),
        **_scalars(model, ("mean_guess", "mean_nobs", "sigma_df",
                           "sigma_guess")))


def hmm_from_jax(model, device="cuda", dtype=torch.float64, **overrides):
    """The port's ``GaussianHmm`` with the reference model's y, state
    count, priors and ``parallel_filter``; ``overrides`` replace options."""
    from boom_tpu_torch.models.hmm import GaussianHmm

    opts = dict(num_states=int(model.num_states),
                parallel_filter=bool(model.parallel_filter),
                **_scalars(model, ("trans_prior", "init_prior", "mean_guess",
                                   "mean_nobs", "sigma_df", "sigma_guess")))
    opts.update(overrides)
    return GaussianHmm(y=_data(model.y, device, dtype), **opts)
