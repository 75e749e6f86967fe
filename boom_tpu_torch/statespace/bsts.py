"""Bsts: Bayesian structural time series, Gaussian path with an optional
spike-and-slab regression (port of boom_tpu/statespace/bsts.py:
``__post_init__`` :195, ``ssm_params`` :238, ``init_state`` :299,
``_smoother`` :324, ``kernel`` :343-478, the TIM marginal move :481-714,
``_asis_pass`` :851, ``log_lik`` :899, ``state_contributions`` :906,
``predict`` :924, ``asis_redraw`` :1010 and
``one_step_prediction_errors`` :1132).

One Gibbs sweep, for all chains at once (leading chain axis ``[C, ...]``):

  1. draw the observation model given the current state path: the
     observation variance, or with ``predictors`` the regression's
     indicators, variance and coefficients on each chain's y - Z alpha
     (the regression's sigma^2 is the observation variance);
  2. draw each state block's variances from its imputed innovations;
  3. impute the state path with the Durbin-Koopman simulation smoother on
     y - X beta;
  4. ASIS: redraw the state-innovation sigmas non-centered;
  5. with ``marginal_sigma_slice``: the TIM marginal move on the log
     variances, the state path integrated out by the Kalman filter.

The sweep takes every random number it uses from a ``noise`` mapping
(:meth:`Bsts.draw_noise` fills it from a ``torch.Generator``); it never
draws itself. Parts of the reference that this slice does not port raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch.profiler import record_function

from boom_tpu_torch import dists, numopt, rng
from boom_tpu_torch.inference.kernels.slice import slice_step
from boom_tpu_torch.models.glm import regression, regression_sweep
from boom_tpu_torch.models.glm import ssvs_kernel
from boom_tpu_torch.models.glm.regression import RegSuf, SpikeSlabPrior
from boom_tpu_torch.statespace import kalman, kalman_kernel, parallel_kalman
from boom_tpu_torch.statespace import scan_kernel
from boom_tpu_torch.statespace.kalman import SsmParams
from boom_tpu_torch.statespace.state_models import SdPrior

# ASIS slice settings of the reference's asis_redraw
ASIS_SLICE_STEPS, ASIS_EXPAND, ASIS_SHRINK = 8, 5, 10
# The Durbin-Koopman draw is alpha+ + E[alpha | y - y+], where the
# unconditional path alpha+ starts from the prior N(a0, P0). With the
# default priors (initial sd = sd(y)) alpha+ grows to about sd(y) * T, 3e6
# for a trending T=4096 series, and the two terms cancel down to the data
# scale: in float32 the state then carries errors of order 1, which bias
# every variance draw (PERF.md, Findings). So the smoother computes in
# float64 whatever the run's dtype; the rest of the sweep keeps it.
SMOOTHER_DTYPE = torch.float64
# the sweep's phases, each a ``torch.profiler`` range named "bsts.<phase>"
SWEEP_PHASES = ("regression", "variance_draws", "impute", "asis", "tim")


def _block_diag(mats):
    """Block-diagonal of batched [C, r_i, s_i] matrices -> [C, R, S]."""
    c = mats[0].shape[0]
    rows = sum(m.shape[-2] for m in mats)
    cols = sum(m.shape[-1] for m in mats)
    out = mats[0].new_zeros(c, rows, cols)
    r = s = 0
    for m in mats:
        out[:, r:r + m.shape[-2], s:s + m.shape[-1]] = m
        r += m.shape[-2]
        s += m.shape[-1]
    return out


@dataclasses.dataclass(frozen=True)
class Bsts:
    """Structural time series with Gaussian observations.

    y: [T] series on the run's device, in the run's dtype.
    predictors: [T, p] design of a spike-and-slab regression component with
    ``reg_prior`` (a ``SpikeSlabPrior``), or None; ``reg_max_flips`` caps
    the indicator flips a sweep.
    parallel_smoother: the reference's option values. ``"pallas"`` runs the
    hand-written scan kernel (``scan_kernel.simulation_smoother``; its
    plain version on a CPU tensor); ``"auto"`` picks it on a CUDA device
    for d <= 6, T >= 512 and at most 32 chains, and the sequential smoother
    (``kalman_kernel.simulation_smoother``: kernel K2 on the card, its plain
    version on the CPU) everywhere else, as ``False`` always does; ``True``
    runs the plain parallel-in-time scan (``parallel_kalman``).
    chains_hint: the number of chains the run will use (``"auto"`` reads it).
    marginal_*: the reference's marginal-move options and defaults. Only
    ``marginal_move="tim"`` is ported; the mtm/grid/slice options are
    carried for a model spec's sake and read by no ported move.
    """

    y: torch.Tensor
    blocks: Sequence
    obs_prior: SdPrior | None = None
    predictors: torch.Tensor | None = None
    reg_prior: SpikeSlabPrior | None = None
    reg_max_flips: int | None = None
    observed: torch.Tensor | None = None
    obs_weights: torch.Tensor | None = None
    parallel_smoother: bool | str = "auto"
    chains_hint: int = 1
    asis: bool = True
    asis_passes: int = 1
    marginal_sigma_slice: bool = False
    marginal_move: str = "tim"
    marginal_mtm_trials: int = 16
    marginal_mtm_moves: int = 2
    marginal_grid_points: int = 10
    marginal_grid_range: tuple = (0.02, 4.0)
    marginal_grid_dirs: int = 1
    marginal_tim_trials: int = 16
    marginal_tim_df: float = 3.0
    marginal_tim_inflate: float = 1.3
    marginal_mtm_width: float = 1.0
    marginal_mtm_ladder: tuple = (0.05, 2.0)
    marginal_slice_random_dirs: int = 1
    marginal_slice_period: int = 1

    def __post_init__(self):
        if self.predictors is not None:
            if self.reg_prior is None:
                raise ValueError("predictors need a reg_prior "
                                 "(SpikeSlabPrior)")
            if tuple(self.predictors.shape[:1]) != (self.t_len,):
                raise ValueError(f"predictors must be [T={self.t_len}, p]; "
                                 f"got {tuple(self.predictors.shape)}")
            if self.marginal_sigma_slice:
                raise NotImplementedError(
                    "the marginal move with a regression component is not "
                    "ported yet (ROADMAP.md, queue 1 item 7: the rest of "
                    "statespace)")
        if self.observed is not None or self.obs_weights is not None:
            raise NotImplementedError(
                "observed/obs_weights (gaps, timestamps) are not ported yet "
                "(ROADMAP.md, queue 1: the observed/obs_weights path)")
        if self.marginal_sigma_slice and self.marginal_move != "tim":
            raise NotImplementedError(
                f"marginal_move={self.marginal_move!r} is not ported; only "
                "'tim' is (ROADMAP.md, queue 7: the other marginal moves)")
        for b in self.blocks:
            if not hasattr(b, "asis_groups") or not hasattr(b, "noise_spec"):
                raise NotImplementedError(
                    f"state block {type(b).__name__} is not ported yet "
                    "(ROADMAP.md, queue 1: the other block classes)")
        if self.obs_prior is None and self.reg_prior is None:
            sd = float(torch.std(self.y, correction=0))
            object.__setattr__(
                self, "obs_prior",
                SdPrior(sigma_guess=0.5 * sd, sample_size=0.01,
                        upper_limit=1.2 * sd))
        if self.marginal_sigma_slice:
            # once per model, as the reference: the mode search runs here,
            # never inside a sweep
            object.__setattr__(self, "_tim_prop", self._build_tim_proposal())

    # -- composite system ---------------------------------------------------
    @property
    def state_dim(self):
        return sum(b.dim for b in self.blocks)

    @property
    def t_len(self):
        return self.y.shape[0]

    def _slices(self):
        out, start = [], 0
        for b in self.blocks:
            out.append((start, b.dim))
            start += b.dim
        return out

    def ssm_params(self, state):
        """The chains' static systems from their parameters."""
        dev, dt = self.y.device, self.y.dtype
        c = state["sigsq_obs"].shape[0]
        ts, rs, qs = zip(*(b.build(state["blocks"][b.name])
                           for b in self.blocks))
        a0s, p0s = zip(*(b.init_dist(dev, dt) for b in self.blocks))
        z = torch.cat([b.z(dev, dt) for b in self.blocks])
        return SsmParams(
            z=z.expand(c, -1),
            t_mat=_block_diag(ts), r_mat=_block_diag(rs),
            q_mat=_block_diag(qs), h=state["sigsq_obs"],
            a0=torch.cat(a0s).expand(c, -1),
            p0=_block_diag([p[None] for p in p0s]).expand(c, -1, -1))

    # -- noise --------------------------------------------------------------
    def _smoother_noise_spec(self):
        q = sum(b.err_dim for b in self.blocks)
        return {"sim_alpha1": ((self.state_dim,), "normal"),
                "sim_eta": ((self.t_len - 1, q), "normal"),
                "sim_eps": ((self.t_len,), "normal")}

    @property
    def num_predictors(self):
        return 0 if self.predictors is None else self.predictors.shape[1]

    def init_noise_spec(self):
        """Per-chain random numbers of :meth:`init_state`."""
        spec = {"blocks": {b.name: b.init_noise_spec() for b in self.blocks},
                "sig_u": ((), "uniform"),
                **self._smoother_noise_spec()}
        if self.predictors is not None:
            spec["gamma_u"] = ((self.num_predictors,), "uniform")
        return spec

    def noise_spec(self):
        """Per-chain random numbers of one kernel call (see :meth:`kernel`):
        one sweep's, or with ``marginal_slice_period`` p > 1 those of p - 1
        sweeps without the marginal move (``sub0``...) and one with it
        (``last``)."""
        period = self.marginal_slice_period
        if not self.marginal_sigma_slice or period <= 1:
            return self._sweep_noise_spec(self.marginal_sigma_slice)
        return {**{f"sub{i}": self._sweep_noise_spec(False)
                   for i in range(period - 1)},
                "last": self._sweep_noise_spec(True)}

    def _sweep_noise_spec(self, marginal):
        spec = {"blocks": {b.name: b.noise_spec() for b in self.blocks},
                **self._smoother_noise_spec()}
        if self.predictors is None:
            spec["obs_u"] = ((), "uniform_pos")
        else:
            # the regression's flip order and flip uniforms, its variance's
            # uniform and its coefficients' normals (SpikeSlabRegression's
            # noise without the mode jump, which bsts does not make)
            p = self.num_predictors
            spec["reg"] = {"perm": ((p,), "permutation"),
                           "flip_u": ((p,), "uniform"),
                           "sigsq_u": ((), "uniform_pos"),
                           "beta_z": ((p,), "normal")}
        if self.asis:
            rounds = (self.asis_passes, ASIS_SLICE_STEPS,
                      len(_asis_groups(self.blocks)))
            spec.update(asis_h_u=(rounds, "uniform_pos"),
                        asis_u_u=(rounds, "uniform"),
                        asis_shrink_u=((*rounds, ASIS_SHRINK), "uniform"))
        if marginal:
            # the TIM move: candidate normals and chi-square uniforms of the
            # multivariate-T draws, the Gumbel uniforms of the selection,
            # the accept uniform
            k, g = self.marginal_tim_trials, len(self._sigma_groups())
            spec.update(tim_z=((k, g), "normal"),
                        tim_chi_u=((k,), "uniform_pos"),
                        tim_gumbel_u=((k,), "uniform_pos"),
                        tim_accept_u=((), "uniform_pos"))
        return spec

    def draw_noise(self, generator, num_chains: int):
        """One sweep's noise for ``num_chains`` chains."""
        return rng.draw(generator, self.noise_spec(), num_chains,
                        self.y.dtype)

    def draw_init_noise(self, generator, num_chains: int):
        return rng.draw(generator, self.init_noise_spec(), num_chains,
                        self.y.dtype)

    # -- state --------------------------------------------------------------
    def init_state(self, noise):
        """Initial states of all chains: overdispersed variances and a
        state path imputed by the smoother (an all-zero path would trap the
        first variance draws at zero)."""
        state = {
            "blocks": {b.name: b.init_params(noise["blocks"][b.name])
                       for b in self.blocks},
            "sigsq_obs": torch.var(self.y, correction=0)
            * (noise["sig_u"] * (0.8 - 0.1) + 0.1),
        }
        if self.predictors is not None:
            # each coordinate in with probability max(pi, 2/p), beta = 0
            # (reference :309-315); with max_size a mask past the cap keeps
            # its first max_size coordinates, as SpikeSlabRegression's
            p = self.num_predictors
            pi = torch.sigmoid(self.reg_prior.log_inclusion_odds)
            gamma = noise["gamma_u"] < torch.clamp_min(pi, 2.0 / p)
            if self.reg_prior.max_size is not None:
                gamma = gamma & (gamma.cumsum(-1) <= self.reg_prior.max_size)
            state["gamma"] = gamma
            state["beta"] = self.y.new_zeros(gamma.shape[0], p)
        state["alpha"] = self._impute(self.ssm_params(state), noise)
        return state

    def _impute(self, params, noise, y_adj=None):
        """A state path draw from the smoother on ``y_adj`` (default y [T];
        [C, T] with a regression), computed in ``SMOOTHER_DTYPE`` and
        returned in the run's dtype."""
        y_adj = self.y if y_adj is None else y_adj
        wide = SMOOTHER_DTYPE
        draw = self._smoother()(
            SsmParams(*(p.to(wide) for p in params)), y_adj.to(wide),
            *(noise[k].to(wide) for k in ("sim_alpha1", "sim_eta",
                                          "sim_eps")))
        return draw.to(self.y.dtype)

    def _smoother(self):
        """Simulation-smoother dispatch (the reference's
        ``parallel_smoother`` values)."""
        mode = self.parallel_smoother
        if mode is True:
            return parallel_kalman.parallel_simulation_smoother
        if mode == "pallas":
            return scan_kernel.simulation_smoother
        if mode == "auto":
            if (self.y.device.type == "cuda" and self.state_dim <= 6
                    and self.t_len >= 512 and self.chains_hint <= 32):
                return scan_kernel.simulation_smoother
            return kalman_kernel.simulation_smoother
        if mode is False:
            return kalman_kernel.simulation_smoother
        raise ValueError(f"unknown parallel_smoother {mode!r}")

    # -- Gibbs sweep --------------------------------------------------------
    def kernel(self):
        """``sweep(noise, state) -> state`` for all chains; ``noise`` as
        :meth:`draw_noise` makes it. With the marginal move and
        ``marginal_slice_period`` p > 1, one call runs p - 1 sweeps without
        the move and one with it (one recorded draw). With a regression,
        ``finish()`` (which ``run_mcmc`` calls) raises if any Cholesky
        factor of the regression's posterior failed in the run."""
        draw_regression = (self._regression_draw()
                           if self.predictors is not None else None)

        def sweep(noise, state, do_marginal=True):
            # each phase is a named profiler range (SWEEP_PHASES); the
            # observation model and the blocks condition on the CURRENT
            # state path, which is re-imputed last (reference :364-370)
            out = dict(state)
            params_cur = self.ssm_params(state)
            state_contrib = (state["alpha"] * params_cur.z[:, None]).sum(-1)
            y_adj = self.y
            if draw_regression is not None:
                # 1. regression | current state: (gamma, sigma^2, beta)
                with record_function("bsts.regression"):
                    out.update(draw_regression(noise["reg"], state,
                                               self.y - state_contrib))
                    y_adj = self.adjusted_series(out)
            with record_function("bsts.variance_draws"):
                if draw_regression is None:
                    # 1. observation variance | current state
                    resid = self.y - state_contrib
                    out["sigsq_obs"] = self.obs_prior.draw_variance(
                        noise["obs_u"], self.t_len, (resid * resid).sum(-1))

                # 2. state-model parameters | current state path
                out["blocks"] = {
                    b.name: b.draw_params(
                        noise["blocks"][b.name], state["blocks"][b.name],
                        state["alpha"][..., start:start + dim])
                    for (start, dim), b in zip(self._slices(), self.blocks)}

            # 3. impute the state (Durbin-Koopman simulation smoother)
            with record_function("bsts.impute"):
                out["alpha"] = self._impute(self.ssm_params(out), noise,
                                            y_adj)

            # 4. ASIS interweaving: non-centered re-draw of state sigmas
            if self.asis:
                with record_function("bsts.asis"):
                    for i in range(self.asis_passes):
                        out = self._asis_pass(
                            {k: noise[f"asis_{k}"][:, i]
                             for k in ("h_u", "u_u", "shrink_u")}, out,
                            y_adj)

            # 5. marginal move on the log variances (state integrated out)
            if self.marginal_sigma_slice and do_marginal:
                with record_function("bsts.tim"):
                    out = self._marginal_sigma_tim(noise, out, y_adj)
            return out

        period = self.marginal_slice_period
        if not self.marginal_sigma_slice or period <= 1:
            run = sweep
        else:
            def run(noise, state):
                for i in range(period - 1):
                    state = sweep(noise[f"sub{i}"], state, do_marginal=False)
                return sweep(noise["last"], state)

        if draw_regression is not None:
            run.finish = draw_regression.finish
        return run

    def _regression_draw(self):
        """``draw(noise, state, y_reg) -> {gamma, beta, sigsq_obs}``: the
        spike-and-slab draw on each chain's residual y_reg = y - Z alpha
        [C, T] (reference :354-403; ``regression.gibbs_draw``). The
        statistics X'y and y'y are per chain, X'X is shared; the indicators
        take kernel (a)'s per-chain entry on the card when the SWEEP path
        is exact for the prior (``valid_for_prior``), else the Cholesky
        sweep. ``draw.finish`` raises if a Cholesky factor failed."""
        x, prior = self.predictors, self.reg_prior
        xtx = x.T @ x
        n = torch.tensor(self.t_len, dtype=x.dtype, device=x.device)
        swept = regression_sweep.valid_for_prior(prior)
        operands = None
        if swept and x.device.type == "cuda":
            # kernel (a)'s per-model operands, made once: the border of S0
            # comes per chain and sweep (ssvs_kernel.launch_sweep)
            operands = ssvs_kernel.sweep_operands(
                RegSuf(xtx=xtx, xty=x.new_zeros(x.shape[1]),
                       yty=x.new_zeros(()), n=n), prior)
        fails, finish = regression.failure_count(
            x.device, "the regression's posterior")

        def draw(noise, state, y_reg):
            suf = RegSuf(xtx=xtx, xty=y_reg @ x, yty=(y_reg * y_reg).sum(-1),
                         n=n)
            gamma, sigsq, beta, bad = regression.gibbs_draw(
                noise, suf, prior, state["gamma"], swept=swept,
                max_flips=self.reg_max_flips, operands=operands)
            fails.add_((bad != 0).sum(dtype=torch.int32))
            return {"gamma": gamma, "beta": beta, "sigsq_obs": sigsq}

        draw.finish = finish
        return draw

    def _asis_pass(self, noise, state, y_adj):
        return asis_redraw(noise, self.blocks, self.ssm_params(state),
                           state, y_adj, state["sigsq_obs"])

    # -- likelihood, contributions, forecasts -------------------------------
    def adjusted_series(self, state):
        """The series the state explains: y [T], or y - X beta [C, T]."""
        if self.predictors is None:
            return self.y
        return self.y - state["beta"] @ self.predictors.T

    def log_lik(self, state):
        """[C] marginal log likelihoods of the chains' parameters, the state
        integrated out (reference :899). One shared series goes through K1
        (``kalman_kernel.kalman_loglik``); with a regression each chain has
        its own series y - X beta, which K1 does not take (ROADMAP.md,
        queue 1 item 7): the plain filter runs it on CPU tensors and a card
        tensor raises."""
        y_adj = self.adjusted_series(state)
        if y_adj.dim() == 1:
            return kalman_kernel.kalman_loglik(self.ssm_params(state), y_adj)
        if y_adj.device.type != "cpu":
            raise NotImplementedError(
                "log_lik with a regression needs K1 with a series a chain, "
                "which is not ported yet (ROADMAP.md, queue 1 item 7: the "
                "rest of statespace)")
        return kalman.kalman_loglik(self.ssm_params(state), y_adj)

    def state_contributions(self, state):
        """Each block's contribution path {name: [C, T]}, and the
        regression's X beta as ``"regression"`` (reference :906-921)."""
        out = {}
        for (start, dim), b in zip(self._slices(), self.blocks):
            z_b = b.z(self.y.device, self.y.dtype)
            out[b.name] = (state["alpha"][..., start:start + dim]
                           * z_b).sum(-1)
        if self.predictors is not None:
            out["regression"] = state["beta"] @ self.predictors.T
        return out

    def predict_noise_spec(self, horizon: int):
        """Per-draw normals of :meth:`predict`: the state innovations and
        the observation noise of each forecast step."""
        q = sum(b.err_dim for b in self.blocks)
        return {"eta": ((horizon, q), "normal"), "eps": ((horizon,), "normal")}

    def predict(self, noise, final_state, horizon: int, future_z=None,
                future_q_scale=None):
        """y_{T+1:T+h} [N, h] simulated from N posterior draws' parameters
        and last imputed state (reference :924-1007, static blocks):
        alpha_{t+1} = T alpha_t + R chol(Q) eta_t, y_{t+1} = z' alpha_{t+1}
        + sqrt(sigma^2) eps_t. Reads only the last row of each draw's alpha
        [N, *, d]. noise: :meth:`predict_noise_spec`'s ``eta`` [N, h, q] and
        ``eps`` [N, h]. The regression's future X beta is the caller's
        (``BstsModel.predict``), as in the reference."""
        if future_z or future_q_scale:
            raise NotImplementedError(
                "future_z / future_q_scale of time-varying blocks are not "
                "ported yet (ROADMAP.md, queue 1 item 7: the time-varying "
                "systems)")
        params = self.ssm_params(final_state)
        q_chol = kalman._chol_jitter(params.q_mat)
        alpha = final_state["alpha"][:, -1]
        sd = torch.sqrt(final_state["sigsq_obs"])
        ys = []
        for t in range(horizon):
            eta = kalman._mv(q_chol, noise["eta"][:, t])
            alpha = (kalman._mv(params.t_mat, alpha)
                     + kalman._mv(params.r_mat, eta))
            ys.append((params.z * alpha).sum(-1) + sd * noise["eps"][:, t])
        return torch.stack(ys, dim=1)

    # -- TIM marginal move ----------------------------------------------------
    def _sigma_groups(self):
        """[(path, prior)] over every variance the marginal move updates:
        path = (block name, param name) or ("sigsq_obs",)."""
        groups = [((b.name, pname), prior) for b in self.blocks
                  for pname, prior, _dims in b.asis_groups()]
        groups.append((("sigsq_obs",), self.obs_prior))
        return groups

    def _marginal_helpers(self, state, y_adj, groups):
        """(get, set_param, lp_batch): lp_batch(u [C, M, G]) -> [C, M] is
        the marginal log posterior of the log-variance vectors u, M points a
        chain: Kalman loglik (the state integrated out) + SdPrior density +
        the log transform's Jacobian. The C x M points are one batch of
        series in ONE loglik call (kernel K1 on the card)."""

        def get(st, path):
            return (st["sigsq_obs"] if path[0] == "sigsq_obs"
                    else st["blocks"][path[0]][path[1]])

        def set_param(st, path, value):
            out = dict(st)
            if path[0] == "sigsq_obs":
                out["sigsq_obs"] = value
                return out
            bname, pname = path
            out["blocks"] = dict(st["blocks"])
            out["blocks"][bname] = dict(st["blocks"][bname])
            out["blocks"][bname][pname] = value
            return out

        def lp_batch(u):
            c, m, _g = u.shape
            flat = u.reshape(c * m, -1)
            st = {"blocks": {name: {k: v.repeat_interleave(m, dim=0)
                                    for k, v in params.items()}
                             for name, params in state["blocks"].items()},
                  "sigsq_obs": state["sigsq_obs"].repeat_interleave(m)}
            for gi, (path, _prior) in enumerate(groups):
                st = set_param(st, path, torch.exp(flat[:, gi]))
            lp = kalman_kernel.kalman_loglik(self.ssm_params(st), y_adj)
            for gi, (_path, prior) in enumerate(groups):
                lp = (lp + _sic_logp(torch.exp(flat[:, gi]), prior)
                      + flat[:, gi])
            return lp.reshape(c, m)

        return get, set_param, lp_batch

    def _build_tim_proposal(self):
        """(mode [G], chol [G, G]) of the multivariate-T proposal tailored
        to p(log variances | y): BFGS then Newton to the mode, the Laplace
        Hessian eigen-clamped and inflated (reference
        ``_build_tim_proposal``, bsts.py:616-672). Built in float64 on the
        series' device whatever the run's dtype: the proposal only shapes
        the move's efficiency, the acceptance is exact (ROADMAP.md, sec. 3).
        On the card its gradients and Hessians come through K1's
        ``autograd.Function``."""
        groups = self._sigma_groups()
        wide = dataclasses.replace(self, y=self.y.to(torch.float64),
                                   marginal_sigma_slice=False)
        dev, dt = wide.y.device, wide.y.dtype
        template = {
            "blocks": {b.name: b.init_params(
                {k: torch.full((1,), 0.5, dtype=dt, device=dev)
                 for k in b.init_noise_spec()}) for b in self.blocks},
            "sigsq_obs": torch.var(wide.y, correction=0)[None] * 0.5}
        _get, _set, lp_batch = wide._marginal_helpers(template, wide.y,
                                                      groups)

        def neg(u):
            lp = lp_batch(u[None, None])[0, 0]
            # the prior's hard upper limit smoothed out of the search, as
            # the reference does
            return -torch.where(torch.isfinite(lp), lp, -1e30)

        u0 = torch.log(torch.tensor([prior.sigma_guess ** 2
                                     for _path, prior in groups],
                                    dtype=dt, device=dev))
        res = numopt.bfgs(neg, u0, max_iters=120)
        res = numopt.newton_raphson(neg, res.x, max_iters=10)
        mode = res.x
        h = torch.autograd.functional.hessian(neg, mode)
        h = 0.5 * (h + h.T)
        w, v = torch.linalg.eigh(h)
        w = torch.clamp_min(w, 1e-3 * max(float(w.max()), 1.0))
        cov = (v / w[None, :]) @ v.T
        cov = (0.5 * (cov + cov.T)) * self.marginal_tim_inflate ** 2
        return mode.detach(), torch.linalg.cholesky(cov).detach()

    def _marginal_sigma_tim(self, noise, state, y_adj):
        """Multiple-try independence MH from the tailored-T proposal
        (reference ``_marginal_sigma_tim``, bsts.py:674-714): k proposal
        draws + the current point scored in one batched loglik; J drawn with
        probability proportional to the importance weight w = pi / q; accept
        with min(1, sum_i w(y_i) / [sum_{i != J} w(y_i) + w(x)]).

        noise: ``tim_z`` [C, k, G], ``tim_chi_u``, ``tim_gumbel_u`` [C, k],
        ``tim_accept_u`` [C]."""
        groups = self._sigma_groups()
        mode, chol = (t.to(y_adj.dtype) for t in self._tim_prop)
        df = self.marginal_tim_df
        get, set_param, lp_batch = self._marginal_helpers(state, y_adj,
                                                          groups)
        u_cur = torch.stack([torch.log(get(state, path))
                             for path, _ in groups], dim=-1)  # [C, G]
        k_tr = self.marginal_tim_trials
        cands = dists.mvt.sample(noise["tim_z"], noise["tim_chi_u"], mode,
                                 None, df, chol=chol)  # [C, k, G]
        pts = torch.cat([cands, u_cur[:, None]], dim=1)  # [C, k+1, G]
        lps = lp_batch(pts)
        lqs = dists.mvt.logpdf(pts, mode, None, df, chol=chol)
        w = lps - lqs  # log importance weights
        j = dists.categorical.sample(w[:, :k_tr], noise["tim_gumbel_u"])
        sum_y = torch.logsumexp(w[:, :k_tr], dim=-1)
        w_x = w[:, :k_tr].scatter(1, j[:, None], w[:, k_tr:])
        sum_x = torch.logsumexp(w_x, dim=-1)
        accept = torch.log(noise["tim_accept_u"]) < sum_y - sum_x
        picked = pts[torch.arange(pts.shape[0], device=pts.device), j]
        u_new = torch.where(accept[:, None], picked, u_cur)
        out = dict(state)
        for gi, (path, _prior) in enumerate(groups):
            out = set_param(out, path, torch.exp(u_new[:, gi]))
        return out


def _sic_logp(sigsq, prior):
    """SdPrior's log density in sigma^2 (scaled inverse chi-square), -inf
    above the upper limit."""
    df = prior.sample_size
    ss = prior.sample_size * prior.sigma_guess ** 2
    lp = -(0.5 * df + 1.0) * torch.log(sigsq) - 0.5 * ss / sigsq
    if prior.upper_limit < float("inf"):
        lp = torch.where(sigsq <= prior.upper_limit ** 2, lp, -torch.inf)
    return lp


def _asis_groups(blocks):
    """[(block name, param name, prior, error dims)] over all blocks."""
    groups, offset = [], 0
    for b in blocks:
        for pname, prior, dims in b.asis_groups():
            groups.append((b.name, pname, prior,
                           tuple(offset + d for d in dims)))
        offset += b.err_dim
    return groups


def asis_redraw(noise, blocks, params: SsmParams, state, y_adj, h,
                slice_steps: int = ASIS_SLICE_STEPS):
    """Non-centered (ancillary) re-draw of each state-innovation sigma, for
    all chains.

    Holding the standardized innovations fixed, the path is affine in the
    sigmas: alpha = alpha_base + sum_g sigma_g D_g, where the D-path of
    group g solves D_t = T D_{t-1} + R w_t with D_0 = 0. The D-paths of all
    chains and groups run in one launch of the reference's sequential
    recurrence, at every d (kernel K3, ``kalman_kernel.dpath``, on a CUDA
    tensor; its plain loop ``kalman.dpath``, the reference's order, on the
    CPU). Then ``slice_steps`` rounds of scalar slice-Gibbs on the sigmas
    use only the G x G Gram matrix.

    noise: ``h_u``, ``u_u`` [C, slice_steps, G] and ``shrink_u``
    [C, slice_steps, G, shrink_iters] uniforms. y_adj: [T], or [C, T] (a
    series a chain, y - X beta). h: [C] observation variances.
    """
    alpha = state["alpha"]  # [C, T, d]
    t_mat, r_mat, z = params.t_mat, params.r_mat, params.z
    # innovations [C, T-1, q]: R is column-orthonormal (selector/identity)
    diff = alpha[:, 1:] - (t_mat[:, None] * alpha[:, :-1, None, :]).sum(-1)
    eta = (r_mat[:, None] * diff[..., :, None]).sum(-2)

    new_blocks = {name: dict(v) for name, v in state["blocks"].items()}
    groups = _asis_groups(blocks)
    n_groups = len(groups)
    if n_groups == 0:
        return dict(state)

    # --- D-paths of all chains x groups: one launch ----------------------
    sigs = torch.stack([torch.sqrt(torch.clamp_min(new_blocks[bn][pn], 1e-30))
                        for (bn, pn, _prior, _dims) in groups], dim=-1)
    cols = alpha.new_zeros(n_groups, eta.shape[-1])
    for gi, (_b, _p, _prior, dims) in enumerate(groups):
        cols[gi, list(dims)] = 1.0
    # tilde[c, t, g, :] = group-g masked standardized innovations
    tilde = eta[:, :, None, :] * cols / sigs[:, None, :, None]
    w_all = torch.einsum("cdq,ctgq->cgtd", r_mat, tilde)  # [C, G, T-1, d]
    dstack = kalman_kernel.dpath(t_mat, w_all)  # [C, G, T, d]
    g_mat = (dstack * z[:, None, None, :]).sum(-1)  # [C, G, T]
    alpha_base = alpha - torch.einsum("cg,cgtd->ctd", sigs, dstack)
    r0 = y_adj - (alpha_base * z[:, None, :]).sum(-1)  # [C, T]
    g_over_h = g_mat / h[:, None, None]
    gram = torch.einsum("cgt,cet->cge", g_over_h, g_mat)  # [C, G, G]
    c_vec = torch.einsum("cgt,ct->cg", g_over_h, r0)  # [C, G]

    # --- alternating scalar slice-Gibbs over the sigmas ------------------
    for it in range(slice_steps):
        for gi, (_bn, _pn, prior, _dims) in enumerate(groups):
            a_coef = gram[:, gi, gi]
            others = c_vec[:, gi] - ((gram[:, gi] * sigs).sum(-1)
                                     - a_coef * sigs[:, gi])
            df = prior.sample_size
            pss = prior.sample_size * prior.sigma_guess ** 2
            upper = (prior.upper_limit if prior.upper_limit < float("inf")
                     else 1e6)

            def logp(sig, df=df, pss=pss, a_coef=a_coef, others=others):
                sigsq = sig * sig
                # SdPrior density on sigma: SIC(sig^2) * 2 sig
                lp = (-(0.5 * df + 1.0) * torch.log(sigsq)
                      - 0.5 * pss / sigsq + torch.log(2.0 * sig))
                return lp + others * sig - 0.5 * a_coef * sigsq

            width = torch.clamp_min(sigs[:, gi], 0.05 * prior.sigma_guess)
            sig_new = slice_step(
                sigs[:, gi], logp, width, noise["h_u"][:, it, gi],
                noise["u_u"][:, it, gi], noise["shrink_u"][:, it, gi],
                expand_iters=ASIS_EXPAND, lower=1e-12, upper=upper)
            sigs = torch.cat([sigs[:, :gi], sig_new[:, None],
                              sigs[:, gi + 1:]], dim=-1)

    # --- rebuild state -----------------------------------------------------
    alpha = alpha_base + sum(sigs[:, gi, None, None] * dstack[:, gi]
                             for gi in range(n_groups))
    for gi, (bname, pname, _prior, _dims) in enumerate(groups):
        new_blocks[bname][pname] = sigs[:, gi] * sigs[:, gi]

    out = dict(state)
    out["alpha"] = alpha
    out["blocks"] = new_blocks
    return out


def one_step_prediction_errors(model: Bsts, states, standardize=True):
    """One-step-ahead prediction errors v_t / sqrt(F_t) [N, T] of N
    posterior draws (reference bsts.py:1132-1159; ``standardize=False``:
    the raw v_t): the Kalman filter of each draw's system over its series,
    y or y - X beta. The reference runs this as an XLA scan off the sweep;
    here it is the plain filter (``kalman.kalman_filter``), one Python step
    a time step, on the draws' device."""
    filt = kalman.kalman_filter(model.ssm_params(states),
                                model.adjusted_series(states))
    return filt.v / torch.sqrt(filt.f) if standardize else filt.v
