"""Bsts: Bayesian structural time series, Gaussian path with an optional
spike-and-slab regression (port of boom_tpu/statespace/bsts.py:
``__post_init__`` :195, ``ssm_params`` :238, ``init_state`` :299,
``_smoother`` :324, ``kernel`` :343-478, the TIM marginal move :481-714,
``_asis_pass`` :851, ``log_lik`` :899, ``state_contributions`` :906,
``predict`` :924, ``asis_redraw`` :1010, ``one_step_prediction_errors``
:1132, ``_training_slice`` :1162, ``holdout_prediction_errors`` :1172 and
``compare_bsts_models`` :1220).

A block whose T moves with its parameters (the AR state's and the
semilocal trend's phi) gives each chain its own T. Time-varying blocks (the
dynamic regression, the random-walk holiday, the Student trend, the
monthly cycle) give the system z_t and Q_t (``SsmParams.q_scale``), the
monthly cycle also T_t (``SsmParams.t_mats``, ``t_choice``), and a
series on a regular grid with gaps and multiplexed time points
(``utils.timestamps``) gives the ``observed`` mask, the observation
weights (h_t = sigma^2 / max(w_t, 1), ``SsmParams.h_scale``) and the
within-time-point sum of squares ``extra_obs_ss``, as the reference's.

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
import functools
from typing import Sequence

import numpy as np

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
    """Block-diagonal of batched [C, r_i, s_i] matrices (or [1, r_i, s_i],
    the same for every chain) -> [C, R, S]."""
    c = max(m.shape[0] for m in mats)
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

    y: [T] series on the run's device, in the run's dtype (0 at a gap of a
    regularized grid).
    observed: [T] bool, False at a grid point without data; obs_weights:
    [T] number of raw observations averaged into y_t (0 at a gap);
    extra_obs_ss: their within-time-point sum of squares, a float or [T] a
    time point (which ``_training_slice`` slices); all as the reference's
    (``utils.timestamps.collapse_to_grid``).
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
    extra_obs_ss: float | torch.Tensor = 0.0
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
        for name, dtype in (("observed", torch.bool),
                            ("obs_weights", self.y.dtype)):
            val = getattr(self, name)
            if val is not None:
                val = torch.as_tensor(val, dtype=dtype, device=self.y.device)
                if tuple(val.shape) != (self.t_len,):
                    raise ValueError(f"{name} must be [T={self.t_len}]; got "
                                     f"{tuple(val.shape)}")
                object.__setattr__(self, name, val)
        if self.marginal_sigma_slice and self.marginal_move != "tim":
            raise NotImplementedError(
                f"marginal_move={self.marginal_move!r} is not ported; only "
                "'tim' is (ROADMAP.md, queue 1 item 7: the other marginal "
                "moves)")
        for b in self.blocks:
            if (not hasattr(b, "asis_groups") or not hasattr(b, "noise_spec")
                    or hasattr(b, "z_seq_params")):
                raise NotImplementedError(
                    f"state block {type(b).__name__} is not ported yet "
                    "(ROADMAP.md, queue 1 item 7: the other block classes)")
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

    @property
    def _time_varying_z(self):
        return any(hasattr(b, "z_seq") for b in self.blocks)

    @property
    def _time_varying_q(self):
        return any(hasattr(b, "q_scale_seq") for b in self.blocks)

    @property
    def _time_varying_t(self):
        return any(hasattr(b, "t_seq") for b in self.blocks)

    @property
    def _chain_t(self):
        """Whether a block's T moves with its parameters (a T a chain)."""
        return any(hasattr(b, "chain_transition") for b in self.blocks)

    @property
    def time_varying(self):
        """Whether the chains' systems vary in time (reference
        ``SsmParams.time_varying`` of ``ssm_params``)."""
        return (self._time_varying_z or self._time_varying_q
                or self._time_varying_t or self.obs_weights is not None)

    def ssm_params(self, state):
        """The chains' systems from their parameters (reference :238-296):
        z [C, d], or [C, T, d] (one [T, d] expanded) with a time-varying
        block; q_scale [C, T, q] with one (expanded where no block's
        differs by chain); h_scale = 1 / max(w, 1) [T] with observation
        weights. R is the model's (:attr:`_transition`), one matrix expanded
        over the chains; so is T, which K1w reads as one matrix
        (``kalman_kernel.launch_loglik``) and K2w by its pattern, unless a
        block's T moves with its parameters: then T [C, d, d] is a chain's.
        A calendar block adds T_t (reference :270-282): the distinct
        block-diagonals of its steps, t_mats [C, K, d, d] (expanded where
        no block's T is a chain's), and t_choice [T] (:attr:`_calendar`).
        t_mat stays the static T (the calendar block's rotation), which
        ASIS reads, as the reference's."""
        dev, dt = self.y.device, self.y.dtype
        c = state["sigsq_obs"].shape[0]
        t_len = self.t_len
        t_mat, r_mat = self._transition
        t_blocks = None
        if self._chain_t:
            t_blocks = self._block_transitions(state["blocks"])
            t_mat = _block_diag(t_blocks)
        qs = [b.variance(state["blocks"][b.name]) if b.err_dim
              else self.y.new_zeros(c, 0, 0) for b in self.blocks]
        a0s, p0s = zip(*(b.init_dist(dev, dt) for b in self.blocks))
        if self._time_varying_z:
            z = torch.cat([b.z_seq(dev, dt) if hasattr(b, "z_seq")
                           else b.z(dev, dt).expand(t_len, b.dim)
                           for b in self.blocks], dim=-1).expand(c, -1, -1)
        else:
            z = torch.cat([b.z(dev, dt) for b in self.blocks]).expand(c, -1)
        q_scale = None
        if self._time_varying_q:
            scales = [b.q_scale_seq(state["blocks"][b.name])
                      if hasattr(b, "q_scale_seq")
                      else torch.ones(t_len, b.err_dim, device=dev, dtype=dt)
                      for b in self.blocks]
            if all(sc.dim() == 2 for sc in scales):
                q_scale = torch.cat(scales, dim=-1).expand(c, -1, -1)
            else:
                q_scale = torch.cat([sc.expand(c, -1, -1) for sc in scales],
                                    dim=-1)
        h_scale = (None if self.obs_weights is None
                   else 1.0 / torch.clamp_min(self.obs_weights, 1.0))
        t_mats = t_choice = None
        if self._time_varying_t:
            mats, combos, t_choice = self._calendar
            t_mats = (self._calendar_mats(t_blocks, mats, combos)
                      if t_blocks is not None else self._calendar_t)
            t_mats = t_mats.expand(c, -1, -1, -1)
        return SsmParams(
            z=z,
            t_mat=t_mat.expand(c, -1, -1), r_mat=r_mat.expand(c, -1, -1),
            q_mat=_block_diag(qs),
            h=state["sigsq_obs"],
            a0=torch.cat(a0s).expand(c, -1),
            p0=_block_diag([p[None] for p in p0s]).expand(c, -1, -1),
            q_scale=q_scale, h_scale=h_scale, t_mats=t_mats,
            t_choice=t_choice)

    def _block_transitions(self, block_params):
        """Each block's T: a chain's [C, dim, dim] where it moves with the
        block's parameters, else its constant one, [1, dim, dim]."""
        dev, dt = self.y.device, self.y.dtype
        return [b.chain_transition(block_params[b.name])
                if hasattr(b, "chain_transition")
                else b.transition(dev, dt)[0][None] for b in self.blocks]

    @functools.cached_property
    def _calendar(self):
        """The calendar blocks' T_t, found once a model: ({block index: its
        distinct matrices [K_b, dim, dim]}, the distinct combinations of
        their choices [K, blocks] (numpy), each step's combination [T],
        int64 on the run's device)."""
        dev, dt = self.y.device, self.y.dtype
        mats, combos, steps = self._calendar_steps(
            lambda b: b.t_seq(dev, dt))
        return mats, combos, torch.as_tensor(steps, device=dev)

    def _calendar_steps(self, rows):
        """({block index: its distinct matrices}, the distinct combinations
        of the calendar blocks' choices [K, blocks], each step's combination
        [n] (numpy)) of ``rows(block)`` -> (its matrices, its choice [n])."""
        mats, cols = {}, []
        for i, b in enumerate(self.blocks):
            if hasattr(b, "t_seq"):
                mats[i], choice = rows(b)
                cols.append(choice.cpu().numpy())
        combos, inverse = np.unique(np.stack(cols, -1), axis=0,
                                    return_inverse=True)
        return mats, combos, inverse.reshape(-1)

    def _calendar_mats(self, t_blocks, mats, combos):
        """[C or 1, K, d, d]: for each combination k of ``combos`` the
        block-diagonal of ``t_blocks``, the calendar blocks' their matrix
        of k."""
        out = []
        for combo in combos:
            parts = list(t_blocks)
            for j, i in enumerate(mats):
                parts[i] = mats[i][combo[j]][None]
            out.append(_block_diag(parts))
        return torch.stack(out, dim=1)

    @functools.cached_property
    def _calendar_t(self):
        """t_mats [1, K, d, d] of a model whose T moves with no chain's
        parameters, built once."""
        mats, combos, _choice = self._calendar
        return self._calendar_mats(self._block_transitions({}), mats,
                                   combos)

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
        returned in the run's dtype. A time-varying system whose T and R
        are the model's (``ssm_params``') takes them in ``SMOOTHER_DTYPE``
        as its pattern's (:attr:`_transition_pattern`): K2w then runs over
        T's non-zeros and no launch reads the host."""
        y_adj = self.y if y_adj is None else y_adj
        wide = SMOOTHER_DTYPE
        # a mask sends the draw to the sequential smoother, which takes it
        kw = {} if self.observed is None else {"observed": self.observed}
        if self.time_varying and self._owns_transition(params):
            pattern = self._transition_pattern
            c = params.h.shape[0]
            params = params._replace(t_mat=pattern.t_mat.expand(c, -1, -1),
                                     r_mat=pattern.r_mat.expand(c, -1, -1))
            kw["pattern"] = pattern
        draw = self._smoother()(
            params.cast(wide), y_adj.to(wide),
            *(noise[k].to(wide) for k in ("sim_alpha1", "sim_eta",
                                          "sim_eps")), **kw)
        return draw.to(self.y.dtype)

    @functools.cached_property
    def _transition(self):
        """The model's T [d, d] and R [d, q] on the run's device and in its
        dtype: the block-diagonal of its blocks' ``transition``, constants
        of their specs, built once a model; T is None where a block's T
        moves with its parameters (``chain_transition``), R is the
        block-diagonal of their ``selection`` too."""
        dev, dt = self.y.device, self.y.dtype
        rs = [b.selection(dev, dt) if hasattr(b, "chain_transition")
              else b.transition(dev, dt)[1] for b in self.blocks]
        r_mat = _block_diag([r[None] for r in rs])[0]
        if self._chain_t:
            return None, r_mat
        ts = [b.transition(dev, dt)[0] for b in self.blocks]
        return _block_diag([t[None] for t in ts])[0], r_mat

    def _owns_transition(self, params):
        """The system's T and R are the model's (:attr:`_transition`),
        expanded over its chains as ``ssm_params`` gives them (no T a
        chain)."""
        return not self._chain_t and all(
            kalman_kernel.expands(x, own) for x, own in zip(
                (params.t_mat, params.r_mat), self._transition))

    @functools.cached_property
    def _transition_pattern(self):
        """T's non-zeros and R's selection (``kalman_kernel
        .TransitionPattern``) of the model's T and R in ``SMOOTHER_DTYPE``,
        found once a model."""
        t_mat, r_mat = self._transition
        return kalman_kernel.TransitionPattern(t_mat.to(SMOOTHER_DTYPE),
                                               r_mat.to(SMOOTHER_DTYPE))

    @functools.cached_property
    def _run_pattern(self):
        """:attr:`_transition_pattern` bound to T and R in the run's dtype
        (the loglik kernels'), with no further read."""
        return self._transition_pattern.bound(*self._transition)

    def _loglik_pattern(self, params):
        """The pattern the loglik kernels take for ``params`` (it vouches
        that R is a selection: ``kalman_kernel.time_varying_operands``): the
        model's (:attr:`_run_pattern`) where the system is time-varying and
        its T and R are the model's expanded, as ``ssm_params`` gives them;
        else None."""
        if params.time_varying and self._owns_transition(params):
            return self._run_pattern
        return None

    def _smoother(self):
        """Simulation-smoother dispatch (the reference's
        ``parallel_smoother`` values, :324-341): a gapped series or a
        time-varying system takes the sequential smoother whatever the
        mode, as the reference's does."""
        if self.observed is not None or self.time_varying:
            return kalman_kernel.simulation_smoother
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
        w_obs, n_obs = self._obs_weights()

        def sweep(noise, state, do_marginal=True):
            # each phase is a named profiler range (SWEEP_PHASES); the
            # observation model and the blocks condition on the CURRENT
            # state path, which is re-imputed last (reference :364-370)
            out = dict(state)
            params_cur = self.ssm_params(state)
            state_contrib = (state["alpha"]
                             * params_cur.zs(self.t_len)).sum(-1)
            y_adj = self.y
            if draw_regression is not None:
                # 1. regression | current state: (gamma, sigma^2, beta)
                with record_function("bsts.regression"):
                    out.update(draw_regression(noise["reg"], state,
                                               self.y - state_contrib))
                    y_adj = self.adjusted_series(out)
            with record_function("bsts.variance_draws"):
                if draw_regression is None:
                    # 1. observation variance | current state; with weights
                    # (gaps 0, a multiplexed time point its count) the
                    # weighted sum of squares and the within-time-point
                    # sum of squares (reference :404-413)
                    resid = self.y - state_contrib
                    if w_obs is None:
                        out["sigsq_obs"] = self.obs_prior.draw_variance(
                            noise["obs_u"], self.t_len,
                            (resid * resid).sum(-1))
                    else:
                        out["sigsq_obs"] = self.obs_prior.draw_variance(
                            noise["obs_u"], n_obs,
                            (w_obs * resid * resid).sum(-1)
                            + self._extra_ss())

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

    def _obs_weights(self):
        """(w [T], n = sum w) of the observation model's draws: the
        observation weights, else the mask as 0/1, else (None, None) (the
        dense path; reference :347-352)."""
        if self.obs_weights is not None:
            w = self.obs_weights
        elif self.observed is not None:
            w = self.observed.to(self.y.dtype)
        else:
            return None, None
        return w, w.sum()

    def _extra_ss(self):
        """The within-time-point sum of squares, summed over time points."""
        extra = self.extra_obs_ss
        return extra.sum() if isinstance(extra, torch.Tensor) else extra

    def _regression_draw(self):
        """``draw(noise, state, y_reg) -> {gamma, beta, sigsq_obs}``: the
        spike-and-slab draw on each chain's residual y_reg = y - Z alpha
        [C, T] (reference :354-403; ``regression.gibbs_draw``). The
        statistics X'y and y'y are per chain, X'X is shared; with weights
        (gaps 0, a multiplexed time point its count) X'W X, X'W y, y'W y
        plus the within-time-point sum of squares, and n their sum. The
        indicators take kernel (a)'s per-chain entry on the card when the
        SWEEP path is exact for the prior (``valid_for_prior``), else the
        Cholesky sweep. ``draw.finish`` raises if a Cholesky factor
        failed."""
        x, prior = self.predictors, self.reg_prior
        w_obs, n_obs = self._obs_weights()
        if w_obs is None:
            xtx = x.T @ x
            n = torch.tensor(self.t_len, dtype=x.dtype, device=x.device)
        else:
            xtx = x.T @ (w_obs[:, None] * x)
            n = n_obs
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
            if w_obs is None:
                suf = RegSuf(xtx=xtx, xty=y_reg @ x,
                             yty=(y_reg * y_reg).sum(-1), n=n)
            else:
                suf = RegSuf(xtx=xtx, xty=(w_obs * y_reg) @ x,
                             yty=(w_obs * y_reg * y_reg).sum(-1)
                             + self._extra_ss(), n=n)
            gamma, sigsq, beta, bad = regression.gibbs_draw(
                noise, suf, prior, state["gamma"], swept=swept,
                max_flips=self.reg_max_flips, operands=operands)
            fails.add_((bad != 0).sum(dtype=torch.int32))
            return {"gamma": gamma, "beta": beta, "sigsq_obs": sigsq}

        draw.finish = finish
        return draw

    def _asis_pass(self, noise, state, y_adj):
        params = self.ssm_params(state)
        return asis_redraw(noise, self.blocks, params, state, y_adj,
                           self._asis_h(params))

    def _asis_h(self, params):
        """The observation variances ASIS's likelihood terms take: h [C],
        or with a mask or weights h_t [C, T], inf where y_t is not
        observed. The reference passes sigma^2 alone (bsts.py:851-853),
        which counts a gap's 0 as data and drops the weights; the filter
        and the smoother take neither so (ROADMAP.md, sec. 3)."""
        if self.observed is None and self.obs_weights is None:
            return params.h
        h = params.hs(self.t_len)
        if self.observed is not None:
            h = torch.where(self.observed, h, torch.inf)
        return h

    # -- likelihood, contributions, forecasts -------------------------------
    def adjusted_series(self, state):
        """The series the state explains: y [T], or y - X beta [C, T]."""
        if self.predictors is None:
            return self.y
        return self.y - state["beta"] @ self.predictors.T

    def log_lik(self, state):
        """[C] marginal log likelihoods of the chains' parameters, the state
        integrated out (reference :899), through K1 (d <= 6) or K1w
        (``kalman_kernel.kalman_loglik``) on y, or with a regression on each
        chain's own series y - X beta. A time-varying system comes with the
        model's pattern (:meth:`_loglik_pattern`), so that no call reads
        its R on the host."""
        params = self.ssm_params(state)
        return kalman_kernel.kalman_loglik(
            params, self.adjusted_series(state), self.observed,
            pattern=self._loglik_pattern(params))

    def state_contributions(self, state):
        """Each block's contribution path {name: [C, T]}, and the
        regression's X beta as ``"regression"`` (reference :906-921)."""
        out = {}
        for (start, dim), b in zip(self._slices(), self.blocks):
            z_b = (b.z_seq(self.y.device, self.y.dtype)
                   if hasattr(b, "z_seq")
                   else b.z(self.y.device, self.y.dtype))
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
        and last imputed state (reference :924-1007): alpha_{t+1} = T
        alpha_t + R (s_t o chol(Q) eta_t), y_{t+1} = z_t' alpha_{t+1} +
        sqrt(sigma^2) eps_t. Reads only the last row of each draw's alpha
        [N, *, d]. noise: :meth:`predict_noise_spec`'s ``eta`` [N, h, q] and
        ``eps`` [N, h]. A block with a time-varying z needs its rows
        ``future_z[name]`` [h, dim] (the dynamic regression's future
        predictors, the holiday's one-hot days); ``future_q_scale[name]``
        [h, err] scales a block's errors (default 1, as the reference's;
        a calendar block's own gates continued, ``future_q_scale``). A
        calendar block continues its T_t from the last day
        (``future_t_rows``, reference :965-1008). The regression's future
        X beta is the caller's (``BstsModel.predict``), as in the
        reference."""
        future_z = future_z or {}
        future_q_scale = future_q_scale or {}
        dev, dt = self.y.device, self.y.dtype
        z_rows, s_rows = [], []
        for b in self.blocks:
            if b.name in future_z:
                z_rows.append(torch.as_tensor(future_z[b.name], dtype=dt,
                                              device=dev))
            elif hasattr(b, "z_seq"):
                raise ValueError(
                    f"block {b.name!r} has a time-varying z; pass "
                    f"future_z[{b.name!r}] with shape [{horizon}, {b.dim}]")
            else:
                z_rows.append(b.z(dev, dt).expand(horizon, b.dim))
            if b.name in future_q_scale:
                s_rows.append(torch.as_tensor(future_q_scale[b.name],
                                              dtype=dt, device=dev))
            elif hasattr(b, "future_q_scale"):
                s_rows.append(b.future_q_scale(horizon, dev, dt))
            else:
                s_rows.append(torch.ones(horizon, b.err_dim, dtype=dt,
                                         device=dev))
        z_fut = torch.cat(z_rows, dim=-1)
        s_fut = torch.cat(s_rows, dim=-1)
        if z_fut.shape != (horizon, self.state_dim):
            raise ValueError(f"future_z must give [{horizon}, "
                             f"{self.state_dim}] rows; got "
                             f"{tuple(z_fut.shape)}")
        params = self.ssm_params(final_state)
        t_rows = [params.t_mat] * horizon
        if self._time_varying_t:
            mats, combos, choice = self._calendar_steps(
                lambda b: b.future_t_rows(horizon, dev, dt))
            steps = self._calendar_mats(self._block_transitions(
                final_state["blocks"]), mats, combos)
            t_rows = [steps[:, k] for k in choice.tolist()]
        q_chol = kalman._chol_jitter(params.q_mat)
        alpha = final_state["alpha"][:, -1]
        sd = torch.sqrt(final_state["sigsq_obs"])
        ys = []
        for t in range(horizon):
            eta = s_fut[t] * kalman._mv(q_chol, noise["eta"][:, t])
            alpha = (kalman._mv(t_rows[t], alpha)
                     + kalman._mv(params.r_mat, eta))
            ys.append((z_fut[t] * alpha).sum(-1) + sd * noise["eps"][:, t])
        return torch.stack(ys, dim=1)

    # -- TIM marginal move ----------------------------------------------------
    def _sigma_groups(self):
        """[(path, prior)] over every variance the marginal move updates:
        path = (block name, param name) or ("sigsq_obs",). With a regression
        the observation variance is the regression's sigma^2, drawn with
        beta, and stays out (reference :481-490)."""
        groups = [((b.name, pname), prior) for b in self.blocks
                  for pname, prior, _dims in b.asis_groups()]
        if self.predictors is None:
            groups.append((("sigsq_obs",), self.obs_prior))
        return groups

    @functools.cached_property
    def _variance_directions(self):
        """(dh [G], dm [G, d, d]): h and R Q R' are linear in each of the
        marginal move's variances (``_sigma_groups``); the direction of
        group g is the system at variance 1 for g and 0 for the others, less
        the system at 0 for all (of a template chain). Raises
        NotImplementedError for a block whose system is not so: z, T, a0 or
        P0 varying with its variance, or h and R Q R' not linear in it
        (checked at 0, 1 and 2)."""
        if self.time_varying:
            raise NotImplementedError(
                "the TIM marginal move on a time-varying system (z_t, Q_t "
                "or observation weights) is not ported yet (ROADMAP.md, "
                "queue 1 item 7: the TIM move on a time-varying system)")
        groups = self._sigma_groups()
        dev, dt = self.y.device, self.y.dtype
        template = {
            "blocks": {b.name: b.init_params(
                {k: torch.full((1,), 0.5, dtype=dt, device=dev)
                 for k in b.init_noise_spec()}) for b in self.blocks},
            "sigsq_obs": self.y.new_ones(1)}
        zero = self.y.new_zeros(1)
        for path, _prior in groups:
            template = _set_var(template, path, zero)
        base = self.ssm_params(template)
        dh, dm = [], []
        for path, _prior in groups:
            unit, two = (self.ssm_params(_set_var(template, path,
                                                  self.y.new_full((1,), v)))
                         for v in (1.0, 2.0))
            _check_linear(path, base, unit, two)
            dh.append(unit.h[0] - base.h[0])
            dm.append(unit.rqr[0] - base.rqr[0])
        return torch.stack(dh), torch.stack(dm)

    def _marginal_lp(self, state, y_adj, groups):
        """lp_batch(u [C, M, G]) -> [C, M]: the marginal log posterior of
        the log-variance vectors u, M points a chain: Kalman loglik (the
        state integrated out) + SdPrior density + the log transform's
        Jacobian. The C x M points are one batch of
        systems in ONE loglik call, the variances exp(u) its coefficients
        along ``_variance_directions`` (``kalman_kernel.loglik_along``: K1
        or K1w on the card, and J1 / J2 for its derivatives), each chain's
        M points on its own series when y_adj is [C, T]."""
        dh, dm = self._variance_directions

        def lp_batch(u):
            c, m, _g = u.shape
            flat = u.reshape(c * m, -1)
            st = {"blocks": {name: {k: v.repeat_interleave(m, dim=0)
                                    for k, v in params.items()}
                             for name, params in state["blocks"].items()},
                  "sigsq_obs": state["sigsq_obs"].repeat_interleave(m)}
            zero = flat.new_zeros(c * m)
            for path, _prior in groups:
                st = _set_var(st, path, zero)
            base = self.ssm_params(st)
            var = torch.exp(flat)
            lp = kalman_kernel.loglik_along(
                var, base.h, base.rqr, dh.to(var.dtype), dm.to(var.dtype),
                base.z, base.t_mat, base.a0, base.p0, y_adj, self.observed)
            for gi, (_path, prior) in enumerate(groups):
                lp = lp + _sic_logp(var[:, gi], prior) + flat[:, gi]
            return lp.reshape(c, m)

        return lp_batch

    def _tim_objective(self):
        """(neg, u0): the TIM proposal's objective, minus the marginal log
        posterior of the log variances u [G] (the prior's hard upper limit
        smoothed out of the search, as the reference does), and its
        starting point, the priors' guesses. In float64 on the series'
        device; with a regression at y - X beta_OLS (reference
        bsts.py:635-641)."""
        groups = self._sigma_groups()
        x = (None if self.predictors is None
             else self.predictors.to(torch.float64))
        wide = dataclasses.replace(self, y=self.y.to(torch.float64),
                                   predictors=x, marginal_sigma_slice=False)
        dev, dt = wide.y.device, wide.y.dtype
        template = {
            "blocks": {b.name: b.init_params(
                {k: torch.full((1,), 0.5, dtype=dt, device=dev)
                 for k in b.init_noise_spec()}) for b in self.blocks},
            "sigsq_obs": torch.var(wide.y, correction=0)[None] * 0.5}
        y_fit = wide.y
        if x is not None:
            # least squares by QR ("gels", the one LAPACK routine that
            # torch.linalg.lstsq offers on the card); X is full rank
            beta_ols = torch.linalg.lstsq(x, y_fit[:, None]).solution[:, 0]
            y_fit = y_fit - x @ beta_ols
        lp_batch = wide._marginal_lp(template, y_fit, groups)

        def neg(u):
            lp = lp_batch(u[None, None])[0, 0]
            # the prior's hard upper limit smoothed out of the search, as
            # the reference does
            return -torch.where(torch.isfinite(lp), lp, -1e30)

        u0 = torch.log(torch.tensor([prior.sigma_guess ** 2
                                     for _path, prior in groups],
                                    dtype=dt, device=dev))
        return neg, u0

    def _build_tim_proposal(self):
        """(mode [G], chol [G, G]) of the multivariate-T proposal tailored
        to p(log variances | y): BFGS then Newton to the mode of
        :meth:`_tim_objective`, the Laplace Hessian eigen-clamped and
        inflated (reference ``_build_tim_proposal``, bsts.py:616-672).
        Built in float64 whatever the run's dtype: the proposal only shapes
        the move's efficiency, the acceptance is exact (ROADMAP.md, sec. 3).
        On the card its gradients and Hessians come through J1 and J2
        (``kalman_kernel.loglik_along``)."""
        neg, u0 = self._tim_objective()
        res = numopt.bfgs(neg, u0, max_iters=120)
        res = numopt.newton_raphson(neg, res.x, max_iters=10)
        return res.x.detach(), self._tim_factor(neg, res.x)

    def _tim_factor(self, neg, mode):
        """The proposal's Cholesky factor [G, G] at ``mode``: the Laplace
        Hessian of ``neg`` there (J1 then J2 on the card), eigen-clamped
        and inflated."""
        h = torch.autograd.functional.hessian(neg, mode)
        h = 0.5 * (h + h.T)
        w, v = torch.linalg.eigh(h)
        w = torch.clamp_min(w, 1e-3 * max(float(w.max()), 1.0))
        cov = (v / w[None, :]) @ v.T
        cov = (0.5 * (cov + cov.T)) * self.marginal_tim_inflate ** 2
        return torch.linalg.cholesky(cov).detach()

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
        lp_batch = self._marginal_lp(state, y_adj, groups)
        u_cur = torch.stack([torch.log(_get_var(state, path))
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
            out = _set_var(out, path, torch.exp(u_new[:, gi]))
        return out


def _get_var(st, path):
    """The variance at ``path`` of a state: (block, param) or
    ("sigsq_obs",)."""
    return (st["sigsq_obs"] if path[0] == "sigsq_obs"
            else st["blocks"][path[0]][path[1]])


def _set_var(st, path, value):
    """A copy of the state with the variance at ``path`` set to value."""
    out = dict(st)
    if path[0] == "sigsq_obs":
        out["sigsq_obs"] = value
        return out
    bname, pname = path
    out["blocks"] = dict(st["blocks"])
    out["blocks"][bname] = dict(st["blocks"][bname])
    out["blocks"][bname][pname] = value
    return out


def _check_linear(path, base, unit, two):
    """The marginal move's directions hold for ``path``'s variance: the
    systems at variance 0, 1 and 2 share z, T, a0 and P0, and h and R Q R'
    move by the same step from 0 to 1 as from 1 to 2."""
    tol = 64 * torch.finfo(base.h.dtype).eps
    fixed = all(torch.equal(getattr(base, f), getattr(m, f))
                for f in ("z", "t_mat", "a0", "p0") for m in (unit, two))
    linear = all(
        torch.allclose(getattr(two, f) - getattr(unit, f),
                       getattr(unit, f) - getattr(base, f), rtol=tol,
                       atol=tol * float(getattr(two, f).abs().max()))
        for f in ("h", "rqr"))
    if not (fixed and linear):
        raise NotImplementedError(
            f"the marginal move needs z, T, a0 and P0 free of the variance "
            f"{path[-1]!r} of {path[0]!r} and h and R Q R' linear in it; "
            f"this block is not so (ROADMAP.md, queue 1 item 7)")


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
    series a chain, y - X beta). h: [C] observation variances, or [C, T]
    (h_t, inf where y_t is not observed: no likelihood term). The system's
    z may vary in time (z_t).
    """
    alpha = state["alpha"]  # [C, T, d]
    t_mat, r_mat = params.t_mat, params.r_mat
    zs = params.zs(alpha.shape[1])  # [C, T, d]
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
    g_mat = (dstack * zs[:, None]).sum(-1)  # [C, G, T]
    alpha_base = alpha - torch.einsum("cg,cgtd->ctd", sigs, dstack)
    r0 = y_adj - (alpha_base * zs).sum(-1)  # [C, T]
    g_over_h = g_mat / (h[:, None, :] if h.dim() == 2 else h[:, None, None])
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
    y or y - X beta, and the model's ``observed`` mask, in one launch of K1
    or K1w on the card (``kalman_kernel.innovations``; a time-varying
    system with the model's pattern), the plain filter on the CPU."""
    params = model.ssm_params(states)
    v, f = kalman_kernel.innovations(params, model.adjusted_series(states),
                                     model.observed,
                                     pattern=model._loglik_pattern(params))
    return v / torch.sqrt(f) if standardize else v


def _training_slice(model: Bsts, cutpoint: int):
    """The same model restricted to y_{1:cutpoint} (reference bsts.py:1162;
    simulate_holdout_prediction_errors, StateSpaceModel.cpp:231-249), its
    predictors and any per-step mask with it."""
    repl = {"y": model.y[:cutpoint]}
    for name in ("predictors", "observed", "obs_weights"):
        if getattr(model, name) is not None:
            repl[name] = getattr(model, name)[:cutpoint]
    if isinstance(model.extra_obs_ss, torch.Tensor):
        repl["extra_obs_ss"] = model.extra_obs_ss[:cutpoint]
    # the time-varying blocks' series with it (the reference slices
    # neither, so its holdout of such a model fails)
    repl["blocks"] = [b.sliced(cutpoint) if hasattr(b, "sliced") else b
                      for b in model.blocks]
    return dataclasses.replace(model, **repl)


def thinned(flat, max_draws):
    """At most ``max_draws`` of the flat draws, spread evenly over them (the
    reference's ``jnp.linspace(0, total - 1, take).astype(int32)``)."""
    from boom_tpu_torch.inference.driver import first_leaf, tree_map

    total = first_leaf(flat).shape[0]
    idx = torch.as_tensor(np.linspace(0, total - 1, min(max_draws, total))
                          .astype(np.int64))
    return tree_map(lambda a: a[idx.to(a.device)], flat)


def holdout_prediction_errors(model: Bsts, generator, cutpoint: int,
                              num_draws: int = 100, *, num_chains: int = 2,
                              burn: int = 100, max_draws: int = 50):
    """Out-of-sample one-step errors past ``cutpoint`` (reference
    bsts.py:1172-1217): the model is refit to y_{1:cutpoint}
    (:func:`_training_slice`, ``num_chains`` chains, ``burn`` sweeps, then
    num_draws // num_chains draws from ``generator``), and each of at most
    ``max_draws`` thinned draws filters the whole series, so every error
    past the cutpoint is a one-step error. Returns the standardized errors
    [draws, T]: columns < cutpoint in sample, the rest held out."""
    from boom_tpu_torch.inference.driver import run_mcmc, tree_map

    train = _training_slice(model, cutpoint)
    res = run_mcmc(train.kernel(), train.draw_noise,
                   lambda g, c: train.init_state(train.draw_init_noise(g, c)),
                   max(1, num_draws // num_chains), generator=generator,
                   num_chains=num_chains, burn=burn)
    flat = thinned(tree_map(lambda a: a.reshape((-1,) + tuple(a.shape[2:])),
                            res.draws), max_draws)
    # a block's per-step parameters past the cutpoint (the Student trend's
    # weights at 1, as the forecast takes them)
    flat["blocks"] = {b.name: (b.extend_params(flat["blocks"][b.name],
                                               model.t_len)
                               if hasattr(b, "extend_params")
                               else flat["blocks"][b.name])
                      for b in model.blocks}
    return one_step_prediction_errors(model, flat)


def compare_bsts_models(models_and_results, cutpoint=None, max_draws=50, *,
                        generator=None, num_draws: int = 100,
                        burn: int = 100):
    """Cumulative mean absolute standardized one-step errors per model, [T]
    each (reference bsts.py:1220-1243, R's CompareBstsModels).
    models_and_results: {name: (model, McmcResult)}. Without a cutpoint the
    results' draws give in-sample errors; with one each model is refit to
    y_{1:cutpoint} from ``generator`` (:func:`holdout_prediction_errors`).
    """
    from boom_tpu_torch.inference.driver import tree_map

    out = {}
    for name, (model, result) in models_and_results.items():
        if cutpoint is None:
            flat = tree_map(lambda a: a.reshape((-1,) + tuple(a.shape[2:])),
                            result.draws)
            errs = one_step_prediction_errors(
                model, thinned(flat, max_draws))
        else:
            if generator is None:
                raise ValueError("pass generator= to refit at a cutpoint")
            errs = holdout_prediction_errors(
                model, generator, cutpoint, num_draws=num_draws, burn=burn,
                max_draws=max_draws)
        out[name] = torch.cumsum(errs.abs().mean(0), 0)
    return out
