"""The monthly annual cycle and its calendar T_t in the port against the
JAX reference (float64, CPU), on the reference's own random numbers
(test_torch_state_blocks.py's helpers):

- the block's calendar (the reference's own boundary-pattern test, ported),
  its system, ``init_params`` and ``draw_params`` (1e-12; the variance's
  draw 1e-9: PyTorch's incomplete gamma);
- the plain Kalman functions with a T_t (``SsmParams.t_mats``,
  ``t_choice``) against the reference's with its ``t_seq`` [T, d, d] at
  1e-10 (the filter's v, f, a, P and loglik, ``smooth_states``,
  ``simulate``, the simulation smoother), and the reference's own check
  that a T_t repeating the static T is the static path;
- ``convert.ssm_params_from_numpy`` of a reference system with its
  ``t_seq``: its distinct matrices found once, and more than the kernels
  take refused;
- phase 10a's model (a semilocal trend and the monthly cycle, d = 14) on
  the first 100 days of the committed series: ``init_state`` and one sweep
  of 3 chains at 1e-9, ``log_lik`` and the one-step errors at 1e-10, the
  holdout refit's calendar, ``predict`` over 40 days (the calendar
  continued) at 1e-10, the front end;
- the refusals that remain: the TIM move on the calendar's time-varying
  system, and a T_t in the d <= 6 kernels (K1, K2), naming their item.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_monthly.py bench 1024 200 200 7

recomputes the reference numbers of chip_smoke.py's phase 10a: bsts_monthly
(a semilocal trend and the monthly cycle, d = 14, on the committed daily
series), x64 off as the bench runs: the posterior medians, split R-hat and
ESS per draw of the monitored parameters, and the 30-day forecast's
medians and sds of 200 thinned draws.
"""

import datetime
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boom_tpu.statespace import kalman as jk
from boom_tpu.statespace import state_models as jsm
from boom_tpu.statespace.bsts import Bsts as JaxBsts
from boom_tpu_torch import data
from boom_tpu_torch.api import BstsModel
from boom_tpu_torch.convert import (
    model_from_jax,
    ssm_params_from_numpy,
    state_from_numpy,
)
from boom_tpu_torch.statespace import bsts as pbsts
from boom_tpu_torch.statespace import kalman
from boom_tpu_torch.statespace import kalman_kernel as kk
from boom_tpu_torch.statespace import state_models as psm
from test_torch_state_blocks import (
    SWEEP_RTOL,
    _close,
    _numpy_tree,
    assert_states_close,
    block_noise,
    init_noise,
    port_noise,
    sweep_noise,
)

torch.set_num_threads(1)

F64 = jnp.float64
RTOL = 1e-10
CHAINS, T_SMALL, HZ = 3, 100, 40
MONTHLY_MONITOR = ("sigsq_obs", "sigma_level_sq", "sigma_slope_sq", "phi",
                   "sigma_monthly_sq")
HORIZON = 30




# -- the block ---------------------------------------------------------------


def _block_pair(t_len=T_SMALL, first=data.BSTS_MONTHLY_FIRST):
    y = jnp.asarray(data.bsts_monthly()["y"][:t_len], F64)
    jb = jsm.MonthlyAnnualCycle.default(y, first)
    return jb, model_from_jax(JaxBsts(y=y, blocks=[jb]),
                              device="cpu").blocks[0]


def test_monthly_boundary_pattern():
    """The reference's own check (tests/test_monthly_annual_cycle.py):
    transitions rotate exactly when the next day is the 1st; the q gate is
    the boundary pattern; the forecast continues the calendar."""
    first = datetime.date(2024, 1, 15)
    jb, b = _block_pair(100, first)
    dev, dt = torch.device("cpu"), torch.float64
    bnd = b._boundary_np(0, 99)
    for k in range(99):
        d = first + datetime.timedelta(days=k + 1)
        assert bnd[k] == (1.0 if d.day == 1 else 0.0), (k, d)
    np.testing.assert_array_equal(bnd, np.asarray(jb._boundary(0, 99)))
    mats, choice = b.t_seq(dev, dt)
    ts = mats[choice].numpy()
    rot = b._rotation(dev, dt).numpy()
    np.testing.assert_array_equal(rot, np.asarray(jb._rotation()))
    np.testing.assert_array_equal(ts, np.asarray(jb.t_seq(100)))
    for k in range(99):
        np.testing.assert_array_equal(ts[k], rot if bnd[k] else np.eye(11))
    qs = b.q_scale_seq({"sigma_monthly_sq": torch.ones(2)})[:, 0].numpy()
    np.testing.assert_array_equal(qs[:99], bnd)
    fut = b.future_q_scale(40, dev, dt)[:, 0].numpy()
    for k in range(40):
        d = first + datetime.timedelta(days=100 + k)
        assert fut[k] == (1.0 if d.day == 1 else 0.0)
    f_mats, f_choice = b.future_t_rows(40, dev, dt)
    np.testing.assert_array_equal(f_mats[f_choice].numpy(),
                                  np.asarray(jb.future_t_rows(100, 40)))


def test_monthly_block_matches_reference():
    """The static T (the rotation) and R, Q, the initial distribution,
    init_params and draw_params on the reference's numbers."""
    jb, b = _block_pair()
    dev, dt = torch.device("cpu"), torch.float64
    keys = jax.random.split(jax.random.key(3), CHAINS)
    params = _numpy_tree(jax.vmap(jb.init_params)(keys))
    t_mat, r_mat, q_mat = b.build(
        {k: torch.tensor(v) for k, v in params.items()})
    want = _numpy_tree(jax.vmap(jb.build)(jax.tree_util.tree_map(
        jnp.asarray, params)))
    for got, w, name in zip((t_mat, r_mat, q_mat), want, "TRQ"):
        _close(got, w, 1e-15, msg=name)
    for got, w in zip(b.init_dist(dev, dt), jb.init_dist()):
        _close(got, w, 1e-15)
    noise = port_noise(lambda k: block_noise(jb, k, True), keys)
    _close(b.init_params(noise)["sigma_monthly_sq"],
           params["sigma_monthly_sq"], 1e-12)
    path = np.cumsum(np.random.default_rng(1).normal(
        size=(CHAINS, T_SMALL, 11)), 1)
    dkeys = jax.random.split(jax.random.key(4), CHAINS)
    want = _numpy_tree(jax.jit(jax.vmap(jb.draw_params))(
        dkeys, jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray(path)))
    noise = port_noise(lambda k: block_noise(jb, k, False), dkeys)
    got = b.draw_params(noise, {k: torch.tensor(v)
                                for k, v in params.items()},
                        torch.tensor(path))
    _close(got["sigma_monthly_sq"], want["sigma_monthly_sq"], SWEEP_RTOL)
    assert b.asis_groups() == [] and b.sliced(40).t_len == 40


# -- the plain Kalman functions with a T_t ------------------------------------


def _calendar_systems(rng, c, t_len, d=4, k=2, shared=False):
    """Reference systems (a list of SsmParams, one a chain) with a t_seq of
    ``k`` distinct matrices over the steps, z_t, q_scale and h_t: (them, the
    per-chain fields stacked as numpy)."""
    def stable():
        m = rng.normal(size=(d, d))
        return m * 0.95 / max(abs(np.linalg.eigvals(m)).max(), 1e-3)

    common = [stable() for _ in range(k)]
    choice = rng.integers(0, k, size=t_len)
    choice[:k] = np.arange(k)
    z = rng.normal(size=(t_len, d))
    q_scale = rng.uniform(0.5, 2.0, size=(t_len, d))
    systems = []
    for _ in range(c):
        mats = common if shared else [stable() for _ in range(k)]
        lq = 0.3 * rng.normal(size=(d, d))
        mp = rng.normal(size=(d, d))
        systems.append(jk.SsmParams(
            z=jnp.asarray(z), t_mat=jnp.asarray(mats[0]),
            r_mat=jnp.eye(d), q_mat=jnp.asarray(lq @ lq.T + 0.1 * np.eye(d)),
            h=jnp.asarray(rng.uniform(0.3, 1.0)), a0=jnp.asarray(
                rng.normal(size=d)), p0=jnp.asarray(mp @ mp.T + np.eye(d)),
            q_scale=jnp.asarray(q_scale),
            t_seq=jnp.asarray(np.stack(mats)[choice])))
    stacked = {f: np.stack([np.asarray(getattr(sy, f)) for sy in systems])
               for f in jk.SsmParams._fields}
    return systems, stacked


@pytest.mark.parametrize("shared", [False, True])
def test_plain_kalman_with_t_seq_matches_reference(shared):
    """kalman_filter (loglik, v, f, a, P), kalman_loglik with the
    innovations, smooth_states, simulate and the simulation smoother, a
    mask, against the reference's time-varying branches (kalman.py:189,
    :258, :299, :392)."""
    rng = np.random.default_rng(7 + shared)
    c, t_len = 3, 45
    systems, stacked = _calendar_systems(rng, c, t_len, shared=shared)
    params = ssm_params_from_numpy(stacked, device="cpu")
    assert params.t_mats.shape == (c, 2, 4, 4)
    assert (params.t_mats.stride(0) == 0) == shared
    y = rng.normal(size=t_len).cumsum()
    obs = rng.uniform(size=t_len) > 0.2
    jsys = jk.SsmParams(**{f: jnp.asarray(v) for f, v in stacked.items()})
    jy, jobs = jnp.asarray(y), jnp.asarray(obs)
    keys = jax.random.split(jax.random.key(8), c)

    def ref_one(sy, k):
        filt = jk.kalman_filter(sy, jy, jobs)
        return (filt, jk.kalman_loglik(sy, jy, jobs),
                jk.smooth_states(sy, jy, jobs), jk.simulate(k, sy, t_len),
                jk.simulation_smoother(k, sy, jy, jobs))

    want, ll_want, sm_want, (wa, wy), draw_want = _numpy_tree(
        jax.jit(jax.vmap(ref_one))(jsys, keys))
    got = kalman.kalman_filter(params, torch.tensor(y), torch.tensor(obs))
    for name in ("loglik", "v", "f", "a", "p"):
        _close(getattr(got, name), getattr(want, name), RTOL, 1e-12,
               msg=name)
    ll, v, f = kalman.kalman_loglik(params, torch.tensor(y),
                                    torch.tensor(obs), innovations=True)
    _close(ll, ll_want, RTOL)
    _close(v, want.v, RTOL, 1e-12)
    _close(f, want.f, RTOL)
    _close(kalman.smooth_states(params, torch.tensor(y), torch.tensor(obs)),
           sm_want, RTOL, 1e-12)
    nz = []
    for shape, j in (((4,), 0), ((t_len - 1, 4), 1), ((t_len,), 2)):
        nz.append(torch.tensor(np.stack([np.asarray(jax.random.normal(
            jax.random.split(k, 3)[j], shape, F64)) for k in keys])))
    alpha, ysim = kalman.simulate(params, t_len, *nz)
    _close(alpha, wa, RTOL, 1e-12)
    _close(ysim, wy, RTOL, 1e-12)
    draw = kalman.simulation_smoother(params, torch.tensor(y), *nz,
                                      observed=torch.tensor(obs))
    _close(draw, draw_want, 1e-9, 1e-9)


def test_t_seq_constant_matches_static_path():
    """The reference's own engine check: a T_t that repeats the static T
    gives the static path's loglik and smoothed states."""
    rng = np.random.default_rng(11)
    _systems, stacked = _calendar_systems(rng, 2, 60, k=1)
    params = ssm_params_from_numpy(stacked, device="cpu")
    assert params.t_mats.shape[1] == 1
    static = params._replace(t_mats=None, t_choice=None)
    y = torch.tensor(rng.normal(size=60).cumsum())
    _close(kalman.kalman_loglik(params, y), kalman.kalman_loglik(static, y),
           1e-12)
    _close(kalman.smooth_states(params, y), kalman.smooth_states(static, y),
           1e-12, 1e-12)


def test_convert_finds_the_distinct_transitions_once():
    """t_seq [C, T, d, d] -> t_mats [C, K, d, d] and t_choice [T]: ts()
    rebuilds it exactly; more than two distinct matrices raise, naming
    their item."""
    rng = np.random.default_rng(12)
    _systems, stacked = _calendar_systems(rng, 2, 30)
    params = ssm_params_from_numpy(stacked, device="cpu")
    np.testing.assert_array_equal(params.ts(30).numpy(), stacked["t_seq"])
    assert params.t_choice.dtype == torch.int64
    _systems, three = _calendar_systems(rng, 2, 30, k=3)
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 7"):
        ssm_params_from_numpy(three, device="cpu")


# -- phase 10a's model --------------------------------------------------------


SWEEP_KEYS = jax.random.split(jax.random.key(13), CHAINS)


@pytest.fixture(scope="module")
def monthly_ref():
    """Phase 10a's reference model on the first T_SMALL days (three month
    boundaries), its chains' initial states and the states after one
    sweep; and the port's model."""
    y = jnp.asarray(data.bsts_monthly()["y"][:T_SMALL], F64)
    jmodel = monthly_model(y, CHAINS)
    keys = jax.random.split(jax.random.key(12), CHAINS)
    state0 = jax.jit(jax.vmap(jmodel.init_state))(keys)
    swept = jax.jit(jax.vmap(jmodel.kernel()))(SWEEP_KEYS, state0)
    return jmodel, keys, state0, swept, model_from_jax(jmodel, device="cpu")


def test_monthly_ssm_params_match_reference(monthly_ref):
    """T a chain (the semilocal trend's phi), T_t's two block-diagonals (a
    chain each) and the steps' choice, the monthly gate in q_scale."""
    jmodel, _keys, state0, _swept, model = monthly_ref
    assert model.state_dim == 14 and model.time_varying
    got = model.ssm_params(state_from_numpy(_numpy_tree(state0),
                                            device="cpu"))
    want = _numpy_tree(jax.vmap(jmodel.ssm_params)(state0))
    for name in ("t_mat", "r_mat", "q_mat", "a0", "p0", "q_scale"):
        _close(getattr(got, name), getattr(want, name), 1e-15, msg=name)
    _close(got.zs(T_SMALL), np.broadcast_to(want.z[:, None],
                                            (CHAINS, T_SMALL, 14)), 0.0)
    assert got.t_mats.shape == (CHAINS, 2, 14, 14)
    assert int(got.t_choice.sum()) == 3
    _close(got.ts(T_SMALL), want.t_seq, 1e-15, msg="t_seq")


def test_monthly_init_state_matches_reference(monthly_ref):
    jmodel, keys, ref, _swept, model = monthly_ref
    noise = port_noise(lambda k: init_noise(jmodel, k), keys)
    assert_states_close(model.init_state(noise), ref, SWEEP_RTOL)


def test_monthly_sweep_matches_reference(monthly_ref):
    """One whole sweep: the observation variance, the semilocal trend's
    variances and phi (the truncated normal), the monthly variance, the
    smoother through T_t and the monthly gate, ASIS on the static T (the
    trend's groups; the cycle has none, as the reference's)."""
    jmodel, _keys, state0, ref, model = monthly_ref
    noise = port_noise(lambda k: sweep_noise(jmodel, k), SWEEP_KEYS)
    spec = model.noise_spec()
    assert set(noise) == set(spec)
    for name, sub in spec["blocks"].items():
        assert set(noise["blocks"][name]) == set(sub), name
    out = model.kernel()(noise, state_from_numpy(_numpy_tree(state0),
                                                 device="cpu"))
    assert_states_close(out, ref, SWEEP_RTOL)
    for name, params in out["blocks"].items():
        for pname, v in params.items():
            assert not np.allclose(v.numpy(), np.asarray(
                state0["blocks"][name][pname])), (name, pname)


def test_monthly_log_lik_and_errors_match_reference(monthly_ref):
    jmodel, _keys, _state0, swept, model = monthly_ref
    state = state_from_numpy(_numpy_tree(swept), device="cpu")
    _close(model.log_lik(state), jax.vmap(jmodel.log_lik)(swept), RTOL)
    want = jbsts_errors(jmodel, swept)
    _close(pbsts.one_step_prediction_errors(model, state), want[0], RTOL,
           1e-12)
    _close(pbsts.one_step_prediction_errors(model, state, False), want[1],
           RTOL, 1e-12)
    contrib = model.state_contributions(state)
    for k, v in jax.vmap(jmodel.state_contributions)(swept).items():
        _close(contrib[k], v, RTOL, 1e-12, msg=k)


def jbsts_errors(jmodel, states):
    from boom_tpu.statespace import bsts as jbsts

    return (np.asarray(jbsts.one_step_prediction_errors(jmodel, states)),
            np.asarray(jbsts.one_step_prediction_errors(jmodel, states,
                                                        standardize=False)))


def test_monthly_predict_matches_reference(monthly_ref):
    """The forecast of each draw over HZ days past the series, its T_t and
    the monthly gate continued from the calendar, from the reference's own
    normals."""
    jmodel, _keys, _state0, swept, model = monthly_ref
    keys = jax.random.split(jax.random.key(21), CHAINS)
    want = jax.vmap(lambda k, s: jmodel.predict(k, s, HZ))(keys, swept)
    q = sum(b.err_dim for b in jmodel.blocks)

    def normals(key):
        parts = jax.vmap(jax.random.split)(jax.random.split(key, HZ))
        return {"eta": jax.vmap(lambda k: jax.random.normal(
                    k, (q,), F64))(parts[:, 0]),
                "eps": jax.vmap(lambda k: jax.random.normal(
                    k, (), F64))(parts[:, 1])}

    noise = port_noise(normals, keys)
    state = state_from_numpy(_numpy_tree(swept), device="cpu")
    _close(model.predict(noise, state, HZ), want, RTOL, 1e-12)


def test_monthly_holdout_refit_slices_the_calendar(monthly_ref):
    """The holdout refit's model ends its calendar at the cutpoint; its
    errors through the whole series are finite."""
    _jmodel, _keys, _state0, _swept, model = monthly_ref
    train = pbsts._training_slice(model, 60)
    assert train.t_len == 60 and train.blocks[1].t_len == 60
    _mats, _combos, choice = train._calendar
    np.testing.assert_array_equal(choice.numpy(),
                                  model._calendar[2][:60].numpy())
    errs = pbsts.holdout_prediction_errors(
        model, torch.Generator().manual_seed(3), 60, num_draws=4, burn=2,
        max_draws=3)
    assert errs.shape == (3, T_SMALL) and bool(torch.isfinite(errs).all())


def test_monthly_front_end_fits_on_the_cpu():
    """``add_semilocal_linear_trend().add_monthly_annual_cycle(first_date)``
    as the reference's builders make them; finite draws and forecast."""
    from boom_tpu.api import BstsModel as JaxBstsModel

    y = np.asarray(data.bsts_monthly()["y"][:90], np.float64)
    fit = (BstsModel().add_semilocal_linear_trend()
           .add_monthly_annual_cycle(first_date=data.BSTS_MONTHLY_FIRST)
           .fit(y, niter=3, burn=2, num_chains=2, seed=1, device="cpu"))
    jblocks = (JaxBstsModel().add_semilocal_linear_trend()
               .add_monthly_annual_cycle(data.BSTS_MONTHLY_FIRST)
               ._build_blocks(jnp.asarray(y)))
    for b, jb in zip(fit._model.blocks, jblocks):
        assert b.name == jb.name and b.dim == jb.dim
    assert fit._model.blocks[1].t_len == 90
    d = fit.draws
    for leaf in (d["sigsq_obs"], d["blocks"]["monthly"]["sigma_monthly_sq"],
                 d["blocks"]["semilocal_trend"]["phi"], d["alpha"]):
        assert bool(torch.isfinite(leaf).all())
    ys = fit.predict(HZ, max_draws=4)
    assert ys.shape == (4, HZ) and bool(torch.isfinite(ys).all())


# -- what stays refused ------------------------------------------------------


def test_tim_move_on_the_calendar_raises():
    y = torch.tensor(np.asarray(data.bsts_monthly()["y"][:60], np.float64))
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 7"):
        pbsts.Bsts(y=y, blocks=[
            psm.LocalLevel.default(y),
            psm.MonthlyAnnualCycle.default(y, data.BSTS_MONTHLY_FIRST)],
            marginal_sigma_slice=True, marginal_move="tim")


def test_narrow_kernels_refuse_a_t_seq():
    """K1 and K2 (d <= 6) take no T_t: their wrappers raise before any
    launch, naming the item; the plain versions take it."""
    rng = np.random.default_rng(13)
    _systems, stacked = _calendar_systems(rng, 2, 20)
    params = ssm_params_from_numpy(stacked, device="cpu")
    y = torch.tensor(rng.normal(size=20))
    before = dict(kk.LAUNCHES)
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 7"):
        kk.launch_loglik_tv(params, y, None)
    nz = [torch.zeros(s, dtype=torch.float64)
          for s in ((2, 4), (2, 19, 4), (2, 20))]
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 7"):
        kk.smoother_operands(params, y, *nz)
    assert kk.LAUNCHES == before
    assert bool(torch.isfinite(kalman.kalman_loglik(params, y)).all())


def monthly_model(y, chains=1, **kw):
    """Phase 10a's reference model on ``y``, as the reference's
    ``BstsModel().add_semilocal_linear_trend()
    .add_monthly_annual_cycle(first_date)`` builds it."""
    blocks = [jsm.SemilocalLinearTrend.default(y),
              jsm.MonthlyAnnualCycle.default(y, data.BSTS_MONTHLY_FIRST)]
    return JaxBsts(y=y, blocks=blocks, chains_hint=chains, **kw)


def monthly_monitor(d):
    """[chains, draws, 5] monitored parameters (MONTHLY_MONITOR)."""
    b = d["blocks"]
    tr = b["semilocal_trend"]
    return np.stack([d["sigsq_obs"], tr["sigma_level_sq"],
                     tr["sigma_slope_sq"], tr["phi"],
                     b["monthly"]["sigma_monthly_sq"]], -1)


def reference(chains=1024, burn=200, draws=200, seed=7, take=200):
    """The JAX reference's bsts_monthly run on the committed data, x64 off:
    medians, ESS per draw and R-hat of MONTHLY_MONITOR, and the forecast's
    medians and sds at each of HORIZON days (``take`` thinned draws)."""
    from boom_tpu.inference import run_mcmc
    from boom_tpu_torch.inference import diagnostics

    with jax.enable_x64(False):
        y = jnp.asarray(data.bsts_monthly()["y"], jnp.float32)
        jmodel = monthly_model(y, chains)

        def extract(s):
            return {"sigsq_obs": s["sigsq_obs"], "blocks": s["blocks"],
                    "alpha_last": s["alpha"][-1]}

        fit = jax.jit(lambda k: run_mcmc(
            k, jmodel.kernel(), jmodel.init_state, draws, num_chains=chains,
            burn=burn, jit=False, extract=extract).draws)
        d = fit(jax.random.key(seed))
        flat = jax.tree_util.tree_map(
            lambda a: a.reshape((-1,) + a.shape[2:]), d)
        total = chains * draws
        idx = np.linspace(0, total - 1, take).astype(np.int64)
        sub = jax.tree_util.tree_map(lambda a: a[idx], flat)

        def one(k, st):
            state = {"blocks": st["blocks"], "sigsq_obs": st["sigsq_obs"],
                     "alpha": st["alpha_last"][None]}
            return jmodel.predict(k, state, HORIZON)

        keys = jax.random.split(jax.random.key(seed), take)
        fcast = np.asarray(jax.jit(jax.vmap(one))(keys, sub))
    d = jax.tree_util.tree_map(np.asarray, d)
    mon = monthly_monitor(d).astype(np.float64)
    ess = diagnostics.effective_sample_size(torch.tensor(mon)).numpy()
    rhat = diagnostics.potential_scale_reduction(torch.tensor(mon)).numpy()
    return {"medians": dict(zip(MONTHLY_MONITOR, np.median(
                mon.reshape(-1, len(MONTHLY_MONITOR)), 0).tolist())),
            "ess_per_draw": (ess / total).tolist(),
            "min_ess_per_draw": float(ess.min() / total),
            "rhat": rhat.tolist(),
            "forecast_median": np.median(fcast, 0).tolist(),
            "forecast_sd": fcast.std(0).tolist()}


if __name__ == "__main__" and sys.argv[1:2] == ["bench"]:
    import json

    print(json.dumps(reference(*map(int, sys.argv[2:]))))
