"""The port's bsts with time-varying blocks on a gapped, multiplexed grid
(chip_smoke.py phase 8's model: a Student trend, a 7-day seasonal, a
dynamic regression, a random-walk holiday and a spike-and-slab regression,
fit with timestamps) against the JAX reference (float64, CPU).

The port's noise is rebuilt from the reference's own keys, so both sides
draw with the same numbers: the Student trend's weights as the CDF levels
of the reference's gamma draws (the port inverts the CDF at them). One
whole sweep is held to ``SWEEP_RTOL`` = 1e-9, as test_torch_bsts_reg.py's
(PyTorch's incomplete gamma is ~1e-10 off the reference's).

One reference fault is corrected on the reference's side here, never
copied (ROADMAP.md, sec. 3): its ASIS redraw takes sigma^2 as every
step's observation variance (bsts.py:851-853), so a gap's 0 counts as
data and the weights are dropped. The tests hand the reference's
``asis_redraw`` the variances the filter uses (h_t, infinite at a gap),
as the port's sweep does.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_bsts_tv.py bench 1024 200 200 7

recomputes the reference numbers of chip_smoke.py's phase 8 (x64 off as
the bench runs, the ASIS fault corrected as here).
"""

import datetime
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boom_tpu.models.glm.regression import SpikeSlabPrior as JaxPrior
from boom_tpu.statespace import bsts as jbsts
from boom_tpu.statespace import kalman as jk
from boom_tpu.statespace import state_models as jsm
from boom_tpu.statespace.bsts import Bsts as JaxBsts
from boom_tpu.utils import timestamps as jts
from boom_tpu_torch import data
from boom_tpu_torch.api import BstsModel
from boom_tpu_torch.convert import model_from_jax, state_from_numpy
from boom_tpu_torch.statespace import bsts as pbsts
from boom_tpu_torch.statespace import kalman_kernel
from boom_tpu_torch.statespace.bsts import ASIS_SHRINK, ASIS_SLICE_STEPS
from boom_tpu_torch.statespace.state_models import NU_SHRINK
from boom_tpu_torch.utils import timestamps as pts

torch.set_num_threads(1)

RTOL = 1e-10
SWEEP_RTOL = 1e-9
F64 = jnp.float64
TINY = np.finfo(np.float64).tiny
CHAINS = 4
G, HZ = data.BSTS_TV_GRID, data.BSTS_TV_HORIZON


# -- the model ---------------------------------------------------------------


def _grid():
    raw = data.bsts_tv()
    info = jts.regularize_timestamps(raw["timestamps"])
    return raw, jts.collapse_to_grid(raw["y"], info, predictors=raw["x"])


def corrected_asis(jmodel):
    """The reference model with its ASIS redraw given the filter's
    observation variances: h_t = sigma^2 / max(w_t, 1), infinite at a gap
    (module docstring)."""
    observed = jnp.asarray(jmodel.observed)

    def asis_pass(key, state, y_adj):
        params = jmodel.ssm_params(state)
        h = jnp.where(observed, jnp.broadcast_to(params.h, observed.shape),
                      jnp.inf)
        return jbsts.asis_redraw(key, jmodel.blocks, params, state, y_adj, h)

    object.__setattr__(jmodel, "_asis_pass", asis_pass)
    return jmodel


def tv_model(dtype=F64, chains=CHAINS):
    """Phase 8's reference model on the committed data, as the reference's
    ``BstsModel.fit(y, predictors=x, timestamps=ts)`` builds it, its ASIS
    corrected."""
    raw, grid = _grid()
    y = jnp.asarray(grid["y_grid"], dtype)
    x = jnp.asarray(grid["predictors_grid"], dtype)
    blocks = [jsm.StudentLocalLinearTrend.default(y),
              jsm.Seasonal.default(y, nseasons=7),
              jsm.DynamicRegression.default(y, jnp.asarray(raw["x_dyn"][:G],
                                                           dtype)),
              jsm.RandomWalkHoliday.default(y, raw["active"][:G],
                                            data.BSTS_TV_WINDOW)]
    prior = JaxPrior.from_data(x, y, expected_model_size=1.0,
                               prior_information_weight=1.0)
    return corrected_asis(JaxBsts(
        y=y, blocks=blocks, predictors=x, reg_prior=prior,
        chains_hint=chains, parallel_smoother=False,
        observed=jnp.asarray(grid["observed"]),
        obs_weights=jnp.asarray(grid["weights"], dtype),
        extra_obs_ss=grid["extra_ss"]))


def future_z():
    raw = data.bsts_tv()
    act = raw["active"][G:]
    return {"dynamic_regression": np.asarray(raw["x_dyn"][G:], np.float64),
            "holiday": np.where((act >= 0)[:, None],
                                np.eye(data.BSTS_TV_WINDOW)[
                                    np.maximum(act, 0)], 0.0)}


# -- the reference's random numbers as the port's noise ----------------------


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _uniform(key, minval=None, shape=()):
    if minval is None:
        return jax.random.uniform(key, shape, F64)
    return jax.random.uniform(key, shape, F64, minval=minval)


def _smoother_normals(key, d, q, t_len):
    k0, ka, ke = jax.random.split(key, 3)
    return {"sim_alpha1": jax.random.normal(k0, (d,)),
            "sim_eta": jax.random.normal(ka, (t_len - 1, q)),
            "sim_eps": jax.random.normal(ke, (t_len,))}


def _slice_noise(key, shrink):
    """A slice step's uniforms from ``key``: (height, offset, shrink)."""
    parts = jax.random.split(key, 4)
    return (_uniform(parts[0], TINY), _uniform(parts[1]),
            jax.vmap(_uniform)(jax.random.split(parts[3], shrink)))


def _gamma_u(key, a, n):
    """The reference's Gamma(a, b) draw of n values from ``key`` as CDF
    levels (``dists.gamma.sample``: jax.random.gamma / b)."""
    g = jax.random.gamma(key, jnp.broadcast_to(a, (n,)), (n,), F64)
    return jax.scipy.special.gammainc(a, g)


def block_noise(block, key, init, params=None):
    """The numbers a reference block draws from ``key`` (``init``:
    init_params', else draw_params' with the block's current ``params``)."""
    lo = None if init else TINY
    kind = type(block).__name__
    if kind == "Seasonal":
        return {"seasonal_u": _uniform(key, lo)}
    if kind == "DynamicRegression":
        if init:
            return {"dynreg_u": _uniform(key, None, (block.dim,))}
        return {"dynreg_u": jax.vmap(lambda k: _uniform(k, TINY))(
            jax.random.split(key, block.dim))}
    if kind == "RandomWalkHoliday":
        return {"holiday_u": _uniform(key, lo)}
    if kind == "StudentLocalLinearTrend" and init:
        k1, k2 = jax.random.split(key)
        return {"level_u": _uniform(k1), "slope_u": _uniform(k2)}
    if kind == "StudentLocalLinearTrend":
        ks = jax.random.split(key, 6)
        n = block.t_len - 1
        out = {"w_level_u": _gamma_u(ks[0], 0.5 * (params["nu_level"] + 1.0),
                                     n),
               "w_slope_u": _gamma_u(ks[1], 0.5 * (params["nu_slope"] + 1.0),
                                     n),
               "level_u": _uniform(ks[2], TINY),
               "slope_u": _uniform(ks[3], TINY)}
        for part, k in (("level", ks[4]), ("slope", ks[5])):
            h_u, u_u, shrink_u = _slice_noise(k, NU_SHRINK)
            out.update({f"nu_{part}_h_u": h_u, f"nu_{part}_u_u": u_u,
                        f"nu_{part}_shrink_u": shrink_u})
        return out
    k1, k2 = jax.random.split(key)
    return {"level_u": _uniform(k1, lo), "slope_u": _uniform(k2, lo)}


def init_noise(model, key):
    """The numbers the reference's ``init_state`` draws from ``key``."""
    keys = jax.random.split(key, len(model.blocks) + 3)
    q = sum(b.err_dim for b in model.blocks)
    p = model.predictors.shape[1]
    return {"blocks": {b.name: block_noise(b, k, True)
                       for b, k in zip(model.blocks, keys[3:])},
            "sig_u": _uniform(keys[1]),
            "gamma_u": jax.random.uniform(keys[0], (p,)),
            **_smoother_normals(keys[2], model.state_dim, q, model.t_len)}


def _sigsq_u(key, df):
    a = 0.5 * df
    return jax.scipy.special.gammainc(a, jax.random.gamma(key, a, (), F64))


def _asis_noise(key, n_groups):
    """{h_u, u_u, shrink_u} of one ASIS pass: fold_in(key, 17), slice step
    j from fold_in(that, j)."""
    k_asis = jax.random.fold_in(key, 17)
    per = [_slice_noise(jax.random.fold_in(k_asis, j), ASIS_SHRINK)
           for j in range(ASIS_SLICE_STEPS * n_groups)]
    rounds = (1, ASIS_SLICE_STEPS, n_groups)
    return {name: jnp.stack([u[i] for u in per]).reshape(
        *rounds, *per[0][i].shape)
        for i, name in enumerate(("h_u", "u_u", "shrink_u"))}


def sweep_noise(model, key, state):
    """The numbers one reference sweep draws from ``key`` given the
    chain's ``state`` (the Student weights' gamma shapes)."""
    k_state, k_obs, k_blocks = jax.random.split(key, 3)
    k1, k2, k3 = jax.random.split(k_obs, 3)
    q = sum(b.err_dim for b in model.blocks)
    p = model.predictors.shape[1]
    n_groups = sum(len(b.asis_groups()) for b in model.blocks)
    _k_jump, k_perm, k_scan = jax.random.split(k1, 3)
    perm = jax.random.permutation(k_perm, p)
    flip_u = jax.vmap(_uniform)(jax.random.split(k_scan, p))
    df = jnp.sum(model.obs_weights) + model.reg_prior.sigma_df
    bkeys = jax.random.split(k_blocks, len(model.blocks))
    noise = {"reg": {"perm": perm, "flip_u": flip_u,
                     "sigsq_u": _sigsq_u(k2, df),
                     "beta_z": jax.random.normal(k3, (p,), F64)},
             "blocks": {b.name: block_noise(b, k, False,
                                            state["blocks"][b.name])
                        for b, k in zip(model.blocks, bkeys)},
             **_smoother_normals(k_state, model.state_dim, q, model.t_len)}
    for name, u in _asis_noise(key, n_groups).items():
        noise[f"asis_{name}"] = u
    return noise


def port_noise(fn, *args):
    tree = _numpy_tree(jax.jit(jax.vmap(fn))(*args))
    return state_from_numpy(tree, device="cpu")


# -- one sweep ---------------------------------------------------------------


SWEEP_KEYS = jax.random.split(jax.random.key(13), CHAINS)


@pytest.fixture(scope="module")
def reference_tv():
    """Phase 8's reference model, its chains' initial states and the states
    after one sweep; compiling the reference's programs is the costly
    part, so the tests share them."""
    jmodel = tv_model()
    keys = jax.random.split(jax.random.key(12), CHAINS)
    state0 = jax.jit(jax.vmap(jmodel.init_state))(keys)
    swept = jax.jit(jax.vmap(jmodel.kernel()))(SWEEP_KEYS, state0)
    return jmodel, keys, state0, swept


def _assert_states_close(port, ref, rtol):
    ref = _numpy_tree(ref)
    _close(port["sigsq_obs"], ref["sigsq_obs"], rtol, msg="sigsq_obs")
    for name, params in ref["blocks"].items():
        for pname, v in params.items():
            _close(port["blocks"][name][pname], v, rtol, msg=pname)
    np.testing.assert_array_equal(port["gamma"].numpy(), ref["gamma"])
    _close(port["beta"], ref["beta"], rtol, rtol, msg="beta")
    _close(port["alpha"], ref["alpha"], rtol, rtol, msg="alpha")


def test_model_from_jax_carries_blocks_and_gaps(reference_tv):
    jmodel, *_ = reference_tv
    model = model_from_jax(jmodel, device="cpu")
    assert [type(b).__name__ for b in model.blocks] == [
        type(b).__name__ for b in jmodel.blocks]
    assert model.state_dim == 13 and model.time_varying
    np.testing.assert_array_equal(model.observed.numpy(),
                                  np.asarray(jmodel.observed))
    _close(model.obs_weights, jmodel.obs_weights, 0.0)
    assert model.extra_obs_ss == pytest.approx(jmodel.extra_obs_ss,
                                               rel=1e-15)
    assert int((~model.observed).sum()) > 10
    assert int((model.obs_weights > 1).sum()) > 3


def test_init_state_matches_reference(reference_tv):
    jmodel, keys, ref, _swept = reference_tv
    model = model_from_jax(jmodel, device="cpu")
    noise = port_noise(lambda k: init_noise(jmodel, k), keys)
    assert set(noise["blocks"]) == set(model.init_noise_spec()["blocks"])
    state = model.init_state(noise)
    _assert_states_close(state, ref, RTOL)


def test_ssm_params_match_reference(reference_tv):
    """z_t, q_scale and h_t of the composite system (reference
    ``ssm_params``, :238-296), from the reference's state carried across
    (``convert.state_from_numpy``: the Student weights [C, T-1], nu, the
    dynamic regression's variances [C, 2])."""
    jmodel, _keys, state0, _swept = reference_tv
    model = model_from_jax(jmodel, device="cpu")
    state = state_from_numpy(_numpy_tree(state0), device="cpu")
    assert state["blocks"]["student_trend"]["w_level"].shape == (CHAINS,
                                                                 G - 1)
    assert state["blocks"]["dynamic_regression"]["sigma_dynreg_sq"].shape \
        == (CHAINS, 2)
    got = model.ssm_params(state)
    want = _numpy_tree(jax.vmap(jmodel.ssm_params)(state0))
    assert got.z.stride(0) == 0  # one z_t for every chain
    _close(got.zs(G), want.z, 0.0)
    _close(got.q_scale, want.q_scale, RTOL)
    _close(got.hs(G), want.h, 1e-15)
    for name in ("t_mat", "r_mat", "q_mat", "a0", "p0"):
        _close(getattr(got, name), getattr(want, name), 0.0, msg=name)
    _close(got.rqrs(G), jax.vmap(lambda s: jmodel.ssm_params(s).rqrs(G))(
        state0), RTOL, 1e-300)


def test_sweep_matches_reference(reference_tv):
    """One whole Gibbs sweep with gaps and duplicated days: the weighted
    regression, the weighted observation variance (its within-day sum of
    squares), every block's draw (the Student weights and nu), the
    time-varying smoother through the mask and ASIS with the filter's
    variances."""
    jmodel, _keys, state0, ref = reference_tv
    model = model_from_jax(jmodel, device="cpu")
    noise = port_noise(lambda k, s: sweep_noise(jmodel, k, s), SWEEP_KEYS,
                       state0)
    spec = model.noise_spec()
    assert set(noise) == set(spec)
    for name, sub in spec["blocks"].items():
        assert set(noise["blocks"][name]) == set(sub), name
    kern = model.kernel()
    out = kern(noise, state_from_numpy(_numpy_tree(state0), device="cpu"))
    kern.finish()
    _assert_states_close(out, ref, SWEEP_RTOL)
    for name, params in out["blocks"].items():
        for pname, v in params.items():
            assert not np.allclose(v.numpy(), np.asarray(
                state0["blocks"][name][pname])), (name, pname)


def test_asis_with_a_mask_matches_the_corrected_reference(reference_tv):
    """ASIS on the gapped series: the port's redraw against the reference's
    ``asis_redraw`` given the filter's variances (inf at a gap); the
    reference's own pass (sigma^2 everywhere, a gap's 0 as data) gives
    another draw."""
    jmodel, _keys, state0, _swept = reference_tv
    model = model_from_jax(jmodel, device="cpu")
    keys = jax.random.split(jax.random.key(33), CHAINS)

    def ref_one(k, st, h_of):
        y_adj = jmodel.y - jmodel.predictors @ st["beta"]
        params = jmodel.ssm_params(st)
        return jbsts.asis_redraw(k, jmodel.blocks, params, st, y_adj,
                                 h_of(params))

    observed = jnp.asarray(jmodel.observed)
    fixed = jax.jit(jax.vmap(lambda k, s: ref_one(
        k, s, lambda p: jnp.where(observed, p.h, jnp.inf))))(keys, state0)
    faulty = jax.jit(jax.vmap(lambda k, s: ref_one(
        k, s, lambda p: s["sigsq_obs"])))(keys, state0)
    noise = port_noise(lambda k: {
        name: v[0] for name, v in _asis_noise_at(k, 1).items()}, keys)
    pstate = state_from_numpy(_numpy_tree(state0), device="cpu")
    params = model.ssm_params(pstate)
    got = pbsts.asis_redraw(noise, model.blocks, params, pstate,
                            model.adjusted_series(pstate),
                            model._asis_h(params))
    want = _numpy_tree(fixed)
    _close(got["alpha"], want["alpha"], RTOL, RTOL)
    _close(got["blocks"]["seasonal_7"]["sigma_seasonal_sq"],
           want["blocks"]["seasonal_7"]["sigma_seasonal_sq"], RTOL)
    assert not np.allclose(
        got["blocks"]["seasonal_7"]["sigma_seasonal_sq"].numpy(),
        np.asarray(faulty["blocks"]["seasonal_7"]["sigma_seasonal_sq"]))


def _asis_noise_at(k_asis, n_groups):
    """{h_u, u_u, shrink_u} [1, steps, G, ...] of asis_redraw(k_asis, ...):
    slice step j from fold_in(k_asis, j)."""
    per = [_slice_noise(jax.random.fold_in(k_asis, j), ASIS_SHRINK)
           for j in range(ASIS_SLICE_STEPS * n_groups)]
    return {name: jnp.stack([u[i] for u in per]).reshape(
        1, ASIS_SLICE_STEPS, n_groups, *per[0][i].shape)
        for i, name in enumerate(("h_u", "u_u", "shrink_u"))}


def test_log_lik_and_errors_with_a_mask_match_reference(reference_tv):
    """log_lik, and the one-step errors (standardized and raw) through the
    mask: the reference's filter given the mask, which its own
    ``one_step_prediction_errors`` drops (ROADMAP.md, sec. 3)."""
    jmodel, _keys, _state0, ref = reference_tv
    model = model_from_jax(jmodel, device="cpu")
    state = state_from_numpy(_numpy_tree(ref), device="cpu")

    def filt(st):
        y_adj = jmodel.y - jmodel.predictors @ st["beta"]
        return jk.kalman_filter(jmodel.ssm_params(st), y_adj,
                                jmodel.observed)

    want = _numpy_tree(jax.jit(jax.vmap(filt))(ref))
    _close(model.log_lik(state), jax.vmap(jmodel.log_lik)(ref), RTOL)
    _close(model.log_lik(state), want.loglik, RTOL)
    _close(pbsts.one_step_prediction_errors(model, state, False), want.v,
           RTOL, 1e-12)
    got = pbsts.one_step_prediction_errors(model, state)
    _close(got, want.v / np.sqrt(want.f), RTOL, 1e-12)
    # no error at a gap
    assert bool((got[:, ~model.observed] == 0).all())
    contrib = model.state_contributions(state)
    for k, v in jax.vmap(jmodel.state_contributions)(ref).items():
        _close(contrib[k], v, RTOL, 1e-12, msg=k)


def test_holdout_errors_of_a_tv_model_refit_through_the_mask():
    """The holdout refit slices y, the mask, the weights, the per-day sum
    of squares and every time-varying block's series; its draws' Student
    weights past the cutpoint are 1, and the errors at gaps are 0."""
    raw, grid = _grid()
    fit = (BstsModel().add_student_local_linear_trend().add_seasonal(7)
           .add_dynamic_regression(raw["x_dyn"][:G])
           .add_random_walk_holiday(raw["active"][:G], 3)
           .fit(raw["y"], predictors=raw["x"], timestamps=raw["timestamps"],
                niter=2, burn=1, num_chains=2, device="cpu"))
    model = fit._model
    train = pbsts._training_slice(model, 120)
    assert train.t_len == 120 and train.observed.shape == (120,)
    assert train.extra_obs_ss.shape == (120,)
    assert [getattr(b, "t_len", None) or b.dim for b in train.blocks][0] \
        == 120
    assert train.blocks[2].predictors.shape == (120, 2)
    assert train.blocks[3].active.shape == (120,)
    errs = pbsts.holdout_prediction_errors(
        model, torch.Generator().manual_seed(3), 120, num_draws=4, burn=2,
        max_draws=3)
    assert errs.shape == (3, G) and bool(torch.isfinite(errs).all())
    assert bool((errs[:, ~model.observed] == 0).all())
    assert bool((errs[:, model.observed] != 0).all())


# -- predict -------------------------------------------------------------------


def test_predict_with_future_z_matches_reference(reference_tv):
    """The forecast of each draw with the dynamic regression's future
    predictors and the holiday's future days, from the reference's own
    normals; without future_z a time-varying block raises."""
    jmodel, _keys, _state0, ref = reference_tv
    model = model_from_jax(jmodel, device="cpu")
    keys = jax.random.split(jax.random.key(21), CHAINS)
    fz = future_z()
    want = jax.vmap(lambda k, s: jmodel.predict(
        k, s, HZ, future_z={n: jnp.asarray(v) for n, v in fz.items()}))(
        keys, ref)
    q = sum(b.err_dim for b in jmodel.blocks)

    def normals(key):
        parts = jax.vmap(jax.random.split)(jax.random.split(key, HZ))
        return {"eta": jax.vmap(lambda k: jax.random.normal(
                    k, (q,), F64))(parts[:, 0]),
                "eps": jax.vmap(lambda k: jax.random.normal(
                    k, (), F64))(parts[:, 1])}

    noise = port_noise(normals, keys)
    state = state_from_numpy(_numpy_tree(ref), device="cpu")
    got = model.predict(noise, state, HZ, future_z=fz)
    _close(got, want, RTOL, 1e-12)
    with pytest.raises(ValueError, match="future_z"):
        model.predict(noise, state, HZ)


# -- the front end and timestamps ----------------------------------------------


def test_fit_with_timestamps_builds_the_reference_grid():
    """BstsModel.fit(timestamps=...) collapses the series onto the
    reference's grid: y, the mask, the weights, the predictors' means and
    the within-day sum of squares; the draws are finite."""
    raw, grid = _grid()
    fit = (BstsModel().add_student_local_linear_trend().add_seasonal(7)
           .add_dynamic_regression(raw["x_dyn"][:G])
           .add_random_walk_holiday(raw["active"][:G], 3)
           .fit(raw["y"], predictors=raw["x"], timestamps=raw["timestamps"],
                niter=3, burn=2, num_chains=2, seed=1, device="cpu"))
    model = fit._model
    _close(model.y, grid["y_grid"], 0.0)
    np.testing.assert_array_equal(model.observed.numpy(), grid["observed"])
    _close(model.obs_weights, grid["weights"], 0.0)
    _close(model.predictors, grid["predictors_grid"], 0.0)
    assert float(model.extra_obs_ss.sum()) == pytest.approx(
        grid["extra_ss"], rel=1e-12)
    assert fit._timestamp_info.number_of_time_points == G
    for leaf in (fit.draws["sigsq_obs"], fit.draws["beta"],
                 fit.draws["blocks"]["student_trend"]["nu_level"]):
        assert bool(torch.isfinite(leaf).all())
    ys = fit.predict(HZ, future_z=future_z(),
                     future_predictors=raw["x_future"])
    assert ys.shape == (6, HZ) and bool(torch.isfinite(ys).all())


TS_CASES = [[1.0, 2.0, 3.0, 4.0], [1.0, 2.0, 2.0, 3.0], [1.0, 2.0, 5.0],
            [1.0, 2.0, 3.1], [0.0, 1.0, 1.0, 2.0, 5.0], [0.0, 1.0, 1.0, 3.0]]


@pytest.mark.parametrize("ts", TS_CASES)
def test_timestamps_match_reference(ts):
    """The regularity predicates, the grid and the collapse against the
    reference's (its tests/test_timestamps.py cases)."""
    for fn in ("no_duplicates", "no_gaps", "is_regular"):
        assert getattr(pts, fn)(ts) == getattr(jts, fn)(ts), fn
    got, want = pts.regularize_timestamps(ts), jts.regularize_timestamps(ts)
    assert got.timestamps_are_trivial == want.timestamps_are_trivial
    assert got.number_of_time_points == want.number_of_time_points
    np.testing.assert_array_equal(got.regular_timestamps,
                                  want.regular_timestamps)
    np.testing.assert_array_equal(got.timestamp_mapping,
                                  want.timestamp_mapping)
    y = np.arange(1.0, len(ts) + 1.0) ** 2
    x = np.stack([y, -y], -1)
    g, w = pts.collapse_to_grid(y, got, x), jts.collapse_to_grid(y, want, x)
    for k in ("y_grid", "observed", "weights", "predictors_grid"):
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert g["extra_ss"] == w["extra_ss"]
    assert g["extra_ss_t"].sum() == pytest.approx(w["extra_ss"], abs=1e-12)


def test_timestamps_reference_examples():
    """The reference's own expectations (tests/test_timestamps.py)."""
    info = pts.regularize_timestamps([0.0, 1.0, 1.0, 2.0, 5.0])
    assert not info.timestamps_are_trivial
    assert info.number_of_time_points == 6
    np.testing.assert_array_equal(info.timestamp_mapping, [0, 1, 1, 2, 5])
    base = datetime.date(2024, 3, 1)
    days = np.asarray([base, base + datetime.timedelta(days=1),
                       base + datetime.timedelta(days=4)],
                      dtype="datetime64[D]")
    info = pts.regularize_timestamps(days)
    assert info.number_of_time_points == 5
    np.testing.assert_array_equal(info.timestamp_mapping, [0, 1, 4])
    g = pts.collapse_to_grid(np.array([1.0, 2.0, 4.0, 8.0]),
                             pts.regularize_timestamps([0.0, 1.0, 1.0, 3.0]))
    np.testing.assert_allclose(g["y_grid"], [1.0, 3.0, 0.0, 8.0])
    np.testing.assert_allclose(g["weights"], [1.0, 2.0, 0.0, 1.0])
    np.testing.assert_allclose(g["extra_ss"], 2.0)


@pytest.mark.parametrize("stamps", [
    np.arange("2020-01", "2021-06", dtype="datetime64[M]"),
    [datetime.date(2020, m, 1) for m in (1, 2, 3, 5)],
    np.arange("2010", "2020", dtype="datetime64[Y]")])
def test_calendar_timestamps_a_month_apart_raise(stamps):
    """Monthly and coarser dates need a calendar grid; the reference snaps
    them to a uniform one (timestamps.py:86), which the port refuses
    (ROADMAP.md, sec. 3)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pts.regularize_timestamps(stamps)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BstsModel().add_local_level().fit(
            np.arange(len(stamps), dtype=float), niter=1, burn=0,
            num_chains=1, device="cpu", timestamps=stamps)


def test_tim_move_on_a_tv_model_raises():
    raw, grid = _grid()
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 7"):
        (BstsModel().add_student_local_linear_trend()
         .add_dynamic_regression(raw["x_dyn"][:G])
         .fit(raw["y"], timestamps=raw["timestamps"], niter=1, burn=0,
              num_chains=1, device="cpu", marginal_sigma_slice=True,
              marginal_move="tim"))


# -- chip_smoke.py phase 8's reference numbers ---------------------------------


TV_NAMES = ("sigsq_obs", "sigma_level_sq", "sigma_slope_sq", "nu_level",
            "nu_slope", "sigma_seasonal_sq", "sigma_dynreg_sq[0]",
            "sigma_dynreg_sq[1]", "sigma_holiday_sq")


def tv_monitor(d):
    """[chains, draws, 13] monitored parameters of a bsts_tv run's draws
    (``TV_NAMES``, then beta[0:4])."""
    cols = [d["sigsq_obs"], d["sigma_level_sq"], d["sigma_slope_sq"],
            d["nu_level"], d["nu_slope"], d["sigma_seasonal_sq"],
            d["sigma_dynreg_sq"][..., 0], d["sigma_dynreg_sq"][..., 1],
            d["sigma_holiday_sq"]]
    return np.concatenate([np.stack(cols, -1), d["beta"][..., :4]], -1)


def reference(chains=1024, burn=200, draws=200, seed=7, take=200):
    """The JAX reference's bsts_tv run on the committed data, x64 off, its
    ASIS corrected (module docstring): posterior medians, ESS per draw and
    R-hat of the monitored parameters, inclusion probabilities, and the
    forecast's medians and sds at each of the 30 steps (``take`` thinned
    draws, their Student weights at 1: the forecast reads only Q)."""
    from boom_tpu.inference import run_mcmc
    from boom_tpu_torch.inference import diagnostics

    with jax.enable_x64(False):
        jmodel = tv_model(jnp.float32, chains)

        def extract(s):
            b = s["blocks"]
            tr = b["student_trend"]
            return {"sigsq_obs": s["sigsq_obs"],
                    **{k: tr[k] for k in ("sigma_level_sq", "sigma_slope_sq",
                                          "nu_level", "nu_slope")},
                    "sigma_seasonal_sq": b["seasonal_7"]["sigma_seasonal_sq"],
                    "sigma_dynreg_sq":
                        b["dynamic_regression"]["sigma_dynreg_sq"],
                    "sigma_holiday_sq": b["holiday"]["sigma_holiday_sq"],
                    "beta": s["beta"], "gamma": s["gamma"],
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
        fz = {k: jnp.asarray(v, jnp.float32) for k, v in future_z().items()}
        x_fut = jnp.asarray(data.bsts_tv()["x_future"])
        ones = jnp.ones(G - 1)

        def one(k, st):
            state = {"blocks": {
                "student_trend": {
                    **{n: st[n] for n in ("sigma_level_sq", "sigma_slope_sq",
                                          "nu_level", "nu_slope")},
                    "w_level": ones, "w_slope": ones},
                "seasonal_7": {"sigma_seasonal_sq": st["sigma_seasonal_sq"]},
                "dynamic_regression": {
                    "sigma_dynreg_sq": st["sigma_dynreg_sq"]},
                "holiday": {"sigma_holiday_sq": st["sigma_holiday_sq"]}},
                "sigsq_obs": st["sigsq_obs"],
                "alpha": st["alpha_last"][None]}
            return (jmodel.predict(k, state, HZ, future_z=fz)
                    + x_fut @ st["beta"])

        keys = jax.random.split(jax.random.key(seed), take)
        fcast = np.asarray(jax.jit(jax.vmap(one))(keys, sub))
    d = {k: np.asarray(v) for k, v in d.items()}
    mon = tv_monitor(d).astype(np.float64)
    ess = diagnostics.effective_sample_size(torch.tensor(mon)).numpy()
    rhat = diagnostics.potential_scale_reduction(torch.tensor(mon)).numpy()
    names = TV_NAMES + tuple(f"beta[{j}]" for j in range(4))
    return {"medians": dict(zip(names, np.median(
                mon.reshape(-1, len(names)), 0).tolist())),
            "inclusion": d["gamma"].reshape(-1, d["gamma"].shape[-1])
            .mean(0).tolist(),
            "ess_per_draw": (ess / total).tolist(),
            "min_ess_per_draw": float(ess.min() / total),
            "rhat": rhat.tolist(),
            "forecast_median": np.median(fcast, 0).tolist(),
            "forecast_sd": fcast.std(0).tolist()}


if __name__ == "__main__" and sys.argv[1:2] == ["bench"]:
    import json

    print(json.dumps(reference(*map(int, sys.argv[2:]))))
