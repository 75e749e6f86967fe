"""The static state blocks of this slice (``StaticIntercept``, ``Trig``,
``ArState``, ``SemilocalLinearTrend``) in the port against the JAX
reference (float64, CPU), on the reference's own random numbers rebuilt
from its keys as the port's noise:

- each block's z, T, R, Q and initial distribution (1e-15), its
  ``init_params`` and ``draw_params`` (1e-12; a variance's draw 1e-9: the
  inverse CDF carries PyTorch's incomplete gamma, ~1e-10 off the
  reference's; the AR state's stationarity test and its fallback, the
  semilocal trend's phi through the truncated normal's body and its
  tail);
- the builders of phase 10b's model on the CPU (its sweep, proposal and
  log_lik against the reference's: test_torch_ar_trig.py).

The random numbers' helpers here (``block_noise``, ``init_noise``,
``sweep_noise``) serve test_torch_ar_trig.py and test_torch_monthly.py.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_state_blocks.py bench 1024 200 200 7

recomputes the reference numbers of chip_smoke.py's phase 10b: bsts_ar_trig
(a static intercept, an AR(2) and a trigonometric cycle of period 52.18 with
two harmonics, d = 7, on the committed weekly series) with
``marginal_sigma_slice=True, marginal_move="tim"``, x64 off as the bench
runs: the posterior medians, split R-hat and ESS per draw of the monitored
parameters.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boom_tpu.statespace import state_models as jsm
from boom_tpu.statespace.bsts import Bsts as JaxBsts
from boom_tpu_torch import data
from boom_tpu_torch.api import BstsModel
from boom_tpu_torch.convert import model_from_jax, state_from_numpy
from boom_tpu_torch.dists.truncated import TAIL_TRIPS
from boom_tpu_torch.statespace import state_models as psm
from boom_tpu_torch.statespace.bsts import ASIS_SHRINK, ASIS_SLICE_STEPS
from boom_tpu_torch.statespace.state_models import AR_CANDIDATES

torch.set_num_threads(1)

F64 = jnp.float64
TINY = np.finfo(np.float64).tiny
BLOCK_TOL, SWEEP_RTOL, RTOL = 1e-12, 1e-9, 1e-10
CHAINS, T_SMALL = 3, 60
AR_TRIG_MONITOR = ("sigsq_obs", "phi[0]", "phi[1]", "sigma_ar_sq",
                   "sigma_trig_sq")




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


def _trun_normal_noise(key):
    """The uniforms of the reference's ``trun_normal.sample(key, ...)`` of
    one value: the body's, then each of the tail's TAIL_TRIPS trips'."""
    k_body, k_tail = jax.random.split(key)
    trips = jax.vmap(jax.random.split)(jax.random.split(k_tail, TAIL_TRIPS))
    return {"phi_u": _uniform(k_body, TINY),
            "phi_tail_u1": jax.vmap(lambda k: _uniform(k, TINY))(
                trips[:, 0]),
            "phi_tail_u2": jax.vmap(lambda k: _uniform(k, TINY))(
                trips[:, 1])}


def block_noise(block, key, init):
    """The numbers a reference block of this slice (or the monthly cycle)
    draws from ``key``: ``init_params``' (``init``), else
    ``draw_params``'."""
    kind = type(block).__name__
    lo = None if init else TINY
    if kind == "StaticIntercept":
        return {}
    if kind in ("Trig", "MonthlyAnnualCycle"):
        name = "trig_u" if kind == "Trig" else "monthly_u"
        return {name: _uniform(key, lo)}
    if kind == "ArState":
        k1, k2 = jax.random.split(key)
        if init:
            return {"phi_u": _uniform(k1), "ar_u": _uniform(k2)}
        return {"phi_z": jax.vmap(lambda k: jax.random.normal(
                    k, (block.lags,), F64))(
                    jax.random.split(k1, AR_CANDIDATES)),
                "ar_u": _uniform(k2, TINY)}
    if kind == "SemilocalLinearTrend":
        k1, k2, k3 = jax.random.split(key, 3)
        if init:
            return {"level_u": _uniform(k1), "slope_u": _uniform(k2),
                    "phi_u": _uniform(k3)}
        return {"level_u": _uniform(k1, TINY), **_trun_normal_noise(k2),
                "slope_u": _uniform(k3, TINY)}
    # the blocks of earlier slices (test_torch_bsts_tv.py's)
    from test_torch_bsts_tv import block_noise as tv_block_noise
    return tv_block_noise(block, key, init)


def _smoother_normals(key, d, q, t_len):
    k0, ka, ke = jax.random.split(key, 3)
    return {"sim_alpha1": jax.random.normal(k0, (d,)),
            "sim_eta": jax.random.normal(ka, (t_len - 1, q)),
            "sim_eps": jax.random.normal(ke, (t_len,))}


def init_noise(model, key):
    """The numbers the reference's ``init_state`` draws from ``key`` (no
    regression)."""
    keys = jax.random.split(key, len(model.blocks) + 3)
    q = sum(b.err_dim for b in model.blocks)
    return {"blocks": {b.name: block_noise(b, k, True)
                       for b, k in zip(model.blocks, keys[3:])},
            "sig_u": _uniform(keys[1]),
            **_smoother_normals(keys[2], model.state_dim, q, model.t_len)}


def _slice_noise(key, shrink):
    parts = jax.random.split(key, 4)
    return (_uniform(parts[0], TINY), _uniform(parts[1]),
            jax.vmap(_uniform)(jax.random.split(parts[3], shrink)))


def sweep_noise(model, key):
    """The numbers one reference sweep draws from ``key`` (no regression):
    the observation variance's, the blocks', the smoother's, ASIS's
    (fold_in(key, 17), slice step j from fold_in(that, j)) and, with the
    marginal move, TIM's (fold_in(key, 977))."""
    k_state, k_obs, k_blocks = jax.random.split(key, 3)
    q = sum(b.err_dim for b in model.blocks)
    bkeys = jax.random.split(k_blocks, len(model.blocks))
    noise = {"obs_u": _uniform(k_obs, TINY),
             "blocks": {b.name: block_noise(b, k, False)
                        for b, k in zip(model.blocks, bkeys)},
             **_smoother_normals(k_state, model.state_dim, q, model.t_len)}
    n_groups = sum(len(b.asis_groups()) for b in model.blocks)
    k_asis = jax.random.fold_in(key, 17)
    per = [_slice_noise(jax.random.fold_in(k_asis, j), ASIS_SHRINK)
           for j in range(ASIS_SLICE_STEPS * n_groups)]
    for i, name in enumerate(("asis_h_u", "asis_u_u", "asis_shrink_u")):
        noise[name] = jnp.stack([u[i] for u in per]).reshape(
            1, ASIS_SLICE_STEPS, n_groups, *per[0][i].shape)
    if model.marginal_sigma_slice:
        from test_torch_tim import _tim_noise

        n_sigma = len(model._sigma_groups())
        noise.update(_tim_noise(key, model.marginal_tim_trials,
                                model.marginal_tim_df, n_sigma))
    return noise


def port_noise(fn, *args):
    return state_from_numpy(_numpy_tree(jax.jit(jax.vmap(fn))(*args)),
                            device="cpu")


def assert_states_close(port, ref, rtol, msg=""):
    ref = _numpy_tree(ref)
    _close(port["sigsq_obs"], ref["sigsq_obs"], rtol, msg=msg + "sigsq_obs")
    for name, params in ref["blocks"].items():
        assert set(port["blocks"][name]) == set(params), name
        for pname, v in params.items():
            _close(port["blocks"][name][pname], v, rtol, rtol,
                   msg=f"{msg}{name}.{pname}")
    _close(port["alpha"], ref["alpha"], rtol, rtol, msg=msg + "alpha")


# -- the blocks ---------------------------------------------------------------


def _series(t_len=T_SMALL):
    return np.asarray(data.bsts_ar_trig()["y"][:t_len], np.float64)


BLOCKS = {
    "static_intercept": lambda y: jsm.StaticIntercept.default(y),
    "trig": lambda y: jsm.Trig.default(y, period=data.BSTS_AR_TRIG_PERIOD,
                                       nfreq=2),
    "trig3": lambda y: jsm.Trig.default(y, period=12.0, nfreq=3),
    "ar1": lambda y: jsm.ArState.default(y, lags=1),
    "ar3": lambda y: jsm.ArState.default(y, lags=3),
    "semilocal": lambda y: jsm.SemilocalLinearTrend.default(y)}


def _pair(name):
    """(reference block, port block) on the AR-and-cycle series."""
    y = jnp.asarray(_series())
    jb = BLOCKS[name](y)
    jmodel = JaxBsts(y=y, blocks=[jb])
    return jb, model_from_jax(jmodel, device="cpu").blocks[0]


def _chain_params(jb, keys):
    return _numpy_tree(jax.vmap(jb.init_params)(keys))


def _port_params(params):
    return {k: torch.tensor(v) for k, v in params.items()}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_system_matches_reference(name):
    """z, T, R, Q of every chain's parameters and the initial distribution
    (a T a chain for the AR state and the semilocal trend)."""
    jb, b = _pair(name)
    keys = jax.random.split(jax.random.key(3), CHAINS)
    params = _chain_params(jb, keys)
    dev, dt = torch.device("cpu"), torch.float64
    _close(b.z(dev, dt), jb.z(), 1e-15)
    a0, p0 = b.init_dist(dev, dt)
    ja0, jp0 = jb.init_dist()
    _close(a0, ja0, 1e-15)
    _close(p0, jp0, 1e-15)
    if params:
        want = _numpy_tree(jax.vmap(jb.build)(jax.tree_util.tree_map(
            jnp.asarray, params)))
    else:  # the intercept: no parameter, the same system for every chain
        want = [np.broadcast_to(np.asarray(m), (CHAINS,) + m.shape)
                for m in jb.build({})]
    if hasattr(b, "chain_transition"):
        t_mat = b.chain_transition(_port_params(params))
        r_mat = b.selection(dev, dt).expand(CHAINS, -1, -1)
    else:
        t_mat, r_mat = (m.expand(CHAINS, *m.shape)
                        for m in b.transition(dev, dt))
    _close(t_mat, want[0], 1e-15, msg="T")
    _close(r_mat, want[1], 0.0, msg="R")
    q_mat = (b.variance(_port_params(params)) if b.err_dim
             else torch.zeros(CHAINS, 0, 0))
    assert tuple(q_mat.shape) == want[2].shape
    _close(q_mat, want[2], 1e-15, msg="Q")
    assert b.err_dim == jb.err_dim and b.dim == jb.dim
    assert b.asis_groups() == [
        (p, _port_prior(prior), dims) for p, prior, dims in jb.asis_groups()]


def _port_prior(prior):
    return psm.SdPrior(sigma_guess=float(prior.sigma_guess),
                       sample_size=float(prior.sample_size),
                       upper_limit=float(prior.upper_limit))


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_init_params_match_reference(name):
    jb, b = _pair(name)
    keys = jax.random.split(jax.random.key(4), CHAINS)
    want = _chain_params(jb, keys)
    noise = port_noise(lambda k: block_noise(jb, k, True), keys)
    assert set(noise) == set(b.init_noise_spec())
    got = b.init_params(noise)
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k], v, BLOCK_TOL, msg=k)


def _paths(name, dim, t_len, kind):
    """[C, T, dim] state paths a block's draw conditions on: "walk" random
    walks; "explosive", every coordinate's steps growing 6 % a step (the AR
    state's candidates then all fail the stationarity test and it halves
    phi; the semilocal trend's phi has its conditional past 1, which the
    truncated normal draws in its tail)."""
    rng = np.random.default_rng(len(name) * 7 + len(kind))
    steps = rng.normal(size=(CHAINS, t_len, dim))
    if kind == "explosive":
        growth = 1.06 ** np.arange(t_len)
        path = np.cumsum(steps * 0.01 + growth[None, :, None], axis=1)
        path = path * growth[None, :, None]
    else:
        path = np.cumsum(steps, axis=1)
    if name == "semilocal":
        path[..., 2] = path[:, :1, 2]  # D is static
    return path


@pytest.mark.parametrize("kind", ["walk", "explosive"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_draw_params_match_reference(name, kind):
    """The conjugate draws given a state path, on the reference's own
    numbers."""
    jb, b = _pair(name)
    keys = jax.random.split(jax.random.key(5), CHAINS)
    params = _chain_params(jb, jax.random.split(jax.random.key(6), CHAINS))
    path = _paths(name, jb.dim, T_SMALL, kind)
    want = _numpy_tree(jax.jit(jax.vmap(jb.draw_params))(
        keys, jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray(path)))
    noise = port_noise(lambda k: block_noise(jb, k, False), keys)
    assert set(noise) == set(b.noise_spec())
    got = b.draw_params(noise, _port_params(params), torch.tensor(path))
    assert set(got) == set(want)
    for k, v in want.items():
        # a variance's inverse-CDF draw carries PyTorch's incomplete gamma
        _close(got[k], v, SWEEP_RTOL if k.startswith("sigma") else BLOCK_TOL,
               msg=k)
    if name.startswith("ar") and kind == "explosive":
        _close(got["phi"], 0.5 * params["phi"], 0.0)
    if name == "semilocal" and kind == "explosive":
        assert bool((got["phi"] > 0.99).all())


@pytest.mark.parametrize("p", [1, 2, 3, 5])
def test_jury_stationarity_matches_reference(p):
    """The step-down test on phi near the stationary region's edge."""
    rng = np.random.default_rng(p)
    phi = rng.uniform(-1.6, 1.6, size=(400, p)) / np.sqrt(p)
    want = np.asarray(jax.vmap(jsm._jury_stationary)(jnp.asarray(phi)))
    got = psm._jury_stationary(torch.tensor(phi)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size
    # the roots' moduli say the same
    for row, ok in zip(phi[:50], got[:50]):
        roots = np.roots(np.concatenate([[1.0], -row]))
        assert ok == bool((np.abs(roots) < 1.0).all())


def test_builders_fit_the_ar_trig_model_on_the_cpu():
    """``add_static_intercept().add_ar(lags=2).add_trig(period, nfreq)`` with
    the TIM move: the reference's blocks and priors, finite draws."""
    from boom_tpu.api import BstsModel as JaxBstsModel

    y = _series(120)
    fit = (BstsModel().add_static_intercept().add_ar(lags=2)
           .add_trig(period=data.BSTS_AR_TRIG_PERIOD, nfreq=2)
           .fit(y, niter=4, burn=2, num_chains=3, seed=1, device="cpu",
                marginal_sigma_slice=True, marginal_move="tim"))
    jblocks = (JaxBstsModel().add_static_intercept().add_ar(lags=2)
               .add_trig(period=data.BSTS_AR_TRIG_PERIOD, nfreq=2)
               ._build_blocks(jnp.asarray(y)))
    model = fit._model
    for b, jb in zip(model.blocks, jblocks):
        assert b.name == jb.name and b.dim == jb.dim
        for pname, prior, _dims in jb.asis_groups():
            got = dict((p, pr) for p, pr, _d in b.asis_groups())[pname]
            assert got.sigma_guess == pytest.approx(
                float(prior.sigma_guess), rel=1e-12)
    d = fit.draws
    assert d["blocks"]["ar2"]["phi"].shape == (3, 4, 2)
    assert d["blocks"]["static_intercept"] == {}
    for leaf in (d["sigsq_obs"], d["blocks"]["trig"]["sigma_trig_sq"],
                 d["alpha"]):
        assert bool(torch.isfinite(leaf).all())
    ys = fit.predict(8, max_draws=6)
    assert ys.shape == (6, 8) and bool(torch.isfinite(ys).all())


def ar_trig_model(y, chains=1, **kw):
    """Phase 10b's reference model on ``y``, as the reference's
    ``BstsModel().add_static_intercept().add_ar(lags=2)
    .add_trig(period=52.18, nfreq=2)`` builds it, with the TIM move."""
    blocks = [jsm.StaticIntercept.default(y), jsm.ArState.default(y, lags=2),
              jsm.Trig.default(y, period=data.BSTS_AR_TRIG_PERIOD, nfreq=2)]
    kw.setdefault("marginal_sigma_slice", True)
    kw.setdefault("marginal_move", "tim")
    return JaxBsts(y=y, blocks=blocks, chains_hint=chains, **kw)


def ar_trig_monitor(d):
    """[chains, draws, 5] monitored parameters (AR_TRIG_MONITOR)."""
    b = d["blocks"]
    return np.stack([d["sigsq_obs"], b["ar2"]["phi"][..., 0],
                     b["ar2"]["phi"][..., 1], b["ar2"]["sigma_ar_sq"],
                     b["trig"]["sigma_trig_sq"]], -1)


def at_port_template(orig):
    """A reference block's ``init_params`` with the port's template phi
    (the AR state's at uniforms 1/2: phi = (0.4, 0, ...)), where the
    reference tailors its TIM proposal."""
    def init_params(self, key):
        out = dict(orig(self, key))
        if "phi" in out:
            out["phi"] = jnp.zeros_like(out["phi"]).at[0].set(0.4)
        return out
    return init_params


def port_template_proposal(y):
    """The reference's TIM proposal of phase 10b's model on ``y``, built as
    the port builds its own: at the port's template (at_port_template) and
    in float64."""
    orig = jsm.ArState.init_params
    jsm.ArState.init_params = at_port_template(orig)
    try:
        with jax.enable_x64(True):
            prop = ar_trig_model(jnp.asarray(y, jnp.float64))._tim_prop
    finally:
        jsm.ArState.init_params = orig
    return tuple(np.asarray(p, np.float64) for p in prop)


def reference(chains=1024, burn=200, draws=200, seed=7):
    """The JAX reference's bsts_ar_trig run on the committed data, x64 off,
    with the TIM proposal the port builds (port_template_proposal): the
    reference tailors its own at a random template phi, which the port
    cannot draw, and the chains mix slowly enough at this length that the
    medians follow the proposal. Medians, ESS per draw and R-hat of
    AR_TRIG_MONITOR, and the proposal."""
    from boom_tpu.inference import run_mcmc
    from boom_tpu_torch.inference import diagnostics

    y_np = data.bsts_ar_trig()["y"]
    prop = port_template_proposal(y_np)
    with jax.enable_x64(False):
        y = jnp.asarray(y_np, jnp.float32)
        jmodel = ar_trig_model(y, chains)
        object.__setattr__(jmodel, "_tim_prop", prop)

        def extract(s):
            return {"sigsq_obs": s["sigsq_obs"], "blocks": s["blocks"]}

        fit = jax.jit(lambda k: run_mcmc(
            k, jmodel.kernel(), jmodel.init_state, draws, num_chains=chains,
            burn=burn, jit=False, extract=extract).draws)
        d = jax.tree_util.tree_map(np.asarray, fit(jax.random.key(seed)))
    mon = ar_trig_monitor(d).astype(np.float64)
    ess = diagnostics.effective_sample_size(torch.tensor(mon)).numpy()
    rhat = diagnostics.potential_scale_reduction(torch.tensor(mon)).numpy()
    total = chains * draws
    return {"medians": dict(zip(AR_TRIG_MONITOR, np.median(
                mon.reshape(-1, len(AR_TRIG_MONITOR)), 0).tolist())),
            "ess_per_draw": (ess / total).tolist(),
            "min_ess_per_draw": float(ess.min() / total),
            "rhat": rhat.tolist(),
            "proposal": [p.tolist() for p in prop]}


if __name__ == "__main__" and sys.argv[1:2] == ["bench"]:
    import json

    print(json.dumps(reference(*map(int, sys.argv[2:]))))
