"""The port's bsts Gibbs sweep against the JAX reference.

The reference ``Bsts`` (``parallel_smoother=True``: the plain
associative-scan smoother) is vmapped over chain keys; the port runs the
same model, converted by ``boom_tpu_torch.convert``, with
``parallel_smoother="pallas"``, which on a CPU tensor runs the scan
kernel's plain version. The port's ``noise`` mapping is rebuilt here from
the reference's own keys, split and folded in the reference's order, so
both sides draw with the same numbers (float64, CPU). Tolerance rtol 1e-7:
the Newton polish of the variance draws inherits PyTorch's ~1e-9 relative
error of the incomplete gamma (see test_torch_dists_diag.py), and the
slice arithmetic carries it on.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boom_tpu.statespace.bsts import Bsts as JaxBsts
from boom_tpu.statespace.state_models import (
    LocalLevel as JaxLocalLevel,
    LocalLinearTrend as JaxLocalLinearTrend,
)
from boom_tpu_torch.api import BstsModel
from boom_tpu_torch.convert import model_from_jax, state_from_numpy
from boom_tpu_torch.statespace import kalman_kernel, parallel_kalman
from boom_tpu_torch.statespace import scan_kernel
from boom_tpu_torch.statespace.bsts import ASIS_SHRINK, ASIS_SLICE_STEPS, Bsts
from boom_tpu_torch.statespace.state_models import LocalLinearTrend

torch.set_num_threads(1)

RTOL = 1e-7
CHAINS, T_LEN = 4, 64
TINY = np.finfo(np.float64).tiny
F64 = jnp.float64


def _llt_series(t_len=T_LEN, seed=4207):
    """A local-linear-trend series (slope sd 0.02, level sd 0.3, obs sd
    0.5), as the reference's bench makes it, drawn with numpy."""
    rng = np.random.default_rng(seed)
    slope = np.cumsum(0.02 * rng.normal(size=t_len))
    level = np.cumsum(slope + 0.3 * rng.normal(size=t_len)) + 5.0
    return level + 0.5 * rng.normal(size=t_len)


def _uniform(key, minval=None):
    if minval is None:
        return jax.random.uniform(key, (), F64)
    return jax.random.uniform(key, (), F64, minval=minval)


def _smoother_normals(key, d, q, t_len):
    k0, ka, ke = jax.random.split(key, 3)
    return {"sim_alpha1": jax.random.normal(k0, (d,)),
            "sim_eta": jax.random.normal(ka, (t_len - 1, q)),
            "sim_eps": jax.random.normal(ke, (t_len,))}


def _block_init_noise(block, key):
    if isinstance(block, JaxLocalLevel):
        return {"level_u": _uniform(key)}
    k1, k2 = jax.random.split(key)
    return {"level_u": _uniform(k1), "slope_u": _uniform(k2)}


def _init_noise(model, key):
    """The numbers the reference's ``init_state`` draws from ``key``."""
    keys = jax.random.split(key, len(model.blocks) + 3)
    q = sum(b.err_dim for b in model.blocks)
    return {"blocks": {b.name: _block_init_noise(b, k)
                       for b, k in zip(model.blocks, keys[3:])},
            "sig_u": _uniform(keys[1]),
            **_smoother_normals(keys[2], model.state_dim, q, model.t_len)}


def _block_noise(block, key):
    if isinstance(block, JaxLocalLevel):
        return {"level_u": _uniform(key, TINY)}
    k1, k2 = jax.random.split(key)
    return {"level_u": _uniform(k1, TINY), "slope_u": _uniform(k2, TINY)}


def _slice_uniforms(k_asis, n_keys):
    """The uniforms of ``n_keys`` ASIS slice steps: step j draws from
    fold_in(k_asis, j), split into (height, offset, unused, shrink)."""
    gks = jax.vmap(lambda j: jax.random.fold_in(k_asis, j))(
        jnp.arange(n_keys))
    parts = jax.vmap(lambda g: jax.random.split(g, 4))(gks)
    shrink = jax.vmap(lambda k: jax.vmap(_uniform)(
        jax.random.split(k, ASIS_SHRINK)))(parts[:, 3])
    return (jax.vmap(lambda k: _uniform(k, TINY))(parts[:, 0]),
            jax.vmap(_uniform)(parts[:, 1]), shrink)


def _sweep_noise(model, key):
    """The numbers one reference sweep draws from ``key``: its 3-way split
    (state, observation, blocks), then fold_in(key, 17 + pass) for ASIS and
    fold_in(that, round * groups + group) for each slice step."""
    k_state, k_obs, k_blocks = jax.random.split(key, 3)
    q = sum(b.err_dim for b in model.blocks)
    n_groups = sum(len(b.asis_groups()) for b in model.blocks)
    bkeys = jax.random.split(k_blocks, len(model.blocks))
    noise = {"obs_u": _uniform(k_obs, TINY),
             "blocks": {b.name: _block_noise(b, k)
                        for b, k in zip(model.blocks, bkeys)},
             **_smoother_normals(k_state, model.state_dim, q, model.t_len)}
    passes = [_slice_uniforms(jax.random.fold_in(key, 17 + i),
                              ASIS_SLICE_STEPS * n_groups)
              for i in range(model.asis_passes)]
    rounds = (model.asis_passes, ASIS_SLICE_STEPS, n_groups)
    for j, name in enumerate(("asis_h_u", "asis_u_u", "asis_shrink_u")):
        stacked = jnp.stack([p[j] for p in passes])
        noise[name] = stacked.reshape(*rounds, *stacked.shape[2:])
    return noise


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_states_close(port, ref, rtol=RTOL):
    ref = _numpy_tree(ref)
    np.testing.assert_allclose(port["sigsq_obs"].numpy(), ref["sigsq_obs"],
                               rtol=rtol)
    for name, params in ref["blocks"].items():
        for pname, v in params.items():
            np.testing.assert_allclose(port["blocks"][name][pname].numpy(),
                                       v, rtol=rtol, err_msg=pname)
    np.testing.assert_allclose(port["alpha"].numpy(), ref["alpha"],
                               rtol=rtol, atol=rtol)


def _jax_model(kind, **kw):
    y = jnp.asarray(_llt_series())
    block = {"llt": JaxLocalLinearTrend, "level": JaxLocalLevel}[kind]
    return JaxBsts(y=y, blocks=[block.default(y)], parallel_smoother=True,
                   **kw)


SWEEP_KEYS = jax.random.split(jax.random.key(13), CHAINS)


@pytest.fixture(scope="module", params=["llt", "level"])
def reference(request):
    """A reference model, its chains' initial states (from ``keys``) and
    the states after one reference sweep (from ``SWEEP_KEYS``); compiling
    the reference's programs is the costly part, so both tests share it."""
    jmodel = _jax_model(request.param)
    keys = jax.random.split(jax.random.key(12), CHAINS)
    state0 = jax.jit(jax.vmap(jmodel.init_state))(keys)
    swept = jax.jit(jax.vmap(jmodel.kernel()))(SWEEP_KEYS, state0)
    return jmodel, keys, state0, swept


def test_init_state_matches_reference(reference):
    jmodel, keys, ref, _swept = reference
    model = model_from_jax(jmodel, device="cpu", parallel_smoother="pallas")
    noise = state_from_numpy(_numpy_tree(jax.jit(jax.vmap(
        lambda k: _init_noise(jmodel, k)))(keys)), device="cpu")
    _assert_states_close(model.init_state(noise), ref, rtol=1e-9)


def test_sweep_matches_reference(reference):
    """One whole Gibbs sweep: observation variance, block variances, the
    simulation smoother and the ASIS redraw."""
    jmodel, _keys, state0, ref = reference
    model = model_from_jax(jmodel, device="cpu", parallel_smoother="pallas")
    noise = state_from_numpy(_numpy_tree(jax.jit(jax.vmap(
        lambda k: _sweep_noise(jmodel, k)))(SWEEP_KEYS)), device="cpu")
    out = model.kernel()(noise, state_from_numpy(_numpy_tree(state0),
                                                 device="cpu"))
    _assert_states_close(out, ref)
    # the sweep moved every variance
    for name, params in out["blocks"].items():
        for pname, v in params.items():
            assert not np.allclose(v.numpy(), np.asarray(
                state0["blocks"][name][pname]))


def test_model_from_jax_carries_the_spec():
    jmodel = _jax_model("llt", asis_passes=2, chains_hint=3,
                        marginal_tim_trials=8, marginal_slice_period=2)
    model = model_from_jax(jmodel, device="cpu")
    assert model.parallel_smoother is True and model.asis_passes == 2
    assert model.chains_hint == 3
    assert (model.marginal_tim_trials, model.marginal_slice_period) == (8, 2)
    assert model.marginal_move == "tim" and not model.marginal_sigma_slice
    assert model.obs_prior.sigma_guess == pytest.approx(
        float(jmodel.obs_prior.sigma_guess), rel=1e-15)
    jb, b = jmodel.blocks[0], model.blocks[0]
    assert b.level_prior.upper_limit == pytest.approx(
        float(jb.level_prior.upper_limit), rel=1e-15)
    assert b.initial_level_mean == pytest.approx(float(jb.initial_level_mean))
    np.testing.assert_array_equal(model.y.numpy(), np.asarray(jmodel.y))


def test_defaults_use_population_sd():
    """The default priors read std(y) with ddof=0, as the reference."""
    y = torch.tensor(_llt_series())
    model = Bsts(y=y, blocks=[LocalLinearTrend.default(y)])
    sd = float(np.std(_llt_series()))
    assert model.obs_prior.sigma_guess == pytest.approx(0.5 * sd, rel=1e-14)
    assert model.blocks[0].level_prior.upper_limit == pytest.approx(
        sd, rel=1e-14)


def test_asis_redraw_at_d2_takes_the_sequential_dpath(monkeypatch):
    """The ASIS redraw of bsts_llt's model (d = 2, the level and slope
    groups) runs its D-paths through ``kalman.dpath``, the reference's
    sequential recurrence (K3's plain version; kernel (c)'s affine scan is
    not called), and matches the reference's redraw on the same noise."""
    from boom_tpu.statespace import bsts as jbsts
    from boom_tpu_torch.statespace import bsts as pbsts
    from boom_tpu_torch.statespace import kalman

    jmodel = _jax_model("llt")
    model = model_from_jax(jmodel, device="cpu")
    rng = np.random.default_rng(41)
    c, t_len, d = CHAINS, jmodel.t_len, jmodel.state_dim
    assert d == 2
    state = {"blocks": {"trend": {
                 "sigma_level_sq": rng.uniform(0.05, 0.2, c),
                 "sigma_slope_sq": rng.uniform(1e-4, 1e-3, c)}},
             "sigsq_obs": rng.uniform(0.2, 0.4, c),
             "alpha": rng.normal(size=(c, t_len, d)).cumsum(1) * 0.3}
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    keys = jax.random.split(jax.random.key(43), c)

    def ref_one(k, st):
        return jbsts.asis_redraw(k, jmodel.blocks, jmodel.ssm_params(st), st,
                                 jmodel.y, st["sigsq_obs"])

    want = _numpy_tree(jax.jit(jax.vmap(ref_one))(keys, jstate))
    uniforms = _numpy_tree(jax.jit(jax.vmap(
        lambda k: _slice_uniforms(k, ASIS_SLICE_STEPS * 2)))(keys))
    noise = {name: torch.tensor(u).reshape(c, ASIS_SLICE_STEPS, 2,
                                           *u.shape[2:])
             for name, u in zip(("h_u", "u_u", "shrink_u"), uniforms)}
    calls = []
    plain = kalman.dpath
    monkeypatch.setattr(kalman, "dpath",
                        lambda t, w: calls.append(w.shape) or plain(t, w))

    def no_scan(*args):
        raise AssertionError("the ASIS D-path ran kernel (c)'s affine scan")

    monkeypatch.setattr(scan_kernel, "affine_prefix", no_scan)
    pstate = state_from_numpy(state, device="cpu")
    before = dict(kalman_kernel.LAUNCHES)
    got = pbsts.asis_redraw(noise, model.blocks, model.ssm_params(pstate),
                            pstate, model.y, pstate["sigsq_obs"])
    assert calls == [(c, 2, t_len - 1, d)]
    assert kalman_kernel.LAUNCHES == before  # no kernel ran on the CPU
    np.testing.assert_allclose(got["alpha"].numpy(), want["alpha"],
                               rtol=RTOL, atol=RTOL)
    for pname, v in want["blocks"]["trend"].items():
        np.testing.assert_allclose(got["blocks"]["trend"][pname].numpy(), v,
                                   rtol=RTOL, err_msg=pname)


def test_smoother_dispatch():
    y = torch.tensor(_llt_series())
    blocks = [LocalLinearTrend.default(y)]
    assert (Bsts(y=y, blocks=blocks, parallel_smoother="pallas")._smoother()
            is scan_kernel.simulation_smoother)
    assert (Bsts(y=y, blocks=blocks, parallel_smoother=True)._smoother()
            is parallel_kalman.parallel_simulation_smoother)
    # "auto" on the CPU, and False, pick the sequential smoother (K2's
    # wrapper, which runs its plain version on a CPU tensor)
    for mode in ("auto", False):
        assert (Bsts(y=y, blocks=blocks, parallel_smoother=mode)._smoother()
                is kalman_kernel.simulation_smoother)


@pytest.mark.parametrize("option", [
    {"obs_weights": torch.ones(T_LEN)},
    {"observed": torch.ones(T_LEN, dtype=torch.bool)},
    {"marginal_sigma_slice": True, "marginal_move": "mtm"},
])
def test_unported_options_raise(option):
    y = torch.tensor(_llt_series())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Bsts(y=y, blocks=[LocalLinearTrend.default(y)], **option)


def test_fit_on_cpu_gives_finite_draws_of_the_right_shape():
    y = _llt_series()
    fit = BstsModel().add_local_linear_trend().fit(
        y, niter=12, burn=4, num_chains=3, seed=1, device="cpu",
        parallel_smoother="pallas")
    assert fit._model.chains_hint == 3
    draws = fit.draws
    assert draws["alpha"].shape == (3, 12, T_LEN, 2)
    assert draws["alpha"].dtype == torch.float64
    trend = draws["blocks"]["trend"]
    for v in (draws["sigsq_obs"], trend["sigma_level_sq"],
              trend["sigma_slope_sq"]):
        assert v.shape == (3, 12)
        assert bool(torch.isfinite(v).all()) and bool((v > 0).all())
    assert bool(torch.isfinite(draws["alpha"]).all())
    # same seed, same draws
    again = BstsModel().add_local_linear_trend().fit(
        y, niter=12, burn=4, num_chains=3, seed=1, device="cpu",
        parallel_smoother="pallas")
    assert torch.equal(again.draws["sigsq_obs"], draws["sigsq_obs"])


def test_fit_takes_the_reference_parameters_in_order():
    """BstsModel.fit's parameters are the reference's, in its order and
    with its defaults, then ``device`` and ``dtype``; ``timestamps`` raise
    naming their ROADMAP item."""
    from boom_tpu.api import BstsModel as JaxBstsModel

    ref = list(inspect.signature(JaxBstsModel.fit).parameters.values())
    port = list(inspect.signature(BstsModel.fit).parameters.values())
    named = [q for q in ref if q.kind is not q.VAR_KEYWORD]
    assert ref[-1].kind is ref[-1].VAR_KEYWORD
    assert ([(q.name, q.kind, q.default) for q in port[:len(named)]]
            == [(q.name, q.kind, q.default) for q in named])
    assert [q.name for q in port[len(named):-1]] == ["device", "dtype"]
    assert port[-1].kind is port[-1].VAR_KEYWORD
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 7"):
        BstsModel().add_local_linear_trend().fit(
            _llt_series(), niter=2, burn=1, num_chains=2, device="cpu",
            timestamps=np.arange(T_LEN))


def test_fit_defaults_to_the_card():
    """With no ``device`` the fit runs on the CUDA card; where there is none
    it raises instead of running on the CPU."""
    y = _llt_series()
    model = BstsModel().add_local_linear_trend()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.fit(y, niter=2, burn=1, num_chains=2)
        assert model._result is None
        return
    model.fit(y, niter=2, burn=1, num_chains=2, parallel_smoother="pallas")
    assert model.draws["alpha"].device.type == "cuda"


def test_smoother_computes_in_float64():
    """A float32 run imputes its state path with the smoother in float64:
    the draw is the float64 computation on the same (float32) inputs,
    rounded once to float32."""
    y = torch.tensor(_llt_series(200), dtype=torch.float32)
    narrow = Bsts(y=y, blocks=[LocalLinearTrend.default(y)],
                  parallel_smoother="pallas")
    wide = Bsts(y=y.double(), blocks=narrow.blocks,
                obs_prior=narrow.obs_prior, parallel_smoother="pallas")
    gen = torch.Generator().manual_seed(0)
    noise = narrow.draw_init_noise(gen, 2)
    state = {"blocks": {"trend": {
        "sigma_level_sq": torch.tensor([0.09, 0.2]),
        "sigma_slope_sq": torch.tensor([4e-4, 1e-3])}},
        "sigsq_obs": torch.tensor([0.25, 0.3])}
    draw = narrow._impute(narrow.ssm_params(state), noise)
    assert draw.dtype == torch.float32
    wide_state = {"blocks": {"trend": {
        k: v.double() for k, v in state["blocks"]["trend"].items()}},
        "sigsq_obs": state["sigsq_obs"].double()}
    wide_noise = {k: v.double() for k, v in noise.items()
                  if k.startswith("sim_")}
    expect = wide._impute(wide.ssm_params(wide_state), wide_noise)
    assert torch.equal(draw, expect.float())
