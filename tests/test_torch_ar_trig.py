"""Phase 10b's model in the port against the JAX reference (float64,
CPU): a static intercept, an AR(2) whose T is each chain's and a
two-harmonic trigonometric cycle (d = 7) with the TIM move, on the first
weeks of the committed series, on the reference's own random numbers
(test_torch_state_blocks.py's helpers):

- ``init_state``, ``ssm_params`` (T a chain, R with the intercept's empty
  error block) and one whole sweep of 3 chains at 1e-9 (the variance draws
  inherit PyTorch's ~1e-10 relative error of the incomplete gamma), and
  ``log_lik`` at 1e-10;
- the TIM proposal (mode 1e-6, Cholesky factor 1e-4, as
  test_torch_tim_reg.py: the two mode searches differentiate different
  code), tailored at the port's template chain: each block's
  ``init_params`` at uniforms 1/2, the AR state's phi (0.4, 0), which the
  reference's proposal is given here in place of its own random one.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boom_tpu.statespace import state_models as jsm
from boom_tpu_torch.convert import model_from_jax, state_from_numpy
from test_torch_state_blocks import (
    CHAINS,
    RTOL,
    SWEEP_RTOL,
    _close,
    _numpy_tree,
    _series,
    ar_trig_model,
    assert_states_close,
    at_port_template,
    init_noise,
    port_noise,
    sweep_noise,
)

torch.set_num_threads(1)


SWEEP_KEYS = jax.random.split(jax.random.key(13), CHAINS)


@pytest.fixture(scope="module")
def ar_trig_ref():
    """Phase 10b's reference model on the series' first weeks, its TIM
    proposal built at the port's template (the AR state's init_params
    replaced while it builds, restored after), its chains' initial states
    and the states after one sweep with the move; and the port's model
    (its own proposal built). The programs' compiling is the costly part,
    so the tests share them."""
    y = jnp.asarray(_series())
    orig = jsm.ArState.init_params
    jsm.ArState.init_params = at_port_template(orig)
    try:
        jmodel = ar_trig_model(y, CHAINS, parallel_smoother=False)
    finally:
        jsm.ArState.init_params = orig
    keys = jax.random.split(jax.random.key(12), CHAINS)
    state0 = jax.jit(jax.vmap(jmodel.init_state))(keys)
    swept = jax.jit(jax.vmap(jmodel.kernel()))(SWEEP_KEYS, state0)
    return jmodel, keys, state0, swept, model_from_jax(jmodel, device="cpu")


def test_ar_trig_init_state_matches_reference(ar_trig_ref):
    jmodel, keys, ref, _swept, model = ar_trig_ref
    assert model.state_dim == 7 and not model.time_varying
    assert model._chain_t and model._transition[0] is None
    noise = port_noise(lambda k: init_noise(jmodel, k), keys)
    assert_states_close(model.init_state(noise), ref, SWEEP_RTOL)


def test_ar_trig_ssm_params_match_reference(ar_trig_ref):
    """T a chain (each chain's phi), R and Q with the intercept's empty
    error block, z, a0 and P0."""
    jmodel, _keys, state0, _swept, model = ar_trig_ref
    got = model.ssm_params(state_from_numpy(_numpy_tree(state0),
                                            device="cpu"))
    want = _numpy_tree(jax.vmap(jmodel.ssm_params)(state0))
    for name in ("z", "t_mat", "r_mat", "q_mat", "a0", "p0"):
        _close(getattr(got, name), getattr(want, name), 1e-15, msg=name)
    assert got.t_mat.stride(0) != 0 and got.r_mat.stride(0) == 0
    assert got.r_mat.shape == (CHAINS, 7, 5)


def test_ar_trig_sweep_matches_reference(ar_trig_ref):
    """One whole sweep with the TIM move (the reference's proposal): the
    observation variance, the intercept (nothing), the AR state's phi and
    variance, the cycle's variance, the smoother with each chain's T, ASIS
    (the AR and cycle groups; K3's plain version with a T a chain) and the
    move over the three variances."""
    jmodel, _keys, state0, ref, model = ar_trig_ref
    model = copy.copy(model)
    object.__setattr__(model, "_tim_prop", tuple(
        torch.tensor(np.asarray(p)) for p in jmodel._tim_prop))
    noise = port_noise(lambda k: sweep_noise(jmodel, k), SWEEP_KEYS)
    spec = model.noise_spec()
    assert set(noise) == set(spec)
    for name, sub in spec["blocks"].items():
        assert set(noise["blocks"][name]) == set(sub), name
    out = model.kernel()(noise, state_from_numpy(_numpy_tree(state0),
                                                 device="cpu"))
    assert_states_close(out, ref, SWEEP_RTOL)
    assert not np.allclose(out["blocks"]["ar2"]["phi"].numpy(),
                           np.asarray(state0["blocks"]["ar2"]["phi"]))


def test_ar_trig_log_lik_matches_reference(ar_trig_ref):
    jmodel, _keys, _state0, swept, model = ar_trig_ref
    state = state_from_numpy(_numpy_tree(swept), device="cpu")
    _close(model.log_lik(state), jax.vmap(jmodel.log_lik)(swept), RTOL)


def test_ar_trig_tim_proposal_matches_reference(ar_trig_ref):
    """The TIM proposal (BFGS then Newton to the mode, the Laplace Hessian
    eigen-clamped and inflated) over the AR and cycle variances and the
    observation variance, each chain's T the template's, against the
    reference's tailored at the same template."""
    jmodel, _keys, _state0, _swept, model = ar_trig_ref
    mode, chol = model._tim_prop
    ref_mode, ref_chol = (np.asarray(p) for p in jmodel._tim_prop)
    assert mode.shape == ref_mode.shape == (3,)
    _close(mode, ref_mode, 1e-6)
    _close(chol, ref_chol, 1e-4, 1e-10)
    assert bool((torch.diagonal(chol) > 0).all())
