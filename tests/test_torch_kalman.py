"""The port's sequential Kalman filter, loglik and smoothers against the
JAX reference (boom_tpu/statespace/kalman.py), on the CPU in float64.

The reference runs one system; it is vmapped here over C random static
systems that share one series and one observed mask, and the port runs the
same C systems as its leading series axis. The smoothers' standard normals
are rebuilt from the reference's own keys (split into k0, ka, ke as its
``simulate`` and ``simulation_smoother`` split them). Both sides do the
same arithmetic in the same order, so they agree to rounding: rtol 1e-10.
``kalman_kernel``'s wrappers run the plain versions on CPU tensors; the
kernels themselves are checked on the card (test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boom_tpu.statespace import kalman as jk
from boom_tpu_torch.convert import ssm_params_from_numpy
from boom_tpu_torch.statespace import kalman, kalman_kernel
from boom_tpu_torch.statespace.bsts import Bsts
from boom_tpu_torch.statespace.state_models import LocalLinearTrend

torch.set_num_threads(1)

RTOL = 1e-10
C, T_LEN = 4, 64


def _systems(rng, c, d):
    """C stable static systems (spectral radius < 1) as stacked arrays."""
    def one():
        qm, _ = np.linalg.qr(rng.normal(size=(d, d)))
        lq = 0.3 * rng.normal(size=(d, d))
        mp = rng.normal(size=(d, d))
        return dict(z=rng.normal(size=d),
                    t_mat=qm @ np.diag(rng.uniform(0.5, 0.97, d)) @ qm.T,
                    r_mat=np.eye(d), q_mat=lq @ lq.T + 0.1 * np.eye(d),
                    h=np.asarray(rng.uniform(0.3, 1.0)),
                    a0=rng.normal(size=d), p0=mp @ mp.T + np.eye(d))

    systems = [one() for _ in range(c)]
    return {k: np.stack([s[k] for s in systems]) for k in systems[0]}


def _normals(key, d, t_len):
    k0, ka, ke = jax.random.split(key, 3)
    return (jax.random.normal(k0, (d,)), jax.random.normal(ka, (t_len - 1, d)),
            jax.random.normal(ke, (t_len,)))


@pytest.fixture(scope="module", params=[(d, m) for d in (1, 2, 3)
                                        for m in (False, True)],
                ids=lambda p: f"d{p[0]}-{'masked' if p[1] else 'dense'}")
def case(request):
    """Inputs and every reference output for one (d, mask) case, from one
    compiled program."""
    d, masked = request.param
    rng = np.random.default_rng(100 * d + masked)
    fields = _systems(rng, C, d)
    y = rng.normal(size=T_LEN).cumsum()
    observed = (rng.uniform(size=T_LEN) > 0.25 if masked
                else np.ones(T_LEN, bool))
    keys = jax.random.split(jax.random.key(7 + d), C)

    def ref_one(p, key):
        params = jk.SsmParams(**p)
        filt = jk.kalman_filter(params, y, observed)
        return {"filter": filt,
                "loglik": jk.kalman_loglik(params, y, observed),
                "fast": jk.fast_state_smoother(params, filt, observed),
                "smooth": jk.smooth_states(params, y, observed),
                "simulate": jk.simulate(key, params, T_LEN),
                "simsmooth": jk.simulation_smoother(key, params, y,
                                                    observed),
                "normals": _normals(key, d, T_LEN)}

    ref = jax.jit(jax.vmap(ref_one))(
        {k: jnp.asarray(v) for k, v in fields.items()}, keys)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    return {"params": ssm_params_from_numpy(fields, device="cpu"),
            "y": torch.tensor(y), "observed": torch.tensor(observed),
            "normals": [torch.tensor(n) for n in ref["normals"]],
            "ref": ref}


def _close(port, ref, rtol=RTOL):
    port = port.detach().numpy()
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def test_kalman_filter_matches_reference(case):
    out = kalman.kalman_filter(case["params"], case["y"], case["observed"])
    ref = case["ref"]["filter"]
    for name in ("loglik", "v", "f", "k", "a", "p"):
        _close(getattr(out, name), getattr(ref, name))


@pytest.mark.parametrize("fn", [kalman.kalman_loglik,
                                kalman_kernel.kalman_loglik],
                         ids=["plain", "wrapper"])
def test_kalman_loglik_matches_reference(case, fn):
    _close(fn(case["params"], case["y"], case["observed"]),
           case["ref"]["loglik"])


def test_state_smoothers_match_reference(case):
    params, y, obs = case["params"], case["y"], case["observed"]
    _close(kalman.fast_state_smoother(
        params, kalman.kalman_filter(params, y, obs), obs),
        case["ref"]["fast"])
    _close(kalman.smooth_states(params, y, obs), case["ref"]["smooth"])


def test_simulate_matches_reference(case):
    alphas, y_sim = kalman.simulate(case["params"], T_LEN, *case["normals"])
    ref_alpha, ref_y = case["ref"]["simulate"]
    _close(alphas, ref_alpha)
    _close(y_sim, ref_y)


@pytest.mark.parametrize("fn", [kalman.simulation_smoother,
                                kalman_kernel.simulation_smoother],
                         ids=["plain", "wrapper"])
def test_simulation_smoother_matches_reference(case, fn):
    out = fn(case["params"], case["y"], *case["normals"],
             observed=case["observed"])
    _close(out, case["ref"]["simsmooth"])


def test_loglik_derivatives_match_reference():
    """Gradient and Hessian of the loglik in the log variances (what the
    TIM mode search differentiates): autograd of the plain version against
    jax.grad / jax.hessian of the reference."""
    rng = np.random.default_rng(3)
    fields = {k: v[0] for k, v in _systems(rng, 1, 2).items()}
    y = rng.normal(size=48).cumsum()
    u0 = np.log([0.2, 0.05, 0.5])

    def ref_f(u):
        p = dict(fields, q_mat=jnp.diag(jnp.exp(u[:2])), h=jnp.exp(u[2]))
        return jk.kalman_loglik(jk.SsmParams(**p), y)

    base = ssm_params_from_numpy({k: v[None] for k, v in fields.items()},
                                 device="cpu")

    def port_f(u):
        p = base._replace(q_mat=torch.diag_embed(torch.exp(u[:2]))[None],
                          h=torch.exp(u[2:]))
        return kalman_kernel.kalman_loglik(p, torch.tensor(y))[0]

    u = torch.tensor(u0, requires_grad=True)
    (grad,) = torch.autograd.grad(port_f(u), u)
    hess = torch.autograd.functional.hessian(port_f, torch.tensor(u0))
    ref_g = np.asarray(jax.grad(ref_f)(jnp.asarray(u0)))
    ref_h = np.asarray(jax.hessian(ref_f)(jnp.asarray(u0)))
    _close(grad, ref_g, rtol=1e-9)
    _close(hess, ref_h, rtol=1e-9)


@pytest.mark.parametrize("d, masked", [(1, False), (2, False), (2, True)])
def test_loglik_autograd_launches_j1_then_j2(monkeypatch, d, masked):
    """The routing of ``loglik_along``'s ``autograd.Function`` on the card,
    with ``_on_card`` and the launches stubbed by the plain loop (K1 by
    ``kalman.kalman_loglik``, J1 and J2 by ``kalman.loglik_jets``), in the
    log variances (directions: Q's diagonal, then h): a value under no_grad
    launches K1; ``torch.autograd.grad`` J1 alone; a Hessian J1, then J2 in
    the backward pass that builds a graph. Both derivatives are autograd of
    the plain loop's to 1e-12. ``kalman_loglik`` itself gives no
    derivatives on the card."""
    launched = []

    def plain_launch(h, rqr, z, t_mat, a0, p0, y, observed):
        launched.append("loglik")
        eye = torch.eye(z.shape[-1], dtype=h.dtype).expand_as(rqr)
        return kalman.kalman_loglik(kalman.SsmParams(z, t_mat, eye, rqr, h,
                                                     a0, p0), y, observed)

    def plain_jets(*fields, order):
        launched.append(kalman_kernel.JET_KINDS[order])
        return kalman.loglik_jets(*fields, order)

    monkeypatch.setattr(kalman_kernel, "_on_card", lambda x: True)
    monkeypatch.setattr(kalman_kernel, "launch_loglik", plain_launch)
    monkeypatch.setattr(kalman_kernel, "launch_jets", plain_jets)
    rng = np.random.default_rng(6 + d)
    base = ssm_params_from_numpy(_systems(rng, 1, d), device="cpu")
    y = torch.tensor(rng.normal(size=40).cumsum())
    obs = torch.tensor(rng.uniform(size=40) > 0.3) if masked else None
    dh = torch.eye(d + 1, dtype=torch.float64)[d]
    dm = torch.zeros(d + 1, d, d, dtype=torch.float64)
    dm[:d] = torch.diag_embed(torch.eye(d, dtype=torch.float64))
    h0, q0 = torch.zeros(1, dtype=torch.float64), 0.0 * dm[:1]

    def lp(fn, u):
        return fn(torch.exp(u)[None], h0, q0, dh, dm, base.z, base.t_mat,
                  base.a0, base.p0, y, obs)[0]

    u0 = torch.linspace(-1.0, 0.4, d + 1, dtype=torch.float64)
    with torch.no_grad():
        value = lp(kalman_kernel.loglik_along, u0)
    assert launched == ["loglik"]
    u = u0.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(lp(kalman_kernel.loglik_along, u), u)
    assert launched[1:] == ["loglik_grad"]
    hess = torch.autograd.functional.hessian(
        lambda x: lp(kalman_kernel.loglik_along, x), u0)
    assert launched[2:] == ["loglik_grad", "loglik_hess"]

    u = u0.clone().requires_grad_(True)
    (ref_grad,) = torch.autograd.grad(lp(kalman.loglik_along, u), u)
    ref_hess = torch.autograd.functional.hessian(
        lambda x: lp(kalman.loglik_along, x), u0)
    _close(value, lp(kalman.loglik_along, u0).detach().numpy(),
           rtol=1e-12)
    _close(grad, ref_grad.numpy(), rtol=1e-12)
    _close(hess, ref_hess.numpy(), rtol=1e-12)
    with pytest.raises(NotImplementedError, match="loglik_along"):
        kalman_kernel.kalman_loglik(
            base._replace(h=base.h.clone().requires_grad_(True)), y)


def test_time_varying_systems_raise():
    """What the port does not take of the time-varying systems raises,
    naming its ROADMAP item: a z [B, T, d] that differs by system (the
    regression holiday's; one z_t for every system is taken,
    test_torch_tv_kalman.py)."""
    rng = np.random.default_rng(4)
    params = ssm_params_from_numpy(_systems(rng, 2, 2), device="cpu")
    y = torch.zeros(5, dtype=torch.float64)
    tv = params._replace(z=params.z[:, None].expand(2, 5, 2).contiguous())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kalman.kalman_loglik(tv, y)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kalman_kernel.simulation_smoother(
            tv, y, torch.zeros(2, 2), torch.zeros(2, 4, 2), torch.zeros(2, 5))


@pytest.mark.parametrize("mode", ["auto", False])
def test_cpu_dispatch_picks_the_sequential_smoother(mode):
    """On the CPU "auto" (whatever the shape) and False run the sequential
    smoother: K2's wrapper, which runs its plain version on a CPU tensor."""
    rng = np.random.default_rng(5)
    y = torch.tensor(rng.normal(size=600).cumsum())
    model = Bsts(y=y, blocks=[LocalLinearTrend.default(y)],
                 parallel_smoother=mode, chains_hint=2)
    assert model._smoother() is kalman_kernel.simulation_smoother
    before = dict(kalman_kernel.LAUNCHES)
    state = model.init_state(model.draw_init_noise(
        torch.Generator().manual_seed(0), 2))
    assert state["alpha"].shape == (2, 600, 2)
    assert bool(torch.isfinite(state["alpha"]).all())
    assert kalman_kernel.LAUNCHES == before  # no kernel ran on the CPU
