"""The port's plain Kalman filter, loglik and smoothers of a time-varying
system against the JAX reference (boom_tpu/statespace/kalman.py), on the
CPU in float64.

A time-varying system here is what bsts' blocks make: z_t [T, d] shared by
the systems (the dynamic regression's x_t), h_t = h h_scale_t (observation
weights) and Q_t = (q_t q_t') o Q with q_t a system (the Student trend's
weights) or shared (the holiday's refresh days), R a 0/1 selection. The
reference runs one system, vmapped over C; the port runs the C systems as
its leading axis, z expanded over them. The smoothers' standard normals
come from the reference's own keys (k0, ka, ke), which its ``simulate``
and its fused static path split alike, so the port's fused smoother and
the reference's simulate-then-smooth path draw with the same numbers: they
agree to rounding, rtol 1e-10. The reference's own Kalman-core cases of
``tests/test_state_models_tv.py`` follow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boom_tpu.statespace import kalman as jk
from boom_tpu_torch.statespace import kalman, kalman_kernel
from boom_tpu_torch.statespace.kalman import SsmParams

torch.set_num_threads(1)

RTOL = 1e-10
C, T_LEN = 4, 48


def _close(got, want, rtol=RTOL, atol=1e-12, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _tv_systems(rng, c, d, t_len, q_mode):
    """C stable systems with q = max(1, d - 1) errors (R the first q rows of
    the identity), z_t [T, d], h_scale [T] and q_scale (one a system, one
    for all, or none) as numpy arrays."""
    q = max(1, d - 1)

    def one():
        qm, _ = np.linalg.qr(rng.normal(size=(d, d)))
        lq = 0.3 * rng.normal(size=(q, q))
        mp = rng.normal(size=(d, d))
        return dict(t_mat=qm @ np.diag(rng.uniform(0.5, 0.97, d)) @ qm.T,
                    r_mat=np.eye(d, q), q_mat=lq @ lq.T + 0.1 * np.eye(q),
                    h=np.asarray(rng.uniform(0.3, 1.0)),
                    a0=rng.normal(size=d), p0=mp @ mp.T + np.eye(d))

    systems = [one() for _ in range(c)]
    fields = {k: np.stack([s[k] for s in systems]) for k in systems[0]}
    zt = rng.normal(size=(t_len, d))
    h_scale = rng.uniform(0.3, 1.5, size=t_len)
    q_scale = {None: None,
               "shared": np.broadcast_to(rng.uniform(0.5, 2.0, (t_len, q)),
                                         (c, t_len, q)),
               "chain": rng.uniform(0.5, 2.0, (c, t_len, q))}[q_mode]
    return fields, zt, h_scale, q_scale


def _port(fields, zt, h_scale, q_scale):
    p = {k: torch.tensor(v) for k, v in fields.items()}
    c, d = fields["a0"].shape
    return SsmParams(**p, z=torch.tensor(zt).expand(c, -1, -1),
                     h_scale=torch.tensor(h_scale),
                     q_scale=None if q_scale is None
                     else torch.tensor(np.ascontiguousarray(q_scale)))


def _reference(fields, zt, h_scale, q_scale):
    """The reference's systems, one a chain: z [T, d], h [T], q_scale."""
    out = dict(fields, z=np.broadcast_to(zt, (fields["h"].shape[0],) +
                                         zt.shape),
               h=fields["h"][:, None] * h_scale[None])
    if q_scale is not None:
        out["q_scale"] = np.asarray(q_scale)
    return out


CASES = [(2, "chain", True), (3, "shared", False), (1, None, True),
         (8, "chain", True)]


@pytest.fixture(scope="module", params=CASES,
                ids=lambda p: f"d{p[0]}-q{p[1]}-{'masked' if p[2] else 'dense'}")
def case(request):
    """Inputs and every reference output of one case, one program."""
    d, q_mode, masked = request.param
    rng = np.random.default_rng(10 * d + masked)
    fields, zt, h_scale, q_scale = _tv_systems(rng, C, d, T_LEN, q_mode)
    y = rng.normal(size=T_LEN).cumsum()
    observed = (rng.uniform(size=T_LEN) > 0.25 if masked
                else np.ones(T_LEN, bool))
    keys = jax.random.split(jax.random.key(3 + d), C)
    q = fields["q_mat"].shape[-1]

    def ref_one(p, key):
        params = jk.SsmParams(**p)
        filt = jk.kalman_filter(params, y, observed)
        k0, ka, ke = jax.random.split(key, 3)
        return {"filter": filt,
                "loglik": jk.kalman_loglik(params, y, observed),
                "fast": jk.fast_state_smoother(params, filt, observed),
                "smooth": jk.smooth_states(params, y, observed),
                "simulate": jk.simulate(key, params, T_LEN),
                "simsmooth": jk.simulation_smoother(key, params, y,
                                                    observed),
                "normals": (jax.random.normal(k0, (d,)),
                            jax.random.normal(ka, (T_LEN - 1, q)),
                            jax.random.normal(ke, (T_LEN,)))}

    ref = jax.jit(jax.vmap(ref_one))(
        {k: jnp.asarray(v) for k, v in
         _reference(fields, zt, h_scale, q_scale).items()}, keys)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    params = _port(fields, zt, h_scale, q_scale)
    return (params, torch.tensor(y), torch.tensor(observed), masked,
            ref)


def test_tv_system_is_time_varying(case):
    params, *_ = case
    assert params.time_varying
    assert params.zs(T_LEN).shape == (C, T_LEN, params.a0.shape[1])
    assert params.hs(T_LEN).shape == (C, T_LEN)
    assert params.rqrs(T_LEN).shape[:2] == (C, T_LEN)


def test_tv_filter_matches_reference(case):
    params, y, obs, _masked, ref = case
    got = kalman.kalman_filter(params, y, obs)
    for name in ("loglik", "v", "f", "k", "a", "p"):
        _close(getattr(got, name), getattr(ref["filter"], name), msg=name)


def test_tv_loglik_and_innovations_match_reference(case):
    params, y, obs, _masked, ref = case
    _close(kalman.kalman_loglik(params, y, obs), ref["loglik"])
    ll, v, f = kalman.kalman_loglik(params, y, obs, innovations=True)
    _close(v, ref["filter"].v)
    _close(f, ref["filter"].f)
    # the wrappers run the plain version on a CPU tensor
    _close(kalman_kernel.kalman_loglik(params, y, obs), ref["loglik"])
    v2, f2 = kalman_kernel.innovations(params, y, obs)
    assert torch.equal(v2, v) and torch.equal(f2, f)


def test_tv_state_smoothers_match_reference(case):
    params, y, obs, _masked, ref = case
    filt = kalman.kalman_filter(params, y, obs)
    _close(kalman.fast_state_smoother(params, filt, obs), ref["fast"])
    _close(kalman.smooth_states(params, y, obs), ref["smooth"])


def test_tv_simulate_matches_reference(case):
    params, _y, _obs, _masked, ref = case
    alphas, ys = kalman.simulate(params, T_LEN, *(torch.tensor(n) for n in
                                                  ref["normals"]))
    _close(alphas, ref["simulate"][0])
    _close(ys, ref["simulate"][1])


def test_tv_simulation_smoother_matches_reference(case):
    """The port's fused draw against the reference's simulate + smooth of
    y - y+ (its time-varying path), from the same normals."""
    params, y, obs, _masked, ref = case
    normals = [torch.tensor(n) for n in ref["normals"]]
    got = kalman.simulation_smoother(params, y, *normals, observed=obs)
    _close(got, ref["simsmooth"], atol=1e-10)
    before = dict(kalman_kernel.LAUNCHES)
    again = kalman_kernel.simulation_smoother(params, y, *normals,
                                              observed=obs)
    assert kalman_kernel.LAUNCHES == before  # no kernel ran on the CPU
    assert torch.equal(again, got)


def test_time_varying_operands_are_the_kernels_streams():
    """u_t = R q_t of a selection R, z one row, h_scale as it is; a shared
    q_scale with a shared R gives one row of u."""
    rng = np.random.default_rng(5)
    fields, zt, h_scale, q_scale = _tv_systems(rng, 3, 4, 9, "chain")
    params = _port(fields, zt, h_scale, q_scale)
    z, hs, u, stride = kalman_kernel.time_varying_operands(
        params, 9, torch.float64, torch.device("cpu"))
    assert torch.equal(z, torch.tensor(zt)) and torch.equal(
        hs, torch.tensor(h_scale))
    assert stride == 9 * 4 and u.shape == (3, 9, 4)
    want = np.concatenate([q_scale, np.zeros((3, 9, 1))], -1)
    np.testing.assert_array_equal(u.numpy(), want)
    # R Q_t R' = (u_t u_t') o R Q R' entry by entry
    rq = params.rqr[:, None] * (u[..., :, None] * u[..., None, :])
    np.testing.assert_array_equal(rq.numpy(), params.rqrs(9).numpy())
    one = params._replace(
        q_scale=params.q_scale[:1].expand(3, -1, -1),
        r_mat=params.r_mat[:1].expand(3, -1, -1))
    assert kalman_kernel.time_varying_operands(
        one, 9, torch.float64, torch.device("cpu"))[3] == 0


def test_tv_systems_the_port_does_not_take_raise():
    """A z a system (the regression holiday's), an R that is no 0/1
    selection, and the loglik's derivative kernels on a time-varying
    system raise, naming their ROADMAP item."""
    rng = np.random.default_rng(6)
    fields, zt, h_scale, q_scale = _tv_systems(rng, 3, 4, 9, "chain")
    params = _port(fields, zt, h_scale, q_scale)
    y = torch.tensor(rng.normal(size=9))
    own_z = params._replace(z=params.z.contiguous() + torch.arange(3.0)[
        :, None, None])
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 7"):
        kalman.kalman_loglik(own_z, y)
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 7"):
        kalman_kernel.time_varying_operands(own_z, 9, torch.float64,
                                            torch.device("cpu"))
    mixed = params._replace(r_mat=params.r_mat + 0.5)
    with pytest.raises(NotImplementedError, match="selection.*ROADMAP"):
        kalman_kernel.time_varying_operands(mixed, 9, torch.float64,
                                            torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 7"):
        kalman_kernel.launch_jets(params.h, params.rqr, params.z,
                                  params.t_mat, params.a0, params.p0, y,
                                  None, torch.ones(1),
                                  torch.zeros(1, 4, 4), order=1)


# -- the reference's own cases (tests/test_state_models_tv.py) ---------------


def test_tv_filter_matches_static_when_constant():
    """Static parameters made time-varying change nothing (reference
    test_tv_filter_matches_static_when_constant)."""
    t_len, d = 40, 2
    params = SsmParams(
        z=torch.tensor([[1.0, 0.0]], dtype=torch.float64),
        t_mat=torch.tensor([[[1.0, 1.0], [0.0, 1.0]]], dtype=torch.float64),
        r_mat=torch.eye(2, dtype=torch.float64)[None],
        q_mat=0.1 * torch.eye(2, dtype=torch.float64)[None],
        h=torch.tensor([0.5], dtype=torch.float64),
        a0=torch.zeros(1, 2, dtype=torch.float64),
        p0=torch.eye(2, dtype=torch.float64)[None])
    y = torch.tensor(np.asarray(jax.random.normal(jax.random.key(0),
                                                  (t_len,))))
    tv = params._replace(z=params.z[:, None].expand(1, t_len, d),
                         h_scale=torch.ones(t_len, dtype=torch.float64),
                         q_scale=torch.ones(1, t_len, 2,
                                            dtype=torch.float64))
    f_static, f_tv = kalman.kalman_filter(params, y), kalman.kalman_filter(
        tv, y)
    _close(f_tv.loglik, f_static.loglik)
    _close(f_tv.a, f_static.a, atol=1e-10)
    _close(kalman.smooth_states(tv, y), kalman.smooth_states(params, y),
           atol=1e-9)


def test_tv_z_filter_is_regression():
    """With T = I, Q = 0, H = sig^2 and Z_t = x_t the smoother's state is
    the Bayesian linear regression's posterior mean (reference
    test_tv_z_filter_is_regression)."""
    kx, ke = jax.random.split(jax.random.key(0))
    t_len, p, sig = 60, 3, 0.3
    x = np.asarray(jax.random.normal(kx, (t_len, p)))
    beta = np.array([1.0, -2.0, 0.5])
    y = x @ beta + sig * np.asarray(jax.random.normal(ke, (t_len,)))
    eye = torch.eye(p, dtype=torch.float64)[None]
    params = SsmParams(z=torch.tensor(x)[None], t_mat=eye, r_mat=eye,
                       q_mat=torch.zeros(1, p, p, dtype=torch.float64),
                       h=torch.tensor([sig ** 2], dtype=torch.float64),
                       a0=torch.zeros(1, p, dtype=torch.float64),
                       p0=10.0 * eye)
    smoothed = kalman.smooth_states(params, torch.tensor(y))[0]
    prec = x.T @ x / sig ** 2 + np.eye(p) / 10.0
    mean = np.linalg.solve(prec, x.T @ y / sig ** 2)
    _close(smoothed[-1], mean, rtol=0, atol=1e-6)
    _close(smoothed[0], mean, rtol=0, atol=1e-6)


def test_tv_simulation_smoother_moments():
    """The mean of 600 draws is the smoothed mean (reference
    test_tv_simulation_smoother_moments)."""
    kx, ke, ks = jax.random.split(jax.random.key(0), 3)
    t_len, n = 30, 600
    x = np.asarray(jax.random.normal(kx, (t_len, 1))) + 1.0
    y = np.cumsum(0.1 * np.asarray(jax.random.normal(ke, (t_len,)))) * x[:, 0]
    one = torch.ones(n, 1, 1, dtype=torch.float64)
    params = SsmParams(z=torch.tensor(x)[None].expand(n, -1, -1),
                       t_mat=one, r_mat=one, q_mat=0.05 * one,
                       h=torch.full((n,), 0.2, dtype=torch.float64),
                       a0=torch.zeros(n, 1, dtype=torch.float64), p0=one)
    y = torch.tensor(y)
    mean = kalman.smooth_states(params, y)[0]
    rng = np.random.default_rng(int(jax.random.randint(ks, (), 0, 2 ** 30)))
    normals = [torch.tensor(rng.normal(size=s))
               for s in ((n, 1), (n, t_len - 1, 1), (n, t_len))]
    draws = kalman.simulation_smoother(params, y, *normals)
    _close(draws.mean(0), mean, rtol=0, atol=0.1)


def test_reference_tv_system_converts(case):
    """``convert.ssm_params_from_numpy`` takes the reference's time-varying
    fields: z [C, T, d] one for every chain (expanded), q_scale as it is,
    and a time-varying h as h [C] with its h_scale."""
    from boom_tpu_torch.convert import ssm_params_from_numpy

    params, *_ = case
    ref = {k: getattr(params, k).numpy() for k in ("t_mat", "r_mat",
                                                   "q_mat", "h", "a0", "p0")}
    ref["z"] = params.zs(T_LEN).numpy()
    ref["q_scale"] = (None if params.q_scale is None
                      else params.q_scale.numpy())
    got = ssm_params_from_numpy(ref, device="cpu",
                                h_scale=params.h_scale.numpy())
    assert got.z.stride(0) == 0
    for name in params._fields:
        a, b = getattr(got, name), getattr(params, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="h_scale"):
        ssm_params_from_numpy(dict(ref, h=params.hs(T_LEN).numpy()),
                              device="cpu")
