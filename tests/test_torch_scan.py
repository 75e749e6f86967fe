"""The port's parallel-in-time Kalman scans against the JAX reference.

The same inputs, made from a numpy seed, go through the reference
(``boom_tpu.statespace.parallel_kalman`` / ``pallas_scan`` in interpret
mode, float64) and the port (``boom_tpu_torch``, float64 on the CPU, where
every scan runs its plain PyTorch version). Tolerances are those of the
reference's own scan tests (``test_pallas_scan.py``): rtol 1e-9, atol
1e-11; the two sides differ only in summation order.

The CUDA kernel itself cannot run here; ``test_kernel_glue_*`` runs the
wrappers' CUDA-side Python (stacking, reverse flag, row offsets) with the
kernel replaced by a layout-aware plain scan. The kernel is held against
the plain version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boom_tpu.statespace import pallas_scan as jps
from boom_tpu.statespace import parallel_kalman as jpk
from boom_tpu.statespace.kalman import SsmParams as JaxSsmParams
from boom_tpu_torch.convert import ssm_params_from_numpy
from boom_tpu_torch.statespace import parallel_kalman as pk
from boom_tpu_torch.statespace import scan_kernel as sk

torch.set_num_threads(1)

RTOL, ATOL = 1e-9, 1e-11
CHAINS = 3


def _systems(seed, d, q=2, chains=CHAINS):
    """numpy fields of ``chains`` random stable systems [C, ...]."""
    rng = np.random.default_rng(seed)

    def one():
        raw = rng.normal(size=(d, d)) * 0.4
        lq = rng.normal(size=(q, q))
        mp = rng.normal(size=(d, d))
        return dict(
            z=rng.normal(size=d),
            t_mat=raw / max(1.0, 1.1 * np.max(np.abs(np.linalg.eigvals(raw)))),
            r_mat=rng.normal(size=(d, q)),
            q_mat=lq @ lq.T + 0.5 * np.eye(q),
            h=np.asarray(rng.uniform(0.3, 1.0)),
            a0=rng.normal(size=d), p0=mp @ mp.T + np.eye(d))

    systems = [one() for _ in range(chains)]
    return {k: np.stack([s[k] for s in systems]) for k in systems[0]}


def _jax_params(fields):
    return JaxSsmParams(**{k: jnp.asarray(v) for k, v in fields.items()})


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _sim_normals(keys, d, q, t_len):
    """The standard normals the reference's ``_simulate_elements`` and
    ``parallel_simulate`` draw from each chain key (split into 3)."""

    def one(key):
        k0, ka, ke = jax.random.split(key, 3)
        return (jax.random.normal(k0, (d,)),
                jax.random.normal(ka, (t_len - 1, q)),
                jax.random.normal(ke, (t_len,)))

    return [torch.tensor(np.asarray(v)) for v in jax.vmap(one)(keys)]


@pytest.mark.parametrize("d", [2, 3])
def test_filter_and_smooth_match_reference(d):
    fields = _systems(10 + d, d)
    y = np.random.default_rng(d).normal(size=(CHAINS, 200))
    fm_j, fp_j = jax.jit(jax.vmap(jpk.parallel_filter_moments))(
        _jax_params(fields), jnp.asarray(y))
    params = ssm_params_from_numpy(fields, device="cpu")
    fm, fp = pk.parallel_filter_moments(params, torch.tensor(y))
    _close(fm, fm_j)
    _close(fp, fp_j)

    sm_j = jax.jit(jax.vmap(jpk.parallel_smooth_means))(
        _jax_params(fields), fm_j, fp_j)
    sm = pk.parallel_smooth_means(params, torch.tensor(np.asarray(fm_j)),
                                  torch.tensor(np.asarray(fp_j)))
    _close(sm, sm_j)


@pytest.mark.parametrize("d", [2, 3])
def test_simulate_and_simulation_smoother_match_reference(d):
    q, t_len = 2, 150
    fields = _systems(20 + d, d, q)
    y = np.random.default_rng(d).normal(size=(CHAINS, t_len))
    keys = jax.random.split(jax.random.key(d), CHAINS)
    normals = _sim_normals(keys, d, q, t_len)
    params = ssm_params_from_numpy(fields, device="cpu")

    a_j, y_j = jax.jit(jax.vmap(
        lambda k, p: jpk.parallel_simulate(k, p, t_len)))(
        keys, _jax_params(fields))
    alphas, ys = pk.parallel_simulate(params, t_len, *normals)
    _close(alphas, a_j)
    _close(ys, y_j)

    draw_j = jax.jit(jax.vmap(jpk.parallel_simulation_smoother))(
        keys, _jax_params(fields), jnp.asarray(y))
    draw = sk.simulation_smoother(params, torch.tensor(y), *normals)
    _close(draw, draw_j)


def test_smooth_states_match_pallas_interpret():
    """As test_smoke.py runs the Pallas kernel (interpret mode, d=1,
    T=64), against the port's scan wrapper on the CPU."""
    fields = dict(z=np.ones((1, 1)), t_mat=np.eye(1)[None],
                  r_mat=np.eye(1)[None], q_mat=0.2 * np.eye(1)[None],
                  h=np.asarray([0.3]), a0=np.zeros((1, 1)),
                  p0=np.eye(1)[None])
    y = np.cumsum(0.4 * np.random.default_rng(5).normal(size=64))
    ref = jps.pallas_smooth_states(
        JaxSsmParams(**{k: jnp.asarray(v[0]) for k, v in fields.items()}),
        jnp.asarray(y))
    out = sk.smooth_states(ssm_params_from_numpy(fields, device="cpu"),
                           torch.tensor(y)[None])
    _close(out[0], ref)


def test_affine_dpath_matches_sequential_scan():
    """The ASIS D-path D_t = T D_{t-1} + w_t, D_0 = 0, as the reference runs
    it (a sequential lax.scan, bsts.py:1077-1082) against the port's
    batched affine scan over chains x groups."""
    rng = np.random.default_rng(7)
    c, g, t_len, d = 3, 2, 120, 2
    t_mat = np.stack([_systems(30 + i, d, chains=1)["t_mat"][0]
                      for i in range(c)])
    w = rng.normal(size=(t_len - 1, c, g, d))

    def rec(dprev, w_t):
        dnext = jnp.einsum("cij,cgj->cgi", jnp.asarray(t_mat), dprev) + w_t
        return dnext, dnext

    _, ref = jax.lax.scan(rec, jnp.zeros((c, g, d)), jnp.asarray(w))
    ref = np.moveaxis(np.asarray(ref), 0, 2)  # [C, G, T-1, d]
    a_elems = torch.tensor(t_mat)[:, None, None].expand(c, g, t_len - 1, d, d)
    out = sk.affine_prefix(
        a_elems.reshape(c * g, t_len - 1, d, d),
        torch.tensor(np.moveaxis(w, 0, 2)).reshape(c * g, t_len - 1, d))
    _close(out.reshape(c, g, t_len - 1, d), ref)


def test_cpu_tensors_run_the_plain_version():
    """A CPU tensor takes the plain path and launches nothing; the launch
    wrapper refuses a CPU tensor rather than running elsewhere."""
    params = ssm_params_from_numpy(_systems(40, 2), device="cpu")
    y = torch.tensor(np.random.default_rng(0).normal(size=(CHAINS, 50)))
    before = dict(sk.LAUNCHES)
    fm, fp = sk.filter_moments(params, y)
    fm0, fp0 = pk.parallel_filter_moments(params, y)
    assert torch.equal(fm, fm0) and torch.equal(fp, fp0)
    assert sk.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        sk.inclusive_scan("affine", 2, torch.zeros(1, 6, 4))


def _emulated_kernel(name, d, stacked, reverse=False):
    """The kernel's contract in plain torch: unpack each element's F rows
    (row-major matrices, then vectors) from [B, F, T], scan with the plain
    combine, and pack the result in the same layout."""
    b, _, t_len = stacked.shape
    x = stacked.transpose(1, 2)  # [B, T, F]
    dd = d * d

    def mat(i):
        return x[..., i * dd:(i + 1) * dd].reshape(b, t_len, d, d)

    if name == "filter":
        vec0 = 3 * dd
        elems = (mat(0), x[..., vec0:vec0 + d], mat(1),
                 x[..., vec0 + d:vec0 + 2 * d], mat(2))
        out = pk.FilterElement(*pk.hillis_steele(pk._combine_filter, elems))
        parts = [out.a, out.c, out.j, out.b, out.eta]
    else:
        combine = pk._combine_smooth if name == "smooth" else pk._combine_affine
        parts = list(pk.hillis_steele(combine, (mat(0), x[..., dd:]),
                                      reverse=reverse))
    flat = [p.reshape(b, t_len, -1) for p in parts]
    return torch.cat(flat, dim=-1).transpose(1, 2).contiguous()


@pytest.mark.parametrize("d", [1, 3])
def test_kernel_glue_matches_plain(monkeypatch, d):
    """The wrappers' CUDA-side code (element stacking, the reverse flag of
    the smooth scan, the row offsets of the outputs) with the kernel
    replaced by its plain layout-aware emulation."""
    q, t_len = 2, 70
    fields = _systems(50 + d, d, q)
    params = ssm_params_from_numpy(fields, device="cpu")
    rng = np.random.default_rng(d)
    y = torch.tensor(rng.normal(size=(CHAINS, t_len)))
    normals = [torch.tensor(rng.normal(size=s)) for s in
               ((CHAINS, d), (CHAINS, t_len - 1, q), (CHAINS, t_len))]
    plain = pk.parallel_simulation_smoother(params, y, *normals)
    fm0, fp0 = pk.parallel_filter_moments(params, y)

    monkeypatch.setattr(sk, "_on_card", lambda x: True)
    monkeypatch.setattr(sk, "inclusive_scan", _emulated_kernel)
    fm, fp = sk.filter_moments(params, y)
    _close(fm, fm0.numpy())
    _close(fp, fp0.numpy())
    _close(sk.simulation_smoother(params, y, *normals), plain.numpy())
