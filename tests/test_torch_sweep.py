"""The port's SWEEP operator and masked subset algebra
(``boom_tpu_torch/linalg``) against the reference's (``boom_tpu/linalg``),
on the CPU in float64, batched over chains with a per-chain index.

Tolerance: rtol 1e-12. Both sides compute the same operations in the same
order; the only difference allowed is rounding of the libraries' triangular
solves and Cholesky factors.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boom_tpu_torch.linalg import masked, sweep

# boom_tpu.linalg re-exports a function named sweep over its module
jmasked = importlib.import_module("boom_tpu.linalg.masked")
jsweep = importlib.import_module("boom_tpu.linalg.sweep")

torch.set_num_threads(1)

RTOL = 1e-12


def _spd(rng, c, d):
    m = rng.normal(size=(c, d, d))
    return m @ np.swapaxes(m, -1, -2) + d * np.eye(d)


def _close(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("d", [1, 5, 12])
def test_sweep_unsweep_flip_with_per_chain_index(d):
    rng = np.random.default_rng(d)
    c = 8
    a = _spd(rng, c, d)
    k = rng.integers(0, d, size=c)
    swept_now = rng.uniform(size=c) < 0.5
    gate = rng.uniform(size=c) < 0.6
    ja, jk = jnp.asarray(a), jnp.asarray(k)
    ta, tk = torch.tensor(a), torch.tensor(k)
    _close(sweep.sweep(ta, tk), jax.vmap(jsweep.sweep)(ja, jk))
    _close(sweep.unsweep(ta, tk), jax.vmap(jsweep.unsweep)(ja, jk))
    _close(sweep.flip_sweep(ta, tk, torch.tensor(swept_now)),
           jax.vmap(jsweep.flip_sweep)(ja, jk, jnp.asarray(swept_now)))
    _close(sweep.gated_flip_sweep(ta, tk, torch.tensor(swept_now),
                                  torch.tensor(gate)),
           jax.vmap(jsweep.gated_flip_sweep)(ja, jk, jnp.asarray(swept_now),
                                             jnp.asarray(gate)))
    # unsweep undoes sweep
    _close(sweep.unsweep(sweep.sweep(ta, tk), tk), a)


def test_sweep_subset_gives_the_regression():
    rng = np.random.default_rng(3)
    c, d = 6, 9
    a = _spd(rng, c, d)
    mask = rng.uniform(size=(c, d)) < 0.5
    port = sweep.sweep_subset(torch.tensor(a), torch.tensor(mask))
    _close(port, jax.vmap(jsweep.sweep_subset)(jnp.asarray(a),
                                               jnp.asarray(mask)))
    # the swept block is -A[m, m]^{-1}
    m = mask[0]
    if m.any():
        inv = np.linalg.inv(a[0][np.ix_(m, m)])
        np.testing.assert_allclose(port[0].numpy()[np.ix_(m, m)], -inv,
                                   rtol=1e-10)


def test_gated_off_zero_pivot_passes_through():
    """A zero pivot with the gate off: the reference's folded gate gives
    0 * inf = NaN (ROADMAP.md §3); the port passes the matrix through."""
    a = np.array([[[0.0, 1.0, 0.5], [1.0, 2.0, 0.3], [0.5, 0.3, 1.0]]])
    ref = jax.vmap(jsweep.gated_flip_sweep)(
        jnp.asarray(a), jnp.asarray([0]), jnp.asarray([False]),
        jnp.asarray([False]))
    assert np.isnan(np.asarray(ref)).any()
    port = sweep.gated_flip_sweep(torch.tensor(a), torch.tensor([0]),
                                  torch.tensor([False]),
                                  torch.tensor([False]))
    np.testing.assert_array_equal(port.numpy(), a)


@pytest.mark.parametrize("d", [1, 7])
def test_masked_ops_match_reference(d):
    rng = np.random.default_rng(10 + d)
    c = 8
    a = _spd(rng, c, d)
    mask = rng.uniform(size=(c, d)) < 0.5
    mask[0] = False  # the empty subset
    b = rng.normal(size=(c, d))
    ta, tm, tb = torch.tensor(a), torch.tensor(mask), torch.tensor(b)
    ja, jm, jb = jnp.asarray(a), jnp.asarray(mask), jnp.asarray(b)
    np.testing.assert_array_equal(
        masked.mask_outer(tm.double()).numpy(),
        np.asarray(jmasked.mask_outer(jm.astype(jnp.float64))))
    _close(masked.masked_spd(ta, tm), jmasked.masked_spd(ja, jm))
    chol = masked.masked_cholesky(ta, tm)
    jchol = jmasked.masked_cholesky(ja, jm)
    _close(chol, jchol)
    l_ex, info = masked.masked_cholesky_ex(ta, tm)
    assert int(info.abs().sum()) == 0
    _close(l_ex, jchol)
    _close(masked.masked_logdet(chol, tm), jmasked.masked_logdet(jchol, jm))
    _close(masked.masked_cho_solve(chol, tb, tm),
           jmasked.masked_cho_solve(jchol, jb, jm))
    _close(masked.masked_quad_form_inv(chol, tb, tm),
           jmasked.masked_quad_form_inv(jchol, jb, jm))
    # the reference's normals, drawn from its key, fed to the port
    key = jax.random.key(d)
    jz = jax.random.normal(key, (c, d), jnp.float64)
    ref = jmasked.masked_mvn_suf_sample(key, jchol, jb, jm)
    _close(masked.masked_mvn_suf_sample(torch.tensor(np.asarray(jz)), chol,
                                        tb, tm), ref)
