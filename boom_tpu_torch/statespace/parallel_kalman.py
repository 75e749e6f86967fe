"""Temporal-parallel (associative-scan) Kalman filtering and smoothing —
port of boom_tpu/statespace/parallel_kalman.py:44-276.

Särkkä & García-Fernández, "Temporal Parallelization of Bayesian
Smoothers" (IEEE TAC 2021): filtering, RTS smoothing and unconditional
simulation become inclusive scans over per-step elements with O(log T)
sequential depth. This module holds the element builders, the combine
rules and a plain Hillis-Steele scan in torch ops. It is the plain
version of the hand-written CUDA scan (``scan_kernel.py``): the CPU runs
it, and the card runs it only to check the kernel.

Layout: elements carry a batch axis first and time second, ``[B, T, ...]``
(the reference's vmap over chains becomes the explicit batch axis). Random
numbers are arguments, never drawn here.

Precision: float32 matmuls on the card stay full precision because
``torch.backends.cuda.matmul.allow_tf32`` keeps its default, False; the
port never sets it. That is the counterpart of the reference's ``_hp``
(parallel_kalman.py:29), which forces "highest" matmul precision — the
innovation differencing downstream amplifies a TF32/bf16 rounding error
catastrophically.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from boom_tpu_torch.statespace.kalman import SsmParams


def _eye(d, like):
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _mv(m, v):
    """Batched matrix-vector product m @ v over leading dims."""
    return (m @ v[..., None])[..., 0]


def _solve_small(a, b):
    """Solve a @ x = b for small static d by unrolled no-pivot Gauss-Jordan
    (reference ``_solve_small``). The systems are I + C J and P F' with C,
    J, P PSD — diagonally dominant in practice, so pivoting is
    unnecessary."""
    d = a.shape[-1]
    aug = torch.cat([a, b], dim=-1)
    for i in range(d):
        row = aug[..., i, :] / aug[..., i, i:i + 1]
        aug = aug - aug[..., :, i:i + 1] * row[..., None, :]
        aug = torch.cat([aug[..., :i, :], row[..., None, :],
                         aug[..., i + 1:, :]], dim=-2)
    return aug[..., d:]


def _mm_small(a, b):
    """a @ b for batches of tiny matrices over [C, T], as a broadcast
    product and sum. On an H100, cuBLAS took 0.54 ms of device time for
    the batched GEMMs of 8 x 4095 float64 2x2 matrices here, over half of
    the simulation smoother's 0.95 ms; this form needs a few elementwise
    kernels (PERF.md, Findings)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _mv_small(m, v):
    """m @ v over [C, T] batches of tiny matrices, elementwise (see
    ``_mm_small``)."""
    return (m * v[..., None, :]).sum(-1)


def _sym(m):
    return 0.5 * (m + m.transpose(-1, -2))


def _chol(m):
    """Cholesky factor of tiny batched SPD matrices; raises on failure
    (``cholesky_ex`` does not)."""
    fac, info = torch.linalg.cholesky_ex(m)
    if bool((info != 0).any()):
        raise torch.linalg.LinAlgError(
            f"Cholesky failed for {int((info != 0).sum())} matrices")
    return fac


# ---------------------------------------------------------------------------
# generic Hillis-Steele inclusive scan (the plain version of the kernel)
# ---------------------------------------------------------------------------

def hillis_steele(combine: Callable, elems: tuple, reverse: bool = False):
    """Inclusive scan of a tuple of ``[B, T, ...]`` tensors along axis 1.

    ``combine(earlier, later)`` takes the element that comes first in scan
    order as its first argument. ``reverse=True`` scans from t = T-1 down
    to 0, so the first argument is then the accumulated LATER suffix (as
    ``jax.lax.associative_scan(..., reverse=True)`` and the reference's
    flipped Pallas smooth scan)."""
    if reverse:
        elems = tuple(e.flip(1) for e in elems)
    t_len = elems[0].shape[1]
    s = 1
    while s < t_len:
        comb = combine(tuple(e[:, :-s] for e in elems),
                       tuple(e[:, s:] for e in elems))
        elems = tuple(torch.cat([e[:, :s], c], dim=1)
                      for e, c in zip(elems, comb))
        s *= 2
    if reverse:
        elems = tuple(e.flip(1) for e in elems)
    return elems


# ---------------------------------------------------------------------------
# filtering
# ---------------------------------------------------------------------------

class FilterElement(NamedTuple):
    """p(x_k | y_{i+1:k}, x_i) as an affine-Gaussian (A, b, C) plus an
    information pair (eta, J) (Särkkä-García-Fernández eq. 10)."""

    a: torch.Tensor  # [B, T, d, d]
    b: torch.Tensor  # [B, T, d]
    c: torch.Tensor  # [B, T, d, d]
    eta: torch.Tensor  # [B, T, d]
    j: torch.Tensor  # [B, T, d, d]


def _batch_y(params: SsmParams, y):
    """y: [T] (shared by the chains) or [C, T] -> [C, T]."""
    if y.dim() == 1:
        y = y.expand(params.z.shape[0], -1)
    return y


def _generic_filter_elements(params: SsmParams, y):
    """Per-step elements for k >= 2: predict with F, Q then update with
    y_k. y: [C, T]."""
    t_len = y.shape[1]
    d = params.z.shape[-1]
    f_mat, q, z = params.t_mat, params.rqr, params.z
    qz = _mv(q, z)
    s = (z * qz).sum(-1) + params.h  # [C]
    k_gain = qz / s[:, None]
    i_kh = _eye(d, z) - k_gain[:, :, None] * z[:, None, :]
    a_obs = i_kh @ f_mat
    c_obs = i_kh @ q
    fz = _mv(f_mat.transpose(-1, -2), z)
    j_obs = fz[:, :, None] * fz[:, None, :] / s[:, None, None]

    def per_t(m):
        return m[:, None].expand(-1, t_len, *m.shape[1:])

    return FilterElement(
        a=per_t(a_obs), b=k_gain[:, None, :] * y[:, :, None],
        c=per_t(c_obs), eta=fz[:, None, :] * (y / s[:, None])[:, :, None],
        j=per_t(j_obs))


def _first_element(params: SsmParams, y0):
    """The k = 1 element: filter the prior N(a0, P0) against y_1. y0: [C]."""
    d = params.z.shape[-1]
    z, p0, a0 = params.z, params.p0, params.a0
    pz = _mv(p0, z)
    s1 = (z * pz).sum(-1) + params.h
    k1 = pz / s1[:, None]
    m1 = a0 + k1 * (y0 - (z * a0).sum(-1))[:, None]
    c1 = (_eye(d, z) - k1[:, :, None] * z[:, None, :]) @ p0
    zeros_m = torch.zeros_like(p0)
    return FilterElement(a=zeros_m, b=m1, c=_sym(c1),
                         eta=torch.zeros_like(a0), j=zeros_m)


def _filter_elements(params: SsmParams, y):
    """All T elements; step 1 conditions on the prior N(a0, P0)."""
    y = _batch_y(params, y)
    elems = _generic_filter_elements(params, y)
    first = _first_element(params, y[:, 0])
    return FilterElement(*(
        torch.cat([f[:, None], arr[:, 1:]], dim=1)
        for arr, f in zip(elems, first)))


def _combine_filter(e1, e2):
    """Särkkä-García-Fernández lemma 8; e1 is the earlier element."""
    e1, e2 = FilterElement(*e1), FilterElement(*e2)
    d = e1.a.shape[-1]
    eye = _eye(d, e1.a)
    icj = eye + e1.c @ e2.j
    # A2 (I + C1 J2)^{-1}
    a2_icj_inv = _solve_small(icj.transpose(-1, -2),
                              e2.a.transpose(-1, -2)).transpose(-1, -2)
    a = a2_icj_inv @ e1.a
    b = _mv(a2_icj_inv, e1.b + _mv(e1.c, e2.eta)) + e2.b
    c = a2_icj_inv @ e1.c @ e2.a.transpose(-1, -2) + e2.c
    ijc = eye + e2.j @ e1.c
    rhs = torch.cat([(e2.eta - _mv(e2.j, e1.b))[..., None], e2.j @ e1.a],
                    dim=-1)
    sol = _solve_small(ijc, rhs)
    eta = _mv(e1.a.transpose(-1, -2), sol[..., 0]) + e1.eta
    jmat = e1.a.transpose(-1, -2) @ sol[..., 1:] + e1.j
    return FilterElement(a=a, b=b, c=_sym(c), eta=eta, j=_sym(jmat))


def parallel_filter_moments(params: SsmParams, y):
    """Filtered means/covariances for all t in O(log T) depth.

    y: [T] or [C, T]. Returns (m [C, T, d], P [C, T, d, d]) with
    m[:, t] = E[alpha_t | y_{1:t}]."""
    out = FilterElement(*hillis_steele(_combine_filter,
                                       _filter_elements(params, y)))
    return out.b, out.c


# ---------------------------------------------------------------------------
# smoothing
# ---------------------------------------------------------------------------

class SmoothElement(NamedTuple):
    e: torch.Tensor  # [B, T, d, d]
    g: torch.Tensor  # [B, T, d]


def _combine_smooth(later, earlier):
    """m_k|T = g_k + E_k m_{k+1|T}; suffix composition. In a reverse scan
    the accumulated LATER suffix is the first argument."""
    later, earlier = SmoothElement(*later), SmoothElement(*earlier)
    return SmoothElement(e=earlier.e @ later.e,
                         g=earlier.g + _mv(earlier.e, later.g))


def _smooth_elements(params: SsmParams, fm, fp):
    """RTS suffix-scan elements (E_k, g_k) from filtered moments
    fm [C, T, d], fp [C, T, d, d]."""
    f_mat = params.t_mat[:, None]
    q = params.rqr[:, None]
    d = fm.shape[-1]
    p = fp[:, :-1]
    f_p = _mm_small(f_mat, p)
    pred = _mm_small(f_p, f_mat.transpose(-1, -2)) + q
    eps = 1e-12 if fp.dtype == torch.float64 else 1e-6
    pred = pred + eps * _eye(d, fp)
    g_mat = _solve_small(pred, f_p).transpose(-1, -2)  # P F' pred^-1
    g_vec = fm[:, :-1] - _mv_small(g_mat, _mv_small(f_mat, fm[:, :-1]))
    # last element: identity on the filtered mean
    e_all = torch.cat([g_mat, torch.zeros_like(fp[:, -1:])], dim=1)
    g_all = torch.cat([g_vec, fm[:, -1:]], dim=1)
    return e_all, g_all


def parallel_smooth_means(params: SsmParams, fm, fp):
    """Smoothed means E[alpha_t | y_{1:T}] [C, T, d] from filtered
    moments (RTS gains + reverse inclusive scan)."""
    e_all, g_all = _smooth_elements(params, fm, fp)
    return hillis_steele(_combine_smooth, (e_all, g_all), reverse=True)[1]


def parallel_smooth_states(params: SsmParams, y):
    fm, fp = parallel_filter_moments(params, y)
    return parallel_smooth_means(params, fm, fp)


# ---------------------------------------------------------------------------
# unconditional simulation
# ---------------------------------------------------------------------------

def _combine_affine(x1, x2):
    """Forward affine composition x -> A2 (A1 x + b1) + b2."""
    a1, b1 = x1
    a2, b2 = x2
    return a2 @ a1, _mv(a2, b1) + b2


def affine_scan(a_elems, b_elems):
    """Plain inclusive affine scan: returns the b part of the prefix
    compositions, i.e. x_t = A_t x_{t-1} + b_t from x_{-1} = 0.
    a_elems [B, T, d, d], b_elems [B, T, d] -> [B, T, d]."""
    return hillis_steele(_combine_affine, (a_elems, b_elems))[1]


def _simulate_elements(params: SsmParams, t_len: int, alpha1_z, eta_z):
    """(A_k, b_k) elements of the state recurrence.

    alpha1_z [C, d] and eta_z [C, T-1, q] are standard normals (the
    reference draws them from keys k0 and ka inside this function)."""
    d = params.z.shape[-1]
    q_dim = params.q_mat.shape[-1]
    p0_chol = _chol(params.p0 + 1e-12 * _eye(d, params.p0))
    q_chol = _chol(params.q_mat + 1e-12 * _eye(q_dim, params.q_mat))
    alpha1 = params.a0 + _mv(p0_chol, alpha1_z)
    # w = R chol(Q) eta_z with R chol(Q) folded first: one product over
    # [C, T-1] instead of two
    w = eta_z @ (params.r_mat @ q_chol).transpose(-1, -2)  # [C, T-1, d]
    a_elems = params.t_mat[:, None].expand(-1, t_len, d, d)
    a_elems = torch.cat([torch.zeros_like(a_elems[:, :1]), a_elems[:, 1:]],
                        dim=1)
    b_elems = torch.cat([alpha1[:, None], w], dim=1)
    return a_elems, b_elems


def _observe(params: SsmParams, alphas, eps_z):
    """y = Z' alpha + sqrt(h) * eps_z, per chain. eps_z: [C, T]."""
    eps = torch.sqrt(params.h)[:, None] * eps_z
    return (alphas * params.z[:, None, :]).sum(-1) + eps


def parallel_simulate(params: SsmParams, t_len: int, alpha1_z, eta_z,
                      eps_z):
    """Unconditional draw of (alpha [C, T, d], y [C, T]): the state
    recursion is an affine scan over (A, b) pairs."""
    a_elems, b_elems = _simulate_elements(params, t_len, alpha1_z, eta_z)
    alphas = affine_scan(a_elems, b_elems)
    return alphas, _observe(params, alphas, eps_z)


def parallel_simulation_smoother(params: SsmParams, y, alpha1_z, eta_z,
                                 eps_z):
    """Durbin-Koopman simulation smoother with O(log T) sequential depth:
    alpha+ + E[alpha | y - y+] with a0 = 0 for the second term."""
    alpha_plus, y_plus = parallel_simulate(params, y.shape[-1], alpha1_z,
                                           eta_z, eps_z)
    params0 = params._replace(a0=torch.zeros_like(params.a0))
    return alpha_plus + parallel_smooth_states(params0, y - y_plus)
