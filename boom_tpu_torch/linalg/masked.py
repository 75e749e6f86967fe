"""Masked (fixed-shape) subset linear algebra, the ``Selector``
replacement (port of boom_tpu/linalg/masked.py:26-72).

``masked_cholesky(A, m)`` factors ``A`` restricted to the mask ``m``, with
a unit diagonal and no coupling outside it, so one fixed-shape batched
Cholesky serves any subset. Every function is batched over leading dims.
"""

from __future__ import annotations

import torch


def mask_outer(mask):
    """m_i & m_j as a float matrix (reference masked.py:26)."""
    m = torch.as_tensor(mask)
    return m[..., :, None] * m[..., None, :]


def masked_spd(a, mask):
    """Embed A[m, m] in fixed shape: unit diagonal, zero coupling outside
    (reference masked.py:32)."""
    m = torch.as_tensor(mask, device=a.device).to(a.dtype)
    mo = m[..., :, None] * m[..., None, :]
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return a * mo + eye * (1.0 - m[..., :, None])


def masked_cholesky_ex(a, mask):
    """(L, info) of the masked embedding of A: ``torch.linalg.cholesky_ex``
    with no host synchronisation; ``info`` is nonzero where a factor
    failed, and the caller decides when to look."""
    return torch.linalg.cholesky_ex(masked_spd(a, mask))


def masked_cholesky(a, mask):
    """Cholesky factor of the masked embedding of A (reference
    masked.py:40); raises where A[m, m] is not positive definite."""
    return torch.linalg.cholesky(masked_spd(a, mask))


def masked_logdet(chol, mask):
    """log det A[m, m] from a masked Cholesky factor (reference
    masked.py:49)."""
    m = torch.as_tensor(mask, device=chol.device).to(chol.dtype)
    d = torch.diagonal(chol, dim1=-2, dim2=-1)
    return 2.0 * (m * torch.log(torch.where(m > 0, d, 1.0))).sum(-1)


def _solve_lower(chol, b):
    return torch.linalg.solve_triangular(chol, b[..., None],
                                         upper=False)[..., 0]


def _solve_upper_t(chol, b):
    """(L')^{-1} b."""
    return torch.linalg.solve_triangular(chol.transpose(-1, -2),
                                         b[..., None], upper=True)[..., 0]


def masked_cho_solve(chol, b, mask):
    """Solve A[m, m] x[m] = b[m]; zeros on excluded coordinates (reference
    masked.py:56)."""
    m = torch.as_tensor(mask, device=b.device).to(b.dtype)
    return _solve_upper_t(chol, _solve_lower(chol, b * m)) * m


def masked_quad_form_inv(chol, b, mask):
    """b[m]' A[m, m]^{-1} b[m] given the masked Cholesky (reference
    masked.py:66)."""
    m = torch.as_tensor(mask, device=b.device).to(b.dtype)
    y = _solve_lower(chol, b * m)
    return (y * y).sum(-1)


def masked_mvn_suf_sample(z, chol, prec_mean, mask):
    """x ~ N(A[m,m]^{-1} b[m], A[m,m]^{-1}) embedded in fixed shape with
    zeros outside the subset (reference masked.py:75), from the standard
    normals ``z`` (shape of ``prec_mean``; the reference draws them from
    its key)."""
    m = torch.as_tensor(mask, device=prec_mean.device).to(prec_mean.dtype)
    w = _solve_lower(chol, prec_mean * m)
    return _solve_upper_t(chol, w + z * m) * m
